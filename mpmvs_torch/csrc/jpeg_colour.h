// The arithmetic of the JPEG decoder's colour kernels (jpeg_codec.cu:
// ycc_to_bgr_kernel, cmyk_to_bgr_kernel), one output pixel at a time:
// libjpeg-turbo's upsampling of each component (jdsample.c), its colour
// conversion (jdcolor.c) and OpenCV's conversions of libjpeg's output
// (grfmt_jpeg.cpp, utils.cpp). Shared by the kernels and by the host, where
// the tests build it with g++; the plain PyTorch versions are
// mpmvs_torch/io/images.py::colour_plain and cmyk_to_bgr_plain.
//
// Upsampling (jinit_upsampler), by a component's ratios rh = hmax / h and
// rv = vmax / v (integers: the parse refuses the rest):
//   * 1 x 1: the samples as they are;
//   * 2 x 1 and 2 x 2 where the component is more than 2 samples wide, and
//     1 x 2 at any width: "fancy" (triangle) upsampling, h2v1, h2v2 and
//     h1v2_fancy_upsample, edge rows and columns replicated as libjpeg's
//     context rows and edge code do;
//   * any other ratio, and 2 x 1 or 2 x 2 at 1 or 2 samples wide: each
//     sample replicated rh x rv times (int_upsample, h2v1_upsample,
//     h2v2_upsample).
// The first component is upsampled by the same rule when it is not the
// largest.
//
// Chunks: a TIFF's JPEG-coded strips or tiles are each a JPEG of its own,
// decoded on its own (tiff_jpeg.h), so each is upsampled on its own: a
// neighbour is clamped to the pixel's own chunk (a strip's edge rows are
// replicated as an image's are), a chunk's samples are its stream's rows
// (a last strip's may pass the image's last row; the rows past a shorter
// stream are black), and tiles are
// cropped at the image's right and bottom edges. Where the orientation
// mirrors the image left-right, libtiff's tile reader mirrors each tile on
// its own and OpenCV no more (tiff_decode.h), so `mirror` lays the tiles
// out in mirrored order, each tile's columns as they are, for the
// orientation applied after to mirror the whole image. A component's samples of
// every chunk lie one after another in one plane (the IDCT's output, rows
// of `pitch` bytes, `stride` rows a chunk). A JPEG file is one chunk, the
// image, and the rule is the one above.
//
// Colour:
//   * YCbCr: jdcolor.c's fixed-point YCbCr -> RGB (16 fractional bits,
//     FIX(1.402), FIX(1.772), FIX(0.71414), FIX(0.34414), rounding as its
//     tables do), clamped; the grey image is the (upsampled) Y component;
//   * RGB components: the samples in B, G, R order, the grey
//     rgb_gray_convert's (19595 R + 38470 G + 7471 B + 32768) >> 16;
//   * with the OpenCV grey (a TIFF's: OpenCV converts libtiff's RGBA
//     image), the grey of either is OpenCV's BGR -> grey of the BGR,
//     (4899 R + 9617 G + 1868 B + 8192) >> 14, not libjpeg's;
//   * CMYK: libjpeg hands OpenCV the four samples (null_convert); YCCK:
//     ycck_cmyk_convert, the YCbCr -> RGB above with C, M, Y = 255 - R, G, B
//     and K passed through. OpenCV then makes BGR by icvCvt_CMYK2BGR_8u_C4C3R,
//     each of C, M, Y becoming k - ((255 - x) k >> 8) with B = Y', G = M',
//     R = C', and grey by icvCvt_CMYK2Gray_8u_C4C1R, (1868 B + 9617 G +
//     4899 R + 8192) >> 14 of those: the grey of a four-component JPEG is
//     not one of its planes.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "jpeg_fdct.h"   // y_of: rgb_gray_convert's coefficients
#include "raster_bgr.h"  // opencv_grey

namespace jpeg_colour {

// One component's samples and how they are upsampled to the image.
struct Plane {
  const uint8_t* p;
  int w;       // its samples across a chunk: ceil(cols / rh) (of the
               // image, for a JPEG); down, ceil(the stream's rows / rv)
  int rh, rv;  // hmax / h_samp_factor, vmax / v_samp_factor
  int fancy;   // 1: fancy upsampling (rh, rv in {1, 2}), 0: replication
  int pitch;   // bytes a row of samples (w for a JPEG)
  int stride;  // rows of samples from one chunk to the next
};

// Up to four components (the count is the kernel's form).
struct Planes {
  Plane c[4];
};

// How the image is cut into chunks, each coded on its own.
struct Chunks {
  int tiled;   // 1: tiles, 0: strips
  int w, h;    // a chunk's pixels (a strip is the image's width)
  int across;  // chunks a row of them (1 for strips)
  int n;       // chunks in all
  int mirror;  // tiles laid out in mirrored order (see above)
  int image_w; // the image's width
  // each chunk's stream's rows (its frame's height); the rows past a
  // shorter stream are black, as libtiff leaves them (its JPEG codec
  // decodes the frame's rows into the zeroed buffer of cv2's read)
  const int* rows;
};

// Where an image pixel lies: its chunk, its row and column there, and the
// rows of that chunk's stream.
struct Spot {
  int chunk, r, c, rows;
};

// The spot of pixel (r, col) of a JPEG file of H rows: its one chunk.
JPEG_HD Spot whole(int H, int r, int col) { return {0, r, col, H}; }

JPEG_HD Spot spot(const Chunks& k, int r, int col) {
  int from = k.mirror ? k.image_w - 1 - col : col;  // the column in the file
  int ty = r / k.h, tx = k.tiled ? from / k.w : 0;
  Spot s;
  s.chunk = ty * k.across + tx;
  s.r = r - ty * k.h;
  s.c = from - tx * k.w;
  if (k.mirror) {  // the tile's columns in order at its mirrored place
    int x0 = tx * k.w, n = k.image_w - x0 < k.w ? k.image_w - x0 : k.w;
    s.c = n - 1 - s.c;
  }
  s.rows = k.rows[s.chunk];
  return s;
}

// The component's upsampled sample at a pixel's spot in its chunk.
JPEG_HD int upsampled(const Plane& q, const Spot& s) {
  const uint8_t* p = q.p + (size_t)s.chunk * q.stride * q.pitch;
  int pitch = q.pitch, r = s.r, col = s.c;
  if (q.rh == 1 && q.rv == 1) return p[r * pitch + col];
  if (!q.fancy) return p[(r / q.rv) * pitch + col / q.rh];
  int h = (s.rows + q.rv - 1) >> (q.rv - 1);  // fancy: rv is 1 or 2
  if (q.rh == 2 && q.rv == 2) {
    int i = r >> 1, j = col >> 1;
    int i2 = (r & 1) ? (i + 1 < h ? i + 1 : h - 1) : (i > 0 ? i - 1 : 0);
    int jn = (col & 1) ? (j + 1 < q.w ? j + 1 : q.w - 1) : (j > 0 ? j - 1 : 0);
    int cs = 3 * p[i * pitch + j] + p[i2 * pitch + j];
    int cn = 3 * p[i * pitch + jn] + p[i2 * pitch + jn];
    return (3 * cs + cn + ((col & 1) ? 7 : 8)) >> 4;
  }
  if (q.rh == 2) {  // h2v1
    int j = col >> 1;
    int jn = (col & 1) ? (j + 1 < q.w ? j + 1 : q.w - 1) : (j > 0 ? j - 1 : 0);
    return (3 * p[r * pitch + j] + p[r * pitch + jn] + ((col & 1) ? 2 : 1)) >>
           2;
  }
  int i = r >> 1;  // h1v2
  int i2 = (r & 1) ? (i + 1 < h ? i + 1 : h - 1) : (i > 0 ? i - 1 : 0);
  return (3 * p[i * pitch + col] + p[i2 * pitch + col] + ((r & 1) ? 2 : 1)) >>
         2;
}

JPEG_HD int clamp_u8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// jdcolor.c build_ycc_rgb_table / ycc_rgb_convert: R, G, B of Y, Cb, Cr.
JPEG_HD void ycc_rgb(int y, int cb, int cr, int* r, int* g, int* b) {
  int xb = cb - 128, xr = cr - 128;
  *r = clamp_u8(y + ((91881 * xr + 32768) >> 16));
  *g = clamp_u8(y + ((-22554 * xb + 32768 - 46802 * xr) >> 16));
  *b = clamp_u8(y + ((116130 * xb + 32768) >> 16));
}

// jdcolor.c ycck_cmyk_convert: C, M, Y of a YCCK pixel's Y, Cb, Cr
// (range_limit[MAXJSAMPLE - (y + ...)] is 255 less the clamped sum).
JPEG_HD void ycck_cmy(int y, int cb, int cr, int* c, int* m, int* yy) {
  int r, g, b;
  ycc_rgb(y, cb, cr, &r, &g, &b);
  *c = 255 - r;
  *m = 255 - g;
  *yy = 255 - b;
}

// icvCvt_CMYK2BGR_8u_C4C3R: one of C, M, Y under black k.
JPEG_HD int cmyk_channel(int x, int k) { return k - ((255 - x) * k >> 8); }

// The form of ycc_pixel: bit 0 RGB components (else YCbCr, or one
// component), bit 1 OpenCV's grey of the BGR (else libjpeg's).
enum YccForm { kFormRgb = 1, kFormOpenCvGrey = 2 };

// The pixel at spot s (spot(), or whole() for a JPEG file) of a one- or
// three-component JPEG: bgr[0..2] and, where grey is not NULL, its grey
// (YccForm bits).
JPEG_HD void ycc_pixel(const Planes& pl, int n, int form, const Spot& s,
                       uint8_t* bgr, uint8_t* grey) {
  if (s.r >= s.rows) {  // past a chunk's shorter stream
    bgr[0] = bgr[1] = bgr[2] = 0;
    if (grey) *grey = 0;
    return;
  }
  int y = upsampled(pl.c[0], s);
  if (n == 1) {
    bgr[0] = bgr[1] = bgr[2] = (uint8_t)y;
    if (grey) *grey = (uint8_t)y;  // OpenCV's grey of (y, y, y) is y
    return;
  }
  int u = upsampled(pl.c[1], s), v = upsampled(pl.c[2], s);
  int red, green, blue;
  if (form & kFormRgb) {  // y, u, v are R, G, B
    red = y;
    green = u;
    blue = v;
  } else {
    ycc_rgb(y, u, v, &red, &green, &blue);
  }
  bgr[0] = (uint8_t)blue;
  bgr[1] = (uint8_t)green;
  bgr[2] = (uint8_t)red;
  if (!grey) return;
  if (form & kFormOpenCvGrey)
    *grey = (uint8_t)raster_bgr::opencv_grey(blue, green, red);
  else
    *grey = (uint8_t)(form & kFormRgb ? jpeg_fdct::y_of(y, u, v) : y);
}

// OpenCV's BGR and grey of libjpeg's C, M, Y, K samples.
JPEG_HD void cmyk_bgr(int c, int m, int y, int k, uint8_t* bgr,
                      uint8_t* grey) {
  int red = cmyk_channel(c, k), green = cmyk_channel(m, k),
      blue = cmyk_channel(y, k);
  bgr[0] = (uint8_t)blue;
  bgr[1] = (uint8_t)green;
  bgr[2] = (uint8_t)red;
  *grey = (uint8_t)raster_bgr::opencv_grey(blue, green, red);
}

// One pixel of a four-component JPEG (ycck: the components are Y, Cb, Cr,
// K): bgr[0..2] and grey.
JPEG_HD void cmyk_pixel(const Planes& pl, int ycck, int H, int r, int col,
                        uint8_t* bgr, uint8_t* grey) {
  Spot s = whole(H, r, col);
  int c = upsampled(pl.c[0], s), m = upsampled(pl.c[1], s);
  int y = upsampled(pl.c[2], s), k = upsampled(pl.c[3], s);
  if (ycck) ycck_cmy(c, m, y, &c, &m, &y);
  cmyk_bgr(c, m, y, k, bgr, grey);
}

}  // namespace jpeg_colour
