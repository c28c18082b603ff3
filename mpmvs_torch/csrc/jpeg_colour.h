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
// Colour:
//   * YCbCr: jdcolor.c's fixed-point YCbCr -> RGB (16 fractional bits,
//     FIX(1.402), FIX(1.772), FIX(0.71414), FIX(0.34414), rounding as its
//     tables do), clamped; the grey image is the (upsampled) Y component;
//   * RGB components: the samples in B, G, R order, the grey
//     rgb_gray_convert's (19595 R + 38470 G + 7471 B + 32768) >> 16;
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

#include "jpeg_fdct.h"  // y_of: rgb_gray_convert's coefficients

namespace jpeg_colour {

// One component's samples and how they are upsampled to the image.
struct Plane {
  const uint8_t* p;
  int h, w;    // its samples: ceil(H / rv) x ceil(W / rh)
  int rh, rv;  // hmax / h_samp_factor, vmax / v_samp_factor
  int fancy;   // 1: fancy upsampling (rh, rv in {1, 2}), 0: replication
};

// Up to four components (the count is the kernel's form).
struct Planes {
  Plane c[4];
};

// The component's upsampled sample at image pixel (r, col).
JPEG_HD int upsampled(const Plane& q, int r, int col) {
  if (q.rh == 1 && q.rv == 1) return q.p[r * q.w + col];
  if (!q.fancy) return q.p[(r / q.rv) * q.w + col / q.rh];
  const uint8_t* p = q.p;
  int pitch = q.w;
  if (q.rh == 2 && q.rv == 2) {
    int i = r >> 1, j = col >> 1;
    int i2 = (r & 1) ? (i + 1 < q.h ? i + 1 : q.h - 1) : (i > 0 ? i - 1 : 0);
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
  int i2 = (r & 1) ? (i + 1 < q.h ? i + 1 : q.h - 1) : (i > 0 ? i - 1 : 0);
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

// One pixel of a one- or three-component JPEG: bgr[0..2] and, where grey
// is not NULL, its grey (form 0: YCbCr or one component, 1: RGB).
JPEG_HD void ycc_pixel(const Planes& pl, int n, int form, int r, int col,
                       uint8_t* bgr, uint8_t* grey) {
  int y = upsampled(pl.c[0], r, col);
  if (n == 1) {
    bgr[0] = bgr[1] = bgr[2] = (uint8_t)y;
    if (grey) *grey = (uint8_t)y;
    return;
  }
  int u = upsampled(pl.c[1], r, col), v = upsampled(pl.c[2], r, col);
  if (form == 1) {  // y, u, v are R, G, B
    bgr[0] = (uint8_t)v;
    bgr[1] = (uint8_t)u;
    bgr[2] = (uint8_t)y;
    if (grey) *grey = (uint8_t)jpeg_fdct::y_of(y, u, v);
    return;
  }
  int red, green, blue;
  ycc_rgb(y, u, v, &red, &green, &blue);
  bgr[0] = (uint8_t)blue;
  bgr[1] = (uint8_t)green;
  bgr[2] = (uint8_t)red;
  if (grey) *grey = (uint8_t)y;
}

// OpenCV's BGR and grey of libjpeg's C, M, Y, K samples.
JPEG_HD void cmyk_bgr(int c, int m, int y, int k, uint8_t* bgr,
                      uint8_t* grey) {
  int red = cmyk_channel(c, k), green = cmyk_channel(m, k),
      blue = cmyk_channel(y, k);
  bgr[0] = (uint8_t)blue;
  bgr[1] = (uint8_t)green;
  bgr[2] = (uint8_t)red;
  *grey = (uint8_t)((blue * 1868 + green * 9617 + red * 4899 + 8192) >> 14);
}

// One pixel of a four-component JPEG (ycck: the components are Y, Cb, Cr,
// K): bgr[0..2] and grey.
JPEG_HD void cmyk_pixel(const Planes& pl, int ycck, int r, int col,
                        uint8_t* bgr, uint8_t* grey) {
  int c = upsampled(pl.c[0], r, col), m = upsampled(pl.c[1], r, col);
  int y = upsampled(pl.c[2], r, col), k = upsampled(pl.c[3], r, col);
  if (ycck) ycck_cmy(c, m, y, &c, &m, &y);
  cmyk_bgr(c, m, y, k, bgr, grey);
}

}  // namespace jpeg_colour
