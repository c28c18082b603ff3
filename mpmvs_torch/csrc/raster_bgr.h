// The arithmetic of raster_to_bgr_kernel (jpeg_codec.cu): cv2.imread's BGR
// and grey pixels of a PNG's, a TIFF's, a BMP's or a PNM's samples, one
// pixel at a time.
// Shared by the kernel and by the host, where the tests build it with g++;
// the plain PyTorch version is mpmvs_torch/io/images.py::raster_to_bgr_plain.
//
// The samples (unfiltered, decompressed on the host: png_unfilter.h,
// tiff_decode.h) are 1 to 4 channels of 1, 2, 4, 8 or 16 bits, chunky (a
// row holds every channel of a pixel together) or planar (a plane a
// channel), packed most significant bit first below 8 bits, 16-bit samples
// big-endian (PNG) or in the TIFF's byte order. What OpenCV makes of them:
//   * grey: 16-bit samples narrowed v >> 8 (libpng's png_set_strip_16;
//     libtiff's grey map takes the high byte too), 1-, 2- and 4-bit samples
//     scaled by 255 / (2^bits - 1) (libpng's expand_gray_1_2_4_to_8,
//     libtiff's Map), min-is-white inverted after; B = G = R = grey;
//   * palette: the index (1 to 8 bits, unscaled) looks up the RGB table;
//   * CMYK (a TIFF's 8-bit separated samples): libtiff's RGBA reader
//     (putRGBcontig8bitCMYKtile, putCMYKseparate8bittile), R = (255 - K)
//     (255 - C) / 255 in integers, and likewise G of M and B of Y;
//   * RGB: 16-bit samples narrowed v >> 8 (libpng, PNM) or (v + 128) / 257
//     (libtiff's Bitdepth16To8); with unassociated alpha (a TIFF's
//     ExtraSamples 2) the colours are premultiplied, (v * a + 127) / 255,
//     as libtiff's RGBA reader does; other alpha is dropped; a BMP's
//     samples are in B, G, R (A) order (`bgr`);
//   * a BMP's 16-bit pixels (little-endian words), 5-5-5 or (`green6`)
//     5-6-5, each field shifted to the top of its byte as OpenCV's
//     icvCvt_BGR5552BGR / BGR5652BGR do (no bit replication);
//   * YCbCr (a TIFF's 8-bit Photometric 6, uncompressed or losslessly
//     compressed): libtiff's data units of sub_h x sub_v Y samples, then
//     Cb, then Cr (a plain pixel at 1 x 1, planar or not), each unit's
//     chroma replicated over it, converted by TIFFYCbCrtoRGB with the
//     int32 tables TIFFYCbCrToRGBInit builds from YCbCrCoefficients and
//     ReferenceBlackWhite (built on the host, io/images.py
//     ycbcr_tables);
//   * CIELab (a TIFF's Photometric 8, 8- or 16-bit L*, a*, b*, a* and b*
//     signed): libtiff 4.7.1's RGBA reader (putcontig8bitCIELab8/16):
//     TIFFCIELab16ToXYZ (8-bit samples scaled to it: L x 257, a* and b* x
//     256) against the reference white of the WhitePoint tag (D50 without
//     it), then TIFFXYZToRGB under display_sRGB: its matrix, the clips to
//     [1, 100], the index into the Yr2r table (built on the host,
//     io/images.py cielab_tables; Yg2g and Yb2b are the same table under
//     display_sRGB) and RINT; every step in libtiff's float arithmetic,
//     each product, sum and quotient rounded on its own (no contraction
//     into fused multiply-adds on the card);
//   * the grey image of colour: libpng's png_do_rgb_to_gray with OpenCV's
//     coefficients (0.299, 0.587 -> 9797, 19234, 3737 of 32768): R where
//     R = G = B, else (rc R + gc G + bc B) >> 15 on 8-bit samples, with
//     +16384 and >> 8 after on 16-bit samples; with a gAMA or sRGB chunk
//     through libpng's gamma tables, rounding: to_1 and from_1 of 256
//     entries on 8-bit samples; on 16-bit samples to_1, from_1 and the
//     table of grey pixels (png_build_16to8_table), 2048 entries each,
//     indexed by a sample's top 11 bits (libpng's gamma_shift 5 under
//     png_set_strip_16);
//     for a TIFF, OpenCV's own BGRA -> grey (14-bit fixed point: 4899, 9617,
//     1868, rounding) of the 8-bit colours.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifndef RASTER_HD
#ifdef __CUDACC__
#define RASTER_HD __host__ __device__ __forceinline__
#else
#define RASTER_HD static inline
#endif
#endif

namespace raster_bgr {

// OpenCV's BGR -> grey (14-bit fixed point, rounding), which it applies to
// libtiff's RGBA image, to libjpeg's CMYK and to a TIFF's JPEG strips.
RASTER_HD int opencv_grey(int b, int g, int r) {
  return (b * 1868 + g * 9617 + r * 4899 + 8192) >> 14;
}

enum Kind { kGrey = 0, kRgb = 1, kPalette = 2, kCmyk = 3, kYcbcr = 4,
            kBmp16 = 5, kCielab = 6 };
enum GreyRule { kLibpng = 0, kLibpngGamma = 1, kOpenCv = 2 };
enum Narrow { kShift = 0, kRound257 = 1 };

// Passed to the kernel by value: what the samples are and which of
// OpenCV's conversions applies.
struct Form {
  int kind;          // Kind
  int bits;          // 1, 2, 4, 8 or 16
  int channels;      // samples a pixel, alpha included (1 to 4)
  int planar;        // 1: a plane a channel
  int little;        // 16-bit samples little-endian
  int min_is_white;  // grey inverted
  int narrow;        // Narrow of 16-bit colour samples
  int premultiply;   // channel 3 is unassociated alpha
  int grey_rule;     // GreyRule of a colour image
  int width, height;
  int bgr;           // RGB samples in B, G, R order (a BMP's)
  int green6;        // kBmp16: 5-6-5 (else 5-5-5)
  int sub_h, sub_v;  // kYcbcr: YCbCrSubSampling
  long long rowbytes;    // bytes a row (of a plane; of data units)
  long long plane_bytes; // bytes a plane
};

constexpr int kFormInts = 15;

// A Form from its fields in order: kFormInts ints, then rowbytes and
// plane_bytes (the layout mpmvs_torch/io/images.py passes).
RASTER_HD Form form_of(const int* v, const long long* sizes) {
  Form f;
  f.kind = v[0];
  f.bits = v[1];
  f.channels = v[2];
  f.planar = v[3];
  f.little = v[4];
  f.min_is_white = v[5];
  f.narrow = v[6];
  f.premultiply = v[7];
  f.grey_rule = v[8];
  f.width = v[9];
  f.height = v[10];
  f.bgr = v[11];
  f.green6 = v[12];
  f.sub_h = v[13];
  f.sub_v = v[14];
  f.rowbytes = sizes[0];
  f.plane_bytes = sizes[1];
  return f;
}

// The tables beside the samples: the palette (256 x RGB), libpng's 8-bit
// gamma tables to_1 and from_1 (256 each), then its 16-bit ones to_1,
// from_1 and grey (2048 big-endian 16-bit entries each).
// A YCbCr image's tables take their place: libtiff's Y_tab, Cr_r_tab,
// Cb_b_tab, Cr_g_tab and Cb_g_tab, 256 little-endian int32 entries each.
constexpr int kPaletteAt = 0, kToOneAt = 768, kFromOneAt = 1024,
              kToOne16At = 1280, kFromOne16At = 1280 + 4096,
              kGrey16At = 1280 + 8192, kTablesLen = 1280 + 12288;
constexpr int kYTabAt = 0, kCrRAt = 1024, kCbBAt = 2048, kCrGAt = 3072,
              kCbGAt = 4096;
// A CIELab image's: libtiff's Yr2r (kLabRange + 1 little-endian float32
// entries), then X0, Y0, Z0 of the reference white and the table's step.
constexpr int kLabRange = 1500, kLabTableAt = 0,
              kLabWhiteAt = 4 * (kLabRange + 1);

RASTER_HD int table32(const uint8_t* tables, int at, int i) {
  const uint8_t* e = tables + at + 4 * i;
  return (int)((uint32_t)e[0] | (uint32_t)e[1] << 8 | (uint32_t)e[2] << 16 |
               (uint32_t)e[3] << 24);
}

RASTER_HD int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

RASTER_HD int table16(const uint8_t* tables, int at, int v) {
  const uint8_t* e = tables + at + 2 * (v >> 5);
  return e[0] << 8 | e[1];
}

RASTER_HD int sample(const uint8_t* raster, const Form& f, int y, int x,
                     int c) {
  const uint8_t* row;
  long long i;
  if (f.planar) {
    row = raster + c * f.plane_bytes + (long long)y * f.rowbytes;
    i = x;
  } else {
    row = raster + (long long)y * f.rowbytes;
    i = (long long)x * f.channels + c;
  }
  if (f.bits == 16) {
    int a = row[2 * i], b = row[2 * i + 1];
    return f.little ? (b << 8 | a) : (a << 8 | b);
  }
  if (f.bits == 8) return row[i];
  long long bit = i * f.bits;
  return (row[bit >> 3] >> (8 - f.bits - (int)(bit & 7))) &
         ((1 << f.bits) - 1);
}

RASTER_HD float table_float(const uint8_t* tables, int at, int i) {
  uint32_t u = (uint32_t)table32(tables, at, i);
  float v;
  memcpy(&v, &u, 4);
  return v;
}

// libtiff's float arithmetic, one rounding an operation.
#ifdef __CUDA_ARCH__
RASTER_HD float fmul(float a, float b) { return __fmul_rn(a, b); }
RASTER_HD float fadd(float a, float b) { return __fadd_rn(a, b); }
RASTER_HD float fsub(float a, float b) { return __fsub_rn(a, b); }
RASTER_HD float fdiv(float a, float b) { return __fdiv_rn(a, b); }
#else
RASTER_HD float fmul(float a, float b) { return a * b; }
RASTER_HD float fadd(float a, float b) { return a + b; }
RASTER_HD float fsub(float a, float b) { return a - b; }
RASTER_HD float fdiv(float a, float b) { return a / b; }
#endif

// TIFFXYZToRGB's one channel of luminosity lum: clipped to [1, 100],
// looked up and rounded (RINT, in double), clipped to 255.
RASTER_HD int cielab_channel(float lum, const uint8_t* tables, float step) {
  lum = lum > 1.0f ? lum : 1.0f;
  lum = lum < 100.0f ? lum : 100.0f;
  int i = (int)fdiv(fsub(lum, 1.0f), step);
  i = i < kLabRange ? i : kLabRange;
  int v = (int)((double)table_float(tables, kLabTableAt, i) + 0.5);
  return v < 255 ? v : 255;
}

// TIFFCIELab16ToXYZ and TIFFXYZToRGB of one pixel's L*, a*, b*.
RASTER_HD void cielab_rgb(const uint8_t* raster, const Form& f,
                          const uint8_t* tables, int y, int x, int* r,
                          int* g, int* b) {
  int l = sample(raster, f, y, x, 0), a = sample(raster, f, y, x, 1);
  int bs = sample(raster, f, y, x, 2);
  if (f.bits == 8) {  // TIFFCIELabToXYZ
    l *= 257;
    a = (int8_t)a * 256;
    bs = (int8_t)bs * 256;
  } else {
    a = (int16_t)a;
    bs = (int16_t)bs;
  }
  const float X0 = table_float(tables, kLabWhiteAt, 0);
  const float Y0 = table_float(tables, kLabWhiteAt, 1);
  const float Z0 = table_float(tables, kLabWhiteAt, 2);
  const float step = table_float(tables, kLabWhiteAt, 3);
  float L = fdiv(fmul((float)l, 100.0f), 65535.0f), Y, cby;
  if (L < 8.856f) {
    Y = fdiv(fmul(L, Y0), 903.292f);
    cby = fadd(fmul(7.787f, fdiv(Y, Y0)), fdiv(16.0f, 116.0f));
  } else {
    cby = fdiv(fadd(L, 16.0f), 116.0f);
    Y = fmul(fmul(fmul(Y0, cby), cby), cby);
  }
  float t = fadd(fdiv(fdiv((float)a, 256.0f), 500.0f), cby);
  float X = t < 0.2069f ? fdiv(fmul(X0, fsub(t, 0.13793f)), 7.787f)
                        : fmul(fmul(fmul(X0, t), t), t);
  t = fsub(cby, fdiv(fdiv((float)bs, 256.0f), 200.0f));
  float Z = t < 0.2069f ? fdiv(fmul(Z0, fsub(t, 0.13793f)), 7.787f)
                        : fmul(fmul(fmul(Z0, t), t), t);
  // display_sRGB's XYZ -> luminosity matrix
  *r = cielab_channel(fadd(fadd(fmul(3.2410f, X), fmul(-1.5374f, Y)),
                           fmul(-0.4986f, Z)), tables, step);
  *g = cielab_channel(fadd(fadd(fmul(-0.9692f, X), fmul(1.8760f, Y)),
                           fmul(0.0416f, Z)), tables, step);
  *b = cielab_channel(fadd(fadd(fmul(0.0556f, X), fmul(-0.2040f, Y)),
                           fmul(1.0570f, Z)), tables, step);
}

RASTER_HD int narrow16(int v, int rule) {
  return rule == kRound257 ? (v + 128) / 257 : v >> 8;
}

// libpng's coefficients for OpenCV's png_set_rgb_to_gray(png, 1, 0.299,
// 0.587): red and green (100000 units) * 32768 / 100000, blue the rest.
constexpr int kRc = 9797, kGc = 19234, kBc = 32768 - kRc - kGc;

// One pixel: bgr[0..2] and grey.
RASTER_HD void pixel(const uint8_t* raster, const Form& f,
                     const uint8_t* tables, int y, int x, uint8_t* bgr,
                     uint8_t* grey) {
  if (f.kind == kGrey) {
    int v = sample(raster, f, y, x, 0);
    int g = f.bits == 16 ? v >> 8
            : f.bits < 8 ? v * 255 / ((1 << f.bits) - 1)
                         : v;
    if (f.min_is_white) g = 255 - g;
    bgr[0] = bgr[1] = bgr[2] = *grey = (uint8_t)g;
    return;
  }
  int r, g, b, g16 = -1;
  if (f.kind == kPalette) {
    const uint8_t* p = tables + kPaletteAt + 3 * sample(raster, f, y, x, 0);
    r = p[0];
    g = p[1];
    b = p[2];
  } else if (f.kind == kYcbcr) {
    int y0, cb, cr;
    if (f.sub_h * f.sub_v == 1) {
      y0 = sample(raster, f, y, x, 0);
      cb = sample(raster, f, y, x, 1);
      cr = sample(raster, f, y, x, 2);
    } else {
      int unit = f.sub_h * f.sub_v + 2;
      const uint8_t* u = raster + (long long)(y / f.sub_v) * f.rowbytes +
                         (long long)(x / f.sub_h) * unit;
      y0 = u[(y % f.sub_v) * f.sub_h + x % f.sub_h];
      cb = u[unit - 2];
      cr = u[unit - 1];
    }
    // TIFFYCbCrtoRGB
    int yv = table32(tables, kYTabAt, y0);
    r = clamp255(yv + table32(tables, kCrRAt, cr));
    g = clamp255(yv + ((table32(tables, kCbGAt, cb) +
                        table32(tables, kCrGAt, cr)) >> 16));
    b = clamp255(yv + table32(tables, kCbBAt, cb));
  } else if (f.kind == kCielab) {
    cielab_rgb(raster, f, tables, y, x, &r, &g, &b);
  } else if (f.kind == kBmp16) {
    int v = sample(raster, f, y, x, 0);
    b = (v << 3) & 0xF8;
    g = f.green6 ? (v >> 3) & 0xFC : (v >> 2) & 0xF8;
    r = f.green6 ? (v >> 8) & 0xF8 : (v >> 7) & 0xF8;
  } else if (f.kind == kCmyk) {
    int k = 255 - sample(raster, f, y, x, 3);
    r = k * (255 - sample(raster, f, y, x, 0)) / 255;
    g = k * (255 - sample(raster, f, y, x, 1)) / 255;
    b = k * (255 - sample(raster, f, y, x, 2)) / 255;
  } else {
    r = sample(raster, f, y, x, f.bgr ? 2 : 0);
    g = sample(raster, f, y, x, 1);
    b = sample(raster, f, y, x, f.bgr ? 0 : 2);
    int a = f.premultiply ? sample(raster, f, y, x, 3) : 0;
    if (f.bits == 16) {  // libpng converts before it narrows
      bool same = r == g && r == b;
      if (f.grey_rule == kLibpng) {
        g16 = same ? r : (kRc * r + kGc * g + kBc * b + 16384) >> 15;
      } else if (f.grey_rule == kLibpngGamma) {
        int mix = (kRc * table16(tables, kToOne16At, r) +
                   kGc * table16(tables, kToOne16At, g) +
                   kBc * table16(tables, kToOne16At, b) + 16384) >> 15;
        g16 = same ? table16(tables, kGrey16At, r)
                   : table16(tables, kFromOne16At, mix);
      }
      r = narrow16(r, f.narrow);
      g = narrow16(g, f.narrow);
      b = narrow16(b, f.narrow);
      a = narrow16(a, f.narrow);
    }
    if (f.premultiply) {
      r = (r * a + 127) / 255;
      g = (g * a + 127) / 255;
      b = (b * a + 127) / 255;
    }
  }
  bgr[0] = (uint8_t)b;
  bgr[1] = (uint8_t)g;
  bgr[2] = (uint8_t)r;
  int v;
  if (f.grey_rule == kOpenCv) {
    v = opencv_grey(b, g, r);
  } else if (g16 >= 0) {
    v = g16 >> 8;
  } else if (r == g && r == b) {
    v = r;
  } else if (f.grey_rule == kLibpngGamma) {
    const uint8_t* to1 = tables + kToOneAt;
    v = tables[kFromOneAt +
               ((kRc * to1[r] + kGc * to1[g] + kBc * to1[b] + 16384) >> 15)];
  } else {
    v = (kRc * r + kGc * g + kBc * b) >> 15;
  }
  *grey = (uint8_t)v;
}

}  // namespace raster_bgr
