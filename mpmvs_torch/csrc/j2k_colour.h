// The arithmetic of j2k_colour_kernel (jpeg_codec.cu): one pixel of a
// JPEG 2000 image, from its tile's transformed components to cv2.imread's
// BGR and grey, as OpenJPEG 2.5 (tcd.c, mct.c) and OpenCV 5's
// grfmt_jpeg2000_openjpeg.cpp make them. Shared by the kernel and by the
// host, where the tests build it with g++; the plain PyTorch version is
// mpmvs_torch/io/images.py's j2k_colour_plain.
//
//   * the pixel's tile, and in it each component's sample (int32 after the
//     5/3 wavelet, float after the 9/7 one); 0 in every image where the
//     codestream stopped before the tile;
//   * the tile's colour transform on the first three components: the
//     reversible one (RCT, integer: g = y - ((u + v) >> 2), r = v + g,
//     b = u + g) after the 5/3 wavelet, the irreversible one (ICT, float:
//     r = y + v 1.402, g = y - u 0.34413 - v 0.71414, b = y + u 1.772, each
//     operation rounded on its own) after the 9/7 one, or none;
//   * OpenJPEG's DC level shift and clamp: a 9/7 sample rounded by lrintf
//     (half to even; __float2ll_rn on the card) first, 2^(precision - 1)
//     added, clamped to [0, 2^precision - 1];
//   * OpenCV's narrowing to 8 bits: v >> (precision - 8) (cv2 refuses
//     fewer than 8 bits, and so does j2k_decode.h);
//   * the B, G, R of components 2, 1, 0 (three or more components, sRGB or
//     a raw codestream), or component 0 three times (a greyscale JP2); the
//     grey image component 0 (one or two components, or a greyscale JP2),
//     or OpenCV's cvtColor of the BGR (15-bit fixed point: (r 9798 +
//     g 19235 + b 3735 + 16384) >> 15).

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define J2K_CHD __host__ __device__ __forceinline__
#else
#define J2K_CHD static inline
#endif

namespace j2k_colour {

#ifdef __CUDA_ARCH__
J2K_CHD float fmul(float a, float b) { return __fmul_rn(a, b); }
J2K_CHD float fadd(float a, float b) { return __fadd_rn(a, b); }
J2K_CHD float fsub(float a, float b) { return __fsub_rn(a, b); }
J2K_CHD long long round_even(float v) { return __float2ll_rn(v); }
#else
J2K_CHD float fmul(float a, float b) { return a * b; }
J2K_CHD float fadd(float a, float b) { return a + b; }
J2K_CHD float fsub(float a, float b) { return a - b; }
J2K_CHD long long round_even(float v) { return (long long)lrintf(v); }
#endif

// x0, y0, width, colour transform, (offset, wavelet) x 3, present (0:
// the codestream stopped before the tile, whose pixels are 0)
enum { kTileInts = 11 };

struct Params {
  int W, H;        // the image
  int tw, XT, YT;  // tiles across, tile size
  int prec, shift;
  int colour;      // 1: B, G, R of components 2, 1, 0; 0: component 0
  int grey_rgb;    // 1: grey by cvtColor of the BGR; 0: component 0
  int ncomp;       // components read: 1 or 3
};

J2K_CHD int clamp_int(long long v, int hi) {
  return (int)(v < 0 ? 0 : v > hi ? hi : v);
}

// one component of the pixel after the level shift and clamp
J2K_CHD int level(float f, int i, int rev, int prec) {
  const int hi = (1 << prec) - 1, dc = 1 << (prec - 1);
  if (rev) return clamp_int((long long)i + dc, hi);
  if (f > 2147483647.0f) return hi;
  if (f < -2147483648.0f) return 0;
  return clamp_int(round_even(f) + dc, hi);
}

J2K_CHD void pixel(const uint32_t* coef, const int* tiles, const Params& p,
                   int x, int y, uint8_t* bgr, uint8_t* grey) {
  const int* t = tiles + kTileInts * ((y / p.YT) * p.tw + x / p.XT);
  if (!t[10]) {
    bgr[0] = bgr[1] = bgr[2] = 0;
    *grey = 0;
    return;
  }
  const long at = (long)(y - t[1]) * t[2] + (x - t[0]);
  int32_t iv[3] = {0, 0, 0};
  float fv[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < p.ncomp; c++) {
    const uint32_t w = coef[t[4 + 2 * c] + at];
    iv[c] = (int32_t)w;
    memcpy(&fv[c], &w, 4);
  }
  const int rev = t[5];
  if (t[3] && p.ncomp == 3) {
    if (rev) {
      const int32_t g = iv[0] - ((iv[1] + iv[2]) >> 2);
      const int32_t r = iv[2] + g, b = iv[1] + g;
      iv[0] = r;
      iv[1] = g;
      iv[2] = b;
    } else {
      const float y0 = fv[0], u = fv[1], v = fv[2];
      fv[0] = fadd(y0, fmul(v, 1.402f));
      fv[1] = fsub(fsub(y0, fmul(u, 0.34413f)), fmul(v, 0.71414f));
      fv[2] = fadd(y0, fmul(u, 1.772f));
    }
  }
  int s[3];
  for (int c = 0; c < p.ncomp; c++)
    s[c] = level(fv[c], iv[c], t[5 + 2 * c], p.prec) >> p.shift;
  int b, g, r;
  if (p.colour) {
    b = s[2];
    g = s[1];
    r = s[0];
  } else {
    b = g = r = s[0];
  }
  bgr[0] = (uint8_t)b;
  bgr[1] = (uint8_t)g;
  bgr[2] = (uint8_t)r;
  *grey = p.grey_rgb
              ? (uint8_t)((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15)
              : (uint8_t)s[0];
}

}  // namespace j2k_colour
