// The arithmetic of the card's JPEG encoder kernels (jpeg_codec.cu:
// bgr_to_ycc_kernel, fdct_islow_quant_kernel), as libjpeg-turbo does it for
// cv2.imencode: its BGR -> YCbCr (jccolor.c), edge expansion (jcprepct.c,
// jcsample.c), 2x2 chroma downsampling (jcsample.c h2v2_downsample),
// accurate integer forward DCT (jfdctint.c, jpeg_fdct_islow) and
// quantization (jcdctmgr.c: compute_reciprocal, quantize). Shared by the
// kernels and by the host, where the tests build it with g++; the plain
// PyTorch versions are mpmvs_torch/io/images.py::bgr_to_ycc_plain and
// fdct_islow_plain.

#pragma once

#include <stdint.h>

#ifndef JPEG_HD
#ifdef __CUDACC__
#define JPEG_HD __host__ __device__ __forceinline__
#else
#define JPEG_HD static inline
#endif
#endif

namespace jpeg_fdct {

// jccolor.c rgb_ycc_start: SCALEBITS 16, FIX(x) = x * 65536 rounded; Cb and
// Cr carry CBCR_OFFSET (128 << 16) and ONE_HALF - 1.
JPEG_HD int y_of(int r, int g, int b) {
  return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
}
JPEG_HD int cb_of(int r, int g, int b) {
  return (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16;
}
JPEG_HD int cr_of(int r, int g, int b) {
  return (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16;
}

JPEG_HD int clampi(int v, int hi) { return v < hi ? v : hi; }

// One 2x2 group (i, j) of the encoder's planes from an (H, W) image, BGR
// interleaved (channels 3) or grey (channels 1):
//   * Y at rows 2i, 2i+1 and columns 2j, 2j+1 of its plane (y_h x y_w, the
//     blocks that hold samples: 8 * ceil(H / 8) x 8 * ceil(W / 8)), the
//     image's last row and column replicated beyond it;
//   * with chroma, Cb and Cr at (i, j) of theirs (c_h x c_w: 8 *
//     ceil(H / 16) x 8 * ceil(W / 16)): the rounded mean of the 2x2 full-size
//     samples with bias 1, 2, 1, 2, ... along the row. The colour buffer is
//     padded to an even height by its last row and to the chroma width by
//     its last column; rows past the downsampled height ceil(H / 2) repeat
//     its last row (jcprepct.c pads the downsampled planes to the iMCU).
JPEG_HD void ycc_group(const uint8_t* img, int H, int W, int channels, int i,
                       int j, uint8_t* y, int y_h, int y_w, uint8_t* cb,
                       uint8_t* cr, int c_w) {
  for (int a = 0; a < 2; a++) {
    int rr = 2 * i + a;
    if (rr >= y_h) break;
    const uint8_t* row = img + (size_t)clampi(rr, H - 1) * W * channels;
    for (int b = 0; b < 2; b++) {
      int cc = 2 * j + b;
      if (cc >= y_w) break;
      const uint8_t* p = row + (size_t)clampi(cc, W - 1) * channels;
      y[(size_t)rr * y_w + cc] =
          (uint8_t)(channels == 1 ? p[0] : y_of(p[2], p[1], p[0]));
    }
  }
  if (cb == 0) return;
  int i2 = clampi(i, (H + 1) / 2 - 1);
  int sb = 0, sr = 0;
  for (int a = 0; a < 2; a++) {
    const uint8_t* row = img + (size_t)clampi(2 * i2 + a, H - 1) * W * 3;
    for (int b = 0; b < 2; b++) {
      const uint8_t* p = row + (size_t)clampi(2 * j + b, W - 1) * 3;
      sb += cb_of(p[2], p[1], p[0]);
      sr += cr_of(p[2], p[1], p[0]);
    }
  }
  int bias = 1 + (j & 1);
  cb[(size_t)i * c_w + j] = (uint8_t)((sb + bias) >> 2);
  cr[(size_t)i * c_w + j] = (uint8_t)((sr + bias) >> 2);
}

// jcdctmgr.c compute_reciprocal for a divisor d = 8 * q (q in 1..255, so
// the reciprocal form always applies): |x| / d rounded half up is
// ((|x| + corr) * recip) >> shift.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

JPEG_HD Divisor divisor_of(uint32_t d) {
  int b = 0;
  while ((d >> (b + 1)) != 0) b++;  // flss(d) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / d, fr = (1u << r) % d, c = d / 2;
  if (fr == 0) {  // a power of two: fq would be one bit too wide
    fq >>= 1;
    r--;
  } else if (fr <= d / 2) {
    c++;
  } else {
    fq++;
  }
  Divisor v = {fq, c, r};
  return v;
}

JPEG_HD int16_t quantize(int x, Divisor v) {
  uint32_t m = (uint32_t)(x < 0 ? -x : x);
  int q = (int)(((m + v.corr) * v.recip) >> v.shift);
  return (int16_t)(x < 0 ? -q : q);
}

// FIX(x) = x * 2^13 rounded, CONST_BITS 13, PASS1_BITS 2 (as jpeg_idct.h)
enum {
  kF0_298631336 = 2446,
  kF0_390180644 = 3196,
  kF0_541196100 = 4433,
  kF0_765366865 = 6270,
  kF0_899976223 = 7373,
  kF1_175875602 = 9633,
  kF1_501321110 = 12299,
  kF1_847759065 = 15137,
  kF1_961570560 = 16069,
  kF2_053119869 = 16819,
  kF2_562915447 = 20995,
  kF3_072711026 = 25172,
};

JPEG_HD int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// One 1-D pass of jpeg_fdct_islow over d[0], d[s], ..., d[7s]: the even
// outputs shifted left by `even_up` (pass 1) or descaled by `even_down`
// (pass 2), the rest descaled by `odd_down`.
JPEG_HD void fdct_1d(int* d, int s, int even_up, int even_down,
                     int odd_down) {
  int tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
  int tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
  int tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
  int tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
  int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  if (even_up) {
    d[0] = (tmp10 + tmp11) * (1 << even_up);
    d[4 * s] = (tmp10 - tmp11) * (1 << even_up);
  } else {
    d[0] = descale(tmp10 + tmp11, even_down);
    d[4 * s] = descale(tmp10 - tmp11, even_down);
  }
  int z1 = (tmp12 + tmp13) * kF0_541196100;
  d[2 * s] = descale(z1 + tmp13 * kF0_765366865, odd_down);
  d[6 * s] = descale(z1 + tmp12 * -kF1_847759065, odd_down);
  z1 = tmp4 + tmp7;
  int z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  int z5 = (z3 + z4) * kF1_175875602;
  tmp4 *= kF0_298631336;
  tmp5 *= kF2_053119869;
  tmp6 *= kF3_072711026;
  tmp7 *= kF1_501321110;
  z1 *= -kF0_899976223;
  z2 *= -kF2_562915447;
  z3 = z3 * -kF1_961570560 + z5;
  z4 = z4 * -kF0_390180644 + z5;
  d[7 * s] = descale(tmp4 + z1 + z3, odd_down);
  d[5 * s] = descale(tmp5 + z2 + z4, odd_down);
  d[3 * s] = descale(tmp6 + z2 + z3, odd_down);
  d[s] = descale(tmp7 + z1 + z4, odd_down);
}

// One 8x8 block of samples (row pitch `pitch`): level shift by -128
// (jcdctmgr.c convsamp), jpeg_fdct_islow, quantization by `div` (natural
// order) into 64 coefficients in natural order.
JPEG_HD void fdct_islow_block(const uint8_t* src, int pitch,
                              const Divisor* div, int16_t* out) {
  int d[64];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++) d[8 * r + c] = src[r * pitch + c] - 128;
  for (int r = 0; r < 8; r++) fdct_1d(d + 8 * r, 1, 2, 0, 13 - 2);
  for (int c = 0; c < 8; c++) fdct_1d(d + c, 8, 0, 2, 13 + 2);
  for (int k = 0; k < 64; k++) out[k] = quantize(d[k], div[k]);
}

}  // namespace jpeg_fdct
