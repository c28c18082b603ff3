// libjpeg's accurate integer inverse DCT (jidctint.c, jpeg_idct_islow, as
// libjpeg-turbo keeps it from libjpeg 6b), with its dequantization and
// post-IDCT range limit, for one 8x8 block. Compiled for the card in
// mpmvs_torch/csrc/jpeg_codec.cu (idct_islow_kernel); the plain PyTorch
// version is mpmvs_torch/io/images.py::idct_islow_plain.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define JPEG_HD __host__ __device__ __forceinline__
#else
#define JPEG_HD static inline
#endif

namespace jpeg_idct {

// FIX(x) = x * 2^13 rounded, CONST_BITS 13, PASS1_BITS 2
enum {
  kConstBits = 13,
  kPass1Bits = 2,
  kFix0_298631336 = 2446,
  kFix0_390180644 = 3196,
  kFix0_541196100 = 4433,
  kFix0_765366865 = 6270,
  kFix0_899976223 = 7373,
  kFix1_175875602 = 9633,
  kFix1_501321110 = 12299,
  kFix1_847759065 = 15137,
  kFix1_961570560 = 16069,
  kFix2_053119869 = 16819,
  kFix2_562915447 = 20995,
  kFix3_072711026 = 25172,
};

JPEG_HD int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// The post-IDCT range limit: the sample of x + 128 through libjpeg's
// IDCT_range_limit table, indexed by x & 1023 (a clamp to [0, 255] for
// |x| < 512, as libjpeg's table wraps beyond).
JPEG_HD uint8_t range_limit(int64_t x) {
  int i = (int)(x & 1023);
  return (uint8_t)(i < 128 ? i + 128 : (i < 512 ? 255 : (i < 896 ? 0 : i - 896)));
}

// One 1-D pass over eight values in[0..7] (stride 1), writing out[0..7].
JPEG_HD void idct_1d(const int64_t* in, int64_t* tmp10_13, int64_t* odd) {
  int64_t z2 = in[2], z3 = in[6];
  int64_t z1 = (z2 + z3) * kFix0_541196100;
  int64_t tmp2 = z1 + z3 * (-kFix1_847759065);
  int64_t tmp3 = z1 + z2 * kFix0_765366865;
  int64_t tmp0 = (in[0] + in[4]) * ((int64_t)1 << kConstBits);
  int64_t tmp1 = (in[0] - in[4]) * ((int64_t)1 << kConstBits);
  tmp10_13[0] = tmp0 + tmp3;  // tmp10
  tmp10_13[3] = tmp0 - tmp3;  // tmp13
  tmp10_13[1] = tmp1 + tmp2;  // tmp11
  tmp10_13[2] = tmp1 - tmp2;  // tmp12
  int64_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * kFix1_175875602;
  t0 = t0 * kFix0_298631336;
  t1 = t1 * kFix2_053119869;
  t2 = t2 * kFix3_072711026;
  t3 = t3 * kFix1_501321110;
  z1 = z1 * (-kFix0_899976223);
  z2 = z2 * (-kFix2_562915447);
  z3 = z3 * (-kFix1_961570560);
  z4 = z4 * (-kFix0_390180644);
  z3 += z5;
  z4 += z5;
  odd[0] = t0 + z1 + z3;
  odd[1] = t1 + z2 + z4;
  odd[2] = t2 + z2 + z3;
  odd[3] = t3 + z1 + z4;
}

// coef: 64 quantized coefficients in natural order; qt: the quantization
// table in natural order; out: 8x8 samples at out[r * pitch + c].
JPEG_HD void idct_islow_block(const int16_t* coef, const uint16_t* qt,
                              uint8_t* out, int pitch, int rows, int cols) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {  // pass 1: columns, into ws
    int64_t in[8], ev[4], od[4];
    for (int k = 0; k < 8; k++) in[k] = (int64_t)coef[8 * k + c] * qt[8 * k + c];
    idct_1d(in, ev, od);
    const int n = kConstBits - kPass1Bits;
    ws[8 * 0 + c] = descale(ev[0] + od[3], n);
    ws[8 * 7 + c] = descale(ev[0] - od[3], n);
    ws[8 * 1 + c] = descale(ev[1] + od[2], n);
    ws[8 * 6 + c] = descale(ev[1] - od[2], n);
    ws[8 * 2 + c] = descale(ev[2] + od[1], n);
    ws[8 * 5 + c] = descale(ev[2] - od[1], n);
    ws[8 * 3 + c] = descale(ev[3] + od[0], n);
    ws[8 * 4 + c] = descale(ev[3] - od[0], n);
  }
  for (int r = 0; r < rows; r++) {  // pass 2: rows, to samples
    int64_t ev[4], od[4], v[8];
    idct_1d(ws + 8 * r, ev, od);
    const int n = kConstBits + kPass1Bits + 3;
    v[0] = descale(ev[0] + od[3], n);
    v[7] = descale(ev[0] - od[3], n);
    v[1] = descale(ev[1] + od[2], n);
    v[6] = descale(ev[1] - od[2], n);
    v[2] = descale(ev[2] + od[1], n);
    v[5] = descale(ev[2] - od[1], n);
    v[3] = descale(ev[3] + od[0], n);
    v[4] = descale(ev[3] - od[0], n);
    for (int c = 0; c < cols; c++) out[r * pitch + c] = range_limit(v[c]);
  }
}

}  // namespace jpeg_idct
