// libjpeg-turbo's accurate integer inverse DCT as cv2 runs it on x86-64,
// with its dequantization, for one 8x8 block: jsimd_idct_islow_avx2
// (simd/x86_64/jidctint-avx2.asm; the SSE2 form computes the same), the
// SIMD form of jidctint.c's jpeg_idct_islow. Compiled for the card in
// mpmvs_torch/csrc/jpeg_codec.cu (idct_islow_kernel); the plain PyTorch
// version is mpmvs_torch/io/images.py::idct_islow_plain.
//
// It takes jidctint's sums (CONST_BITS 13, PASS1_BITS 2) with its
// constants regrouped into pairs of 16-bit products added in 32 bits
// (pmaddwd), in its lanes' widths: a dequantized coefficient is the low 16
// bits of coefficient x table entry (pmullw); in0 + in4, in0 - in4, in7 +
// in3 and in5 + in1 wrap in 16 bits, every 32-bit sum wraps; each pass's
// descaled outputs saturate to 16 bits (packssdw) and the samples to -128
// .. 127 before the + 128 (packsswb, paddb), where jidctint's C indexes its
// range-limit table by x & 1023. A block whose coefficients in rows 1 to 7
// are all 0 takes pass 1's DC shortcut: each column's dequantized row-0
// value shifted left by 2, in 16 bits. On coefficients whose sums stay in
// range the SIMD and C forms agree bit for bit; they part only on the
// large values a stream cut short can leave (zeros fed past its end, or
// the junk symbols a cut scan decodes).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define JPEG_HD __host__ __device__ __forceinline__
#else
#define JPEG_HD static inline
#endif

namespace jpeg_idct {

// FIX(x) = x * 2^13 rounded, paired as the SIMD code pairs them
enum {
  kConstBits = 13,
  kPass1Bits = 2,
  kF054 = 4433,               // FIX(0.541196100)
  kF130 = 4433 + 6270,        // + FIX(0.765366865)
  kMF130 = 4433 - 15137,      // - FIX(1.847759065)
  kF117 = 9633,               // FIX(1.175875602)
  kMF078 = 9633 - 16069,      // - FIX(1.961570560)
  kF078 = 9633 - 3196,        // - FIX(0.390180644)
  kMF089 = -7373,             // -FIX(0.899976223)
  kMF060 = 2446 - 7373,       // FIX(0.298631336) - FIX(0.899976223)
  kF060 = 12299 - 7373,       // FIX(1.501321110) - FIX(0.899976223)
  kMF256 = -20995,            // -FIX(2.562915447)
  kMF050 = 16819 - 20995,     // FIX(2.053119869) - FIX(2.562915447)
  kF050 = 25172 - 20995,      // FIX(3.072711026) - FIX(2.562915447)
};

JPEG_HD int32_t wrap16(int64_t x) { return (int16_t)(uint16_t)(x & 0xFFFF); }
JPEG_HD int32_t wrap32(int64_t x) {
  return (int32_t)(uint32_t)(x & 0xFFFFFFFF);
}
JPEG_HD int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}
// pmaddwd: a * ca + b * cb, 16-bit inputs, the sum in 32 bits
JPEG_HD int32_t madd(int32_t a, int32_t ca, int32_t b, int32_t cb) {
  return wrap32((int64_t)a * ca + (int64_t)b * cb);
}

// One 1-D pass over eight 16-bit inputs: the eight 32-bit sums of outputs
// 0..7 before the descale.
JPEG_HD void idct_1d(const int32_t* in, int32_t* out) {
  int32_t tmp3 = madd(in[2], kF130, in[6], kF054);
  int32_t tmp2 = madd(in[2], kF054, in[6], kMF130);
  int32_t tmp0 = wrap32((int64_t)wrap16(in[0] + in[4]) * (1 << kConstBits));
  int32_t tmp1 = wrap32((int64_t)wrap16(in[0] - in[4]) * (1 << kConstBits));
  int32_t t10 = wrap32((int64_t)tmp0 + tmp3);
  int32_t t13 = wrap32((int64_t)tmp0 - tmp3);
  int32_t t11 = wrap32((int64_t)tmp1 + tmp2);
  int32_t t12 = wrap32((int64_t)tmp1 - tmp2);
  int32_t z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
  int32_t z3s = madd(z3, kMF078, z4, kF117);
  int32_t z4s = madd(z3, kF117, z4, kF078);
  int32_t o0 = wrap32((int64_t)madd(in[7], kMF060, in[1], kMF089) + z3s);
  int32_t o3 = wrap32((int64_t)madd(in[7], kMF089, in[1], kF060) + z4s);
  int32_t o1 = wrap32((int64_t)madd(in[5], kMF050, in[3], kMF256) + z4s);
  int32_t o2 = wrap32((int64_t)madd(in[5], kMF256, in[3], kF050) + z3s);
  out[0] = wrap32((int64_t)t10 + o3);
  out[7] = wrap32((int64_t)t10 - o3);
  out[1] = wrap32((int64_t)t11 + o2);
  out[6] = wrap32((int64_t)t11 - o2);
  out[2] = wrap32((int64_t)t12 + o1);
  out[5] = wrap32((int64_t)t12 - o1);
  out[3] = wrap32((int64_t)t13 + o0);
  out[4] = wrap32((int64_t)t13 - o0);
}

// paddd of the rounding, psrad by n, packssdw
JPEG_HD int32_t descale(int32_t x, int n) {
  return sat16(wrap32((int64_t)x + (1 << (n - 1))) >> n);
}

// coef: 64 quantized coefficients in natural order; qt: the quantization
// table in natural order; out: 8x8 samples at out[r * pitch + c].
JPEG_HD void idct_islow_block(const int16_t* coef, const uint16_t* qt,
                              uint8_t* out, int pitch, int rows, int cols) {
  int32_t ws[64];
  bool ac = false;
  for (int k = 8; k < 64; k++) ac = ac || coef[k] != 0;
  for (int c = 0; c < 8; c++) {  // pass 1: columns, into ws
    int32_t in[8], o[8];
    for (int k = 0; k < 8; k++)
      in[k] = wrap16((int64_t)coef[8 * k + c] * qt[8 * k + c]);
    if (!ac) {  // the DC shortcut: psllw by PASS1_BITS
      for (int k = 0; k < 8; k++) ws[8 * k + c] = wrap16(in[0] * 4);
      continue;
    }
    idct_1d(in, o);
    for (int k = 0; k < 8; k++)
      ws[8 * k + c] = descale(o[k], kConstBits - kPass1Bits);
  }
  for (int r = 0; r < rows; r++) {  // pass 2: rows, to samples
    int32_t o[8];
    idct_1d(ws + 8 * r, o);
    for (int c = 0; c < cols; c++) {
      int32_t v = descale(o[c], kConstBits + kPass1Bits + 3);
      v = v < -128 ? -128 : (v > 127 ? 127 : v);  // packsswb
      out[r * pitch + c] = (uint8_t)(v + 128);
    }
  }
}

}  // namespace jpeg_idct
