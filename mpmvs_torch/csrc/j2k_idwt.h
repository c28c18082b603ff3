// The arithmetic of j2k_idwt_kernel (jpeg_codec.cu): one line, a row or a
// column, of one level of the inverse discrete wavelet transform of a
// JPEG 2000 tile-component, as OpenJPEG 2.5's dwt.c computes it. Shared
// by the kernel and by the host, where the tests build it with g++; the
// plain PyTorch version is mpmvs_torch/io/images.py's j2k_idwt_plain.
//
// A level of width len has sn low-pass samples (the resolution below's
// width) followed by len - sn high-pass ones; the line is interleaved,
// low-pass samples at the positions whose coordinate on the level's grid
// is even, so that cas, the parity of the level's origin, puts the first
// low-pass sample at position cas. Then, with each end mirrored
// (symmetric extension):
//   * 5/3 (reversible, int32): even positions x -= (left + right + 2) >> 2,
//     then odd ones x += (left + right) >> 1; a line of one sample is left
//     as it is at an even origin and halved (C division) at an odd one;
//   * 9/7 (irreversible, float): low-pass samples times K = 1.230174105,
//     high-pass ones times OpenJPEG's 2/K, 1.625732422; then four lifting
//     steps, x += (left + right) c, with c = -delta on the low-pass
//     samples, -gamma on the high-pass ones, -beta, -alpha, each product
//     and sum rounded on its own (__fmul_rn / __fadd_rn on the card, as
//     each lane of OpenJPEG's SSE path computes it, no fused multiply-add);
//     a line of one sample is not scaled (OpenJPEG returns early).
// A level transforms every row (low-pass rows first, then high-pass ones,
// each into a new row) and then every column.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define J2K_HD __host__ __device__ __forceinline__
#else
#define J2K_HD static inline
#endif

namespace j2k_idwt {

#ifdef __CUDA_ARCH__
J2K_HD float fmul(float a, float b) { return __fmul_rn(a, b); }
J2K_HD float fadd(float a, float b) { return __fadd_rn(a, b); }
#else
J2K_HD float fmul(float a, float b) { return a * b; }
J2K_HD float fadd(float a, float b) { return a + b; }
#endif

// OpenJPEG's constants (dwt.c)
#define J2K_K 1.230174105f
#define J2K_TWO_INVK 1.625732422f
#define J2K_ALPHA (-1.586134342f)
#define J2K_BETA (-0.052980118f)
#define J2K_GAMMA 0.882911075f
#define J2K_DELTA 0.443506852f

// the neighbours of position p on a line of len, mirrored at both ends
J2K_HD int left_of(int p) { return p > 0 ? p - 1 : p + 1; }
J2K_HD int right_of(int p, int len) { return p + 1 < len ? p + 1 : p - 1; }

// Interleave in[0 .. len) (stride sin; sn low-pass then high-pass) into
// out (stride sout).
template <typename T>
J2K_HD void interleave(const T* in, long sin, T* out, long sout, int sn,
                       int len, int cas) {
  for (int i = 0; i < sn; i++) out[(2 * i + cas) * sout] = in[i * sin];
  for (int i = 0; i < len - sn; i++)
    out[(2 * i + 1 - cas) * sout] = in[(sn + i) * sin];
}

J2K_HD void line53(const int32_t* in, long sin, int32_t* x, long s, int sn,
                   int len, int cas) {
  interleave(in, sin, x, s, sn, len, cas);
  if (len == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  if (len < 1) return;
  for (int p = cas; p < len; p += 2)  // low-pass positions
    x[p * s] -= (x[left_of(p) * s] + x[right_of(p, len) * s] + 2) >> 2;
  for (int p = 1 - cas; p < len; p += 2)  // high-pass positions
    x[p * s] += (x[left_of(p) * s] + x[right_of(p, len) * s]) >> 1;
}

J2K_HD void lift97(float* x, long s, int first, int len, float c) {
  for (int p = first; p < len; p += 2)
    x[p * s] = fadd(x[p * s],
                    fmul(fadd(x[left_of(p) * s], x[right_of(p, len) * s]), c));
}

J2K_HD void line97(const float* in, long sin, float* x, long s, int sn,
                   int len, int cas) {
  interleave(in, sin, x, s, sn, len, cas);
  const int dn = len - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  for (int p = cas; p < len; p += 2) x[p * s] = fmul(x[p * s], J2K_K);
  for (int p = 1 - cas; p < len; p += 2)
    x[p * s] = fmul(x[p * s], J2K_TWO_INVK);
  lift97(x, s, cas, len, -J2K_DELTA);
  lift97(x, s, 1 - cas, len, -J2K_GAMMA);
  lift97(x, s, cas, len, -J2K_BETA);
  lift97(x, s, 1 - cas, len, -J2K_ALPHA);
}

}  // namespace j2k_idwt
