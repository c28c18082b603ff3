// K-stacked bilateral-ZNCC matching cost for Hopper (sm_90a).
//
// Replaces the TPU kernel mpmvs_tpu/ops/pallas_ncc.py::_kernel, which the
// JAX package calls as ncc_eval_pallas_multi (K stacked plane fields) and
// ncc_eval_pallas (K = 1). For every (hypothesis k, source view s, pixel p)
// it computes what mpmvs_torch/ops/ncc.py::ncc_eval computes: the
// plane-induced homography, 36 window taps, the footprint-cap box, clamped
// bilinear source samples and the bilateral-weighted ZNCC against the
// reference-side moments (NCCRefSide). out[k, s, p] in [0, cost_max].
//
// What bounds it on an H100: gathers, not flops. Each tap reads the four
// bilinear corners of one source texel quad (16 B, scattered, served from
// L1/L2: a band's sources fit in the 50 MB L2) plus w/wr of the pixel;
// the arithmetic per tap is ~34 flops. The TPU kernel's slab/window sweep,
// SMEM range tables and DMA existed because the TPU has no gather unit;
// none of that carries over. This first form is one thread per
// (pixel, source view) looping over K hypotheses x 36 taps, with w/wr read
// at [t, pixel] so neighbouring threads read neighbouring addresses, four
// __ldg point loads per tap and the sums in registers. Staging a block's
// source footprint in shared memory is later work.
//
// Rounding: the operations follow the plain version one for one. Build
// with -fmad=false (PyTorch's eager ops round every multiply and add) and
// without --use_fast_math: divisions are IEEE (one ulp of a coordinate can
// move a tap to another texel). NaN propagates through clip and max as it
// does in torch.clamp. The homography and tap arithmetic live in
// ncc_tap.cuh, shared with ncc_samples.cu (the sorted path's kernel).

#include <stdint.h>

#include "ncc_tap.cuh"

__global__ void __launch_bounds__(128)
ncc_eval_multi_kernel(const float* __restrict__ w,        // (T, P)
                      const float* __restrict__ wr,       // (T, P)
                      const float* __restrict__ inv_w,    // (P,)
                      const float* __restrict__ m_ref,    // (P,)
                      const float* __restrict__ var_ref,  // (P,)
                      const float4* __restrict__ planes,  // (K, P)
                      const float* __restrict__ xg,       // (P,)
                      const float* __restrict__ yg,       // (P,)
                      const float* __restrict__ src,      // (S, Hp, Wp)
                      const float* __restrict__ wh,       // (S, 2)
                      const float* __restrict__ ab,       // (S, 12)
                      const float* __restrict__ kinvt,    // (9,) K_ref^-T
                      NccTaps taps, int K, int S, int P, int Hp, int Wp,
                      float cost_max, float cap_radius,
                      float* __restrict__ out) {          // (K, S, P)
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (p >= P) return;

  NccView v;
  load_view(wh + 2 * s, ab + 12 * s, Hp, Wp, &v);
  float kt[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) kt[i] = __ldg(kinvt + i);

  const float x = __ldg(xg + p);
  const float y = __ldg(yg + p);
  const float iw = __ldg(inv_w + p);
  const float mr = __ldg(m_ref + p);
  const float vr = __ldg(var_ref + p);
  const float* img = src + (size_t)s * Hp * Wp;
  const bool cap = cap_radius > 0.0f;

  for (int k = 0; k < K; ++k) {
    const float4 pl = planes[(size_t)k * P + p];
    NccHomography h;
    plane_homography(v, kt, pl, x, y, cap_radius, &h);
    float sum_src = 0.0f, sum_src2 = 0.0f, sum_rs = 0.0f;
    for (int t = 0; t < taps.n; ++t) {
      const float val = tap_sample(img, Wp, v, &h, (float)taps.dx[t],
                                   (float)taps.dy[t], cap);
      const float ws = __ldg(w + (size_t)t * P + p) * val;
      sum_src = sum_src + ws;
      sum_src2 = sum_src2 + ws * val;
      sum_rs = sum_rs + __ldg(wr + (size_t)t * P + p) * val;
    }

    const float m_src = sum_src * iw;
    const float var_src = sum_src2 * iw - m_src * m_src;
    const float covar = sum_rs * iw - mr * m_src;
    const bool degenerate = vr < 1e-5f || var_src < 1e-5f;
    float prod = vr * var_src;
    prod = (prod != prod || prod >= 1e-30f) ? prod : 1e-30f;
    const float denom = sqrtf(prod);
    float ncc = 1.0f - covar / denom;
    ncc = ncc < 0.0f ? 0.0f : (ncc > cost_max ? cost_max : ncc);
    out[((size_t)k * S + s) * P + p] = (h.bad || degenerate) ? cost_max : ncc;
  }
}

extern "C" int ncc_eval_multi_launch(
    const float* w, const float* wr, const float* inv_w, const float* m_ref,
    const float* var_ref, const float* planes, const float* x, const float* y,
    const float* src, const float* wh, const float* ab, const float* kinvt,
    NccTaps taps, int K, int S, int P, int Hp, int Wp, float cost_max,
    float cap_radius, float* out, void* stream) {
  if (taps.n < 1 || taps.n > NCC_MAX_TAPS || K < 1 || S < 1 || P < 1 ||
      S > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  dim3 grid((P + threads - 1) / threads, S);
  ncc_eval_multi_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      w, wr, inv_w, m_ref, var_ref, reinterpret_cast<const float4*>(planes),
      x, y, src, wh, ab, kinvt, taps, K, S, P, Hp, Wp, cost_max, cap_radius,
      out);
  return (int)cudaGetLastError();
}
