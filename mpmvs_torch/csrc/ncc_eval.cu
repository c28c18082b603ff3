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
// the arithmetic per tap is ~20 flops. The TPU kernel's slab/window sweep,
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
// does in torch.clamp.

#include <cuda_runtime.h>
#include <stdint.h>

#define NCC_MAX_TAPS 64

struct NccTaps {
  int n;
  int dx[NCC_MAX_TAPS];
  int dy[NCC_MAX_TAPS];
};

__device__ __forceinline__ bool finite_f(float v) { return isfinite(v); }

__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

// Floor index and its right neighbour, clipped to [0, lim]; the floor is
// clamped to [-1, lim + 1] (NaN -> 0) before the conversion, exactly as
// ops/sampling.py::_floor_index.
__device__ __forceinline__ void floor_index(float f, int lim, int* i0,
                                            int* i1) {
  float fc = f != f ? 0.0f : (f < -1.0f ? -1.0f : f);
  float top = (float)(lim + 1);
  fc = fc > top ? top : fc;
  int i = (int)fc;
  int a = i < 0 ? 0 : (i > lim ? lim : i);
  int b = i + 1;
  b = b < 0 ? 0 : (b > lim ? lim : b);
  *i0 = a;
  *i1 = b;
}

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

  const float Wv = __ldg(wh + 2 * s);
  const float Hv = __ldg(wh + 2 * s + 1);
  // valid extent, never beyond the stored (Hp, Wp) — as the plain version
  const int w_lim = min((int)Wv, Wp) - 1;
  const int h_lim = min((int)Hv, Hp) - 1;
  float A[9], bb[3], kt[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) A[i] = __ldg(ab + 12 * s + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) bb[i] = __ldg(ab + 12 * s + 9 + i);
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
    // m = K_ref^-T n, summed in order; scale = m / w
    const float m0 = kt[0] * pl.x + kt[1] * pl.y + kt[2] * pl.z;
    const float m1 = kt[3] * pl.x + kt[4] * pl.y + kt[5] * pl.z;
    const float m2 = kt[6] * pl.x + kt[7] * pl.y + kt[8] * pl.z;
    const float s0 = m0 / pl.w;
    const float s1 = m1 / pl.w;
    const float s2 = m2 / pl.w;
    float colx[3], coly[3], hp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      colx[i] = A[3 * i + 0] - bb[i] * s0;
      coly[i] = A[3 * i + 1] - bb[i] * s1;
      const float col1 = A[3 * i + 2] - bb[i] * s2;
      hp[i] = colx[i] * x + coly[i] * y + col1;
    }
    const float pt0 = hp[0] / hp[2];
    const float pt1 = hp[1] / hp[2];
    bool bad = pt0 < 0.0f || pt0 >= Wv || pt1 < 0.0f || pt1 >= Hv ||
               !finite_f(pt0) || !finite_f(pt1);

    float bx_lo = 0.f, bx_hi = 0.f, by_lo = 0.f, by_hi = 0.f;
    if (cap) {
      const float inv_zc = 1.0f / hp[2];
      const float ccx = finite_or_zero(hp[0] * inv_zc);
      const float ccy = finite_or_zero(hp[1] * inv_zc);
      bx_lo = ccx - cap_radius;
      bx_hi = ccx + cap_radius;
      by_lo = ccy - cap_radius;
      by_hi = ccy + cap_radius;
    }

    float sum_src = 0.0f, sum_src2 = 0.0f, sum_rs = 0.0f;
    for (int t = 0; t < taps.n; ++t) {
      const float dx = (float)taps.dx[t];
      const float dy = (float)taps.dy[t];
      const float h0 = hp[0] + dx * colx[0] + dy * coly[0];
      const float h1 = hp[1] + dx * colx[1] + dy * coly[1];
      const float h2 = hp[2] + dx * colx[2] + dy * coly[2];
      const float inv_z = 1.0f / h2;
      const float xs = h0 * inv_z;
      const float ys = h1 * inv_z;
      if (cap) {
        const float xf = finite_or_zero(xs);
        const float yf = finite_or_zero(ys);
        bad = bad || xf < bx_lo || xf > bx_hi || yf < by_lo || yf > by_hi;
      }
      const float x0f = floorf(xs);
      const float y0f = floorf(ys);
      const float fx = xs - x0f;
      const float fy = ys - y0f;
      int x0, x1, y0, y1;
      floor_index(x0f, w_lim, &x0, &x1);
      floor_index(y0f, h_lim, &y0, &y1);
      const float v00 = __ldg(img + (size_t)y0 * Wp + x0);
      const float v01 = __ldg(img + (size_t)y0 * Wp + x1);
      const float v10 = __ldg(img + (size_t)y1 * Wp + x0);
      const float v11 = __ldg(img + (size_t)y1 * Wp + x1);
      const float top = v00 + fx * (v01 - v00);
      const float bot = v10 + fx * (v11 - v10);
      const float v = top + fy * (bot - top);
      const float ws = __ldg(w + (size_t)t * P + p) * v;
      sum_src = sum_src + ws;
      sum_src2 = sum_src2 + ws * v;
      sum_rs = sum_rs + __ldg(wr + (size_t)t * P + p) * v;
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
    out[((size_t)k * S + s) * P + p] = (bad || degenerate) ? cost_max : ncc;
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
