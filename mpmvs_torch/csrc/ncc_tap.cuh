// Tap arithmetic of the bilateral-ZNCC window, shared by ncc_eval.cu (the
// costs) and ncc_samples.cu (the sorted path's costs and raw samples), so
// that both place every tap on the same texel and turn the same sums into
// the same cost.
//
// The operations follow mpmvs_torch/ops/ncc.py::ncc_eval one for one:
// geometry.homography_apply for the centre (m = K_ref^-T n, scale = m / w,
// columns, h_p, pt = h_p[:2] / h_p[2]), then per tap h = h_p + dx col_x +
// dy col_y, xs = h0 * (1 / h2), the footprint-cap box test, and
// ops/sampling.py's clamped bilinear lerp. Build with -fmad=false and
// without --use_fast_math: divisions stay IEEE, and no multiply-add is
// contracted, because one ulp of a coordinate can move a tap to another
// texel.

#pragma once

#include <cuda_runtime.h>

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

// The texel rule of a bilinear tap along one axis, the one place it is
// written: ops/sampling.py::_floor_index takes the floor f clamped to
// [-1, lim + 1] (NaN -> 0) and its right neighbour, both clipped to
// [0, lim]. The same texels follow from the floor clamped to [-1, lim]
// (clamp_floor): the pair (max(c, 0), c + 1), whose right texel collapses
// onto the left one where c reaches lim (pair_collapses).
__device__ __forceinline__ float clamp_floor(float f, int lim) {
  const float c = f != f ? 0.0f : (f < -1.0f ? -1.0f : f);
  const float top = (float)lim;
  return c > top ? top : c;
}

__device__ __forceinline__ bool pair_collapses(float c, int lim) {
  return c >= (float)lim;
}

// Floor index and its right neighbour in [0, lim].
__device__ __forceinline__ void floor_index(float f, int lim, int* i0,
                                            int* i1) {
  const float c = clamp_floor(f, lim);
  const int i = (int)c;
  *i0 = i < 0 ? 0 : i;
  *i1 = pair_collapses(c, lim) ? *i0 : i + 1;
}

// One source view: its valid extent (never beyond the stored Hp x Wp) and
// homography terms A (row-major 3x3) and b.
struct NccView {
  float Wv, Hv;
  int w_lim, h_lim;
  float A[9], bb[3];
};

// wh: (width, height); ab: A (9) then b (3).
__device__ __forceinline__ void load_view(const float* __restrict__ wh,
                                          const float* __restrict__ ab,
                                          int Hp, int Wp, NccView* v) {
  v->Wv = __ldg(wh);
  v->Hv = __ldg(wh + 1);
  v->w_lim = min((int)v->Wv, Wp) - 1;
  v->h_lim = min((int)v->Hv, Hp) - 1;
#pragma unroll
  for (int i = 0; i < 9; ++i) v->A[i] = __ldg(ab + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) v->bb[i] = __ldg(ab + 9 + i);
}

// The plane-induced homography of one hypothesis at one pixel: the image
// hp of (x, y, 1) and the columns colx, coly; ``bad`` starts as the
// centre's out-of-bounds test (PatchMatch.cu:350-353) and collects the
// footprint cap's verdicts tap by tap.
struct NccHomography {
  float colx[3], coly[3], hp[3];
  float bx_lo, bx_hi, by_lo, by_hi;
  bool bad;
};

// m / w of one plane, m = K_ref^-T n summed in order: the part of the
// homography that does not depend on the source view.
__device__ __forceinline__ void plane_scale(const float* kt, float4 pl,
                                            float* sc) {
  const float m0 = kt[0] * pl.x + kt[1] * pl.y + kt[2] * pl.z;
  const float m1 = kt[3] * pl.x + kt[4] * pl.y + kt[5] * pl.z;
  const float m2 = kt[6] * pl.x + kt[7] * pl.y + kt[8] * pl.z;
  sc[0] = m0 / pl.w;
  sc[1] = m1 / pl.w;
  sc[2] = m2 / pl.w;
}

// The homography of view v for a plane's m / w (plane_scale) at (x, y).
__device__ __forceinline__ void view_homography(const NccView& v,
                                                const float* sc, float x,
                                                float y, float cap_radius,
                                                NccHomography* h) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h->colx[i] = v.A[3 * i + 0] - v.bb[i] * sc[0];
    h->coly[i] = v.A[3 * i + 1] - v.bb[i] * sc[1];
    const float col1 = v.A[3 * i + 2] - v.bb[i] * sc[2];
    h->hp[i] = h->colx[i] * x + h->coly[i] * y + col1;
  }
  const float pt0 = h->hp[0] / h->hp[2];
  const float pt1 = h->hp[1] / h->hp[2];
  h->bad = pt0 < 0.0f || pt0 >= v.Wv || pt1 < 0.0f || pt1 >= v.Hv ||
           !finite_f(pt0) || !finite_f(pt1);
  h->bx_lo = h->bx_hi = h->by_lo = h->by_hi = 0.0f;
  if (cap_radius > 0.0f) {
    const float inv_zc = 1.0f / h->hp[2];
    const float ccx = finite_or_zero(h->hp[0] * inv_zc);
    const float ccy = finite_or_zero(h->hp[1] * inv_zc);
    h->bx_lo = ccx - cap_radius;
    h->bx_hi = ccx + cap_radius;
    h->by_lo = ccy - cap_radius;
    h->by_hi = ccy + cap_radius;
  }
}

__device__ __forceinline__ void plane_homography(const NccView& v,
                                                 const float* kt, float4 pl,
                                                 float x, float y,
                                                 float cap_radius,
                                                 NccHomography* h) {
  float sc[3];
  plane_scale(kt, pl, sc);
  view_homography(v, sc, x, y, cap_radius, h);
}

// Source coordinates (xs, ys) of a tap from its homogeneous image (h0, h1,
// h2); with ``cap`` a tap outside the footprint-cap box sets h->bad.
__device__ __forceinline__ void tap_point(float h0, float h1, float h2,
                                          NccHomography* h, bool cap,
                                          float* xs, float* ys) {
  const float inv_z = 1.0f / h2;
  *xs = h0 * inv_z;
  *ys = h1 * inv_z;
  if (cap) {
    const float xf = finite_or_zero(*xs);
    const float yf = finite_or_zero(*ys);
    h->bad = h->bad || xf < h->bx_lo || xf > h->bx_hi || yf < h->by_lo ||
             yf > h->by_hi;
  }
}

// The clamped bilinear sample at (xs, ys) in ``img`` (Hp x Wp, row stride
// Wp), ops/sampling.py's lerp.
__device__ __forceinline__ float bilinear_clamped(const float* __restrict__ img,
                                                  int Wp, const NccView& v,
                                                  float xs, float ys) {
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  const float fx = xs - x0f;
  const float fy = ys - y0f;
  int x0, x1, y0, y1;
  floor_index(x0f, v.w_lim, &x0, &x1);
  floor_index(y0f, v.h_lim, &y0, &y1);
  const float v00 = __ldg(img + (size_t)y0 * Wp + x0);
  const float v01 = __ldg(img + (size_t)y0 * Wp + x1);
  const float v10 = __ldg(img + (size_t)y1 * Wp + x0);
  const float v11 = __ldg(img + (size_t)y1 * Wp + x1);
  const float top = v00 + fx * (v01 - v00);
  const float bot = v10 + fx * (v11 - v10);
  return top + fy * (bot - top);
}

// The same sample through one tex2Dgather of the view's texture (a CUDA
// array made for gather, point filtering, clamp addressing at the stored
// Hp x Wp, unnormalised coordinates). The gather at (cx + 1, cy + 1)
// returns the texels (cx, cx + 1) x (cy, cy + 1), the hardware clamping
// -1 to 0; where the pair collapses, the second texel is the first, since
// the view's valid extent may end before the stored one.
__device__ __forceinline__ float bilinear_tex(cudaTextureObject_t tex,
                                              const NccView& v, float xs,
                                              float ys) {
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  const float fx = xs - x0f;
  const float fy = ys - y0f;
  const float cx = clamp_floor(x0f, v.w_lim);
  const float cy = clamp_floor(y0f, v.h_lim);
  // components: w (x0, y0), z (x1, y0), x (x0, y1), y (x1, y1)
  const float4 g = tex2Dgather<float4>(tex, cx + 1.0f, cy + 1.0f, 0);
  float v00 = g.w, v01 = g.z, v10 = g.x, v11 = g.y;
  if (pair_collapses(cx, v.w_lim)) {
    v01 = v00;
    v11 = v10;
  }
  if (pair_collapses(cy, v.h_lim)) {
    v10 = v00;
    v11 = v01;
  }
  const float top = v00 + fx * (v01 - v00);
  const float bot = v10 + fx * (v11 - v10);
  return top + fy * (bot - top);
}

// The sample of tap (dx, dy): h = h_p + dx col_x + dy col_y, projected and
// sampled from ``img`` through __ldg.
__device__ __forceinline__ float tap_sample(const float* __restrict__ img,
                                            int Wp, const NccView& v,
                                            NccHomography* h, float dx,
                                            float dy, bool cap) {
  const float h0 = h->hp[0] + dx * h->colx[0] + dy * h->coly[0];
  const float h1 = h->hp[1] + dx * h->colx[1] + dy * h->coly[1];
  const float h2 = h->hp[2] + dx * h->colx[2] + dy * h->coly[2];
  float xs, ys;
  tap_point(h0, h1, h2, h, cap, &xs, &ys);
  return bilinear_clamped(img, Wp, v, xs, ys);
}

// The weighted source sums of one window, tap by tap in the plain
// version's order (ops/ncc.py::ncc_eval, ncc_sorted.zncc_from_samples).
struct NccSums {
  float src, src2, rs;
};

__device__ __forceinline__ void zncc_add(NccSums* s, float w, float wr,
                                         float val) {
  const float ws = w * val;
  s->src = s->src + ws;
  s->src2 = s->src2 + ws * val;
  s->rs = s->rs + wr * val;
}

// The cost of a window from its sums and the reference-side moments (iw =
// 1 / sum w, mr, vr): ops/ncc.py::zncc_from_sums, cost_max where ``bad``
// or either variance is below 1e-5 (PatchMatch.cu:406-408), else
// clip(1 - cov / sqrt(vr var_src), 0, cost_max). NaN passes through the
// clamp and the clip as it does in torch.clamp.
__device__ __forceinline__ float zncc_cost(const NccSums& s, float iw,
                                           float mr, float vr, bool bad,
                                           float cost_max) {
  const float m_src = s.src * iw;
  const float var_src = s.src2 * iw - m_src * m_src;
  const float covar = s.rs * iw - mr * m_src;
  const bool degenerate = vr < 1e-5f || var_src < 1e-5f;
  float prod = vr * var_src;
  prod = (prod != prod || prod >= 1e-30f) ? prod : 1e-30f;
  const float denom = sqrtf(prod);
  float ncc = 1.0f - covar / denom;
  ncc = ncc < 0.0f ? 0.0f : (ncc > cost_max ? cost_max : ncc);
  return (bad || degenerate) ? cost_max : ncc;
}
