// Tap arithmetic of the bilateral-ZNCC window, shared by ncc_eval.cu (the
// costs) and ncc_samples.cu (the raw samples of the sorted path), so that
// both place every tap on the same texel.
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

__device__ __forceinline__ void plane_homography(const NccView& v,
                                                 const float* kt, float4 pl,
                                                 float x, float y,
                                                 float cap_radius,
                                                 NccHomography* h) {
  // m = K_ref^-T n, summed in order; scale = m / w
  const float m0 = kt[0] * pl.x + kt[1] * pl.y + kt[2] * pl.z;
  const float m1 = kt[3] * pl.x + kt[4] * pl.y + kt[5] * pl.z;
  const float m2 = kt[6] * pl.x + kt[7] * pl.y + kt[8] * pl.z;
  const float s0 = m0 / pl.w;
  const float s1 = m1 / pl.w;
  const float s2 = m2 / pl.w;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h->colx[i] = v.A[3 * i + 0] - v.bb[i] * s0;
    h->coly[i] = v.A[3 * i + 1] - v.bb[i] * s1;
    const float col1 = v.A[3 * i + 2] - v.bb[i] * s2;
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

// The clamped bilinear sample of tap (dx, dy) in ``img`` (Hp x Wp, row
// stride Wp); with ``cap`` a tap outside the box sets h->bad.
__device__ __forceinline__ float tap_sample(const float* __restrict__ img,
                                            int Wp, const NccView& v,
                                            NccHomography* h, float dx,
                                            float dy, bool cap) {
  const float h0 = h->hp[0] + dx * h->colx[0] + dy * h->coly[0];
  const float h1 = h->hp[1] + dx * h->colx[1] + dy * h->coly[1];
  const float h2 = h->hp[2] + dx * h->colx[2] + dy * h->coly[2];
  const float inv_z = 1.0f / h2;
  const float xs = h0 * inv_z;
  const float ys = h1 * inv_z;
  if (cap) {
    const float xf = finite_or_zero(xs);
    const float yf = finite_or_zero(ys);
    h->bad = h->bad || xf < h->bx_lo || xf > h->bx_hi || yf < h->by_lo ||
             yf > h->by_hi;
  }
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
