// The bucket-sorted NCC path of one source view, for Hopper (sm_90a): the
// bucket keys, and one kernel in two compile-time forms, the fused costs
// and the raw samples.
//
// Replaces the TPU kernel mpmvs_tpu/ops/pallas_ncc.py::_sample_view_vals
// (pallas_ncc.py:733; its pallas_call runs _kernel with emit_vals=True)
// and the per-view work around it in ncc_eval_pallas_sorted (:814): bucket
// keys of the centre projection (:867-874), a sort, the raw samples, the
// un-permute and the ZNCC in XLA. Why a sorted stream: the path serves
// incoherent fields (a random depth per pixel), whose 36-tap windows land
// anywhere along each pixel's epipolar line. Unsorted, a warp's 32 threads
// read 32 unrelated source regions; sorted by the bucket of the projected
// centre, a warp's taps fall in a few neighbouring texel rows and hit in
// L1.
//
//   * ncc_keys_kernel: the int32 bucket key of every pixel, from the centre
//     projection alone (mpmvs_torch/ops/ncc_sorted.py::bucket_keys_plain);
//     the wrapper sorts the keys with a stable torch.sort.
//   * ncc_sorted_kernel<FUSED = true> (the path's form): for sorted
//     position i it takes pixel p = perm[i], forms the homography, samples
//     the T taps, sums w s, w s^2 and wr s in the tap order of
//     ncc_sorted.zncc_from_samples, applies the ZNCC tail (ncc_tap.cuh)
//     and writes cost[p]. It computes what the plain chain computes per
//     view (sort_view -> sample_view_vals_plain -> unpermute ->
//     zncc_from_samples).
//   * ncc_sorted_kernel<FUSED = false>: the raw samples, the direct
//     counterpart of _sample_view_vals: T + 1 rows in sorted order (the T
//     samples and a flag, 1.0 where the centre projects off the view or a
//     tap leaves the footprint-cap box), sample_view_vals_plain's function.
//
// What bounds it on an H100: bytes and latency. The raw-samples form wrote
// (T + 1) x 4 B a pixel that an un-permute (a scatter) and a 36-step eager
// ZNCC read back: 12.5 ms of kernel against 147 ms of glue over the 10
// views of a 3200x2130 init field (PERF.md section 6). The fused form
// writes one 4-byte cost a pixel and reads what it needs from one row of a
// pixel-major record (ncc_sorted.pixel_record, built once per call and
// shared by the views): plane, x, y, inv_w, m_ref, then w_t and wr_t in
// blocks of four taps, then var_ref, 336 B at T = 36 in 11 sectors, where
// the (T, R, C) refside read at a scattered p would cost a 32-byte sector
// per value. Pixels whose centre falls off the view cost cost_max at
// once, without their taps.
// Both forms read the source through __ldg on the stack. A texture gather
// (as ncc_eval.cu reads) was timed in the fused form on an H100: 7% faster
// at the init field, 2% slower on the half-width trial fields that make 360
// of a depth map's 370 launches, a tie over a depth map (PERF.md section
// 6), so the path keeps one fetch and needs no texture.
//
// Rounding: as ncc_eval.cu, -fmad=false, IEEE division, no
// --use_fast_math, so a cost and a sample equal the plain version's bit for
// bit.

#include <float.h>
#include <stdint.h>

#include "ncc_tap.cuh"

#define NCC_SORTED_THREADS 128

__device__ __forceinline__ float nan_to_num_f(float v) {
  if (v != v) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// clamp(floor(c / size), 0, n - 1), c finite
__device__ __forceinline__ int bucket_of(float c, float size, int n) {
  float f = floorf(c / size);
  f = f < 0.0f ? 0.0f : f;
  const float top = (float)(n - 1);
  return (int)(f > top ? top : f);
}

__global__ void __launch_bounds__(NCC_SORTED_THREADS)
ncc_keys_kernel(const float* __restrict__ xg,        // (N,)
                const float* __restrict__ yg,        // (N,)
                const float4* __restrict__ planes,   // (N,)
                const float* __restrict__ ab,        // (12,)
                const float* __restrict__ kinvt,     // (9,) K_ref^-T
                int N, int Hp, int Wp, int bucket_rows, int bucket_cols,
                int32_t* __restrict__ keys) {        // (N,)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  NccView v = {};  // the homography terms; a key needs no extent
#pragma unroll
  for (int j = 0; j < 9; ++j) v.A[j] = __ldg(ab + j);
#pragma unroll
  for (int j = 0; j < 3; ++j) v.bb[j] = __ldg(ab + 9 + j);
  float kt[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) kt[j] = __ldg(kinvt + j);
  NccHomography h;
  plane_homography(v, kt, planes[i], __ldg(xg + i), __ldg(yg + i), 0.0f,
                   &h);
  const float cx = nan_to_num_f(h.hp[0] / h.hp[2]);
  const float cy = nan_to_num_f(h.hp[1] / h.hp[2]);
  const int n_rows = (Hp + bucket_rows - 1) / bucket_rows;
  const int n_cols = (Wp + bucket_cols - 1) / bucket_cols;
  keys[i] = bucket_of(cy, (float)bucket_rows, n_rows) * n_cols +
            bucket_of(cx, (float)bucket_cols, n_cols);
}

// FUSED: cost[p] for sorted position i from the record; else the raw
// samples of column i. Row p of the record (rec_stride floats): plane, x,
// y, inv_w, m_ref, then for each block b of four taps w_4b..w_4b+3 and
// wr_4b..wr_4b+3 (T rounded up to a multiple of 4), then var_ref.
template <bool FUSED>
__global__ void __launch_bounds__(NCC_SORTED_THREADS)
ncc_sorted_kernel(const int64_t* __restrict__ perm,   // (N,)
                  const float* __restrict__ xg,       // (N,) samples form
                  const float* __restrict__ yg,       // (N,) samples form
                  const float4* __restrict__ planes,  // (N,) samples form
                  const float* __restrict__ rec,      // (N, rec_stride)
                  int rec_stride,
                  const float* __restrict__ img,      // (Hp, Wp)
                  const float* __restrict__ wh,       // (2,)
                  const float* __restrict__ ab,       // (12,)
                  const float* __restrict__ kinvt,    // (9,) K_ref^-T
                  NccTaps taps, int N, int Hp, int Wp, float cap_radius,
                  float cost_max,
                  float* __restrict__ out) {  // (N,) or (T + 1, N)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t p = __ldg(perm + i);

  NccView v;
  load_view(wh, ab, Hp, Wp, &v);
  float kt[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) kt[j] = __ldg(kinvt + j);
  const bool cap = cap_radius > 0.0f;
  NccHomography h;

  if (!FUSED) {
    plane_homography(v, kt, planes[p], __ldg(xg + p), __ldg(yg + p),
                     cap_radius, &h);
    for (int t = 0; t < taps.n; ++t) {
      out[(size_t)t * N + i] = tap_sample(
          img, Wp, v, &h, (float)taps.dx[t], (float)taps.dy[t], cap);
    }
    out[(size_t)taps.n * N + i] = h.bad ? 1.0f : 0.0f;
    return;
  }

  const float* r = rec + (size_t)p * rec_stride;
  const float4 pl = __ldg(reinterpret_cast<const float4*>(r));
  const float4 hd = __ldg(reinterpret_cast<const float4*>(r) + 1);
  plane_homography(v, kt, pl, hd.x, hd.y, cap_radius, &h);
  if (h.bad) {  // off the view: the sums cannot change the cost
    out[p] = cost_max;
    return;
  }
  const float* blocks = r + 8;  // 8 floats a block of four taps
  NccSums sums = {0.0f, 0.0f, 0.0f};
  int t = 0;
  for (; t + 3 < taps.n; t += 4) {
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(blocks + 2 * t));
    const float4 wr4 =
        __ldg(reinterpret_cast<const float4*>(blocks + 2 * t + 4));
    const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
    const float wrs[4] = {wr4.x, wr4.y, wr4.z, wr4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      zncc_add(&sums, ws[j], wrs[j],
               tap_sample(img, Wp, v, &h, (float)taps.dx[t + j],
                          (float)taps.dy[t + j], cap));
  }
  for (; t < taps.n; ++t) {
    const float* b = blocks + 2 * (t & ~3) + (t & 3);
    zncc_add(&sums, __ldg(b), __ldg(b + 4),
             tap_sample(img, Wp, v, &h, (float)taps.dx[t],
                        (float)taps.dy[t], cap));
  }
  const int tp = (taps.n + 3) & ~3;
  out[p] = zncc_cost(sums, hd.z, hd.w, __ldg(blocks + 2 * tp), h.bad,
                     cost_max);
}

static int blocks_of(int N) {
  return (N + NCC_SORTED_THREADS - 1) / NCC_SORTED_THREADS;
}

extern "C" int ncc_keys_launch(const float* x, const float* y,
                               const float* planes, const float* ab,
                               const float* kinvt, int N,
                               int Hp, int Wp, int bucket_rows,
                               int bucket_cols, int32_t* keys,
                               void* stream) {
  if (N < 1 || Hp < 1 || Wp < 1 || bucket_rows < 1 || bucket_cols < 1)
    return (int)cudaErrorInvalidValue;
  ncc_keys_kernel<<<blocks_of(N), NCC_SORTED_THREADS, 0,
                    (cudaStream_t)stream>>>(
      x, y, reinterpret_cast<const float4*>(planes), ab, kinvt, N, Hp, Wp,
      bucket_rows, bucket_cols, keys);
  return (int)cudaGetLastError();
}

// fused != 0: costs (N,) in pixel order from the record (x, y and planes
// unused); else the (T + 1, N) samples in sorted order (the record
// unused). Both read the source view from img.
extern "C" int ncc_sorted_launch(const int64_t* perm, const float* x,
                                 const float* y, const float* planes,
                                 const float* rec, int rec_stride,
                                 const float* img,
                                 const float* wh, const float* ab,
                                 const float* kinvt, NccTaps taps, int N,
                                 int Hp, int Wp, float cap_radius,
                                 float cost_max, int fused, float* out,
                                 void* stream) {
  if (taps.n < 1 || taps.n > NCC_MAX_TAPS || N < 1 || Hp < 1 || Wp < 1 ||
      img == nullptr ||
      (fused && (rec_stride % 4 != 0 ||
                 rec_stride < 8 + 2 * ((taps.n + 3) & ~3) + 1)))
    return (int)cudaErrorInvalidValue;
  auto kern = fused ? ncc_sorted_kernel<true> : ncc_sorted_kernel<false>;
  kern<<<blocks_of(N), NCC_SORTED_THREADS, 0, (cudaStream_t)stream>>>(
      perm, x, y, reinterpret_cast<const float4*>(planes), rec, rec_stride,
      img, wh, ab, kinvt, taps, N, Hp, Wp,
      cap_radius, cost_max, out);
  return (int)cudaGetLastError();
}
