// Raw bilateral-window tap samples of one source view over a bucket-sorted
// pixel stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpmvs_tpu/ops/pallas_ncc.py::_sample_view_vals
// (pallas_ncc.py:733; its pallas_call runs _kernel with emit_vals=True),
// which ncc_eval_pallas_sorted calls once per source view. For sorted
// position i of the stream it reads pixel p = perm[i] (x, y and its plane,
// 24 B) and writes T + 1 values: the T bilinear tap samples and a flag, 1.0
// where the centre projects off the view or a tap leaves the footprint-cap
// box, else 0.0. It computes what mpmvs_torch/ops/ncc_sorted.py::
// sample_view_vals_plain computes; the ZNCC runs afterwards in PyTorch, in
// pixel order (ncc_sorted.zncc_from_samples).
//
// Why a sorted stream: the path serves incoherent fields (a random depth
// per pixel), whose 36-tap windows land anywhere along each pixel's
// epipolar line. Unsorted, a warp's 32 threads read 32 unrelated source
// regions; sorted by the bucket of the projected centre (the wrapper sorts
// with torch.sort), a warp's taps fall in a few neighbouring texel rows and
// hit in L1.
//
// What bounds it on an H100: bytes. Per pixel it reads 32 B (perm, x, y,
// plane) and writes (T + 1) x 4 = 148 B, against ~28 flops per tap; the
// source view (27 MB at 3200x2130) is read once into L2. The TPU kernel's
// slab/window sweep, SMEM range tables and DMA do not carry over: this
// first form is one thread per sorted position, four __ldg point loads per
// tap, with the homography and tap arithmetic of ncc_eval.cu (ncc_tap.cuh).
//
// Output layout: column i, sorted order (coalesced stores); the wrapper
// un-permutes with one index_copy_. Of the two layouts timed, this is the
// faster: over the 10 views of the 3200x2130 init field, 12.5 ms of kernel
// + 48.7 ms of index_copy_ against 137.7 ms for a variant of this kernel
// that wrote column p (pixel order), whose scattered stores each cost a
// 32-byte sector (chip_smoke.py phase 7 as it stood when the variant was
// timed; NVIDIA H100 80GB HBM3, 700 W).
//
// Rounding: as ncc_eval.cu, -fmad=false, IEEE division, no
// --use_fast_math, so a sample equals the plain version's bit for bit.

#include <stdint.h>

#include "ncc_tap.cuh"

__global__ void __launch_bounds__(128)
ncc_samples_kernel(const int64_t* __restrict__ perm,    // (N,)
                   const float* __restrict__ xg,        // (N,) pixel order
                   const float* __restrict__ yg,        // (N,)
                   const float4* __restrict__ planes,   // (N,)
                   const float* __restrict__ img,       // (Hp, Wp)
                   const float* __restrict__ wh,        // (2,)
                   const float* __restrict__ ab,        // (12,)
                   const float* __restrict__ kinvt,     // (9,) K_ref^-T
                   NccTaps taps, int N, int Hp, int Wp, float cap_radius,
                   float* __restrict__ out) {           // (T + 1, N)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t p = __ldg(perm + i);

  NccView v;
  load_view(wh, ab, Hp, Wp, &v);
  float kt[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) kt[j] = __ldg(kinvt + j);

  const float x = __ldg(xg + p);
  const float y = __ldg(yg + p);
  const float4 pl = planes[p];
  const bool cap = cap_radius > 0.0f;
  NccHomography h;
  plane_homography(v, kt, pl, x, y, cap_radius, &h);

  for (int t = 0; t < taps.n; ++t) {
    out[(size_t)t * N + i] = tap_sample(img, Wp, v, &h, (float)taps.dx[t],
                                        (float)taps.dy[t], cap);
  }
  out[(size_t)taps.n * N + i] = h.bad ? 1.0f : 0.0f;
}

extern "C" int ncc_samples_launch(const int64_t* perm, const float* x,
                                  const float* y, const float* planes,
                                  const float* img, const float* wh,
                                  const float* ab, const float* kinvt,
                                  NccTaps taps, int N, int Hp, int Wp,
                                  float cap_radius, float* out,
                                  void* stream) {
  if (taps.n < 1 || taps.n > NCC_MAX_TAPS || N < 1 || Hp < 1 || Wp < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  ncc_samples_kernel<<<(N + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      perm, x, y, reinterpret_cast<const float4*>(planes), img, wh, ab,
      kinvt, taps, N, Hp, Wp, cap_radius, out);
  return (int)cudaGetLastError();
}
