// K-stacked bilateral-ZNCC matching cost for Hopper (sm_90a).
//
// Replaces the TPU kernel mpmvs_tpu/ops/pallas_ncc.py::_kernel, which the
// JAX package calls as ncc_eval_pallas_multi (K stacked plane fields) and
// ncc_eval_pallas (K = 1). For every (hypothesis k, source view s, pixel p)
// it computes what mpmvs_torch/ops/ncc.py::ncc_eval computes: the
// plane-induced homography, the 6 x 6 window taps, the footprint-cap box,
// clamped bilinear source samples and the bilateral-weighted ZNCC against
// the reference-side moments (NCCRefSide). out[k, s, p] in [0, cost_max].
//
// What bounds it on an H100: the source fetches. One thread scores one
// (pixel, view) for all K hypotheses; a warp is 32 consecutive pixels of
// one view. With the fetches replaced by a constant the kernel takes ~16 ms
// at K = 9, S = 10 over 2130 x 1600 pixels, with them ~38-57 ms (a band
// step's own candidates 38-41 ms): the 36 x 2 x 2 texel quads per (k, s,
// p), served from L1 and L2, are most of the time (PERF.md section 6).
// What the design does about it:
//   * one tex2Dgather per tap returns the 2 x 2 quad (bilinear_tex in
//     ncc_tap.cuh; one texture object per view over a CUDA array made for
//     gather, which holds a copy of the view in the card's 2-D block
//     layout): one instruction in place of four loads, 64-bit addresses
//     and the integer clamps. The clamp to the view's valid extent stays
//     in software (the texture spans the stored Hp x Wp), and the lerp is
//     the plain version's f32 arithmetic: no hardware filtering, whose
//     weights have 8 bits;
//   * the reference side moves less. In the tile launch a block owns 32
//     pixels for up to NCC_VIEWS_MAX views (one warp each): it copies their
//     w and wr (36 + 36 floats a pixel) into shared memory once and
//     computes m / w of each hypothesis once (plane_scale), and every warp
//     of the block reads them there, instead of K x S reads through L1/L2.
//     Shared memory stays small (12.7 KB at K = 9), so L1 keeps its room
//     for the source quads;
//   * the window is a compile-time 6 x 6 grid: dx col_x is formed once per
//     window column, the tap offsets come in by value (NccAxis), and no
//     per-tap parameter is loaded.
// The view-major launch (scattered fields: full-range random depths, whose
// taps land anywhere on the view) gives each view its own grid row, so the
// card works through the views one after the other and the one view in
// flight stays in L2; there each thread reads w and wr through L1 and
// computes m / w itself. On a band step's K = 9 candidates, and on its
// trial call with banded random depths, the tile launch is 1.05-1.3x
// faster than the view-major one; on the trial call with full-range depths
// the view-major one is 1.14x faster, on a full-range init field 1.8x
// (PERF.md section 6).
//
// Rounding: the operations follow the plain version one for one. Build
// with -fmad=false (PyTorch's eager ops round every multiply and add) and
// without --use_fast_math: divisions are IEEE (one ulp of a coordinate can
// move a tap to another texel). NaN propagates through clip and max as it
// does in torch.clamp. The homography, the tap arithmetic and the ZNCC
// tail live in ncc_tap.cuh, shared with ncc_samples.cu (the sorted path's
// kernel).

#include <stdint.h>

#include "ncc_tap.cuh"

#define NCC_TILE 32        // pixels of a tile block: one lane each
#define NCC_VIEWS_MAX 10   // views (warps) of a tile block
#define NCC_VM_THREADS 128 // pixels of a view-major block
#define NCC_AXIS 6
#define NCC_WIN (NCC_AXIS * NCC_AXIS)

// Tap offsets along one axis, evenly spaced integers; tap t = a * NCC_AXIS
// + b sits at (dx, dy) = (v[a], v[b]), the order of
// PatchMatchParams.tap_offsets.
struct NccAxis {
  float v[NCC_AXIS];
};

// The K costs of one (pixel p, view s): out[k, s, p]. m / w of hypothesis
// k is sc[3 k + c] at stride sc_stride (TILE: from the block's shared
// copy) or, with sc null, computed here from planes; w[t] and wr[t] of the
// pixel are wt[t * w_stride] and wrt[t * w_stride].
template <bool CAP>
__device__ __forceinline__ void score_view(
    const float* sc_tile, int sc_stride, const float4* __restrict__ planes,
    const float* __restrict__ kinvt, const float* wt, const float* wrt,
    size_t w_stride, cudaTextureObject_t tex, const NccView& v,
    const NccAxis& axis, int K, int S, int P, int s, int p, float x, float y,
    float iw, float mr, float vr, float cost_max, float cap_radius,
    float* __restrict__ out) {
  float kt[9];
  if (sc_tile == nullptr) {
#pragma unroll
    for (int c = 0; c < 9; ++c) kt[c] = __ldg(kinvt + c);
  }
  for (int k = 0; k < K; ++k) {
    float sc[3];
    if (sc_tile != nullptr) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sc[c] = sc_tile[(3 * k + c) * sc_stride];
    } else {
      plane_scale(kt, planes[(size_t)k * P + p], sc);
    }
    NccHomography h;
    view_homography(v, sc, x, y, cap_radius, &h);
    NccSums sums = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int a = 0; a < NCC_AXIS; ++a) {
      // h = (h_p + dx col_x) + dy col_y, as tap_sample rounds it; the
      // axis is evenly spaced, so v[a] = v[0] + a (v[1] - v[0]) exactly
      const float dx = axis.v[0] + (float)a * (axis.v[1] - axis.v[0]);
      const float hx0 = h.hp[0] + dx * h.colx[0];
      const float hx1 = h.hp[1] + dx * h.colx[1];
      const float hx2 = h.hp[2] + dx * h.colx[2];
      const float* tw = wt + (size_t)a * NCC_AXIS * w_stride;
      const float* twr = wrt + (size_t)a * NCC_AXIS * w_stride;
#pragma unroll
      for (int b = 0; b < NCC_AXIS; ++b) {
        const float dy = axis.v[b];
        float xs, ys;
        tap_point(hx0 + dy * h.coly[0], hx1 + dy * h.coly[1],
                  hx2 + dy * h.coly[2], &h, CAP, &xs, &ys);
        zncc_add(&sums, tw[b * w_stride], twr[b * w_stride],
                 bilinear_tex(tex, v, xs, ys));
      }
    }

    out[((size_t)k * S + s) * P + p] =
        zncc_cost(sums, iw, mr, vr, h.bad, cost_max);
  }
}

// The tile launch: block (NCC_TILE, views of the block), grid (tiles, view
// groups). Shared memory: the tile's w and wr [NCC_WIN][NCC_TILE], then
// m / w of each hypothesis [K][3][NCC_TILE].
template <bool CAP>
__global__ void __launch_bounds__(NCC_TILE * NCC_VIEWS_MAX)
ncc_tile_kernel(const float* __restrict__ w,        // (T, P)
                const float* __restrict__ wr,       // (T, P)
                const float* __restrict__ inv_w,    // (P,)
                const float* __restrict__ m_ref,    // (P,)
                const float* __restrict__ var_ref,  // (P,)
                const float4* __restrict__ planes,  // (K, P)
                const float* __restrict__ xg,       // (P,)
                const float* __restrict__ yg,       // (P,)
                const unsigned long long* __restrict__ texs,  // (S,)
                const float* __restrict__ wh,       // (S, 2)
                const float* __restrict__ ab,       // (S, 12)
                const float* __restrict__ kinvt,    // (9,) K_ref^-T
                NccAxis axis, int K, int S, int P, int Hp, int Wp,
                float cost_max, float cap_radius,
                float* __restrict__ out) {          // (K, S, P)
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_wr = s_w + NCC_WIN * NCC_TILE;
  float* s_sc = s_wr + NCC_WIN * NCC_TILE;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * NCC_TILE + lane;
  const int nthr = blockDim.y * NCC_TILE;
  const int base = blockIdx.x * NCC_TILE;
  const int np = min(NCC_TILE, P - base);

  for (int e = tid; e < NCC_WIN * NCC_TILE; e += nthr) {
    const int t = e / NCC_TILE, j = e % NCC_TILE;
    if (j < np) {
      s_w[e] = __ldg(w + (size_t)t * P + base + j);
      s_wr[e] = __ldg(wr + (size_t)t * P + base + j);
    }
  }
  for (int e = tid; e < K * NCC_TILE; e += nthr) {
    const int k = e / NCC_TILE, j = e % NCC_TILE;
    if (j < np) {
      float kt[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) kt[c] = __ldg(kinvt + c);
      float sc[3];
      plane_scale(kt, planes[(size_t)k * P + base + j], sc);
#pragma unroll
      for (int c = 0; c < 3; ++c) s_sc[(3 * k + c) * NCC_TILE + j] = sc[c];
    }
  }
  __syncthreads();
  const int s = blockIdx.y * blockDim.y + threadIdx.y;
  if (s >= S || lane >= np) return;
  const int p = base + lane;
  NccView v;
  load_view(wh + 2 * s, ab + 12 * s, Hp, Wp, &v);
  score_view<CAP>(s_sc + lane, NCC_TILE, planes, kinvt, s_w + lane,
                  s_wr + lane, NCC_TILE, texs[s], v, axis, K, S, P, s, p,
                  __ldg(xg + p), __ldg(yg + p), __ldg(inv_w + p),
                  __ldg(m_ref + p), __ldg(var_ref + p), cost_max,
                  cap_radius, out);
}

// The view-major launch: grid (pixel blocks, S), one thread per pixel.
template <bool CAP>
__global__ void __launch_bounds__(NCC_VM_THREADS)
ncc_view_major_kernel(const float* __restrict__ w,        // (T, P)
                      const float* __restrict__ wr,       // (T, P)
                      const float* __restrict__ inv_w,    // (P,)
                      const float* __restrict__ m_ref,    // (P,)
                      const float* __restrict__ var_ref,  // (P,)
                      const float4* __restrict__ planes,  // (K, P)
                      const float* __restrict__ xg,       // (P,)
                      const float* __restrict__ yg,       // (P,)
                      const unsigned long long* __restrict__ texs,  // (S,)
                      const float* __restrict__ wh,       // (S, 2)
                      const float* __restrict__ ab,       // (S, 12)
                      const float* __restrict__ kinvt,    // (9,)
                      NccAxis axis, int K, int S, int P, int Hp, int Wp,
                      float cost_max, float cap_radius,
                      float* __restrict__ out) {          // (K, S, P)
  const int p = blockIdx.x * NCC_VM_THREADS + threadIdx.x;
  const int s = blockIdx.y;
  if (p >= P) return;
  NccView v;
  load_view(wh + 2 * s, ab + 12 * s, Hp, Wp, &v);
  score_view<CAP>(nullptr, 0, planes, kinvt, w + p, wr + p, (size_t)P,
                  texs[s], v, axis, K, S, P, s, p, __ldg(xg + p),
                  __ldg(yg + p), __ldg(inv_w + p), __ldg(m_ref + p),
                  __ldg(var_ref + p), cost_max, cap_radius, out);
}

// Shared memory of a tile block for K hypotheses.
static size_t tile_smem_bytes(int K) {
  return (size_t)(2 * NCC_WIN + 3 * K) * NCC_TILE * sizeof(float);
}

extern "C" int ncc_eval_max_k(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (int)(((size_t)optin / (NCC_TILE * sizeof(float)) - 2 * NCC_WIN) /
               3);
}

// scattered != 0 takes the view-major launch, else the tile launch.
extern "C" int ncc_eval_multi_launch(
    const float* w, const float* wr, const float* inv_w, const float* m_ref,
    const float* var_ref, const float* planes, const float* x, const float* y,
    const unsigned long long* texs, const float* wh, const float* ab,
    const float* kinvt, NccAxis axis, int K, int S, int P, int Hp, int Wp,
    float cost_max, float cap_radius, int scattered, float* out,
    void* stream) {
  if (K < 1 || S < 1 || P < 1 || S > 65535 || K > ncc_eval_max_k())
    return (int)cudaErrorInvalidValue;
  const bool cap = cap_radius > 0.0f;
  const float4* pl = reinterpret_cast<const float4*>(planes);
  cudaStream_t st = (cudaStream_t)stream;
  if (scattered) {
    auto kern = cap ? ncc_view_major_kernel<true>
                    : ncc_view_major_kernel<false>;
    dim3 grid((P + NCC_VM_THREADS - 1) / NCC_VM_THREADS, S);
    kern<<<grid, NCC_VM_THREADS, 0, st>>>(w, wr, inv_w, m_ref, var_ref, pl,
                                          x, y, texs, wh, ab, kinvt, axis, K,
                                          S, P, Hp, Wp, cost_max, cap_radius,
                                          out);
    return (int)cudaGetLastError();
  }
  auto kern = cap ? ncc_tile_kernel<true> : ncc_tile_kernel<false>;
  const size_t smem = tile_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the views split into the fewest groups of at most NCC_VIEWS_MAX, as
  // even as they can be
  const int groups = (S + NCC_VIEWS_MAX - 1) / NCC_VIEWS_MAX;
  dim3 grid((P + NCC_TILE - 1) / NCC_TILE, groups);
  dim3 block(NCC_TILE, (S + groups - 1) / groups);
  kern<<<grid, block, smem, st>>>(w, wr, inv_w, m_ref, var_ref, pl, x, y,
                                  texs, wh, ab, kinvt, axis, K, S, P, Hp, Wp,
                                  cost_max, cap_radius, out);
  return (int)cudaGetLastError();
}

// One texture object per view of the (S, H, W) stack, over a CUDA array
// made for gather (cudaArrayTextureGather) that holds a copy of the view,
// copied on ``stream``: point filtering, clamp addressing, unnormalised
// coordinates. arrays[s] and handles[s] receive the array and the object;
// on failure everything made so far is freed.
extern "C" int ncc_free_textures(void** arrays,
                                 const unsigned long long* handles, int S);

extern "C" int ncc_make_textures(const float* src, int S, int H, int W,
                                 void* stream, void** arrays,
                                 unsigned long long* handles) {
  const cudaChannelFormatDesc desc = cudaCreateChannelDesc<float>();
  cudaStream_t st = (cudaStream_t)stream;
  for (int s = 0; s < S; ++s) {
    arrays[s] = nullptr;
    handles[s] = 0;
  }
  for (int s = 0; s < S; ++s) {
    cudaArray_t arr = nullptr;
    cudaError_t err = cudaMallocArray(&arr, &desc, W, H,
                                      cudaArrayTextureGather);
    if (err == cudaSuccess) {
      arrays[s] = arr;
      err = cudaMemcpy2DToArrayAsync(arr, 0, 0, src + (size_t)s * H * W,
                                     (size_t)W * sizeof(float),
                                     (size_t)W * sizeof(float), H,
                                     cudaMemcpyDeviceToDevice, st);
    }
    if (err == cudaSuccess) {
      cudaResourceDesc rd = {};
      rd.resType = cudaResourceTypeArray;
      rd.res.array.array = arr;
      cudaTextureDesc td = {};
      td.addressMode[0] = cudaAddressModeClamp;
      td.addressMode[1] = cudaAddressModeClamp;
      td.filterMode = cudaFilterModePoint;
      td.readMode = cudaReadModeElementType;
      td.normalizedCoords = 0;
      cudaTextureObject_t tex = 0;
      err = cudaCreateTextureObject(&tex, &rd, &td, nullptr);
      handles[s] = (unsigned long long)tex;
    }
    if (err != cudaSuccess) {
      ncc_free_textures(arrays, handles, S);
      return (int)err;
    }
  }
  return 0;
}

// Destroys the texture objects and frees the arrays of ncc_make_textures
// (null entries are skipped); the caller makes sure no launch still reads
// them. Returns the first error.
extern "C" int ncc_free_textures(void** arrays,
                                 const unsigned long long* handles, int S) {
  int first = 0;
  for (int s = 0; s < S; ++s) {
    cudaError_t err = cudaSuccess;
    if (handles[s] != 0) err = cudaDestroyTextureObject(handles[s]);
    if (err == cudaSuccess && arrays[s] != nullptr)
      err = cudaFreeArray((cudaArray_t)arrays[s]);
    if (err != cudaSuccess && first == 0) first = (int)err;
  }
  return first;
}
