// Joint bilateral refinement of the sky probability map for Hopper (sm_90a).
//
// Replaces the TPU kernel mpmvs_tpu/ops/pallas_bilateral.py::_kernel, which
// the JAX package calls as bilateral_refine_pallas. For every pixel it
// computes what mpmvs_torch/ops/bilateral_cuda.py::bilateral_refine_plain
// computes over the (2R+1)^2 window (R = 18 in the sky stage):
//     w   = sw[dy, dx] * exp(-|BGR(p + d) - BGR(p)| / sigma_color)
//     out = sum w * prob(p + d) / max(sum w, 1e-12),
// with sw = exp(-|d| / sigma_spatial) a per-tap table and taps outside the
// image skipped (the TPU kernel gives them weight 0 through a sentinel
// colour).
//
// What bounds it on an H100: the special-function and FMA pipes. A
// 3200x2130 view is 6.8 M pixels x 1369 taps = 9.3 G (sqrt, exp) pairs,
// while its inputs are 109 MB: well under the memory roof. The TPU kernel's
// 8-row slab DMA existed to keep a band in VMEM; here a block of 32x8
// output pixels stages its tile plus the R-pixel halo as four planes (B, G,
// R, prob) in shared memory, (32 + 2R) x (8 + 2R) x 4 floats = 47.9 KB at
// R = 18, one thread per output pixel reads its taps from there, and the
// spatial weights sit in __constant__ memory, read by all lanes of a warp
// at the same address. The ragged edge is masked.
//
// Rounding: every multiply and add of this file is an explicit _rn
// intrinsic, so none is contracted into an FMA, as in the plain version's
// eager ops; sqrt is IEEE and exp is the CUDA library's expf, the functions
// torch.sqrt and torch.exp call on the card. The colour term multiplies by
// 1/sigma_color like the plain version (exact for the sky's 8). Taps run in
// the plain version's order, row-major in (dy, dx), so the sums agree.

#include <cuda_runtime.h>

#define BL_TILE_W 32
#define BL_TILE_H 8
#define BL_MAX_RADIUS 24

__constant__ float c_sw[(2 * BL_MAX_RADIUS + 1) * (2 * BL_MAX_RADIUS + 1)];

__global__ void __launch_bounds__(BL_TILE_W * BL_TILE_H)
bilateral_refine_kernel(const float* __restrict__ bgr,   // (H, W, 3)
                        const float* __restrict__ prob,  // (H, W)
                        int H, int W, int radius, float inv_sigma_color,
                        float* __restrict__ out) {       // (H, W)
  extern __shared__ float smem[];
  const int n = 2 * radius + 1;
  const int tw = BL_TILE_W + 2 * radius;
  const int plane = tw * (BL_TILE_H + 2 * radius);
  float* sB = smem;
  float* sG = smem + plane;
  float* sR = smem + 2 * plane;
  float* sP = smem + 3 * plane;

  // stage the tile and its halo; outside the image the values are never read
  const int x0 = blockIdx.x * BL_TILE_W - radius;
  const int y0 = blockIdx.y * BL_TILE_H - radius;
  for (int i = threadIdx.y * BL_TILE_W + threadIdx.x; i < plane;
       i += BL_TILE_W * BL_TILE_H) {
    const int gy = y0 + i / tw;
    const int gx = x0 + i % tw;
    float b = 0.0f, g = 0.0f, r = 0.0f, p = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t o = (size_t)gy * W + gx;
      b = __ldg(bgr + 3 * o);
      g = __ldg(bgr + 3 * o + 1);
      r = __ldg(bgr + 3 * o + 2);
      p = __ldg(prob + o);
    }
    sB[i] = b;
    sG[i] = g;
    sR[i] = r;
    sP[i] = p;
  }
  __syncthreads();

  const int ox = blockIdx.x * BL_TILE_W + threadIdx.x;
  const int oy = blockIdx.y * BL_TILE_H + threadIdx.y;
  if (ox >= W || oy >= H) return;
  const int centre = (threadIdx.y + radius) * tw + threadIdx.x + radius;
  const float cb = sB[centre], cg = sG[centre], cr = sR[centre];

  float num = 0.0f, den = 0.0f;
  for (int dy = -radius; dy <= radius; ++dy) {
    if (oy + dy < 0 || oy + dy >= H) continue;  // the whole row is outside
    const int row = centre + dy * tw;
    const int sw = (dy + radius) * n + radius;  // c_sw index of (dy, 0)
    for (int dx = -radius; dx <= radius; ++dx) {
      if (ox + dx < 0 || ox + dx >= W) continue;
      const int j = row + dx;
      const float db = __fsub_rn(sB[j], cb);
      const float dg = __fsub_rn(sG[j], cg);
      const float dr = __fsub_rn(sR[j], cr);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(db, db), __fmul_rn(dg, dg)),
                                 __fmul_rn(dr, dr));
      const float dc = __fsqrt_rn(d2);
      const float w = __fmul_rn(c_sw[sw + dx], expf(__fmul_rn(-dc, inv_sigma_color)));
      num = __fadd_rn(num, __fmul_rn(w, sP[j]));
      den = __fadd_rn(den, w);
    }
  }
  out[(size_t)oy * W + ox] = __fdiv_rn(num, fmaxf(den, 1e-12f));
}

// sw_host: the (2R+1)^2 spatial weights, row-major in (dy, dx), in host
// memory; copied to constant memory on `stream` ahead of the launch.
extern "C" int bilateral_refine_launch(const float* bgr, const float* prob,
                                       int H, int W, int radius,
                                       const float* sw_host,
                                       float inv_sigma_color, float* out,
                                       void* stream) {
  if (radius < 0 || radius > BL_MAX_RADIUS || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 2 * radius + 1;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_sw, sw_host, sizeof(float) * n * n, 0, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * 4 * (BL_TILE_W + 2 * radius) *
                      (BL_TILE_H + 2 * radius);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bilateral_refine_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(BL_TILE_W, BL_TILE_H);
  dim3 grid((W + BL_TILE_W - 1) / BL_TILE_W, (H + BL_TILE_H - 1) / BL_TILE_H);
  bilateral_refine_kernel<<<grid, block, smem, st>>>(bgr, prob, H, W, radius,
                                                     inv_sigma_color, out);
  return (int)cudaGetLastError();
}
