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
// What bounds it on an H100: instruction issue and the SM's shared/L1
// data path. A 3200x2130 view is 6.8 M pixels x 1369 taps = 9.3 G taps,
// while its inputs are 109 MB: far under the memory roof. The first form
// spent ~40 instructions a tap: four scalar shared loads, the colour
// distance, the IEEE sqrt and the library expf (each a special-function
// instruction plus range reduction, correction and a call to a slow path),
// the weight and sums, and per-tap image-bounds tests. What this design
// does about it:
//   * one shared load a tap: a block of 32x8 output pixels stages its tile
//     plus the R-pixel halo once, a texel per tap load;
//   * no per-tap bounds test in interior blocks: at R = 18 a block whose
//     whole window lies inside the image runs a window whose row is
//     unrolled at compile time (offsets fold into the loads'
//     immediates). Edge blocks, and other radii, keep a test per tap;
//   * the float form (float4 texels B, G, R, prob: 47.9 KB at R = 18)
//     computes the colour factor per tap;
//   * the table form for 8-bit guides (uint2 texels: B, G, R as bytes and
//     prob's bits, 23.9 KB at R = 18, so a float4 load's 4 cycles of
//     shared bandwidth a warp become 2). With B, G and R integers in
//     [0, 255], d2 = db^2 + dg^2 + dr^2 is an exact integer <= 195075: one
//     per-byte |difference| and one 4-way integer dot product give it,
//     equal to the float form's d2, and the colour factor
//     expf(-sqrtf(d2) / sigma_color) is entry d2 of a table that
//     bilateral_table_kernel builds with this file's own expression, read
//     through __ldg from L1/L2 (780 KB; a copy of its first entries in
//     shared memory cost more in the per-tap test than it saved, PERF.md
//     section 6). The wrapper takes this form only when every guide value
//     is an integer in [0, 255]; any other guide takes the float form.
// The spatial weights sit in __constant__ memory, read by all lanes of a
// warp at the same address.
//
// Rounding: every multiply and add of this file is an explicit _rn
// intrinsic, so none is contracted into an FMA, as in the plain version's
// eager ops; sqrt is IEEE and exp is the CUDA library's expf, the functions
// torch.sqrt and torch.exp call on the card. The colour term multiplies by
// 1/sigma_color like the plain version (exact for the sky's 8). Taps run in
// the plain version's order, row-major in (dy, dx), so the sums agree; a
// table entry is the float form's weight of the same d2 bit for bit.

#include <cuda_runtime.h>

#define BL_TILE_W 32
#define BL_TILE_H 8
#define BL_MAX_RADIUS 24
#define BL_SKY_RADIUS 18  // the radius whose interior blocks are unrolled
#define BL_TABLE_SIZE (3 * 255 * 255 + 1)

__constant__ float c_sw[(2 * BL_MAX_RADIUS + 1) * (2 * BL_MAX_RADIUS + 1)];

// The colour factor of squared distance d2.
__device__ __forceinline__ float colour_exact(float d2, float inv_sigma) {
  return expf(__fmul_rn(-__fsqrt_rn(d2), inv_sigma));
}

// A texel of the float form: B, G, R, prob.
__device__ __forceinline__ void make_texel(float b, float g, float r,
                                           float p, float4* t) {
  *t = make_float4(b, g, r, p);
}

// A texel of the table form: B, G and R as the bytes 0-2 of x (integers
// in [0, 255], as the wrapper checked), prob's bits in y.
__device__ __forceinline__ void make_texel(float b, float g, float r,
                                           float p, uint2* t) {
  *t = make_uint2(__float2uint_rz(b) | (__float2uint_rz(g) << 8) |
                      (__float2uint_rz(r) << 16),
                  __float_as_uint(p));
}

// One tap of the float form: the colour factor of d2 computed (table
// unused).
__device__ __forceinline__ void tap(float4 q, float4 c, float sw,
                                    float inv_sigma,
                                    const float* __restrict__ table,
                                    float* num, float* den) {
  const float db = __fsub_rn(q.x, c.x);
  const float dg = __fsub_rn(q.y, c.y);
  const float dr = __fsub_rn(q.z, c.z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(db, db), __fmul_rn(dg, dg)),
                             __fmul_rn(dr, dr));
  const float w = __fmul_rn(sw, colour_exact(d2, inv_sigma));
  *num = __fadd_rn(*num, __fmul_rn(w, q.w));
  *den = __fadd_rn(*den, w);
}

// One tap of the table form: d2 as an integer from the bytes (per-byte
// |difference|, then a 4-way dot product), the float form's d2 exactly,
// and its factor looked up.
__device__ __forceinline__ void tap(uint2 q, uint2 c, float sw,
                                    float inv_sigma,
                                    const float* __restrict__ table,
                                    float* num, float* den) {
  const unsigned diff = __vabsdiffu4(q.x, c.x);
  const unsigned d2 = __dp4a(diff, diff, 0u);
  const float w = __fmul_rn(sw, __ldg(table + d2));
  *num = __fadd_rn(*num, __fmul_rn(w, __uint_as_float(q.y)));
  *den = __fadd_rn(*den, w);
}

// The whole window of an interior pixel at compile-time radius R.
template <int R, typename Texel>
__device__ __forceinline__ void window_interior(const Texel* centre, int tw,
                                                Texel c, float inv_sigma,
                                                const float* table,
                                                float* num, float* den) {
#pragma unroll 1
  for (int dy = -R; dy <= R; ++dy) {
    const Texel* row = centre + dy * tw;
    const int sw = (dy + R) * (2 * R + 1) + R;  // c_sw index of (dy, 0)
#pragma unroll
    for (int dx = -R; dx <= R; ++dx)
      tap(row[dx], c, c_sw[sw + dx], inv_sigma, table, num, den);
  }
}

// The window of pixel (ox, oy) at any radius, taps outside the image
// skipped by a test each.
template <typename Texel>
__device__ __forceinline__ void window_tested(
    const Texel* centre, int tw, int radius, int ox, int oy, int H, int W,
    Texel c, float inv_sigma, const float* table, float* num, float* den) {
  const int n = 2 * radius + 1;
  for (int dy = -radius; dy <= radius; ++dy) {
    if (oy + dy < 0 || oy + dy >= H) continue;  // the whole row is outside
    const Texel* row = centre + dy * tw;
    const int sw = (dy + radius) * n + radius;  // c_sw index of (dy, 0)
    for (int dx = -radius; dx <= radius; ++dx) {
      if (ox + dx < 0 || ox + dx >= W) continue;
      tap(row[dx], c, c_sw[sw + dx], inv_sigma, table, num, den);
    }
  }
}

// Texel: float4 (the float form) or uint2 (the table form).
template <typename Texel>
__global__ void __launch_bounds__(BL_TILE_W * BL_TILE_H)
bilateral_refine_kernel(const float* __restrict__ bgr,   // (H, W, 3)
                        const float* __restrict__ prob,  // (H, W)
                        const float* __restrict__ table, // (BL_TABLE_SIZE,)
                        int H, int W, int radius,
                        float inv_sigma_color,
                        float* __restrict__ out) {       // (H, W)
  extern __shared__ float4 smem_f4[];  // 16-byte aligned
  Texel* smem = reinterpret_cast<Texel*>(smem_f4);
  const int tw = BL_TILE_W + 2 * radius;
  const int plane = tw * (BL_TILE_H + 2 * radius);
  const int tid = threadIdx.y * BL_TILE_W + threadIdx.x;

  // stage the tile and its halo; outside the image the values are never read
  const int x0 = blockIdx.x * BL_TILE_W - radius;
  const int y0 = blockIdx.y * BL_TILE_H - radius;
  for (int i = tid; i < plane; i += BL_TILE_W * BL_TILE_H) {
    const int gy = y0 + i / tw;
    const int gx = x0 + i % tw;
    Texel q;
    make_texel(0.0f, 0.0f, 0.0f, 0.0f, &q);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t o = (size_t)gy * W + gx;
      make_texel(__ldg(bgr + 3 * o), __ldg(bgr + 3 * o + 1),
                 __ldg(bgr + 3 * o + 2), __ldg(prob + o), &q);
    }
    smem[i] = q;
  }
  __syncthreads();

  const int ox = blockIdx.x * BL_TILE_W + threadIdx.x;
  const int oy = blockIdx.y * BL_TILE_H + threadIdx.y;
  if (ox >= W || oy >= H) return;
  const Texel* centre =
      smem + (threadIdx.y + radius) * tw + threadIdx.x + radius;
  const Texel c = *centre;

  float num = 0.0f, den = 0.0f;
  const bool interior = x0 >= 0 && x0 + tw <= W && y0 >= 0 &&
                        y0 + BL_TILE_H + 2 * radius <= H;
  if (radius == BL_SKY_RADIUS && interior) {
    window_interior<BL_SKY_RADIUS>(centre, tw, c, inv_sigma_color, table,
                                   &num, &den);
  } else {
    window_tested(centre, tw, radius, ox, oy, H, W, c, inv_sigma_color,
                  table, &num, &den);
  }
  out[(size_t)oy * W + ox] = __fdiv_rn(num, fmaxf(den, 1e-12f));
}

// table[i] = the float form's colour factor of d2 = i, for i < n.
__global__ void bilateral_table_kernel(float inv_sigma_color, int n,
                                       float* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) table[i] = colour_exact((float)i, inv_sigma_color);
}

extern "C" int bilateral_table_size(void) { return BL_TABLE_SIZE; }

extern "C" int bilateral_table_launch(float inv_sigma_color, float* table,
                                      void* stream) {
  bilateral_table_kernel<<<(BL_TABLE_SIZE + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>(inv_sigma_color,
                                                   BL_TABLE_SIZE, table);
  return (int)cudaGetLastError();
}

// sw_host: the (2R+1)^2 spatial weights, row-major in (dy, dx), in host
// memory; copied to constant memory on `stream` ahead of the launch.
// table null: the float form; else the table form.
extern "C" int bilateral_refine_launch(const float* bgr, const float* prob,
                                       int H, int W, int radius,
                                       const float* sw_host,
                                       float inv_sigma_color,
                                       const float* table, float* out,
                                       void* stream) {
  if (radius < 0 || radius > BL_MAX_RADIUS || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 2 * radius + 1;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_sw, sw_host, sizeof(float) * n * n, 0, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (table ? sizeof(uint2) : sizeof(float4)) *
                      (BL_TILE_W + 2 * radius) * (BL_TILE_H + 2 * radius);
  auto kern = table ? bilateral_refine_kernel<uint2>
                    : bilateral_refine_kernel<float4>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(BL_TILE_W, BL_TILE_H);
  dim3 grid((W + BL_TILE_W - 1) / BL_TILE_W, (H + BL_TILE_H - 1) / BL_TILE_H);
  kern<<<grid, block, smem, st>>>(bgr, prob, table, H, W, radius,
                                  inv_sigma_color, out);
  return (int)cudaGetLastError();
}
