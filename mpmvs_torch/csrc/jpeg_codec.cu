// JPEG decode and encode on the card for the port's workspace I/O (sm_90a),
// the host half of its PNG and TIFF reads, and its lossy WebP reads.
//
// No TPU kernel has this work: the JAX package reads and writes images with
// OpenCV (cv2.imread / cv2.imwrite, which code JPEGs with libjpeg-turbo).
// The machine with the card has no OpenCV, so the port codes here, and gives
// what OpenCV gives, bit for bit.
//
// Decoding:
//   * the host parses the file and entropy-decodes it to quantized DCT
//     coefficients as libjpeg does (jpeg_entropy.h: baseline, extended and
//     progressive Huffman, restart intervals); they are copied to the card;
//   * idct_islow_kernel runs libjpeg's accurate integer inverse DCT
//     (jidctint.c, jpeg_idct.h) with its dequantization and range limit,
//     one thread per 8x8 block, into each component's plane. nvJPEG's own
//     decode was tried first and differs: its inverse DCT is not jidctint
//     (1.3-2.1% of grey values off by 1 on the H100);
//   * ycc_to_bgr_kernel (one or three components) and cmyk_to_bgr_kernel
//     (four: CMYK or YCCK) upsample each component by its own rule and make
//     interleaved BGR and grey with libjpeg-turbo's integer arithmetic and
//     OpenCV's conversions (jpeg_colour.h says which):
//       - fancy (triangle) upsampling of jdsample.c for a component at half
//         the largest factor in one or both axes, replication for every
//         other integer ratio and for components 1 or 2 samples wide;
//       - YCbCr: jdcolor.c's fixed-point YCbCr -> RGB; the grey image is the
//         Y plane itself, upsampled (written by the launch) when Y is not
//         the largest component (cv2.imread(IMREAD_GRAYSCALE) of a YCbCr
//         JPEG is libjpeg's Y component, not a conversion of BGR);
//       - RGB components (libjpeg's guess, jpeg_entropy.h): the samples in
//         B, G, R order, and the grey image rgb_gray_convert's, written by
//         the same launch;
//       - CMYK and YCCK: libjpeg's CMYK (ycck_cmyk_convert for YCCK), then
//         OpenCV's CMYK -> BGR and CMYK -> grey, both written by the one
//         launch;
//     a one-component JPEG gives B = G = R = Y, as cv2 gives it. An EXIF
//     orientation is applied to both images on the card afterwards
//     (io/images.py).
//
// Encoding gives cv2.imencode's bytes (quality q, 4:2:0 or grey):
//   * bgr_to_ycc_kernel: libjpeg-turbo's BGR -> YCbCr, edge expansion and
//     2x2 chroma downsampling (jpeg_fdct.h), one thread per 2x2 group;
//   * fdct_islow_quant_kernel: level shift, jfdctint's forward DCT and
//     libjpeg-turbo's reciprocal quantization, one thread per block;
//   * the host Huffman-codes the coefficients with the standard tables and
//     writes libjpeg's markers (jpeg_encode.h). That pass is bit-serial.
//     nvJPEG's encoder writes other bytes than cv2: its colour conversion,
//     DCT and rounding are its own.
//
// What bounds the kernels: bytes. The IDCT reads 2 bytes a coefficient and
// writes 1 a sample, the YCbCr colour kernel reads 1.5 bytes a pixel
// (4:2:0) and writes 3, the four-component one reads up to 4 and writes 4
// (BGR and grey); bgr_to_ycc reads 3 and writes 1.5, the forward DCT reads 1 a
// sample and writes 2 a coefficient. The host's entropy coding takes far
// longer than any of them.
//
// PNG and TIFF reads: png_unfilter.h undoes a PNG's row filters and
// Adam7 interlacing on the host (png_unfilter_rows, png_adam7_rows),
// exif_orientation_tiff reads its eXIf; tiff_decode.h parses a TIFF and
// decompresses its strips or tiles on the host (tiff_host_info,
// tiff_host_layout, tiff_host_decode). The samples are copied to the card,
// where raster_to_bgr_kernel makes cv2.imread's BGR and grey images of them
// (raster_bgr.h: sub-8-bit grey expanded, palette looked up, 16 bits
// narrowed, alpha dropped or premultiplied, RGB to BGR, and the grey of a
// colour image by libpng's or OpenCV's arithmetic), one thread a pixel.
// It reads at most 8 bytes a pixel and writes 4.
//
// The C interface below is bound with ctypes by mpmvs_torch/io/images.py.
// Every function returns 0 or an error code: a decode error of
// jpeg_entropy.h (2001-2011), an encode or PNG error (2010, 3001-3002), a
// TIFF error (4001-4018), a WebP error (webp_decode.h, 5001-5007) or a CUDA
// error offset by 1000.

#include <cuda_runtime.h>

#include <stdint.h>
#include <stdlib.h>

#include "jpeg_colour.h"
#include "jpeg_encode.h"
#include "jpeg_entropy.h"
#include "jpeg_fdct.h"
#include "jpeg_idct.h"
#include "png_unfilter.h"
#include "raster_bgr.h"
#include "tiff_decode.h"
#include "vp8_filter.h"
#include "vp8_recon.h"
#include "webp_colour.h"
#include "webp_decode.h"

#define CODEC_CUDA_ERR 1000

// Parse and entropy-decode a JPEG on the host. info (39 ints) receives the
// number of components, the width and height, the EXIF orientation, the
// colour space (jpeg_entropy::Space), the largest sampling factors hmax and
// vmax, then from info[7] per component eight values: its plane's width and
// height (the sampled size, ceil(W * h / hmax)), the coefficient array's
// blocks across and down (padded to whole MCUs), the blocks that cover the
// plane across and down, and its factors h and v. *out holds the
// coefficients until jpeg_host_free.
extern "C" int jpeg_host_decode(const unsigned char* data, size_t length,
                                void** out, int* info) {
  jpeg_entropy::Decoder* d = new jpeg_entropy::Decoder();
  int err = jpeg_entropy::decode(d, data, length, false);
  if (err != 0) {
    delete d;
    return err;
  }
  info[0] = d->ncomp;
  info[1] = d->width;
  info[2] = d->height;
  info[3] = d->orientation;
  info[4] = d->space;
  info[5] = d->hmax;
  info[6] = d->vmax;
  for (int i = 0; i < d->ncomp; i++) {
    const jpeg_entropy::Component& c = d->comp[i];
    int* ci = info + 7 + 8 * i;
    ci[0] = (d->width * c.h + d->hmax - 1) / d->hmax;
    ci[1] = (d->height * c.v + d->vmax - 1) / d->vmax;
    ci[2] = c.blocks_w;
    ci[3] = c.blocks_h;
    ci[4] = c.width_in_blocks;
    ci[5] = c.height_in_blocks;
    ci[6] = c.h;
    ci[7] = c.v;
  }
  *out = d;
  return 0;
}

// Copy component comp's coefficients (blocks_h x blocks_w x 64 int16) and
// its quantization table (64 values, natural order) to the card.
extern "C" int jpeg_host_upload(void* img, int comp, short* coef,
                                unsigned short* qt, cudaStream_t stream) {
  jpeg_entropy::Decoder* d = (jpeg_entropy::Decoder*)img;
  const jpeg_entropy::Component& c = d->comp[comp];
  cudaError_t e = cudaMemcpyAsync(coef, c.coef.data(),
                                  c.coef.size() * sizeof(int16_t),
                                  cudaMemcpyHostToDevice, stream);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(qt, d->qt[c.tq], 64 * sizeof(uint16_t),
                        cudaMemcpyHostToDevice, stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

extern "C" void jpeg_host_free(void* img) {
  delete (jpeg_entropy::Decoder*)img;
}

// One thread per 8x8 block of the plane: libjpeg's islow IDCT of the
// block's coefficients into the plane's samples, cropped at its edge.
__global__ void idct_islow_kernel(const short* __restrict__ coef,
                                  const unsigned short* __restrict__ qt,
                                  int blocks_w, int width_in_blocks,
                                  int height_in_blocks,
                                  unsigned char* __restrict__ plane,
                                  int plane_w, int plane_h) {
  int bx = blockIdx.x * blockDim.x + threadIdx.x;
  int by = blockIdx.y;
  if (bx >= width_in_blocks || by >= height_in_blocks) return;
  int rows = min(8, plane_h - 8 * by), cols = min(8, plane_w - 8 * bx);
  if (rows <= 0 || cols <= 0) return;
  int16_t c[64];
  uint16_t q[64];
  const short* src = coef + ((size_t)by * blocks_w + bx) * 64;
  for (int k = 0; k < 64; k++) {
    c[k] = src[k];
    q[k] = qt[k];
  }
  jpeg_idct::idct_islow_block(c, q, plane + (size_t)(8 * by) * plane_w + 8 * bx,
                              plane_w, rows, cols);
}

extern "C" int idct_islow_launch(const short* coef, const unsigned short* qt,
                                 int blocks_w, int width_in_blocks,
                                 int height_in_blocks, unsigned char* plane,
                                 int plane_w, int plane_h,
                                 cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((width_in_blocks + 127) / 128, height_in_blocks);
  idct_islow_kernel<<<grid, block, 0, stream>>>(coef, qt, blocks_w,
                                                width_in_blocks,
                                                height_in_blocks, plane,
                                                plane_w, plane_h);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// The planes of n components (pointers and n x 5 ints: h, w, rh, rv, fancy,
// the fields of jpeg_colour::Plane) as the kernels take them.
static jpeg_colour::Planes planes_of(const unsigned char* const* ptrs,
                                     const int* geo, int n) {
  jpeg_colour::Planes pl = {};
  for (int i = 0; i < n; i++) {
    const int* g = geo + 5 * i;
    pl.c[i] = {ptrs[i], g[0], g[1], g[2], g[3], g[4]};
  }
  return pl;
}

// One thread a pixel of the (H, W) image of one or three components: BGR
// (H, W, 3) and, where gray is not NULL, grey (jpeg_colour.h ycc_pixel;
// form 0 YCbCr, 1 RGB).
__global__ void ycc_to_bgr_kernel(jpeg_colour::Planes pl, int n, int form,
                                  int H, int W,
                                  unsigned char* __restrict__ bgr,
                                  unsigned char* __restrict__ gray) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y;
  if (col >= W) return;
  size_t i = (size_t)r * W + col;
  jpeg_colour::ycc_pixel(pl, n, form, r, col, bgr + 3 * i,
                         gray ? gray + i : nullptr);
}

extern "C" int ycc_to_bgr_launch(const unsigned char* const* ptrs,
                                 const int* geo, int n, int form, int H,
                                 int W, unsigned char* bgr,
                                 unsigned char* gray, cudaStream_t stream) {
  dim3 block(256);
  dim3 grid((W + 255) / 256, H);
  ycc_to_bgr_kernel<<<grid, block, 0, stream>>>(planes_of(ptrs, geo, n), n,
                                                form, H, W, bgr, gray);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// One thread a pixel of the (H, W) image of four components, CMYK or
// (ycck) YCCK, each upsampled by its own rule: cv2.imread's BGR (H, W, 3)
// and grey (H, W), both written by the one launch (jpeg_colour.h
// cmyk_pixel). Row-major over a 1-D grid.
__global__ void cmyk_to_bgr_kernel(jpeg_colour::Planes pl, int ycck, int H,
                                   int W, unsigned char* __restrict__ bgr,
                                   unsigned char* __restrict__ gray) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)H * W) return;
  int r = (int)(i / W), col = (int)(i % W);
  jpeg_colour::cmyk_pixel(pl, ycck, r, col, bgr + 3 * i, gray + i);
}

extern "C" int cmyk_to_bgr_launch(const unsigned char* const* ptrs,
                                  const int* geo, int ycck, int H, int W,
                                  unsigned char* bgr, unsigned char* gray,
                                  cudaStream_t stream) {
  size_t n = (size_t)H * W;
  dim3 block(256);
  dim3 grid((unsigned)((n + 255) / 256));
  cmyk_to_bgr_kernel<<<grid, block, 0, stream>>>(planes_of(ptrs, geo, 4),
                                                 ycck, H, W, bgr, gray);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// The encoder's planes from an (H, W) image, BGR (channels 3) or grey
// (channels 1): one thread per 2x2 group of Y (y_h x y_w) and, for colour,
// per sample of Cb and Cr (g_h x g_w, the chroma planes' size; for grey the
// groups of Y). jpeg_fdct.h ycc_group says what each plane holds.
__global__ void bgr_to_ycc_kernel(const unsigned char* __restrict__ img,
                                  int H, int W, int channels,
                                  unsigned char* __restrict__ y, int y_h,
                                  int y_w, unsigned char* __restrict__ cb,
                                  unsigned char* __restrict__ cr, int g_h,
                                  int g_w) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int i = blockIdx.y;
  if (j >= g_w || i >= g_h) return;
  jpeg_fdct::ycc_group(img, H, W, channels, i, j, y, y_h, y_w, cb, cr, g_w);
}

extern "C" int bgr_to_ycc_launch(const unsigned char* img, int H, int W,
                                 int channels, unsigned char* y, int y_h,
                                 int y_w, unsigned char* cb, unsigned char* cr,
                                 int g_h, int g_w, cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((g_w + 127) / 128, g_h);
  bgr_to_ycc_kernel<<<grid, block, 0, stream>>>(img, H, W, channels, y, y_h,
                                                y_w, cb, cr, g_h, g_w);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// One thread per 8x8 block of a (8 bh, 8 bw) plane: the quantized
// coefficients (bh, bw, 64) in natural order, the layout idct_islow_kernel
// reads. The 64 divisors of the table qt (natural order) are derived once
// per thread block into shared memory.
__global__ void fdct_islow_quant_kernel(const unsigned char* __restrict__ plane,
                                        int bw, int bh,
                                        const unsigned short* __restrict__ qt,
                                        short* __restrict__ coef) {
  __shared__ jpeg_fdct::Divisor div[64];
  if (threadIdx.x < 64) div[threadIdx.x] = jpeg_fdct::divisor_of(
      8u * qt[threadIdx.x]);
  __syncthreads();
  size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)bw * bh) return;
  int by = (int)(b / bw), bx = (int)(b % bw);
  jpeg_fdct::fdct_islow_block(plane + (size_t)(8 * by) * (8 * bw) + 8 * bx,
                              8 * bw, div, (int16_t*)coef + 64 * b);
}

extern "C" int fdct_islow_launch(const unsigned char* plane, int bw, int bh,
                                 const unsigned short* qt, short* coef,
                                 cudaStream_t stream) {
  size_t n = (size_t)bw * bh;
  dim3 block(128);
  dim3 grid((unsigned)((n + 127) / 128));
  fdct_islow_quant_kernel<<<grid, block, 0, stream>>>(plane, bw, bh, qt,
                                                      coef);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// One thread a pixel of an (H, W) raster, row-major over a 1-D grid (any
// height): cv2.imread's BGR (H, W, 3) and grey (H, W) of its samples
// (raster_bgr.h says what each form computes). tables:
// raster_bgr::kTablesLen bytes (palette, libpng's gamma tables).
__global__ void raster_to_bgr_kernel(const unsigned char* __restrict__ raster,
                                     raster_bgr::Form form,
                                     const unsigned char* __restrict__ tables,
                                     unsigned char* __restrict__ bgr,
                                     unsigned char* __restrict__ gray) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)form.width * form.height) return;
  int y = (int)(i / form.width), x = (int)(i % form.width);
  raster_bgr::pixel(raster, form, tables, y, x, bgr + 3 * i, gray + i);
}

// form: the fields of raster_bgr::Form in order (11 ints, 2 long longs).
extern "C" int raster_to_bgr_launch(const unsigned char* raster,
                                    const int* form_ints,
                                    const long long* form_sizes,
                                    const unsigned char* tables,
                                    unsigned char* bgr, unsigned char* gray,
                                    cudaStream_t stream) {
  raster_bgr::Form f = raster_bgr::form_of(form_ints, form_sizes);
  size_t n = (size_t)f.width * f.height;
  dim3 block(256);
  dim3 grid((unsigned)((n + 255) / 256));
  raster_to_bgr_kernel<<<grid, block, 0, stream>>>(raster, f, tables, bgr,
                                                   gray);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// Lossy WebP reads: webp_decode.h parses the RIFF and the VP8 frame header
// and entropy-decodes every macroblock (MB) on the host (webp_host_header,
// webp_host_decode: a record and 25 x 16 quantized coefficients an MB);
// they are copied to the card, where
//   * vp8_reconstruct_kernel rebuilds the unfiltered Y, U and V planes
//     (vp8_recon.h: dequantization, inverse WHT and DCT, intra prediction);
//   * vp8_loop_filter_kernel filters them in place (vp8_filter.h);
//   * webp_yuv_to_bgr_kernel makes cv2.imread's BGR and grey of them
//     (webp_colour.h: libwebp's fancy upsampling and YUV -> RGB, OpenCV's
//     BGR -> grey), one thread a pixel.
// MB (x, y) is rebuilt from the unfiltered samples of MBs (x - 1, y),
// (x, y - 1) and (x + 1, y - 1) (the above-right samples of the sub-block
// modes), and the loop filter of MB (x, y) reads what the filters of the
// same three MBs wrote. So both kernels run one launch of warps, each
// claiming the next MB row from a ticket (rows are claimed in order, so a
// row's warp only waits on a row whose warp is running: no deadlock at any
// height or grid size), walking its row left to right and before each MB
// waiting until the row above has finished the MB above right of it (an
// acquire load of that row's progress counter; a release store after each
// MB). The 32 lanes of a warp share an MB's work between __syncwarp()
// barriers; another SM's samples are read through L2 (__ldcg). All the
// arithmetic is integer (the build's default flags: no fast math; nothing
// to contract).

__device__ __forceinline__ int vp8_load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void vp8_store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The row-ticket walk of the MBs of a frame by one warp: claim a row, then
// for each of its MBs wait for the row above, run `mb`, publish progress.
// sync: mb_h + 1 zeroed ints (the ticket, then each row's finished MBs).
template <class MB>
__device__ void vp8_row_walk(int mb_w, int mb_h, int* sync, MB mb) {
  __shared__ int row;
  const int lane = threadIdx.x;
  int* progress = sync + 1;
  for (;;) {
    if (lane == 0) row = atomicAdd(sync, 1);
    __syncwarp();
    const int mby = row;
    __syncwarp();
    if (mby >= mb_h) return;
    for (int mbx = 0; mbx < mb_w; mbx++) {
      if (mby > 0) {
        const int need = min(mbx + 2, mb_w);
        if (lane == 0) {
          // a wait of seconds means a broken dependency: fault, do not hang
          for (long long spins = 0;
               vp8_load_acquire(progress + mby - 1) < need; spins++) {
            if (spins > (1ll << 26)) __trap();
            __nanosleep(32);
          }
        }
        __syncwarp();
      }
      mb(mbx, mby, lane);
      __threadfence();
      __syncwarp();
      if (lane == 0) vp8_store_release(progress + mby, mbx + 1);
    }
  }
}

__global__ void __launch_bounds__(32)
    vp8_reconstruct_kernel(const vp8::Record* __restrict__ records,
                           const short* __restrict__ coefs, vp8::Params prm,
                           vp8::Planes pl, int* sync) {
  __shared__ vp8::MBBuf buf;
  vp8_row_walk(pl.mb_w, pl.mb_h, sync, [&](int mbx, int mby, int lane) {
    const size_t i = (size_t)mby * pl.mb_w + mbx;
    vp8::reconstruct_mb(records[i], (const int16_t*)coefs + vp8::kCoefsPerMB * i,
                        prm, pl, mbx, mby, buf, lane, 32);
  });
}

__global__ void __launch_bounds__(32)
    vp8_loop_filter_kernel(const vp8::Record* __restrict__ records,
                           vp8::Params prm, vp8::Planes pl, int* sync) {
  vp8_row_walk(pl.mb_w, pl.mb_h, sync, [&](int mbx, int mby, int lane) {
    vp8::filter_mb(records[(size_t)mby * pl.mb_w + mbx], prm, pl, mbx, mby,
                   lane, 32);
  });
}

// Enough warps to keep a row in flight for each MB row the wavefront holds
// at once (about min(mb_h, mb_w / 2)), at most one per row.
static int vp8_grid(int mb_w, int mb_h) {
  int g = mb_w / 2 + 2;
  return g < mb_h ? g : mb_h;
}

extern "C" int vp8_reconstruct_launch(const int* records, const short* coefs,
                                      const int* params, int mb_w, int mb_h,
                                      unsigned char* y, unsigned char* u,
                                      unsigned char* v, int* sync,
                                      cudaStream_t stream) {
  vp8::Planes pl = {y, u, v, mb_w, mb_h};
  vp8_reconstruct_kernel<<<vp8_grid(mb_w, mb_h), 32, 0, stream>>>(
      (const vp8::Record*)records, coefs, vp8::params_of(params), pl, sync);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

extern "C" int vp8_loop_filter_launch(const int* records, const int* params,
                                      int mb_w, int mb_h, unsigned char* y,
                                      unsigned char* u, unsigned char* v,
                                      int* sync, cudaStream_t stream) {
  vp8::Planes pl = {y, u, v, mb_w, mb_h};
  vp8_loop_filter_kernel<<<vp8_grid(mb_w, mb_h), 32, 0, stream>>>(
      (const vp8::Record*)records, vp8::params_of(params), pl, sync);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// One thread a pixel of the (h, w) image, row-major over a 1-D grid:
// cv2.imread's BGR (h, w, 3) and grey (h, w) of a frame's filtered planes
// (Y row stride 16 mb_w, U and V 8 mb_w).
__global__ void webp_yuv_to_bgr_kernel(const unsigned char* __restrict__ y,
                                       const unsigned char* __restrict__ u,
                                       const unsigned char* __restrict__ v,
                                       int mb_w, int w, int h,
                                       unsigned char* __restrict__ bgr,
                                       unsigned char* __restrict__ gray) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)w * h) return;
  int r = (int)(i / w), c = (int)(i % w);
  webp_colour::pixel(y, u, v, 16 * mb_w, 8 * mb_w, w, h, r, c, bgr + 3 * i,
                     gray + i);
}

extern "C" int webp_yuv_to_bgr_launch(const unsigned char* y,
                                      const unsigned char* u,
                                      const unsigned char* v, int mb_w, int w,
                                      int h, unsigned char* bgr,
                                      unsigned char* gray,
                                      cudaStream_t stream) {
  size_t n = (size_t)w * h;
  webp_yuv_to_bgr_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      y, u, v, mb_w, w, h, bgr, gray);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}
