// JPEG decode and encode on the card for the port's workspace I/O (sm_90a),
// and the host half of its PNG reads.
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
//   * ycc_to_bgr_kernel upsamples the planes and makes interleaved BGR with
//     libjpeg-turbo's integer arithmetic:
//       - "fancy" (triangle) upsampling of jdsample.c for h2v2 (4:2:0),
//         h2v1 (4:2:2) and h1v2 (4:4:0), edge rows and columns replicated;
//       - YCbCr: the fixed-point YCbCr -> RGB of jdcolor.c (16 fractional
//         bits, FIX(1.402), FIX(1.772), FIX(0.71414), FIX(0.34414),
//         rounding as its tables do); the grey image is the Y plane itself
//         (cv2.imread(IMREAD_GRAYSCALE) of a YCbCr JPEG is libjpeg's Y
//         component, not a conversion of BGR);
//       - RGB components (libjpeg's guess, jpeg_entropy.h): the samples in
//         B, G, R order, and the grey image rgb_gray_convert's
//         (19595 R + 38470 G + 7471 B + 32768) >> 16, written by the same
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
// writes 1 a sample, the colour kernel reads 1.5 bytes a pixel (4:2:0) and
// writes 3; bgr_to_ycc reads 3 and writes 1.5, the forward DCT reads 1 a
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
// jpeg_entropy.h (2001-2009), an encode or PNG error (2010, 3001-3002), a
// TIFF error (4001-4017) or a CUDA error offset by 1000.

#include <cuda_runtime.h>

#include <stdint.h>
#include <stdlib.h>

#include "jpeg_encode.h"
#include "jpeg_entropy.h"
#include "jpeg_fdct.h"
#include "jpeg_idct.h"
#include "png_unfilter.h"
#include "raster_bgr.h"
#include "tiff_decode.h"

#define CODEC_CUDA_ERR 1000

// Parse and entropy-decode a JPEG on the host. info receives the number of
// components, the width and height, then per component six values: its
// plane's width and height (the sampled size, ceil(W * h / hmax)), the
// coefficient array's blocks across and down (padded to whole MCUs), and the
// blocks that cover the plane across and down; info[21] the EXIF
// orientation, info[22] 1 for RGB components. *out holds the coefficients
// until jpeg_host_free.
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
  for (int i = 0; i < d->ncomp; i++) {
    const jpeg_entropy::Component& c = d->comp[i];
    int* ci = info + 3 + 6 * i;
    ci[0] = (d->width * c.h + d->hmax - 1) / d->hmax;
    ci[1] = (d->height * c.v + d->vmax - 1) / d->vmax;
    ci[2] = c.blocks_w;
    ci[3] = c.blocks_h;
    ci[4] = c.width_in_blocks;
    ci[5] = c.height_in_blocks;
  }
  info[21] = d->orientation;
  info[22] = d->rgb;
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

// One chroma sample at output pixel (r, col): jdsample.c's fancy
// upsampling for factors (hs, vs) in {1, 2}, with the plane's edge rows and
// columns replicated as libjpeg's context rows and edge code do.
__device__ __forceinline__ int chroma_at(const unsigned char* p, int pitch,
                                         int Hc, int Wc, int r, int col,
                                         int hs, int vs) {
  if (hs == 1 && vs == 1) return p[r * pitch + col];
  if (hs == 2 && vs == 2) {
    int i = r >> 1, j = col >> 1;
    int i2 = (r & 1) ? min(i + 1, Hc - 1) : max(i - 1, 0);
    int jn = (col & 1) ? min(j + 1, Wc - 1) : max(j - 1, 0);
    int cs = 3 * p[i * pitch + j] + p[i2 * pitch + j];
    int cn = 3 * p[i * pitch + jn] + p[i2 * pitch + jn];
    return (3 * cs + cn + ((col & 1) ? 7 : 8)) >> 4;
  }
  if (hs == 2) {  // h2v1
    int j = col >> 1;
    int jn = (col & 1) ? min(j + 1, Wc - 1) : max(j - 1, 0);
    return (3 * p[r * pitch + j] + p[r * pitch + jn] + ((col & 1) ? 2 : 1)) >>
           2;
  }
  int i = r >> 1;  // h1v2
  int i2 = (r & 1) ? min(i + 1, Hc - 1) : max(i - 1, 0);
  return (3 * p[i * pitch + col] + p[i2 * pitch + col] + ((r & 1) ? 2 : 1)) >>
         2;
}

__device__ __forceinline__ unsigned char clamp_u8(int v) {
  return (unsigned char)min(max(v, 0), 255);
}

// Interleaved BGR (H, W, 3) from the planes; cb == NULL: one component.
// rgb: the planes are R, G, B (G and B sampled as Cb and Cr would be), and
// gray receives rgb_gray_convert's grey.
__global__ void ycc_to_bgr_kernel(const unsigned char* __restrict__ y,
                                  const unsigned char* __restrict__ cb,
                                  const unsigned char* __restrict__ cr,
                                  int H, int W, int Hc, int Wc, int hs, int vs,
                                  int rgb, unsigned char* __restrict__ bgr,
                                  unsigned char* __restrict__ gray) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y;
  if (col >= W) return;
  int Y = y[r * W + col];
  unsigned char* o = bgr + 3 * ((size_t)r * W + col);
  if (cb == NULL) {
    o[0] = o[1] = o[2] = (unsigned char)Y;
    return;
  }
  int ub = chroma_at(cb, Wc, Hc, Wc, r, col, hs, vs);
  int ur = chroma_at(cr, Wc, Hc, Wc, r, col, hs, vs);
  if (rgb) {  // Y, ub, ur are R, G, B
    o[0] = (unsigned char)ur;
    o[1] = (unsigned char)ub;
    o[2] = (unsigned char)Y;
    gray[r * W + col] = (unsigned char)jpeg_fdct::y_of(Y, ub, ur);
    return;
  }
  int xb = ub - 128, xr = ur - 128;
  // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF 1 << 15
  int red = (91881 * xr + 32768) >> 16;
  int green = (-22554 * xb + 32768 - 46802 * xr) >> 16;
  int blue = (116130 * xb + 32768) >> 16;
  o[0] = clamp_u8(Y + blue);
  o[1] = clamp_u8(Y + green);
  o[2] = clamp_u8(Y + red);
}

extern "C" int ycc_to_bgr_launch(const unsigned char* y,
                                 const unsigned char* cb,
                                 const unsigned char* cr, int H, int W, int Hc,
                                 int Wc, int hs, int vs, int rgb,
                                 unsigned char* bgr, unsigned char* gray,
                                 cudaStream_t stream) {
  dim3 block(256);
  dim3 grid((W + 255) / 256, H);
  ycc_to_bgr_kernel<<<grid, block, 0, stream>>>(y, cb, cr, H, W, Hc, Wc, hs,
                                                vs, rgb, bgr, gray);
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
