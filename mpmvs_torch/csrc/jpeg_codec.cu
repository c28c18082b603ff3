// JPEG decode and encode on the card for the port's workspace I/O (sm_90a),
// the host half of its PNG and TIFF reads, its lossy, lossless and
// animated WebP reads, and its JPEG 2000 reads.
//
// No TPU kernel has this work: the JAX package reads and writes images with
// OpenCV (cv2.imread / cv2.imwrite, which code JPEGs with libjpeg-turbo).
// The machine with the card has no OpenCV, so the port codes here, and gives
// what OpenCV gives, bit for bit.
//
// Decoding:
//   * the host parses the file and entropy-decodes it to quantized DCT
//     coefficients as libjpeg does (jpeg_entropy.h: baseline, extended and
//     progressive Huffman, restart intervals; jpeg_arith.h: sequential and
//     progressive arithmetic coding); they are copied to the card;
//   * a progressive file whose coefficients libjpeg-turbo would smooth (a
//     file cut short, or one whose scans stop before the last bit) goes
//     through jpeg_smooth_kernel first (jpeg_smooth.h: its estimates of the
//     first coefficients from the 5 x 5 blocks' DC values), one thread per
//     block, into a new coefficient array;
//   * idct_islow_kernel runs libjpeg-turbo's accurate integer inverse DCT
//     as cv2 runs it (jidctint.c's sums in jsimd_idct_islow_avx2's lane
//     widths, jpeg_idct.h) with its dequantization and saturation,
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
// Lossless JPEGs (SOF3): the host entropy-decodes each component's sample
// differences (jpeg_lossless.h), they are copied to the card, and
// ljpeg_scan_kernel (predictors 1-4) or ljpeg_wavefront_kernel (5-7)
// undifference them into the planes the IDCT would write (uint8, each at
// its sampled size); ycc_to_bgr_kernel's RGB form or cmyk_to_bgr_kernel's
// CMYK form then makes the BGR, each component upsampled by replication
// (libjpeg-turbo takes no fancy upsampling in lossless mode).
//
// JPEG-compressed TIFFs (tiff_jpeg.h): each strip or tile is a stream of
// its own, entropy-decoded on the host; the coefficients of every chunk,
// concatenated, go through one IDCT launch a component, and one launch of
// ycc_to_bgr_kernel's chunked form upsamples each chunk on its own and
// converts as libtiff has libjpeg convert (YCbCr, or the components as
// they are for RGB), with OpenCV's grey of the BGR, both images from the
// one launch.
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
// What bounds the kernels: bytes. The smoothing kernel reads and writes 2
// bytes a coefficient, the IDCT reads 2 bytes a coefficient and writes 1 a
// sample, the YCbCr colour kernel reads 1.5 bytes a pixel
// (4:2:0) and writes 3, the four-component one reads up to 4 and writes 4
// (BGR and grey); bgr_to_ycc reads 3 and writes 1.5, the forward DCT reads 1 a
// sample and writes 2 a coefficient. The host's entropy coding takes far
// longer than any of them.
//
// PNG, TIFF, BMP and PNM reads: png_unfilter.h undoes a PNG's row filters
// and Adam7 interlacing on the host (png_unfilter_rows, png_adam7_rows),
// exif_orientation_tiff reads its eXIf; tiff_decode.h parses a TIFF and
// decompresses its strips or tiles on the host (tiff_host_info,
// tiff_host_layout, tiff_host_decode); BMP and PNM are parsed in
// io/images.py. The samples are copied to the card, where
// raster_to_bgr_kernel makes cv2.imread's BGR and grey images of them
// (raster_bgr.h: sub-8-bit grey expanded, palette looked up, 16 bits
// narrowed, alpha dropped or premultiplied, RGB or BGR samples, a BMP's
// 16-bit pixels, a TIFF's YCbCr data units by libtiff's tables, its CIELab
// samples by libtiff's RGBA reader's float arithmetic, and the grey of a
// colour image by libpng's or OpenCV's arithmetic), one thread a pixel. It
// reads at most 8 bytes a pixel and writes 4.
//
// JPEG 2000 reads (a JP2 file or a raw codestream, as OpenJPEG 2.5 decodes
// it and OpenCV converts it):
//   * the host parses the file and runs tier-2 and tier-1 (j2k_decode.h,
//     j2k_t1.h): every tile-component's wavelet coefficients, dequantized,
//     in one array of 32-bit words (int32 after the 5/3 wavelet, float
//     after the 9/7 one), copied to the card once with the tables that say
//     where each tile-component and each level lies;
//   * j2k_idwt_kernel runs one level of the inverse wavelet transform of
//     every tile-component that has it, lowest level first: a launch over
//     every row (one thread a row, from the array into a scratch array of
//     the same layout), then a launch over every column (one thread a
//     column, back into the array), each line interleaved and lifted as
//     OpenJPEG's dwt.c lifts it (j2k_idwt.h), a template form for each
//     wavelet. Its float arithmetic is one IEEE operation after another
//     (__fmul_rn / __fadd_rn);
//   * j2k_colour_kernel, one thread a pixel, finds the pixel's tile, undoes
//     the tile's colour transform (RCT or ICT), shifts and clamps each
//     component as OpenJPEG does, narrows it as OpenCV does and writes the
//     BGR and the grey images in one launch (j2k_colour.h).
// What bounds them: bytes. A level needs its coefficients read once and
// written once, 8 bytes a coefficient; the two launches move 16, since the
// rows go through the scratch array and back. The colour kernel reads 4
// bytes a component and writes 4 a pixel (BGR and grey). Tier-1 on the
// host takes far longer than any of them.
//
// The C interface below is bound with ctypes by mpmvs_torch/io/images.py.
// Every function returns 0 or an error code: a decode error of
// jpeg_entropy.h (2001-2014), an encode or PNG error (2010, 3001-3002), a
// TIFF error (4001-4024), a WebP error (webp_decode.h, 5001-5007;
// webp_lossless.h, 5008-5011), a JPEG 2000 error (j2k_decode.h,
// 6001-6012, 6014) or a CUDA error offset by 1000.

#include <cuda_runtime.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "j2k_colour.h"
#include "j2k_decode.h"
#include "j2k_idwt.h"
#include "j2k_t1.h"
#include "jpeg_colour.h"
#include "jpeg_encode.h"
#include "jpeg_entropy.h"
#include "jpeg_arith.h"
#include "jpeg_lossless.h"
#include "jpeg_lossless_pred.h"
#include "jpeg_fdct.h"
#include "jpeg_idct.h"
#include "jpeg_smooth.h"
#include "png_unfilter.h"
#include "raster_bgr.h"
#include "tiff_decode.h"
#include "tiff_jpeg.h"
#include "vp8_filter.h"
#include "vp8_recon.h"
#include "vp8l_transform.h"
#include "webp_colour.h"
#include "webp_decode.h"
#include "webp_lossless.h"

#define CODEC_CUDA_ERR 1000

// Parse and entropy-decode a JPEG on the host. info (50 ints) receives the
// number of components, the width and height, the EXIF orientation, the
// colour space (jpeg_entropy::Space), the largest sampling factors hmax and
// vmax, then from info[7] per component eight values: its plane's width and
// height (the sampled size, ceil(W * h / hmax)), the coefficient array's
// blocks across and down (padded to whole MCUs), the blocks that cover the
// plane across and down, and its factors h and v; info[39] is 1 for a
// lossless JPEG, info[40] its precision, and per component
// its predictor and point transform (info[42], info[43] for the first);
// info[41] is 1 for an arithmetic-coded one. *out holds the coefficients
// (or a lossless JPEG's differences) until jpeg_host_free.
extern "C" int jpeg_host_decode(const unsigned char* data, size_t length,
                                void** out, int* info) {
  jpeg_entropy::Decoder* d = new jpeg_entropy::Decoder();
  int err = jpeg_entropy::decode(d, data, length, false);
  if (err != 0) {
    delete d;
    return err;
  }
  jpeg_entropy::host_info(d, info);
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
    e = cudaMemcpyAsync(qt, c.qt, 64 * sizeof(uint16_t),
                        cudaMemcpyHostToDevice, stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

extern "C" void jpeg_host_free(void* img) {
  delete (jpeg_entropy::Decoder*)img;
}

// Copy a lossless JPEG's component comp's sample differences (plane height
// x width int16) and its first-row marks (height bytes) to host memory.
extern "C" int jpeg_host_lossless(void* img, int comp, short* diff,
                                  unsigned char* first) {
  return jpeg_entropy::lossless_planes((jpeg_entropy::Decoder*)img, comp,
                                       diff, first);
}

// What libjpeg's smoothing_ok latches of a decode (jpeg_entropy.h
// smoothing): out (jpeg_entropy::kSmoothLen ints) receives 1 where libjpeg
// smooths the image's blocks, then per component the kSmoothInts ints of
// jpeg_smooth::Params.
extern "C" int jpeg_host_smoothing(void* img, int* out) {
  jpeg_entropy::smoothing((jpeg_entropy::Decoder*)img, out);
  return 0;
}

// One thread a block of a component's coefficient array (blocks_h x
// blocks_w x 64 int16): libjpeg-turbo's inter-block smoothing of a
// progressive image (jpeg_smooth.h) into out, a new array of the same
// layout, which idct_islow_kernel then takes. Blocks outside the samples'
// are copied as they are.
__global__ void jpeg_smooth_kernel(const short* __restrict__ coef,
                                   jpeg_smooth::Params p,
                                   short* __restrict__ out) {
  int bx = blockIdx.x * blockDim.x + threadIdx.x;
  int by = blockIdx.y;
  if (bx >= p.blocks_w || by >= p.blocks_h) return;
  int16_t blk[64];
  jpeg_smooth::smooth_block(coef, p, bx, by, blk);
  short* dst = out + ((size_t)by * p.blocks_w + bx) * 64;
  for (int k = 0; k < 64; k++) dst[k] = blk[k];
}

// params: a component's jpeg_entropy::kSmoothInts ints.
extern "C" int jpeg_smooth_launch(const short* coef, const int* params,
                                  short* out, cudaStream_t stream) {
  jpeg_smooth::Params p = jpeg_smooth::params_of(params);
  dim3 block(128);
  dim3 grid((p.blocks_w + 127) / 128, p.blocks_h);
  jpeg_smooth_kernel<<<grid, block, 0, stream>>>(coef, p, out);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
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

// The planes of n components (pointers and n x 6 ints: w, rh, rv, fancy,
// pitch, stride, the fields of jpeg_colour::Plane) as the kernels take
// them.
static jpeg_colour::Planes planes_of(const unsigned char* const* ptrs,
                                     const int* geo, int n) {
  jpeg_colour::Planes pl = {};
  for (int i = 0; i < n; i++) {
    const int* g = geo + 6 * i;
    pl.c[i] = {ptrs[i], g[0], g[1], g[2], g[3], g[4], g[5]};
  }
  return pl;
}

// One thread a pixel of the (H, W) image of one or three components, cut
// into chunks ck (kChunks) or one chunk, a JPEG file: BGR (H, W, 3) and,
// where gray is not NULL, grey (jpeg_colour.h ycc_pixel; form: YccForm
// bits). A file's pixels take their spot without spot()'s divisions.
template <bool kChunks>
__global__ void ycc_to_bgr_kernel(jpeg_colour::Planes pl, int n, int form,
                                  jpeg_colour::Chunks ck, int H, int W,
                                  unsigned char* __restrict__ bgr,
                                  unsigned char* __restrict__ gray) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y;
  if (col >= W) return;
  size_t i = (size_t)r * W + col;
  jpeg_colour::Spot s = kChunks ? jpeg_colour::spot(ck, r, col)
                                : jpeg_colour::whole(H, r, col);
  jpeg_colour::ycc_pixel(pl, n, form, s, bgr + 3 * i,
                         gray ? gray + i : nullptr);
}

// chunks: the int fields of jpeg_colour::Chunks (7 ints), or NULL for one
// chunk, the image; rows: each chunk's stream's rows on the card.
extern "C" int ycc_to_bgr_launch(const unsigned char* const* ptrs,
                                 const int* geo, int n, int form,
                                 const int* chunks, const int* rows, int H,
                                 int W, unsigned char* bgr,
                                 unsigned char* gray, cudaStream_t stream) {
  dim3 block(256);
  dim3 grid((W + 255) / 256, H);
  jpeg_colour::Planes pl = planes_of(ptrs, geo, n);
  if (chunks) {
    jpeg_colour::Chunks ck = {chunks[0], chunks[1], chunks[2], chunks[3],
                              chunks[4], chunks[5], chunks[6], rows};
    ycc_to_bgr_kernel<true><<<grid, block, 0, stream>>>(pl, n, form, ck, H,
                                                        W, bgr, gray);
  } else {
    ycc_to_bgr_kernel<false><<<grid, block, 0, stream>>>(
        pl, n, form, jpeg_colour::Chunks{}, H, W, bgr, gray);
  }
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
  jpeg_colour::cmyk_pixel(pl, ycck, H, r, col, bgr + 3 * i, gray + i);
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

// form: the fields of raster_bgr::Form in order (raster_bgr::kFormInts
// ints, 2 long longs).
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

// Lossless WebP reads (VP8L frames of still files, and of the first frame
// of an animated file): webp_lossless.h entropy-decodes the bitstream on
// the host (vp8l_host_decode: prefix codes, colour cache, LZ77) into the
// coded ARGB image and the transforms' data; they are copied to the card,
// where the inverse transforms run in the file's reverse order:
//   * vp8l_predictor_kernel, the inverse predictor. Pixel (x, y) needs the
//     rebuilt (x - 1, y), (x - 1, y - 1), (x, y - 1) and (x + 1, y - 1):
//     a wavefront. One warp takes a band of 32 rows, lane i row i, and
//     walks it skewed: at step s lane i rebuilds column s - 2 i, so the
//     row above's three neighbours were rebuilt by lane i - 1 one, two and
//     three steps before: one shuffle a step, the other two kept from the
//     steps before. The band's first row reads the band above's last row,
//     which that band's last lane writes column by column as tagged 64-bit
//     words (tag and pixel in one relaxed store, so no fence); before
//     each 32 steps the warp polls the 33 columns they need (bands are
//     claimed in order from a ticket and a band waits only on the band
//     above, so no deadlock; a wait of seconds traps instead of hanging,
//     as vp8_row_walk does). A band walks its steps 32 at a time, fully
//     unrolled; the residuals are loaded 32 columns ahead, coalesced, into
//     registers and staged in a shared ring of 128 columns; every mode is
//     computed and the pixel's picked by a select tree, so the lanes do
//     not diverge. One warp alone on its SM issues the steps in order, so
//     a step costs its instructions' latency; the critical path is
//     W + 2 (H - 1) steps plus each band's wait (about 33 columns).
//   * vp8l_colour_kernel, one thread an output pixel: a run of
//     consecutive element-wise inverse transforms (cross-colour, add green,
//     colour indexing, which widens the image), one launch a run;
//   * webp_argb_to_bgr_kernel, one thread a canvas pixel: cv2.imread's BGR
//     and grey of the ARGB frame at its offset on a canvas of zeros.
// vp8l_transform.h holds their arithmetic. All bound by bytes: the
// predictor reads 4 bytes a pixel and the modes and writes 4, the colour
// kernel reads at most 4 and writes 4, the conversion reads 4 and writes 4.

__device__ __forceinline__ unsigned long long vp8l_load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void vp8l_store_relaxed(unsigned long long* p,
                                                   unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v));
}

// sync: 1 + W zeroed 64-bit words: the ticket (its low half), then per
// column the last rebuilt row of a band above: (band + 1) << 32 | pixel,
// each written whole by one relaxed 64-bit store, so a reader that sees the
// tag it waits for has the pixel with it (no fence).
__global__ void __launch_bounds__(32)
    vp8l_predictor_kernel(const uint32_t* __restrict__ res,
                          const uint32_t* __restrict__ modes, int bits,
                          int W, int H, uint32_t* __restrict__ out,
                          unsigned long long* sync) {
  __shared__ uint32_t tile[32][129];  // residuals: 32 rows, 128 columns
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  const int tiles = (W + (1 << bits) - 1) >> bits;
  unsigned long long* edge = sync + 1;
  for (;;) {
    int band = 0;
    if (lane == 0) band = atomicAdd((int*)sync, 1);
    band = __shfl_sync(full, band, 0);
    const int y0 = 32 * band;
    if (y0 >= H) return;
    const int rows = min(32, H - y0), y = y0 + lane;
    const int ym = min(y, H - 1);  // a lane past the image reads row H - 1
    const unsigned long long tag = (unsigned long long)(band + 1) << 32;
    uint32_t pre[32];  // the next 32 columns' residuals, one row each
    auto prefetch = [&](int col) {
#pragma unroll
      for (int r = 0; r < 32; r++)
        pre[r] = r < rows && col < W
                     ? __ldg(res + (size_t)(y0 + r) * W + col) : 0u;
    };
    prefetch(lane);
    // h1: own last output (L); t, tl: the row above at this step's column
    // and the one before (what tr was one and two steps ago)
    uint32_t h1 = 0, first = 0, t = 0, tl = 0;
    for (int c = 0, steps = W + 2 * (rows - 1); 32 * c < steps; c++) {
      const int col = 32 * c + lane;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 32; r++) tile[r][col & 127] = pre[r];
      prefetch(col + 32);  // in flight while these 32 columns are rebuilt
      // the row above at columns 32 c + lane (and 32 c + 32 on lane 0):
      // lane 0's neighbours above for this block's 32 steps
      uint32_t above = 0, beyond = 0;
      if (band > 0) {
        for (long long spins = 0;; spins++) {
          bool ok = true;
          unsigned long long e = 0, e2 = 0;
          if (col < W) {
            e = vp8l_load_relaxed(edge + col);
            ok = (e >> 32) == (unsigned long long)band;
          }
          if (lane == 0 && col + 32 < W) {
            e2 = vp8l_load_relaxed(edge + col + 32);
            ok = ok && (e2 >> 32) == (unsigned long long)band;
          }
          if (__all_sync(full, ok)) {
            above = (uint32_t)e;
            beyond = (uint32_t)e2;
            break;
          }
          // a wait of seconds means a broken dependency: fault, not hang
          if (spins > (1ll << 26)) __trap();
          __nanosleep(32);
        }
        if (c == 0) t = __shfl_sync(full, above, 0);
      }
#pragma unroll
      for (int j = 0; j < 32; j++) {
        const int x = 32 * c + j - 2 * lane;
        // top-right: lane i - 1's last output; lane 0's from the row above
        const uint32_t up = __shfl_up_sync(full, h1, 1);
        const uint32_t above_tr = j < 31 ? __shfl_sync(full, above, j + 1)
                                         : __shfl_sync(full, beyond, 0);
        const uint32_t tr = lane ? up : above_tr;
        // every lane computes a pixel, in or out of the image (straight
        // code the compiler can interleave across steps); only pixels in
        // it are stored and used
        const int xm = min(max(x, 0), W - 1);
        const uint32_t pix = vp8l::predictor_pixel(
            tile[lane][x & 127], x, y, h1, t, tl, x == W - 1 ? first : tr,
            vp8l::predictor_mode(modes, bits, tiles, xm, ym));
        if (lane < rows && x >= 0 && x < W) {
          out[(size_t)y * W + x] = pix;
          if (x == 0) first = pix;
          if (lane == rows - 1) vp8l_store_relaxed(edge + x, tag | pix);
        }
        tl = t;
        t = tr;
        h1 = pix;
      }
    }
  }
}

// Enough warps for every band at once (at most 1024).
extern "C" int vp8l_predictor_launch(const unsigned* res,
                                     const unsigned* modes, int bits, int W,
                                     int H, unsigned* out,
                                     unsigned long long* sync,
                                     cudaStream_t stream) {
  const int bands = (H + 31) / 32;
  vp8l_predictor_kernel<<<bands < 1024 ? bands : 1024, 32, 0, stream>>>(
      res, modes, bits, W, H, out, sync);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

__global__ void vp8l_colour_kernel(const uint32_t* __restrict__ in,
                                   vp8l::Run run, uint32_t* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)run.out_w * run.h) return;
  out[i] = vp8l::colour_pixel(run, in, (int)(i % run.out_w),
                              (int)(i / run.out_w));
}

// desc: n, in_w, out_w, h, then per transform (order applied) its type,
// bits and output width; data: its data pointer (NULL for add green).
extern "C" int vp8l_colour_launch(const unsigned* in, const int* desc,
                                  const unsigned* const* data, unsigned* out,
                                  cudaStream_t stream) {
  vp8l::Run run = {};
  run.n = desc[0];
  run.in_w = desc[1];
  run.out_w = desc[2];
  run.h = desc[3];
  for (int j = 0; j < run.n && j < 3; j++)
    run.t[j] = {desc[4 + 3 * j], desc[5 + 3 * j], desc[6 + 3 * j], data[j]};
  const size_t n = (size_t)run.out_w * run.h;
  vp8l_colour_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      in, run, out);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

__global__ void webp_argb_to_bgr_kernel(const uint32_t* __restrict__ argb,
                                        int w, int h, int ox, int oy,
                                        int cw, int ch,
                                        unsigned char* __restrict__ bgr,
                                        unsigned char* __restrict__ gray) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)cw * ch) return;
  vp8l::canvas_pixel(argb, w, h, ox, oy, (int)(i % cw), (int)(i / cw),
                     bgr + 3 * i, gray + i);
}

extern "C" int webp_argb_to_bgr_launch(const unsigned* argb, int w, int h,
                                       int ox, int oy, int cw, int ch,
                                       unsigned char* bgr,
                                       unsigned char* gray,
                                       cudaStream_t stream) {
  const size_t n = (size_t)cw * ch;
  webp_argb_to_bgr_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      argb, w, h, ox, oy, cw, ch, bgr, gray);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// Lossless JPEG reads: the undifferencing of each component's sample
// differences (jpeg_lossless.h) into its samples, jdlossls.c's arithmetic
// (jpeg_lossless_pred.h, which derives the scan form's identities).
//   * ljpeg_scan_kernel, predictors 1-4, whose predictions are linear mod
//     2^16: two launches. Pass A, a warp a row (every row for predictors 1
//     and 4, each band's first row for 2 and 3): the row's prefix sums of
//     its differences, a warp scan of 32 columns at a time carried along
//     the row, into a uint16 plane. Pass B, a thread a column (1, 2, 4) or
//     a diagonal (3) of one band (a first row and the rows up to the next:
//     a restart interval), grid (lanes, bands, components): it walks the
//     band's rows, its running sum the sample (scan_walk); a warp's lanes
//     read and write 32 neighbouring columns of a row, coalesced. Bands are
//     independent, so a file with restarts runs them all at once.
//   * ljpeg_wavefront_kernel, predictors 5-7, whose shifted sums are not
//     associative: the VP8L predictor kernel's design. One warp takes a
//     band of 32 rows, lane i row i, and walks it skewed by one column
//     (step s: lane i rebuilds column s - i), so the row above's Rb is lane
//     i - 1's last sample (one shuffle a step) and its Rc the Rb of the step
//     before. The band's first lane reads the band above's last row, which
//     that band's last lane writes column by column as tagged 64-bit words
//     (band + 1 in the high half, the 16-bit sample in the low; one relaxed
//     store), polled before each 32 steps; a band whose first row is a
//     first row (a restart) waits on nothing. Bands of every component are
//     claimed in order from a ticket, and a band waits only on the band
//     above of its component, which holds an earlier ticket: no deadlock; a
//     wait of seconds traps. The differences are staged 32 columns ahead,
//     coalesced, in a shared ring of 128 columns. The critical path is
//     W + 31 steps a band plus each band's wait, about W + H steps for a
//     component without restarts.
// Both write the uint8 planes idct_islow_kernel writes. Bound by bytes: 2
// read (the difference) and 1 written (the sample) a sample; pass A's
// prefix sums add 2 written and 2 read a sample of the rows it scans.

struct LjpegPlanes {
  ljpeg::Plane c[4];
  int n;
};

static LjpegPlanes ljpeg_planes(const short* const* d, unsigned short* const* r,
                                unsigned char* const* out,
                                const unsigned char* const* first,
                                const int* geo, int n) {
  LjpegPlanes pl = {};
  pl.n = n;
  for (int i = 0; i < n && i < 4; i++)
    pl.c[i] = {(const int16_t*)d[i], r ? (uint16_t*)r[i] : nullptr, out[i],
               first[i], geo[4 * i], geo[4 * i + 1], geo[4 * i + 2],
               geo[4 * i + 3]};
  return pl;
}

// One pass of the scan form. kPass 0 (A): warp w of the grid takes row w
// of the planes' rows, one after another, and writes its prefix sums.
// kPass 1 (B): thread x of block (bx, band, z) walks lane bx * blockDim.x
// + x of band `band` of plane z: a column, or for predictor 3 diagonal
// lane - (rows - 1). bands: per plane max_bands + 1 row starts, the last
// ones the height.
template <int kPass>
__global__ void ljpeg_scan_kernel(LjpegPlanes pl, int p, const int* bands,
                                  int max_bands) {
  if (kPass == 0) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
    int z = 0;
    while (z < pl.n && row >= pl.c[z].h) row -= pl.c[z++].h;
    if (z >= pl.n) return;
    const ljpeg::Plane& q = pl.c[z];
    if (!ljpeg::scan_row_needed(p, q, row)) return;
    const int16_t* d = q.d + (size_t)row * q.w;
    uint16_t* out = q.r + (size_t)row * q.w;
    uint32_t carry = 0;
    for (int c0 = 0; c0 < q.w; c0 += 32) {
      const int c = c0 + lane;
      uint32_t v = c < q.w ? (uint16_t)d[c] : 0u;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(full, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (c < q.w) out[c] = (uint16_t)v;
      carry = __shfl_sync(full, v, 31);
    }
    return;
  }
  const int z = blockIdx.z, b = blockIdx.y;
  if (z >= pl.n) return;
  const ljpeg::Plane& q = pl.c[z];
  const int r0 = max(bands[z * (max_bands + 1) + b], 0);
  const int r1 = min(bands[z * (max_bands + 1) + b + 1], q.h);
  if (r0 >= r1) return;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = p == 3 ? lane - (r1 - r0 - 1) : lane;
  if (g >= q.w) return;
  ljpeg::scan_walk(p, q, r0, r1, g);
}

// geo: n x 4 ints (w, h, pt, init) a plane; r: the uint16 scratch planes of
// pass A; pass 0 (A) or 1 (B); bands: device ints (pass B).
extern "C" int ljpeg_scan_launch(const short* const* d,
                                 unsigned short* const* r,
                                 unsigned char* const* out,
                                 const unsigned char* const* first,
                                 const int* geo, int n, int p, int pass,
                                 const int* bands, int max_bands,
                                 cudaStream_t stream) {
  LjpegPlanes pl = ljpeg_planes(d, r, out, first, geo, n);
  int max_w = 0, max_h = 0;
  size_t rows = 0;
  for (int i = 0; i < n; i++) {
    rows += pl.c[i].h;
    max_w = pl.c[i].w > max_w ? pl.c[i].w : max_w;
    max_h = pl.c[i].h > max_h ? pl.c[i].h : max_h;
  }
  if (pass == 0) {
    ljpeg_scan_kernel<0><<<(unsigned)((rows * 32 + 255) / 256), 256, 0,
                           stream>>>(pl, p, bands, max_bands);
  } else {
    const int lanes = p == 3 ? max_w + max_h - 1 : max_w;
    dim3 grid((lanes + 127) / 128, max_bands, n);
    ljpeg_scan_kernel<1><<<grid, 128, 0, stream>>>(pl, p, bands, max_bands);
  }
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// sync: 1 + the planes' widths zeroed 64-bit words: the ticket, then each
// plane's edge words (the band above's last row, tagged).
__global__ void __launch_bounds__(32)
    ljpeg_wavefront_kernel(LjpegPlanes pl, int p, unsigned long long* sync) {
  __shared__ int16_t tile[32][128 + 8];  // differences: 32 rows, 128 columns
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  for (;;) {
    int ticket = 0;
    if (lane == 0) ticket = atomicAdd((int*)sync, 1);
    ticket = __shfl_sync(full, ticket, 0);
    int z = 0, band = ticket;
    size_t edge_at = 1;
    while (z < pl.n && band >= (pl.c[z].h + 31) / 32) {
      band -= (pl.c[z].h + 31) / 32;
      edge_at += pl.c[z++].w;
    }
    if (z >= pl.n) return;
    const ljpeg::Plane& q = pl.c[z];
    unsigned long long* edge = sync + edge_at;
    const int W = q.w, y0 = 32 * band, rows = min(32, q.h - y0);
    const int y = y0 + lane, ym = min(y, q.h - 1);
    const bool first = q.first[ym] != 0;
    const bool need_above = band > 0 && !q.first[y0];
    const unsigned long long tag = (unsigned long long)(band + 1) << 32;
    int16_t pre[32];  // the next 32 columns' differences, one row each
    auto prefetch = [&](int col) {
#pragma unroll
      for (int r = 0; r < 32; r++)
        pre[r] = r < rows && col < W ? q.d[(size_t)(y0 + r) * W + col] : 0;
    };
    prefetch(lane);
    int h1 = 0, rb_prev = 0;
    for (int c = 0, steps = W + rows - 1; 32 * c < steps; c++) {
      const int col = 32 * c + lane;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 32; r++) tile[r][col & 127] = pre[r];
      prefetch(col + 32);  // in flight while these 32 columns are rebuilt
      int above = 0;  // the row above at column col: lane 0's Rb at step j
      if (need_above) {
        for (long long spins = 0;; spins++) {
          bool ok = true;
          unsigned long long e = 0;
          if (col < W) {
            e = vp8l_load_relaxed(edge + col);
            ok = (e >> 32) == (unsigned long long)band;
          }
          if (__all_sync(full, ok)) {
            above = (int)(e & 0xFFFF);
            break;
          }
          // a wait of seconds means a broken dependency: fault, not hang
          if (spins > (1ll << 26)) __trap();
          __nanosleep(32);
        }
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 32; j++) {
        const int x = 32 * c + j - lane;
        const int up = __shfl_up_sync(full, h1, 1);
        const int ab = __shfl_sync(full, above, j);
        const int v = ljpeg::wave_step(p, tile[lane][x & 127], x, first,
                                       q.init, lane ? up : ab, &h1,
                                       &rb_prev);
        if (lane < rows && x >= 0 && x < W) {
          q.out[(size_t)y * W + x] = ljpeg::narrow(v, q.pt);
          if (lane == rows - 1) vp8l_store_relaxed(edge + x, tag | v);
        }
      }
    }
  }
}

// Enough warps for every band of every plane at once (at most 1024).
extern "C" int ljpeg_wavefront_launch(const short* const* d,
                                      unsigned char* const* out,
                                      const unsigned char* const* first,
                                      const int* geo, int n, int p,
                                      unsigned long long* sync,
                                      cudaStream_t stream) {
  LjpegPlanes pl = ljpeg_planes(d, nullptr, out, first, geo, n);
  int bands = 0;
  for (int i = 0; i < n; i++) bands += (pl.c[i].h + 31) / 32;
  ljpeg_wavefront_kernel<<<bands < 1024 ? bands : 1024, 32, 0, stream>>>(
      pl, p, sync);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// One level's rows (pass 0: a, the level's bands, into b, interleaved and
// lifted) or columns (pass 1: b into a) of every tile-component of a
// launch, one thread a line. jobs: 8 ints a tile-component (its offset in
// words and width, the level's width and height, its low-pass columns and
// rows, the parities of its origin); starts: the first line of each job,
// rows (njobs values) then columns (njobs values), in a 1-D grid of total
// lines.
template <int kForm>
__global__ void j2k_idwt_kernel(uint32_t* __restrict__ a,
                                uint32_t* __restrict__ b,
                                const int* __restrict__ jobs,
                                const long long* __restrict__ starts,
                                int njobs, int pass, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long* s = starts + (pass ? njobs : 0);
  int lo = 0, hi = njobs - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s[mid] <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int* J = jobs + 8 * lo;
  const long k = (long)(i - s[lo]);
  const long off = J[0], w = J[1];
  if (kForm == 53) {
    int32_t *A = (int32_t*)a + off, *B = (int32_t*)b + off;
    if (pass == 0)
      j2k_idwt::line53(A + k * w, 1, B + k * w, 1, J[4], J[2], J[6]);
    else
      j2k_idwt::line53(B + k, w, A + k, w, J[5], J[3], J[7]);
  } else {
    float *A = (float*)a + off, *B = (float*)b + off;
    if (pass == 0)
      j2k_idwt::line97(A + k * w, 1, B + k * w, 1, J[4], J[2], J[6]);
    else
      j2k_idwt::line97(B + k, w, A + k, w, J[5], J[3], J[7]);
  }
}

extern "C" int j2k_idwt_launch(void* a, void* b, const int* jobs,
                               const long long* starts, int njobs, int pass,
                               long long total, int form,
                               cudaStream_t stream) {
  if (total <= 0) return 0;
  dim3 block(128);
  dim3 grid((unsigned)((total + 127) / 128));
  if (form == 53)
    j2k_idwt_kernel<53><<<grid, block, 0, stream>>>(
        (uint32_t*)a, (uint32_t*)b, jobs, starts, njobs, pass, total);
  else
    j2k_idwt_kernel<97><<<grid, block, 0, stream>>>(
        (uint32_t*)a, (uint32_t*)b, jobs, starts, njobs, pass, total);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// One thread a pixel of the (H, W) image: cv2's BGR (H, W, 3) and grey
// (H, W). tiles: j2k_colour::kTileInts ints a tile; params: the fields of
// j2k_colour::Params in order.
__global__ void j2k_colour_kernel(const uint32_t* __restrict__ coef,
                                  const int* __restrict__ tiles,
                                  j2k_colour::Params p,
                                  uint8_t* __restrict__ bgr,
                                  uint8_t* __restrict__ grey) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)p.W * p.H) return;
  const int y = (int)(i / p.W), x = (int)(i % p.W);
  j2k_colour::pixel(coef, tiles, p, x, y, bgr + 3 * i, grey + i);
}

extern "C" int j2k_colour_launch(const void* coef, const int* tiles,
                                 const int* params, void* bgr, void* grey,
                                 cudaStream_t stream) {
  j2k_colour::Params p;
  memcpy(&p, params, sizeof p);
  const size_t n = (size_t)p.W * p.H;
  dim3 block(256);
  dim3 grid((unsigned)((n + 255) / 256));
  j2k_colour_kernel<<<grid, block, 0, stream>>>(
      (const uint32_t*)coef, tiles, p, (uint8_t*)bgr, (uint8_t*)grey);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}
