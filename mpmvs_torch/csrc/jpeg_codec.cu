// JPEG decode and encode on the card for the port's workspace I/O (sm_90a).
//
// No TPU kernel has this work: the JAX package reads and writes images with
// OpenCV (cv2.imread / cv2.imwrite, which decode with libjpeg-turbo). The
// machine with the card has no OpenCV, so the port decodes here, and gives
// what cv2.imread gives, bit for bit:
//
//   * the host parses the file and entropy-decodes it to quantized DCT
//     coefficients as libjpeg does (jpeg_entropy.h: baseline, extended and
//     progressive Huffman, restart intervals); they are copied to the card;
//   * idct_islow_kernel runs libjpeg's accurate integer inverse DCT
//     (jidctint.c, jpeg_idct.h) with its dequantization and range limit,
//     one thread per 8x8 block, into each component's plane. nvJPEG's own
//     decode was tried first and differs: its inverse DCT is not jidctint
//     (1.3-2.1% of grey values off by 1 on the H100);
//   * ycc_to_bgr_kernel upsamples the chroma planes and converts to
//     interleaved BGR with libjpeg-turbo's integer arithmetic:
//       - "fancy" (triangle) upsampling of jdsample.c for h2v2 (4:2:0),
//         h2v1 (4:2:2) and h1v2 (4:4:0), edge rows and columns replicated;
//       - the fixed-point YCbCr -> RGB of jdcolor.c (16 fractional bits,
//         FIX(1.402), FIX(1.772), FIX(0.71414), FIX(0.34414), rounding as
//         its tables do);
//     a one-component JPEG gives B = G = R = Y, as cv2 gives it.
//   * the grey image is the Y plane itself: cv2.imread(IMREAD_GRAYSCALE)
//     of a YCbCr JPEG is libjpeg's Y component, not a conversion of BGR.
//
// What bounds the kernels: bytes. The IDCT reads 2 bytes a coefficient and
// writes 1 a sample, the colour kernel reads 1.5 bytes a pixel (4:2:0) and
// writes 3; the host's entropy decoding takes far longer than either.
//
// Encoding (previews, workspaces) is nvJPEG's encoder (the CUDA toolkit's
// libnvjpeg): interleaved BGR at the caller's quality and 4:2:0
// (cv2.imwrite's default), or one grey component.
//
// The C interface below is bound with ctypes by mpmvs_torch/io/images.py.
// Every function returns 0 or an error code: an nvJPEG status (1-9), a
// decode error of jpeg_entropy.h (2001-2003) or a CUDA error offset by 1000.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <stdint.h>
#include <stdlib.h>

#include "jpeg_entropy.h"
#include "jpeg_idct.h"

#define CODEC_CUDA_ERR 1000

struct Codec {
  nvjpegHandle_t handle;
  nvjpegEncoderState_t enc_state;
  nvjpegEncoderParams_t enc_params;
};

#define NV_TRY(x)                                  \
  do {                                             \
    nvjpegStatus_t s_ = (x);                       \
    if (s_ != NVJPEG_STATUS_SUCCESS) return (int)s_; \
  } while (0)

extern "C" int jpeg_codec_create(void** out) {
  Codec* c = (Codec*)calloc(1, sizeof(Codec));
  if (c == NULL) return CODEC_CUDA_ERR + (int)cudaErrorMemoryAllocation;
  NV_TRY(nvjpegCreateSimple(&c->handle));
  NV_TRY(nvjpegEncoderStateCreate(c->handle, &c->enc_state, 0));
  NV_TRY(nvjpegEncoderParamsCreate(c->handle, &c->enc_params, 0));
  *out = c;
  return 0;
}

// Parse and entropy-decode a JPEG on the host. info receives the number of
// components, the width and height, then per component six values: its
// plane's width and height (the sampled size, ceil(W * h / hmax)), the
// coefficient array's blocks across and down (padded to whole MCUs), and the
// blocks that cover the plane across and down. *out holds the coefficients
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
__global__ void ycc_to_bgr_kernel(const unsigned char* __restrict__ y,
                                  const unsigned char* __restrict__ cb,
                                  const unsigned char* __restrict__ cr,
                                  int H, int W, int Hc, int Wc, int hs, int vs,
                                  unsigned char* __restrict__ bgr) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y;
  if (col >= W) return;
  int Y = y[r * W + col];
  unsigned char* o = bgr + 3 * ((size_t)r * W + col);
  if (cb == NULL) {
    o[0] = o[1] = o[2] = (unsigned char)Y;
    return;
  }
  int xb = chroma_at(cb, Wc, Hc, Wc, r, col, hs, vs) - 128;
  int xr = chroma_at(cr, Wc, Hc, Wc, r, col, hs, vs) - 128;
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
                                 int Wc, int hs, int vs, unsigned char* bgr,
                                 cudaStream_t stream) {
  dim3 block(256);
  dim3 grid((W + 255) / 256, H);
  ycc_to_bgr_kernel<<<grid, block, 0, stream>>>(y, cb, cr, H, W, Hc, Wc, hs,
                                                vs, bgr);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

// Encode an (H, W, 3) interleaved BGR image (channels 3) at 4:2:0, or an
// (H, W) grey image (channels 1), on the stream; the stream is synchronised
// and the bitstream's length written to *length. jpeg_codec_retrieve copies
// it out.
extern "C" int jpeg_codec_encode(void* codec, const unsigned char* img, int H,
                                 int W, int channels, int quality,
                                 cudaStream_t stream, size_t* length) {
  Codec* c = (Codec*)codec;
  nvjpegImage_t src = {};
  src.channel[0] = (unsigned char*)img;
  NV_TRY(nvjpegEncoderParamsSetQuality(c->enc_params, quality, stream));
  NV_TRY(nvjpegEncoderParamsSetOptimizedHuffman(c->enc_params, 0, stream));
  if (channels == 3) {
    src.pitch[0] = 3 * W;
    NV_TRY(nvjpegEncoderParamsSetSamplingFactors(c->enc_params,
                                                 NVJPEG_CSS_420, stream));
    NV_TRY(nvjpegEncodeImage(c->handle, c->enc_state, c->enc_params, &src,
                             NVJPEG_INPUT_BGRI, W, H, stream));
  } else {
    src.pitch[0] = W;
    NV_TRY(nvjpegEncoderParamsSetSamplingFactors(c->enc_params,
                                                 NVJPEG_CSS_GRAY, stream));
    NV_TRY(nvjpegEncodeYUV(c->handle, c->enc_state, c->enc_params, &src,
                           NVJPEG_CSS_GRAY, W, H, stream));
  }
  NV_TRY(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, NULL, length,
                                       stream));
  cudaError_t e = cudaStreamSynchronize(stream);
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}

extern "C" int jpeg_codec_retrieve(void* codec, unsigned char* out,
                                   size_t* length, cudaStream_t stream) {
  Codec* c = (Codec*)codec;
  NV_TRY(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, out, length,
                                       stream));
  cudaError_t e = cudaStreamSynchronize(stream);
  return e == cudaSuccess ? 0 : CODEC_CUDA_ERR + (int)e;
}
