// The arithmetic of vp8_reconstruct_kernel (jpeg_codec.cu): a lossy WebP's
// key frame (VP8, RFC 6386) rebuilt from its modes and quantized
// coefficients into unfiltered Y, U and V planes, one macroblock (MB) at a
// time. Shared by the kernel and by the host, where the tests build it with
// g++; the plain PyTorch version is
// mpmvs_torch/io/images.py::vp8_reconstruct_plain.
//
// What an MB holds (webp_decode.h writes it on the host):
//   * a record of 4 int32 (Record): whether its luma is predicted as 16
//     4x4 sub-blocks, the 16x16 luma mode or the 16 sub-block modes, the
//     chroma mode, the segment, whether the loop filter runs its inner
//     edges, and which 4x4 blocks have coefficients;
//   * 25 x 16 int16 quantized coefficients in natural (row-major 4x4)
//     order: block 0 the Y2 (the luma DCs' Walsh-Hadamard block, 16x16
//     modes only), 1-16 the luma blocks in raster order, 17-20 U, 21-24 V.
// Per segment the dequantization factors (Params.dq) of RFC 6386 section
// 14.1, as libwebp's quant_dec.c makes them.
//
// The rules followed, RFC 6386 and libwebp's (dec/frame_dec.c
// ReconstructRow, dsp/dec.c):
//   * dequantization is level * factor stored as int16 (libwebp's
//     GetCoeffs writes the product into an int16_t);
//   * the inverse WHT (section 14.3) and the inverse DCT (section 14.4,
//     20091 and 35468 in 16-bit fixed point) are libwebp's TransformWHT_C
//     and TransformOne_C, whose other forms (DC only, AC3) give the same
//     samples;
//   * intra prediction (section 12) reads the unfiltered samples of the MBs
//     above and to the left; outside the frame the row above is 127 (its
//     top-left corner too) and the column to the left 129 (its top-left
//     corner where the MB is not in the top row); the sub-block modes of the
//     rightmost column read, as their above-right samples, the 4 samples of
//     the row above the MB to the right of the MB above (the last sample of
//     the row above, 4 times, in the rightmost MB; 127 in the top row), for
//     sub-block rows 1-3 too; DC modes of 16x16 luma and of chroma average
//     only the edges inside the frame (128 with none: libwebp's CheckMode).
// The arithmetic is all integer: no fast math or contraction applies.
//
// The MB is rebuilt in a working buffer with libwebp's yuv_b_ layout
// (MBBuf): a row of samples above and a column to the left of each plane,
// and 4 above-right luma samples. A function here takes (lane, lanes): on
// the card the 32 lanes of a warp share the work between VP8_SYNC()
// barriers; on the host one lane does all of it, in the same order of
// phases.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define VP8_HD __host__ __device__ __forceinline__
#else
#define VP8_HD static inline
#endif

#if defined(__CUDA_ARCH__)
#define VP8_SYNC() __syncwarp()
#define VP8_LD(p) __ldcg(p)  // another SM's stores: read through L2
#else
#define VP8_SYNC() ((void)0)
#define VP8_LD(p) (*(p))
#endif

namespace vp8 {

// libwebp's numbering of the intra modes (dec/common_dec.h): the 16x16
// luma and chroma modes are the first four.
// CheckMode's DC forms at the frame's edges follow the four (16x16 and
// chroma only).
enum { kDC = 0, kTM, kVE, kHE, kRD, kVR, kLD, kVL, kHD, kHU,
       kDCNoTop = 4, kDCNoLeft, kDCNoTopLeft };

constexpr int kCoefsPerMB = 25 * 16;

// Record word 0: flags; words 1, 2: the 16 sub-block modes, 4 bits each
// (sub-block n in word 1 + n / 8, bits 4 (n % 8)); word 3: bit b (0-15) a
// luma block, 16-19 U, 20-23 V, that has coefficients (libwebp's
// non_zero_y / non_zero_uv).
enum {
  kI4x4 = 1,            // bit 0: 16 sub-block modes
  kYModeShift = 1,      // bits 1-2: the 16x16 mode
  kUVModeShift = 3,     // bits 3-4: the chroma mode
  kSegmentShift = 5,    // bits 5-6: the segment
  kInner = 1 << 7,      // bit 7: the loop filter runs the inner edges
};

struct Record {
  int32_t flags, modes_lo, modes_hi, nz;
};

VP8_HD int record_submode(const Record& r, int n) {
  int32_t w = n < 8 ? r.modes_lo : r.modes_hi;
  return (w >> (4 * (n & 7))) & 15;
}

// Per segment: dequantization factors (y1 DC, y1 AC, y2 DC, y2 AC, uv DC,
// uv AC); per segment and form (16x16 luma, sub-blocks) the loop filter's
// limit, interior limit and high-edge-variance threshold; the filter type
// (0 none, 1 simple, 2 normal). As 49 ints: dq, then filter, then type.
struct Params {
  int dq[4][6];
  int filter[4][2][3];
  int filter_type;
};

VP8_HD Params params_of(const int* p) {
  Params q;
  for (int i = 0; i < 24; i++) q.dq[i / 6][i % 6] = p[i];
  for (int i = 0; i < 24; i++) q.filter[i / 6][(i / 3) & 1][i % 3] = p[24 + i];
  q.filter_type = p[48];
  return q;
}

constexpr int BPS = 32;            // the luma buffer's row stride
constexpr int UV_BPS = 16;         // a chroma buffer's
constexpr int Y_OFF = BPS + 8;     // sample (0, 0): row -1 above, col -1 left
constexpr int UV_OFF = UV_BPS + 4;

struct MBBuf {
  uint8_t y[17 * BPS];
  uint8_t u[9 * UV_BPS];
  uint8_t v[9 * UV_BPS];
  int16_t coef[kCoefsPerMB];  // dequantized; luma DCs from the WHT
};

// The planes an image's MBs are rebuilt into: Y of (16 mb_h, 16 mb_w), U
// and V of (8 mb_h, 8 mb_w), row-major.
struct Planes {
  uint8_t* y;
  uint8_t* u;
  uint8_t* v;
  int mb_w, mb_h;
};

VP8_HD int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// libwebp's TransformWHT_C: the 16 luma DCs (raster order) of the
// dequantized Y2 block.
VP8_HD void iwht(const int16_t* in, int16_t* dc) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc0 = tmp[0 + i * 4] + 3;
    const int a0 = dc0 + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc0 - tmp[3 + i * 4];
    dc[4 * i + 0] = (int16_t)((a0 + a1) >> 3);
    dc[4 * i + 1] = (int16_t)((a3 + a2) >> 3);
    dc[4 * i + 2] = (int16_t)((a0 - a1) >> 3);
    dc[4 * i + 3] = (int16_t)((a3 - a2) >> 3);
  }
}

VP8_HD int mul1(int a) { return ((a * 20091) >> 16) + a; }
VP8_HD int mul2(int a) { return (a * 35468) >> 16; }

// libwebp's TransformOne_C: the inverse DCT of a dequantized block added
// to the prediction at dst (row stride `stride`), clamped.
VP8_HD void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = (uint8_t)clip8(dst[0] + ((a + d) >> 3));
    dst[1] = (uint8_t)clip8(dst[1] + ((b + c) >> 3));
    dst[2] = (uint8_t)clip8(dst[2] + ((b - c) >> 3));
    dst[3] = (uint8_t)clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += stride;
  }
}

VP8_HD uint8_t avg3(int a, int b, int c) {
  return (uint8_t)((a + 2 * b + c + 2) >> 2);
}
VP8_HD uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

// libwebp's 4x4 predictors (dsp/dec.c VE4_C ... HU4_C) at dst in the luma
// buffer: the row above (top-left at -1, above-right at 4..7) and the
// column to the left are in place.
VP8_HD void pred4(int mode, uint8_t* dst) {
#define DST(x, y) dst[(x) + (y) * BPS]
  const uint8_t* top = dst - BPS;
  const int X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case kDC: {
      int dc = 4 + A + B + C + D + I + J + K + L;
      dc >>= 3;
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) DST(x, y) = (uint8_t)dc;
      break;
    }
    case kTM:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
          DST(x, y) = (uint8_t)clip8(top[x] + dst[-1 + y * BPS] - X);
      break;
    case kVE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) DST(x, y) = v[x];
      break;
    }
    case kHE: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L),
                            avg3(K, L, L)};
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) DST(x, y) = v[y];
      break;
    }
    case kRD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case kVR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case kLD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case kVL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case kHD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(X, I, J);
      DST(1, 2) = DST(3, 3) = avg3(I, J, K);
      DST(1, 3) = avg3(J, K, L);
      break;
    default:  // kHU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = (uint8_t)L;
      break;
  }
#undef DST
}

// libwebp's CheckMode: the DC form a 16x16 or chroma DC mode takes at the
// frame's top and left edges.
VP8_HD int check_mode(int mbx, int mby, int mode) {
  if (mode != kDC) return mode;
  if (mbx == 0) return mby == 0 ? kDCNoTopLeft : kDCNoLeft;
  return mby == 0 ? kDCNoTop : kDC;
}

// Sample (r, c) of an n x n block (16: luma, 8: chroma) predicted by a
// 16x16 or chroma mode (check_mode's form) at dst (row stride bps):
// libwebp's DC16 ... TM16 and DC8uv ... TM8uv.
VP8_HD uint8_t pred_block_sample(int mode, const uint8_t* dst, int bps,
                                 int n, int r, int c) {
  const uint8_t* top = dst - bps;
  const int shift = n == 16 ? 4 : 3;
  switch (mode) {
    case kVE:
      return top[c];
    case kHE:
      return dst[-1 + r * bps];
    case kTM:
      return (uint8_t)clip8(top[c] + dst[-1 + r * bps] - top[-1]);
    case kDCNoTopLeft:
      return 0x80;
    default: {
      int dc = 0;
      if (mode != kDCNoTop)
        for (int i = 0; i < n; i++) dc += top[i];
      if (mode != kDCNoLeft)
        for (int i = 0; i < n; i++) dc += dst[-1 + i * bps];
      if (mode == kDC) return (uint8_t)((dc + n) >> (shift + 1));
      return (uint8_t)((dc + (n >> 1)) >> shift);
    }
  }
}

// The value of a border sample of an MB's buffer, from the unfiltered
// planes: the row above (r = -1, c = -1..19 for luma, -1..7 for chroma) or
// the column to the left (c = -1, r >= 0). `plane` is 0 (Y), 1 (U), 2 (V).
VP8_HD uint8_t border_sample(const Planes& pl, int plane, int mbx, int mby,
                             int r, int c) {
  const int n = plane == 0 ? 16 : 8;
  const int stride = n * pl.mb_w;
  const uint8_t* p = plane == 0 ? pl.y : plane == 1 ? pl.u : pl.v;
  const int y0 = n * mby, x0 = n * mbx;
  if (r < 0) {
    if (mby == 0) return 127;
    if (c < 0 && mbx == 0) return 129;
    if (c >= 16 && mbx == pl.mb_w - 1) c = 15;  // no MB to the above right
    return VP8_LD(p + (size_t)(y0 - 1) * stride + x0 + c);
  }
  if (mbx == 0) return 129;
  return VP8_LD(p + (size_t)(y0 + r) * stride + x0 - 1);
}

// Rebuild MB (mbx, mby) into the planes from its record and coefficients,
// reading its neighbours' unfiltered samples there. `buf` is the working
// buffer (the warp's shared memory on the card).
VP8_HD void reconstruct_mb(const Record& rec, const int16_t* coefs,
                           const Params& prm, const Planes& pl, int mbx,
                           int mby, MBBuf& buf, int lane, int lanes) {
  const int seg = (rec.flags >> kSegmentShift) & 3;
  const int* dq = prm.dq[seg];
  const bool i4x4 = rec.flags & kI4x4;
  // phase 0: the borders, and the coefficients dequantized
  for (int i = lane; i < 21 + 16 + 2 * (9 + 8) + kCoefsPerMB; i += lanes) {
    if (i < 21) {
      buf.y[Y_OFF - BPS + i - 1] = border_sample(pl, 0, mbx, mby, -1, i - 1);
    } else if (i < 37) {
      buf.y[Y_OFF + (i - 21) * BPS - 1] =
          border_sample(pl, 0, mbx, mby, i - 21, -1);
    } else if (i < 37 + 34) {
      const int k = i - 37, plane = 1 + k / 17, j = k % 17;
      uint8_t* b = plane == 1 ? buf.u : buf.v;
      if (j < 9)
        b[UV_OFF - UV_BPS + j - 1] = border_sample(pl, plane, mbx, mby, -1,
                                                   j - 1);
      else
        b[UV_OFF + (j - 9) * UV_BPS - 1] =
            border_sample(pl, plane, mbx, mby, j - 9, -1);
    } else {
      const int k = i - 71, blk = k >> 4, pos = k & 15;
      // Y2: y2 factors; luma: y1 (the DC of a 16x16 MB's block comes from
      // the WHT); chroma: uv
      const int* f = blk == 0 ? dq + 2 : blk <= 16 ? dq : dq + 4;
      buf.coef[k] = (int16_t)(coefs[k] * (pos == 0 ? f[0] : f[1]));
    }
  }
  VP8_SYNC();
  // phase 1: the luma DCs of a 16x16 MB; the predictions of 16x16 luma and
  // of chroma; the above-right samples repeated for sub-block rows 1-3
  const int ymode = check_mode(mbx, mby, (rec.flags >> kYModeShift) & 3);
  const int uvmode = check_mode(mbx, mby, (rec.flags >> kUVModeShift) & 3);
  if (!i4x4 && lane == 0) {
    int16_t dc[16];
    iwht(buf.coef, dc);
    for (int b = 0; b < 16; b++) buf.coef[16 * (1 + b)] = dc[b];
  }
  for (int i = lane; i < 256 + 128 + 12; i += lanes) {
    if (i < 256) {
      if (!i4x4)
        buf.y[Y_OFF + (i >> 4) * BPS + (i & 15)] = pred_block_sample(
            ymode, buf.y + Y_OFF, BPS, 16, i >> 4, i & 15);
    } else if (i < 384) {
      const int k = i - 256, r = (k >> 3) & 7, c = k & 7;
      uint8_t* b = k < 64 ? buf.u : buf.v;
      b[UV_OFF + r * UV_BPS + c] = pred_block_sample(uvmode, b + UV_OFF,
                                                     UV_BPS, 8, r, c);
    } else {
      const int k = i - 384;  // rows 3, 7, 11 at columns 16..19
      buf.y[Y_OFF + (4 * (k >> 2) + 3) * BPS + 16 + (k & 3)] =
          buf.y[Y_OFF - BPS + 16 + (k & 3)];
    }
  }
  VP8_SYNC();
  // phase 2: the residuals. Sub-block modes: the 16 sub-blocks in order,
  // each predicted from the ones before it; else the 16 luma blocks at
  // once. The chroma blocks beside either.
  for (int i = lane; i < (i4x4 ? 1 : 16) + 8; i += lanes) {
    const int nl = i4x4 ? 1 : 16;
    if (i < nl) {
      if (i4x4) {
        for (int n = 0; n < 16; n++) {
          uint8_t* dst = buf.y + Y_OFF + (n >> 2) * 4 * BPS + (n & 3) * 4;
          pred4(record_submode(rec, n), dst);
          if (rec.nz & (1 << n)) idct_add(buf.coef + 16 * (1 + n), dst, BPS);
        }
      } else if (rec.nz & (1 << i)) {
        idct_add(buf.coef + 16 * (1 + i),
                 buf.y + Y_OFF + (i >> 2) * 4 * BPS + (i & 3) * 4, BPS);
      }
    } else {
      const int k = i - nl;  // 0-3 U, 4-7 V, raster within each
      uint8_t* b = k < 4 ? buf.u : buf.v;
      if (rec.nz & (1 << (16 + k)))
        idct_add(buf.coef + 16 * (17 + k),
                 b + UV_OFF + ((k & 3) >> 1) * 4 * UV_BPS + (k & 1) * 4,
                 UV_BPS);
    }
  }
  VP8_SYNC();
  // phase 3: the MB's samples into the planes
  for (int i = lane; i < 256 + 128; i += lanes) {
    if (i < 256) {
      const int r = i >> 4, c = i & 15;
      pl.y[(size_t)(16 * mby + r) * 16 * pl.mb_w + 16 * mbx + c] =
          buf.y[Y_OFF + r * BPS + c];
    } else {
      const int k = i - 256, r = (k >> 3) & 7, c = k & 7;
      uint8_t* p = k < 64 ? pl.u : pl.v;
      p[(size_t)(8 * mby + r) * 8 * pl.mb_w + 8 * mbx + c] =
          (k < 64 ? buf.u : buf.v)[UV_OFF + r * UV_BPS + c];
    }
  }
  VP8_SYNC();
}

}  // namespace vp8
