// The per-sample arithmetic of the lossless JPEG undifferencing, libjpeg-
// turbo's jdlossls.c, shared by the card's two kernels (jpeg_codec.cu:
// ljpeg_scan_kernel, ljpeg_wavefront_kernel) and by the host, where the
// tests build it with g++; the plain PyTorch version is
// mpmvs_torch/io/images.py::ljpeg_undiff_plain.
//
// A component's sample x at (r, c) is (diff + prediction) & 0xFFFF, from
// its rebuilt neighbours Ra (r, c - 1), Rb (r - 1, c) and Rc (r - 1, c - 1):
//   * on a row that predicts as a first row (the scan's first, and the
//     first after each restart: jpeg_lossless.h marks them), predictor 1,
//     with 2^(P - Pt - 1) for column 0 (INITIAL_PREDICTORx);
//   * in column 0 of any other row, Rb (INITIAL_PREDICTOR2);
//   * elsewhere the scan's predictor, in int arithmetic: 1 Ra, 2 Rb, 3 Rc,
//     4 Ra + Rb - Rc, 5 Ra + ((Rb - Rc) >> 1), 6 Rb + ((Ra - Rc) >> 1),
//     7 (Ra + Rb) >> 1, the shifts arithmetic on signed values.
// The output sample is (x << Pt) narrowed to 8 bits (simple_upscale into a
// JSAMPLE), as cv2 gets it.
//
// The scan form (predictors 1-4: linear mod 2^16, so prefix sums). Within a
// band of rows r0..r1 - 1 (a first row and the rows up to the next one), I
// the initial value, R[r][c] = D[r][0] + ... + D[r][c] (mod 2^16) the
// prefix sum of row r's differences, and C(r) = D[r0][0] + ... + D[r][0]:
//   * row r0: x[r0][c] = I + R[r0][c]; column 0: x[r][0] = I + C(r);
//   * 1: x[r][c] = x[r][0] + D[r][1] + ... + D[r][c] = I + C(r - 1) +
//     R[r][c] (C(r0 - 1) = 0), so row r0 is the same rule;
//   * 2: x[r][c] = x[r0][c] + D[r0 + 1][c] + ... + D[r][c] = I + R[r0][c]
//     + the column's sum below r0;
//   * 4: with E = D but E[r0][0] = D[r0][0] + I, x[r][c] - x[r][c - 1] -
//     x[r - 1][c] + x[r - 1][c - 1] = D[r][c] inside the band, and row r0
//     and column 0 are E's prefix sums, so x is E's 2-D prefix sum:
//     x[r][c] = I + R[r0][c] + ... + R[r][c];
//   * 3: x[r][c] = x[r - 1][c - 1] + D[r][c] walks a diagonal c - (r - r0)
//     = d down to its start: row r0 at column d (I + R[r0][d]) for d >= 0,
//     column 0 at row r0 - d (I + C(r0 - d)) for d < 0.
// So two passes: pass A, a warp a row, its prefix sum R (every row for
// predictors 1 and 4, the band's first row for 2 and 3); pass B, a lane a
// column (1, 2, 4) or a diagonal (3) walking the band's rows
// (scan_walk). The wavefront form (predictors 5-7, whose shifted sums are
// not associative) rebuilds sample after sample (wave_step).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define LJPEG_HD __host__ __device__ __forceinline__
#else
#define LJPEG_HD static inline
#endif

namespace ljpeg {

// jdlossls.c PREDICTOR1..7
LJPEG_HD int predict(int p, int ra, int rb, int rc) {
  switch (p) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;
  }
}

LJPEG_HD int undiff(int diff, int pred) { return (diff + pred) & 0xFFFF; }

// simple_upscale's (x << Pt) stored in an 8-bit sample
LJPEG_HD uint8_t narrow(int x, int pt) { return (uint8_t)(x << pt); }

LJPEG_HD int initial(int precision, int pt) {
  return 1 << (precision - pt - 1);
}

// One sample by libjpeg's rules: its difference, its column, whether its
// row is a first row, the initial value and its neighbours.
LJPEG_HD int sample(int p, int diff, int c, bool first, int init, int ra,
                    int rb, int rc) {
  int pred = first ? (c == 0 ? init : ra) : (c == 0 ? rb : predict(p, ra, rb,
                                                                   rc));
  return undiff(diff, pred);
}

// One component plane on the card or the host: differences D (h x w
// int16), the prefix sums R (pass A's output, uint16), the output samples
// (uint8), and which rows are first rows.
struct Plane {
  const int16_t* d;
  uint16_t* r;
  uint8_t* out;
  const uint8_t* first;
  int w, h, pt, init;
};

// Pass B of the scan form for one lane: column (predictors 1, 2, 4) or
// diagonal g (3; g = c - (r - r0), from -(r1 - r0 - 1) to w - 1) of the
// band r0..r1 - 1, after pass A (R on the rows the predictor needs). Every
// sum mod 2^16, in 32-bit unsigned words.
LJPEG_HD void scan_walk(int p, const Plane& q, int r0, int r1, int g) {
  const size_t w = q.w;
  uint32_t acc = 0, x = 0;
  if (p == 3) {
    uint32_t col0 = 0;  // C(r)
    for (int r = r0; r < r1; r++) {
      const int c = g + (r - r0);
      col0 += (uint16_t)q.d[r * w];
      if (c >= q.w) break;
      if (c < 0) continue;
      if (r == r0)
        x = q.init + q.r[r0 * w + c];
      else if (c == 0)
        x = q.init + col0;
      else
        x += (uint16_t)q.d[r * w + c];
      q.out[r * w + c] = narrow(x & 0xFFFF, q.pt);
    }
    return;
  }
  const int c = g;
  for (int r = r0; r < r1; r++) {
    if (p == 1) {  // I + C(r - 1) + R[r][c]; acc holds C(r - 1)
      x = q.init + acc + q.r[r * w + c];
      acc += (uint16_t)q.d[r * w];
    } else if (p == 2) {  // I + R[r0][c] + the column's sum below r0
      acc += r == r0 ? q.r[r0 * w + c] : (uint16_t)q.d[r * w + c];
      x = q.init + acc;
    } else {  // 4: I + R[r0][c] + ... + R[r][c]
      acc += q.r[r * w + c];
      x = q.init + acc;
    }
    q.out[r * w + c] = narrow(x & 0xFFFF, q.pt);
  }
}

// The rows pass A scans for predictor p: every row, or first rows only.
LJPEG_HD bool scan_row_needed(int p, const Plane& q, int r) {
  return p == 1 || p == 4 || q.first[r];
}

// One step of a wavefront lane: the sample at column x of its row from its
// difference, with Ra its own last sample (*h1), Rb the row above's at x
// and Rc the row above's at x - 1, the Rb of the step before (*rb_prev).
// Returns the sample (16 bits) and moves the lane's state on.
LJPEG_HD int wave_step(int p, int diff, int x, bool first, int init, int rb,
                       int* h1, int* rb_prev) {
  const int v = sample(p, diff, x, first, init, *h1, rb, *rb_prev);
  *rb_prev = rb;
  *h1 = v;
  return v;
}

}  // namespace ljpeg
