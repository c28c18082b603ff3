// libjpeg-turbo's inter-block smoothing of a progressive JPEG (jdcoefct.c
// decompress_smooth_data, 3.1), for one block of a component: the card's
// jpeg_smooth_kernel (jpeg_codec.cu) runs it a thread a block, and the host
// builds it for the tests; the plain PyTorch version is
// mpmvs_torch/io/images.py::jpeg_smooth_plain.
//
// libjpeg smooths a progressive image's blocks when smoothing_ok says so
// (jpeg_entropy.h smoothing latches it): every component's DC is at least
// partly known, its quantization entries of the DC and of the first nine AC
// coefficients are non-zero, and some of those nine coefficients are not
// yet exact. Then each block's first nine AC coefficients that are still 0
// and not exact are estimated from the DC values of the 5 x 5 blocks around
// it; where no AC coefficient of the nine is known at all, with a
// Gaussian-like kernel that estimates three more and the DC too. All of it
// is integer arithmetic: Q00 times a weighted sum of DC values, divided by
// the coefficient's quantization entry times 256 and rounded, then clamped
// below 2^Al where the coefficient's Al is positive. The IDCT then runs on
// the smoothed block.
//
// The neighbourhood is libjpeg's: columns clamp to the blocks that cover
// the component's samples (width_in_blocks), rows follow its iMCU-row walk,
// which clamps to height_in_blocks except that a block two rows above the
// last iMCU row's first may read the MCU padding's row below the image
// (its DC as the interleaved DC scan left it), and the last iMCU row's
// rows index as if each iMCU row held only its own number of rows. The
// iMCU rows past the one in which the input ran out of data take the
// progression status from before the last scan (libjpeg's
// prev_coef_bits).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define JPEG_HD __host__ __device__ __forceinline__
#else
#define JPEG_HD static inline
#endif

namespace jpeg_smooth {

enum { kSaved = 10 };  // libjpeg's SAVED_COEFS: the DC and 9 AC coefficients

// A component's smoothing: its coefficient array's geometry, libjpeg's
// latched progression status of the ten coefficients (bits: after the last
// scan; prev: before it, for the iMCU rows past last_good, the row in which
// the input ran out of data) and its quantization entries q[k], k the zigzag
// index (Q00, Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30).
struct Params {
  int blocks_w, blocks_h;                  // the array (padded to MCUs)
  int width_in_blocks, height_in_blocks;   // the blocks of the samples
  int v;                                   // the component's v factor
  int total_imcu_rows, last_good;          // the frame's iMCU rows
  int bits[kSaved], prev[kSaved];
  int q[kSaved];
};

// Params from jpeg_entropy::smoothing's kSmoothInts ints of a component.
JPEG_HD Params params_of(const int* v) {
  Params p;
  p.blocks_w = v[0];
  p.blocks_h = v[1];
  p.width_in_blocks = v[2];
  p.height_in_blocks = v[3];
  p.v = v[4];
  p.total_imcu_rows = v[5];
  p.last_good = v[6];
  for (int k = 0; k < kSaved; k++) {
    p.bits[k] = v[7 + k];
    p.prev[k] = v[17 + k];
    p.q[k] = v[27 + k];
  }
  return p;
}

// The rows decompress_smooth_data reads around block row by: rows[0..4] =
// two above, one above, its own, one below, two below.
JPEG_HD void window_rows(const Params& p, int by, int* rows) {
  int imcu = by / p.v, br = by - imcu * p.v;
  int last = p.total_imcu_rows - 1;
  int block_rows = p.v;
  if (imcu == last) {
    block_rows = p.height_in_blocks % p.v;
    if (block_rows == 0) block_rows = p.v;
  }
  int image_block_rows = block_rows * p.total_imcu_rows;
  int image_block_row = imcu * block_rows + br;
  rows[2] = by;
  rows[1] = image_block_row > 0 ? by - 1 : by;
  rows[0] = image_block_row > 1 ? by - 2 : rows[1];
  rows[3] = image_block_row < image_block_rows - 1 ? by + 1 : by;
  rows[4] = image_block_row < image_block_rows - 2 ? by + 2 : rows[3];
}

// The estimate of a coefficient of quantization entry q from num = Q00
// times the DC sum, clamped below 2^al where al > 0.
JPEG_HD int estimate(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// Block (bx, by) of coef (blocks_h x blocks_w x 64 int16, natural order)
// into out[0..63]: the block as it is outside the samples' blocks, else
// smoothed.
JPEG_HD void smooth_block(const int16_t* coef, const Params& p, int bx,
                          int by, int16_t* out) {
  const int16_t* blk = coef + ((int64_t)by * p.blocks_w + bx) * 64;
  for (int k = 0; k < 64; k++) out[k] = blk[k];
  if (bx >= p.width_in_blocks || by >= p.height_in_blocks) return;
  int rows[5];
  window_rows(p, by, rows);
  int dc[5][5];  // dc[row][column], the block at dc[2][2]
  for (int i = 0; i < 5; i++) {
    for (int j = 0; j < 5; j++) {
      int x = bx + j - 2;
      x = x < 0 ? 0 : (x > p.width_in_blocks - 1 ? p.width_in_blocks - 1 : x);
      dc[i][j] = coef[((int64_t)rows[i] * p.blocks_w + x) * 64];
    }
  }
  const int* bits = by / p.v > p.last_good ? p.prev : p.bits;
  bool change_dc = true;
  for (int k = 1; k < kSaved; k++) change_dc = change_dc && bits[k] == -1;
  // libjpeg's DC01..DC25, row by row
  const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2],
            DC04 = dc[0][3], DC05 = dc[0][4], DC06 = dc[1][0],
            DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3],
            DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
            DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4],
            DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2],
            DC19 = dc[3][3], DC20 = dc[3][4], DC21 = dc[4][0],
            DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
            DC25 = dc[4][4];
  const int64_t Q00 = p.q[0];
  int64_t sums[kSaved];
  if (change_dc) {
    sums[1] = -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
              13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
              3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
              DC21 - DC22 + DC24 + DC25;
    sums[2] = -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
              13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
              13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
              3 * DC22 + 3 * DC23 + 3 * DC24 + DC25;
    sums[3] = DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
              14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23;
    sums[4] = -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
              DC21 - DC25;
    sums[5] = 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
              14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19;
    sums[6] = DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19;
    sums[7] = DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19;
    sums[8] = DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19;
    sums[9] = DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19;
  } else {
    sums[1] = -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15;
    sums[2] = -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23;
    sums[3] = -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23;
    sums[4] = DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
              DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09;
    sums[5] = -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15;
  }
  // the natural-order positions of the zigzag coefficients 0..9
  const int pos[kSaved] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  const int n = change_dc ? kSaved : 6;
  for (int k = 1; k < n; k++) {
    int al = bits[k];
    if (al != 0 && out[pos[k]] == 0)
      out[pos[k]] = (int16_t)estimate(Q00 * sums[k], p.q[k], al);
  }
  if (change_dc) {
    int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                         2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                         6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                         6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                         2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                         2 * DC25);
    out[0] = (int16_t)estimate(num, Q00, 0);
  }
}

}  // namespace jpeg_smooth
