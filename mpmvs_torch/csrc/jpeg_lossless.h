// Host-side entropy decoding of lossless JPEG scans (SOF3, T.81 Annex H) to
// sample differences, for jpeg_entropy.h: libjpeg-turbo's jdlhuff.c with
// the scan checks of jdinput.c and the restart logic of jddiffct.c. The
// card undifferences them (jpeg_codec.cu: ljpeg_scan_kernel and
// ljpeg_wavefront_kernel, their arithmetic in jpeg_lossless_pred.h).
//
//   * A lossless scan's Ss is its predictor (1-7), its Al the point
//     transform Pt; Se and Ah must be 0 and Pt below the precision, or
//     libjpeg refuses the scan (kLosslessScan).
//   * Each sample's difference is a DC-class Huffman symbol SSSS (0-16) and
//     SSSS more bits, HUFF_EXTENDed; SSSS 16 means 32768 with no bits. It
//     is kept as int16 (32768 wraps to -32768: the undifferencing is mod
//     2^16). Samples an interleaved MCU holds past the component's edge
//     are decoded and dropped, as libjpeg drops them.
//   * The restart interval must be whole MCU rows (jddiffct.c
//     start_input_pass, JERR_BAD_RESTART: kLosslessRestart). A restart, and
//     the scan's start, makes the first row of the iMCU row it falls in
//     predict as a first row (predictor 1 from 2^(P - Pt - 1)): libjpeg
//     sets each component's undifferencer to the first-row one then and
//     undifferences an iMCU row after decoding it. An interleaved scan's
//     MCU row is an iMCU row (v rows of the component); a non-interleaved
//     scan's iMCU row is v of its MCU rows, and a restart inside one marks
//     its first row. Component::first holds the marks.
//   * Once a read goes past the data (a stream cut short), each later MCU
//     row's differences are zeros and its first row a first row, as
//     jdlhuff.c zeroes them and restarts the undifferencer.
// The bit reader and the Huffman tables are jpeg_entropy.h's.

#pragma once

#include "jpeg_entropy.h"

namespace jpeg_entropy {

// H.2.2: a sample difference of category s (16: 32768, no bits).
static inline int lossless_diff(Decoder* d, int s) {
  if (s == 0 || s > 16) return 0;  // a corrupt category reads as 0
  if (s == 16) return 32768;
  return extend(get_bits(d, s), s);
}

static int decode_lossless_scan(Decoder* d, Component** sc, int ns, int ss,
                                int se, int ah, int al, const uint8_t* data,
                                size_t length, size_t start) {
  if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= d->precision)
    return kLosslessScan;
  for (int i = 0; i < ns; i++)
    if (!huffman_table(d, true, sc[i]->dc_tbl)) return kBadStream;
  const int mcus_x = ns == 1 ? sc[0]->width_in_blocks : d->mcus_x;
  const int mcus_y = ns == 1 ? sc[0]->height_in_blocks : d->mcus_y;
  if (d->restart_interval % mcus_x) return kLosslessRestart;
  const int restart_rows = d->restart_interval / mcus_x;
  d->data = data;
  d->length = length;
  d->pos = start;
  d->bitbuf = 0;
  d->bitcnt = 0;
  d->real_bits = 0;
  d->insufficient = false;
  d->hit_marker = false;
  for (int i = 0; i < ns; i++) {
    sc[i]->predictor = ss;
    sc[i]->pt = al;
  }
  for (int my = 0; my < mcus_y; my++) {
    bool fresh = my == 0;
    if (restart_rows && my > 0 && my % restart_rows == 0) {
      restart(d);
      fresh = true;
    }
    // jdlhuff.c decode_mcus: once the data has run out, an MCU row's
    // differences are zeros and the undifferencer starts again (its first
    // row rule): the samples are 2^(P - Pt - 1)
    const bool empty = d->insufficient;
    fresh = fresh || empty;
    if (fresh) {
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int row = ns == 1 ? my / c.v * c.v : my * c.v;
        if (row < c.height_in_blocks) c.first[row] = 1;
      }
    }
    for (int mx = 0; mx < mcus_x && !empty; mx++) {
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        const Huffman* t = &d->dc[c.dc_tbl];
        int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; by++) {
          for (int bx = 0; bx < bw; bx++) {
            int diff = lossless_diff(d, decode_symbol(d, t));
            int row = ns == 1 ? my : my * c.v + by;
            int col = ns == 1 ? mx : mx * c.h + bx;
            if (row < c.height_in_blocks && col < c.width_in_blocks)
              c.diff[(size_t)row * c.width_in_blocks + col] = (int16_t)diff;
          }
        }
      }
    }
  }
  return kOk;
}

// Copy component comp's differences and first-row marks out (the card's
// jpeg_host_lossless, and the tests' host build).
static int lossless_planes(const Decoder* d, int comp, int16_t* diff,
                           uint8_t* first) {
  if (!d->lossless || comp < 0 || comp >= d->ncomp) return kBadStream;
  const Component& c = d->comp[comp];
  memcpy(diff, c.diff.data(), c.diff.size() * sizeof(int16_t));
  memcpy(first, c.first.data(), c.first.size());
  return kOk;
}

}  // namespace jpeg_entropy
