// Host-side decoding of arithmetic-coded JPEG scans (SOF9 sequential and
// SOF10 progressive) to quantized DCT coefficients: a port of
// libjpeg-turbo's jdarith.c, the QM decoder of T.81 Annex D with the
// statistics of Annex F.1.4.4 and G.1.3, for jpeg_entropy.h.
//
// It fills Decoder::comp[*].coef exactly as the Huffman scans do
// (jpeg_entropy.h decode_scan), so the card's IDCT and colour kernels take
// the coefficients unchanged. What it keeps of jdarith.c:
//   * arith_decode: the C and A registers, renormalization with byte input,
//     and the probability estimation of Table D.2 (kQe, state 113 the fixed
//     estimate of 0.5 for signs and DC refinement bits);
//   * get_byte: a stuffed 0xFF 0x00 is a data 0xFF, extra 0xFF bytes are
//     swallowed, and a marker ends the data: from there on zeros are fed
//     (legal in arithmetic coding), and the marker is the one the stream
//     resumes at;
//   * process_restart: at each restart the statistics of the scan's tables
//     and the DC predictions and contexts are reset and the registers
//     re-initialised;
//   * the sequential decode_mcu and the progressive DC first, AC first, DC
//     refine and AC refine routines;
//   * the DAC marker's conditioning, L and U of each DC table and Kx of each
//     AC table (defaults L = 0, U = 1, Kx = 5);
//   * ct = -1 after a magnitude or spectral overflow: the scan's blocks are
//     left as they are (zeros, or what earlier scans gave them) until the
//     next restart, as libjpeg-turbo leaves them.
// Included by jpeg_entropy.h, which declares decode_arith_scan.

#pragma once

#include "jpeg_entropy.h"

namespace jpeg_entropy {

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16, then
// Next_Index_MPS << 8, then Switch_MPS << 7 | Next_Index_LPS.
#define JPEG_ARITH_V(qe, nlps, nmps, sw) \
  (((uint32_t)(qe) << 16) | ((uint32_t)(nmps) << 8) | ((sw) << 7) | (nlps))
static const uint32_t kQe[114] = {
    JPEG_ARITH_V(0x5a1d, 1, 1, 1),     JPEG_ARITH_V(0x2586, 14, 2, 0),
    JPEG_ARITH_V(0x1114, 16, 3, 0),    JPEG_ARITH_V(0x080b, 18, 4, 0),
    JPEG_ARITH_V(0x03d8, 20, 5, 0),    JPEG_ARITH_V(0x01da, 23, 6, 0),
    JPEG_ARITH_V(0x00e5, 25, 7, 0),    JPEG_ARITH_V(0x006f, 28, 8, 0),
    JPEG_ARITH_V(0x0036, 30, 9, 0),    JPEG_ARITH_V(0x001a, 33, 10, 0),
    JPEG_ARITH_V(0x000d, 35, 11, 0),   JPEG_ARITH_V(0x0006, 9, 12, 0),
    JPEG_ARITH_V(0x0003, 10, 13, 0),   JPEG_ARITH_V(0x0001, 12, 13, 0),
    JPEG_ARITH_V(0x5a7f, 15, 15, 1),   JPEG_ARITH_V(0x3f25, 36, 16, 0),
    JPEG_ARITH_V(0x2cf2, 38, 17, 0),   JPEG_ARITH_V(0x207c, 39, 18, 0),
    JPEG_ARITH_V(0x17b9, 40, 19, 0),   JPEG_ARITH_V(0x1182, 42, 20, 0),
    JPEG_ARITH_V(0x0cef, 43, 21, 0),   JPEG_ARITH_V(0x09a1, 45, 22, 0),
    JPEG_ARITH_V(0x072f, 46, 23, 0),   JPEG_ARITH_V(0x055c, 48, 24, 0),
    JPEG_ARITH_V(0x0406, 49, 25, 0),   JPEG_ARITH_V(0x0303, 51, 26, 0),
    JPEG_ARITH_V(0x0240, 52, 27, 0),   JPEG_ARITH_V(0x01b1, 54, 28, 0),
    JPEG_ARITH_V(0x0144, 56, 29, 0),   JPEG_ARITH_V(0x00f5, 57, 30, 0),
    JPEG_ARITH_V(0x00b7, 59, 31, 0),   JPEG_ARITH_V(0x008a, 60, 32, 0),
    JPEG_ARITH_V(0x0068, 62, 33, 0),   JPEG_ARITH_V(0x004e, 63, 34, 0),
    JPEG_ARITH_V(0x003b, 32, 35, 0),   JPEG_ARITH_V(0x002c, 33, 9, 0),
    JPEG_ARITH_V(0x5ae1, 37, 37, 1),   JPEG_ARITH_V(0x484c, 64, 38, 0),
    JPEG_ARITH_V(0x3a0d, 65, 39, 0),   JPEG_ARITH_V(0x2ef1, 67, 40, 0),
    JPEG_ARITH_V(0x261f, 68, 41, 0),   JPEG_ARITH_V(0x1f33, 69, 42, 0),
    JPEG_ARITH_V(0x19a8, 70, 43, 0),   JPEG_ARITH_V(0x1518, 72, 44, 0),
    JPEG_ARITH_V(0x1177, 73, 45, 0),   JPEG_ARITH_V(0x0e74, 74, 46, 0),
    JPEG_ARITH_V(0x0bfb, 75, 47, 0),   JPEG_ARITH_V(0x09f8, 77, 48, 0),
    JPEG_ARITH_V(0x0861, 78, 49, 0),   JPEG_ARITH_V(0x0706, 79, 50, 0),
    JPEG_ARITH_V(0x05cd, 48, 51, 0),   JPEG_ARITH_V(0x04de, 50, 52, 0),
    JPEG_ARITH_V(0x040f, 50, 53, 0),   JPEG_ARITH_V(0x0363, 51, 54, 0),
    JPEG_ARITH_V(0x02d4, 52, 55, 0),   JPEG_ARITH_V(0x025c, 53, 56, 0),
    JPEG_ARITH_V(0x01f8, 54, 57, 0),   JPEG_ARITH_V(0x01a4, 55, 58, 0),
    JPEG_ARITH_V(0x0160, 56, 59, 0),   JPEG_ARITH_V(0x0125, 57, 60, 0),
    JPEG_ARITH_V(0x00f6, 58, 61, 0),   JPEG_ARITH_V(0x00cb, 59, 62, 0),
    JPEG_ARITH_V(0x00ab, 61, 63, 0),   JPEG_ARITH_V(0x008f, 61, 32, 0),
    JPEG_ARITH_V(0x5b12, 65, 65, 1),   JPEG_ARITH_V(0x4d04, 80, 66, 0),
    JPEG_ARITH_V(0x412c, 81, 67, 0),   JPEG_ARITH_V(0x37d8, 82, 68, 0),
    JPEG_ARITH_V(0x2fe8, 83, 69, 0),   JPEG_ARITH_V(0x293c, 84, 70, 0),
    JPEG_ARITH_V(0x2379, 86, 71, 0),   JPEG_ARITH_V(0x1edf, 87, 72, 0),
    JPEG_ARITH_V(0x1aa9, 87, 73, 0),   JPEG_ARITH_V(0x174e, 72, 74, 0),
    JPEG_ARITH_V(0x1424, 72, 75, 0),   JPEG_ARITH_V(0x119c, 74, 76, 0),
    JPEG_ARITH_V(0x0f6b, 74, 77, 0),   JPEG_ARITH_V(0x0d51, 75, 78, 0),
    JPEG_ARITH_V(0x0bb6, 77, 79, 0),   JPEG_ARITH_V(0x0a40, 77, 48, 0),
    JPEG_ARITH_V(0x5832, 80, 81, 1),   JPEG_ARITH_V(0x4d1c, 88, 82, 0),
    JPEG_ARITH_V(0x438e, 89, 83, 0),   JPEG_ARITH_V(0x3bdd, 90, 84, 0),
    JPEG_ARITH_V(0x34ee, 91, 85, 0),   JPEG_ARITH_V(0x2eae, 92, 86, 0),
    JPEG_ARITH_V(0x299a, 93, 87, 0),   JPEG_ARITH_V(0x2516, 86, 71, 0),
    JPEG_ARITH_V(0x5570, 88, 89, 1),   JPEG_ARITH_V(0x4ca9, 95, 90, 0),
    JPEG_ARITH_V(0x44d9, 96, 91, 0),   JPEG_ARITH_V(0x3e22, 97, 92, 0),
    JPEG_ARITH_V(0x3824, 99, 93, 0),   JPEG_ARITH_V(0x32b4, 99, 94, 0),
    JPEG_ARITH_V(0x2e17, 93, 86, 0),   JPEG_ARITH_V(0x56a8, 95, 96, 1),
    JPEG_ARITH_V(0x4f46, 101, 97, 0),  JPEG_ARITH_V(0x47e5, 102, 98, 0),
    JPEG_ARITH_V(0x41cf, 103, 99, 0),  JPEG_ARITH_V(0x3c3d, 104, 100, 0),
    JPEG_ARITH_V(0x375e, 99, 93, 0),   JPEG_ARITH_V(0x5231, 105, 102, 0),
    JPEG_ARITH_V(0x4c0f, 106, 103, 0), JPEG_ARITH_V(0x4639, 107, 104, 0),
    JPEG_ARITH_V(0x415e, 103, 99, 0),  JPEG_ARITH_V(0x5627, 105, 106, 1),
    JPEG_ARITH_V(0x50e7, 108, 107, 0), JPEG_ARITH_V(0x4b85, 109, 103, 0),
    JPEG_ARITH_V(0x5597, 110, 109, 0), JPEG_ARITH_V(0x504f, 111, 107, 0),
    JPEG_ARITH_V(0x5a10, 110, 111, 1), JPEG_ARITH_V(0x5522, 112, 109, 0),
    JPEG_ARITH_V(0x59eb, 112, 111, 1), JPEG_ARITH_V(0x5a1d, 113, 113, 0)};
#undef JPEG_ARITH_V

enum { kDcBins = 64, kAcBins = 256 };

// One scan's QM decoder state (jdarith.c arith_entropy_decoder).
struct Arith {
  int32_t c = 0, a = 0;
  int ct = -16;  // -16: 2 bytes to fetch; 0..7: bits left; -1: an overflow
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  uint8_t dc_stats[4][kDcBins], ac_stats[4][kAcBins];
  uint8_t fixed_bin = 113;
};

// get_byte with jdarith.c's marker handling: a marker sets hit_marker (at
// marker_pos) and zeros are fed from then on, as they are past the data's
// end.
static inline int arith_byte(Decoder* d) {
  if (d->hit_marker) return 0;
  if (d->pos >= d->length) {
    d->hit_marker = true;
    d->marker_pos = d->length;
    return 0;
  }
  int data = d->data[d->pos++];
  if (data != 0xFF) return data;
  size_t at = d->pos - 1;  // the last 0xFF before the code: fill bytes
  for (;;) {                // (T.81 B.1.1.2) may precede a marker
    data = d->pos < d->length ? d->data[d->pos++] : 0xD9;
    if (data != 0xFF || d->pos > d->length) break;
    at = d->pos - 1;
  }
  if (data == 0) return 0xFF;  // a stuffed zero byte
  d->hit_marker = true;
  d->marker_pos = at;
  return 0;
}

// arith_decode: one binary decision in the statistics bin st.
static inline int arith_decode(Decoder* d, Arith* e, uint8_t* st) {
  while (e->a < 0x8000) {  // renormalization and data input (D.2.6)
    if (--e->ct < 0) {
      int data = arith_byte(d);
      e->c = (e->c << 8) | data;
      if ((e->ct += 8) < 0)
        if (++e->ct == 0) e->a = 0x8000;  // 2 initial bytes read
    }
    e->a <<= 1;
  }
  int sv = *st;
  uint32_t qe = kQe[sv & 0x7F];
  uint8_t nl = qe & 0xFF;
  qe >>= 8;
  uint8_t nm = qe & 0xFF;
  qe >>= 8;
  int32_t temp = e->a - (int32_t)qe;  // decoding per D.2.4 and D.2.5
  e->a = temp;
  temp <<= e->ct;
  if (e->c >= temp) {
    e->c -= temp;
    if (e->a < (int32_t)qe) {  // conditional LPS exchange
      e->a = qe;
      *st = (sv & 0x80) ^ nm;
    } else {
      e->a = qe;
      *st = (sv & 0x80) ^ nl;
      sv ^= 0x80;
    }
  } else if (e->a < 0x8000) {  // conditional MPS exchange
    if (e->a < (int32_t)qe) {
      *st = (sv & 0x80) ^ nl;
      sv ^= 0x80;
    } else {
      *st = (sv & 0x80) ^ nm;
    }
  }
  return sv >> 7;
}

// The statistics a scan uses, zeroed, and the registers re-initialised
// (start_pass, process_restart).
static void arith_reset(Decoder* d, Arith* e, Component** sc, int ns, int ss,
                        int ah) {
  for (int i = 0; i < ns; i++) {
    if (!d->progressive || (ss == 0 && ah == 0)) {
      memset(e->dc_stats[sc[i]->dc_tbl], 0, kDcBins);
      e->last_dc[i] = 0;
      e->dc_context[i] = 0;
    }
    if (!d->progressive || ss)
      memset(e->ac_stats[sc[i]->ac_tbl], 0, kAcBins);
  }
  e->c = 0;
  e->a = 0;
  e->ct = -16;
}

// process_restart: read past the RSTn marker (the one that ended the data,
// or the next one in the stream) and reset.
static void arith_restart(Decoder* d, Arith* e, Component** sc, int ns,
                          int ss, int ah) {
  if (d->hit_marker) {
    size_t m = d->marker_pos;
    bool rst = m + 1 < d->length && d->data[m + 1] >= 0xD0 &&
               d->data[m + 1] <= 0xD7;
    if (rst) d->hit_marker = false;  // else zeros go on being fed
  } else {
    while (d->pos + 1 < d->length &&
           !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] >= 0xD0 &&
             d->data[d->pos + 1] <= 0xD7))
      d->pos++;
    if (d->pos + 1 < d->length) d->pos += 2;
  }
  arith_reset(d, e, sc, ns, ss, ah);
}

// Figures F.19 and F.21-F.24: a DC difference in the bins of table tbl
// from context *context, which it updates; false on a magnitude overflow.
static inline bool arith_dc_diff(Decoder* d, Arith* e, int tbl,
                                 int* context, int* diff) {
  uint8_t* st = e->dc_stats[tbl] + *context;
  if (arith_decode(d, e, st) == 0) {
    *context = 0;
    *diff = 0;
    return true;
  }
  int sign = arith_decode(d, e, st + 1);
  st += 2 + sign;
  int m = arith_decode(d, e, st);
  if (m != 0) {
    st = e->dc_stats[tbl] + 20;  // X1
    while (arith_decode(d, e, st)) {
      if ((m <<= 1) == 0x8000) return false;
      st += 1;
    }
  }
  // F.1.4.4.1.2: the conditioning category of the next difference
  if (m < (int)((1L << d->arith_dc_L[tbl]) >> 1))
    *context = 0;
  else if (m > (int)((1L << d->arith_dc_U[tbl]) >> 1))
    *context = 12 + sign * 4;
  else
    *context = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(d, e, st)) v |= m;
  v += 1;
  *diff = sign ? -v : v;
  return true;
}

// Figures F.21-F.24 for a nonzero AC coefficient at k, st pointing at its
// bin SE = 3 (k - 1); false on a magnitude overflow.
static inline bool arith_ac_value(Decoder* d, Arith* e, int tbl, int k,
                                  uint8_t* st, int* value) {
  int sign = arith_decode(d, e, &e->fixed_bin);
  st += 2;
  int m = arith_decode(d, e, st);
  if (m != 0) {
    if (arith_decode(d, e, st)) {
      m <<= 1;
      st = e->ac_stats[tbl] + (k <= d->arith_ac_K[tbl] ? 189 : 217);
      while (arith_decode(d, e, st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(d, e, st)) v |= m;
  v += 1;
  *value = sign ? -v : v;
  return true;
}

// The sequential decode_mcu for one block of scan component i.
static void arith_block_sequential(Decoder* d, Arith* e, Component& c, int i,
                                   int16_t* blk) {
  int diff;
  if (!arith_dc_diff(d, e, c.dc_tbl, &e->dc_context[i], &diff)) {
    e->ct = -1;
    return;
  }
  e->last_dc[i] = (e->last_dc[i] + diff) & 0xFFFF;
  blk[0] = (int16_t)e->last_dc[i];
  for (int k = 1; k <= 63; k++) {  // F.20: Decode_AC_coefficients
    uint8_t* st = e->ac_stats[c.ac_tbl] + 3 * (k - 1);
    if (arith_decode(d, e, st)) break;  // EOB
    while (arith_decode(d, e, st + 1) == 0) {
      st += 3;
      if (++k > 63) {  // spectral overflow
        e->ct = -1;
        return;
      }
    }
    int v;
    if (!arith_ac_value(d, e, c.ac_tbl, k, st, &v)) {
      e->ct = -1;
      return;
    }
    blk[kNatural[k]] = (int16_t)v;
  }
}

// The progressive routines for one block (decode_mcu_DC_first,
// decode_mcu_AC_first, decode_mcu_DC_refine, decode_mcu_AC_refine).
static void arith_block_progressive(Decoder* d, Arith* e, Component& c, int i,
                                    int16_t* blk, int ss, int se, int ah,
                                    int al) {
  if (ss == 0 && ah == 0) {
    int diff;
    if (!arith_dc_diff(d, e, c.dc_tbl, &e->dc_context[i], &diff)) {
      e->ct = -1;
      return;
    }
    e->last_dc[i] = (e->last_dc[i] + diff) & 0xFFFF;
    blk[0] = (int16_t)((uint32_t)e->last_dc[i] << al);
    return;
  }
  if (ss == 0) {  // DC refine: the next bit, at the fixed estimate
    if (arith_decode(d, e, &e->fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << al));
    return;
  }
  const int tbl = c.ac_tbl;
  if (ah == 0) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = e->ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(d, e, st)) break;  // EOB
      while (arith_decode(d, e, st + 1) == 0) {
        st += 3;
        if (++k > se) {
          e->ct = -1;
          return;
        }
      }
      int v;
      if (!arith_ac_value(d, e, tbl, k, st, &v)) {
        e->ct = -1;
        return;
      }
      blk[kNatural[k]] = (int16_t)((uint32_t)v << al);
    }
    return;
  }
  const int p1 = 1 << al, m1 = -1 * (1 << al);
  int kex = se;  // the previous stage's end of block
  for (; kex > 0; kex--)
    if (blk[kNatural[kex]]) break;
  for (int k = ss; k <= se; k++) {
    uint8_t* st = e->ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && arith_decode(d, e, st)) break;  // EOB
    for (;;) {
      int16_t* coef = blk + kNatural[k];
      if (*coef) {  // nonzero before: a correction bit
        if (arith_decode(d, e, st + 2))
          *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (arith_decode(d, e, st + 1)) {  // newly nonzero
        *coef = (int16_t)(arith_decode(d, e, &e->fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) {
        e->ct = -1;
        return;
      }
    }
  }
}

// An arithmetic-coded scan of the sc[0..ns) components from data[start],
// MCUs as decode_scan walks them. Returns with d->pos at the marker that
// ends the data (or past the last byte read).
static int decode_arith_scan(Decoder* d, Component** sc, int ns, int ss,
                             int se, int ah, int al, const uint8_t* data,
                             size_t length, size_t start) {
  if (d->progressive &&
      ((ah != 0 && ah - 1 != al) || al > 13))  // jdarith.c start_pass
    return kBadStream;
  Arith* e = new Arith();
  d->data = data;
  d->length = length;
  d->pos = start;
  d->hit_marker = false;
  arith_reset(d, e, sc, ns, ss, ah);
  int mcus_x = ns == 1 ? sc[0]->width_in_blocks : d->mcus_x;
  int mcus_y = ns == 1 ? sc[0]->height_in_blocks : d->mcus_y;
  int todo = d->restart_interval;
  for (int my = 0; my < mcus_y; my++) {
    input_row_starts(d, ns == 1 ? sc[0]->v : 1, my);
    for (int mx = 0; mx < mcus_x; mx++) {
      if (d->restart_interval) {
        if (todo == 0) {
          arith_restart(d, e, sc, ns, ss, ah);
          todo = d->restart_interval;
        }
        todo--;
      }
      if (e->ct == -1 && !(d->progressive && ss == 0 && ah != 0))
        continue;  // after an overflow: nothing until the restart
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; by++) {
          for (int bx = 0; bx < bw; bx++) {
            int row = ns == 1 ? my : my * c.v + by;
            int col = ns == 1 ? mx : mx * c.h + bx;
            int16_t* blk = &c.coef[((size_t)row * c.blocks_w + col) * 64];
            if (e->ct == -1) continue;
            if (d->progressive)
              arith_block_progressive(d, e, c, i, blk, ss, se, ah, al);
            else
              arith_block_sequential(d, e, c, i, blk);
          }
        }
      }
    }
  }
  if (d->hit_marker) d->pos = d->marker_pos;
  delete e;
  return kOk;
}

}  // namespace jpeg_entropy
