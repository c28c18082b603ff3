// Host-side JPEG parsing and entropy decoding to quantized DCT coefficients,
// for mpmvs_torch/csrc/jpeg_codec.cu.
//
// The card's decode must give what cv2.imread gives, and OpenCV decodes with
// libjpeg-turbo: its integer inverse DCT (jidctint.c) and fancy upsampling.
// nvJPEG's inverse DCT is another, so the coefficients are decoded here, on
// the host, as libjpeg's jdhuff.c / jdphuff.c (Huffman) and jdarith.c
// (arithmetic, jpeg_arith.h) decode them, and the card runs jidctint's
// arithmetic (idct_islow_kernel in jpeg_codec.cu).
//
// Supported: baseline and extended sequential (SOF0, SOF1) and progressive
// (SOF2) Huffman JPEGs and sequential (SOF9) and progressive (SOF10)
// arithmetic-coded ones, of 8-bit samples with one, three or four
// components, interleaved or not, with restart intervals, at every sampling
// layout libjpeg takes: factors 1 to 4 that divide the largest of their
// axis, at most 10 blocks in an interleaved MCU. Lossless Huffman JPEGs
// (SOF3) of 2 to 8 bits are entropy-decoded to sample differences instead
// (jpeg_lossless.h), which the card undifferences. Refused, each with its
// own code: 12-bit DCT samples and lossless ones above 8 bits, arithmetic-
// coded lossless (SOF11) and hierarchical (DHP, SOF5-7, SOF13-15)
// processes, a lossless scan libjpeg refuses, 2 or more than 4 components,
// and the sampling layouts libjpeg refuses too. Two things that make cv2.imread give another image than the
// planes are reported with the coefficients, for the caller to apply: the
// EXIF orientation (OpenCV rotates or mirrors by 2..8) and the colour space
// libjpeg takes the components for (jdapimin.c default_decompress_parms,
// from the JFIF and Adobe markers and the component ids): YCbCr or RGB for
// three, CMYK or YCCK for four. Every coefficient is stored in natural
// (row-major) order, as libjpeg's coefficient buffer holds it, with each
// component's blocks padded to whole MCUs. A tables-only stream (a TIFF's
// JPEGTables) can be loaded into a Decoder first; the abbreviated streams
// of the TIFF's strips or tiles are then decoded with its tables, as
// libjpeg decodes them after jpeg_read_header(TRUE) of the tables.

#pragma once

#include <stdint.h>
#include <string.h>

#include <vector>

namespace jpeg_entropy {

enum Error {
  kOk = 0,
  kTruncated = 2001,     // a cut marker segment libjpeg rejects completed
  kUnsupported = 2002,   // a coding process or layout this decoder refuses
  kBadStream = 2003,     // a malformed segment or an undefined table
  kPrecision = 2006,     // DCT samples of another precision than 8 bits,
                         // lossless ones outside 2-8
  kArithmetic = 2007,    // arithmetic-coded lossless (SOF11)
  kHierarchical = 2008,  // hierarchical (DHP, SOF5-7, SOF13-15)
  kSampling = 2011,      // sampling factors libjpeg refuses too
  kLosslessScan = 2012,  // a lossless scan libjpeg refuses (Ss outside 1-7,
                         // Se or Ah not 0, Pt not below the precision)
  kLosslessRestart = 2013,  // a lossless restart interval of part of a row
  kLosslessColour = 2014,   // lossless YCbCr or YCCK components, which
                            // libjpeg-turbo does not convert
};

// The colour space of the components (libjpeg's jpeg_color_space); one
// component is grey and reported as kYcc.
enum Space { kYcc = 0, kRgb = 1, kCmyk = 2, kYcck = 3 };

static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in decoders that overrun k (jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// A DHT's table as the segment gave it (jdmarker.c get_dht keeps the counts
// and symbols), and the decoding tables built from it when a scan first
// uses it (jdhuff.c jpeg_make_d_derived_tbl, which checks them only then).
struct Huffman {
  bool defined = false, built = false;
  uint8_t counts[16];
  int nvals = 0;
  // canonical code: for each length l (1..16) the largest code (maxcode) and
  // the index of its first symbol (valptr) with its first code (mincode)
  int32_t maxcode[18];
  int32_t mincode[17];
  int valptr[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, 0 when the code is longer
  uint16_t look[1 << 9];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  // the quantization table latched at the component's first scan
  // (jdinput.c latch_quant_tables: a DQT after it changes nothing here);
  // zeros while no scan has coded it, as jddctmgr.c leaves its multipliers
  bool latched = false;
  uint16_t qt[64] = {0};
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // of the image's samples
  int blocks_w = 0, blocks_h = 0;                 // padded to whole MCUs
  int dc_pred = 0;
  std::vector<int16_t> coef;                      // blocks_h x blocks_w x 64
  // lossless: the sample differences (height_in_blocks x width_in_blocks,
  // a block being a sample), the rows that predict as a first row, and the
  // predictor and point transform of the component's scan
  std::vector<int16_t> diff;
  std::vector<uint8_t> first;
  int predictor = 0, pt = 0;
};

struct Decoder {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  bool progressive = false, arithmetic = false, lossless = false;
  int precision = 8;
  int restart_interval = 0;
  // the DAC marker's conditioning of each table (jdmarker.c get_dac)
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];
  bool frame = false;
  // the entropy-coded segment's bit reader
  const uint8_t* data = nullptr;
  size_t length = 0, pos = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  int real_bits = 0;          // of bitcnt, those read from the data
  bool insufficient = false;  // a read went past the data (libjpeg's
                              // insufficient_data): the scan's later MCUs
                              // are left as they are, until a restart
  bool hit_marker = false;
  size_t marker_pos = 0;  // where an arithmetic scan's data met a marker
  int eobrun = 0;
  // what the markers before the first scan say of the image's layout
  bool saw_jfif = false, saw_adobe = false, saw_app1 = false;
  int adobe_transform = 1, orientation = 1;
  int space = kYcc;  // libjpeg's guess from the markers and ids (Space)
  int scans = 0;
  // libjpeg's progression status (coef_bits, set by jdphuff.c / jdarith.c
  // start_pass when a scan starts) of each component's first ten
  // coefficients: -1 until a scan codes one, then that scan's Al;
  // prev_bits the status before the component's latest scan (0 for the
  // first scan); last_good the last iMCU row the input started before its
  // data ran out (jdcoefct.c consume_data's last_good_iMCU_row, 0 at first
  // and kept from scan to scan). jpeg_smooth.h smooths by them.
  int coef_bits[4][10], prev_bits[4][10];
  int last_good = 0;
  Decoder() {
    memset(coef_bits, 0xFF, sizeof(coef_bits));
    memset(prev_bits, 0xFF, sizeof(prev_bits));
    memset(arith_dc_L, 0, sizeof(arith_dc_L));
    memset(arith_dc_U, 1, sizeof(arith_dc_U));
    memset(arith_ac_K, 5, sizeof(arith_ac_K));
  }
};

static int decode_arith_scan(Decoder* d, Component** sc, int ns, int ss,
                             int se, int ah, int al, const uint8_t* data,
                             size_t length, size_t start);
static int decode_lossless_scan(Decoder* d, Component** sc, int ns, int ss,
                                int se, int ah, int al, const uint8_t* data,
                                size_t length, size_t start);

static inline int read16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// Build a stored table's decoding tables; false where libjpeg's
// jpeg_make_d_derived_tbl raises JERR_BAD_HUFF_TABLE: code lengths that
// overflow, or a DC symbol above 15 (16 in lossless mode).
static bool build_huffman(Huffman* t, bool dc, bool lossless) {
  if (t->built) return true;
  const uint8_t* counts = t->counts;
  for (int i = 0; dc && i < t->nvals; i++)
    if (t->vals[i] > (lossless ? 16 : 15)) return false;
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    t->valptr[l] = k;
    t->mincode[l] = code;
    code += counts[l - 1];
    k += counts[l - 1];
    if (code > (1 << l)) return false;
    t->maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  memset(t->look, 0, sizeof(t->look));
  code = 0;
  k = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < counts[l - 1]; i++, k++) {
      int c = t->mincode[l] + i;
      int shift = 9 - l;
      for (int j = 0; j < (1 << shift); j++)
        t->look[(c << shift) | j] = (uint16_t)((l << 8) | t->vals[k]);
    }
  }
  t->built = true;
  return true;
}

// The table number tbl of a scan ready to decode with, or null where
// libjpeg raises JERR_NO_HUFF_TABLE or JERR_BAD_HUFF_TABLE.
static const Huffman* huffman_table(Decoder* d, bool dc, int tbl) {
  if (tbl > 3) return nullptr;
  Huffman* t = dc ? &d->dc[tbl] : &d->ac[tbl];
  return t->defined && build_huffman(t, dc, d->lossless) ? t : nullptr;
}

// One byte of entropy-coded data: 0xFF 0x00 is a data 0xFF; any other
// marker stops the segment, and from there on zeros are fed (as libjpeg
// does when data runs out).
static inline void fill_bits(Decoder* d) {
  while (d->bitcnt <= 24) {
    uint32_t byte = 0;
    bool real = false;
    if (!d->hit_marker && d->pos < d->length) {
      byte = d->data[d->pos];
      if (byte == 0xFF) {
        uint8_t next = d->pos + 1 < d->length ? d->data[d->pos + 1] : 0xD9;
        if (next == 0x00) {
          d->pos += 2;
          real = true;
        } else {
          d->hit_marker = true;
          byte = 0;
        }
      } else {
        d->pos++;
        real = true;
      }
    }
    d->bitbuf |= byte << (24 - d->bitcnt);
    d->bitcnt += 8;
    if (real) d->real_bits += 8;
  }
}

// n bits taken from the buffer: past the data's bits, libjpeg's
// jpeg_fill_bit_buffer sets insufficient_data (and stuffs zeros).
static inline void took(Decoder* d, int n) {
  if (n > d->real_bits) d->insufficient = true;
  d->real_bits = n > d->real_bits ? 0 : d->real_bits - n;
}

static inline int get_bits(Decoder* d, int n) {
  if (n == 0) return 0;
  if (d->bitcnt < n) fill_bits(d);
  int v = (int)(d->bitbuf >> (32 - n));
  d->bitbuf <<= n;
  d->bitcnt -= n;
  took(d, n);
  return v;
}

static inline int get_bit(Decoder* d) { return get_bits(d, 1); }

// HUFF_EXTEND: a received value of s bits as a signed difference.
static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static inline int decode_symbol(Decoder* d, const Huffman* t) {
  if (d->bitcnt < 16) fill_bits(d);
  int peek = (int)(d->bitbuf >> (32 - 9));
  int e = t->look[peek];
  if (e) {
    int l = e >> 8;
    d->bitbuf <<= l;
    d->bitcnt -= l;
    took(d, l);
    return e & 0xFF;
  }
  int code = (int)(d->bitbuf >> (32 - 10));
  int l = 10;
  while (l <= 16 && code > t->maxcode[l]) {
    l++;
    code = (int)(d->bitbuf >> (32 - l));
  }
  if (l > 16) {  // a corrupt code: libjpeg returns 0 and goes on
    d->bitbuf <<= 16;
    d->bitcnt -= 16;
    took(d, 16);
    return 0;
  }
  d->bitbuf <<= l;
  d->bitcnt -= l;
  took(d, l);
  return t->vals[t->valptr[l] + code - t->mincode[l]];
}

// A frame of DCT coefficients (progressive or sequential, Huffman or
// arithmetic-coded) or, with lossless, of sample differences.
static int parse_sof(Decoder* d, const uint8_t* p, int len, bool progressive,
                     bool arithmetic = false, bool lossless = false) {
  if (len < 6) return kBadStream;
  // jdinput.c initial_setup: a lossless precision of 2 to 16 bits (cv2
  // reads 8 bits and fewer), a DCT one of 8 (12 is another build)
  if (lossless ? p[0] < 2 || p[0] > 8 : p[0] != 8) return kPrecision;
  d->precision = p[0];
  d->arithmetic = arithmetic;
  d->lossless = lossless;
  d->height = read16(p + 1);
  d->width = read16(p + 3);
  d->ncomp = p[5];
  if ((d->ncomp != 1 && d->ncomp != 3 && d->ncomp != 4) ||
      len < 6 + 3 * d->ncomp ||
      d->width <= 0 || d->height <= 0 ||
      (int64_t)d->width * d->height > ((int64_t)1 << 28))
    return kUnsupported;
  d->progressive = progressive;
  d->hmax = d->vmax = 1;
  for (int i = 0; i < d->ncomp; i++) {
    Component& c = d->comp[i];
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i] & 3;
    // jdinput.c initial_setup: JERR_BAD_SAMPLING
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kSampling;
    d->hmax = c.h > d->hmax ? c.h : d->hmax;
    d->vmax = c.v > d->vmax ? c.v : d->vmax;
  }
  // jdsample.c jinit_upsampler: a factor that does not divide the largest
  // is JERR_FRACT_SAMPLE_NOTIMPL
  for (int i = 0; i < d->ncomp; i++)
    if (d->hmax % d->comp[i].h || d->vmax % d->comp[i].v) return kSampling;
  const int bs = lossless ? 1 : 8;  // a lossless block is a sample
  d->mcus_x = (d->width + bs * d->hmax - 1) / (bs * d->hmax);
  d->mcus_y = (d->height + bs * d->vmax - 1) / (bs * d->vmax);
  for (int i = 0; i < d->ncomp; i++) {
    Component& c = d->comp[i];
    // jdinput.c: width_in_blocks = ceil(image_width * h / (hmax * 8))
    c.width_in_blocks = (d->width * c.h + bs * d->hmax - 1) / (bs * d->hmax);
    c.height_in_blocks =
        (d->height * c.v + bs * d->vmax - 1) / (bs * d->vmax);
    c.blocks_w = d->mcus_x * c.h;
    c.blocks_h = d->mcus_y * c.v;
    if (lossless) {
      c.diff.assign((size_t)c.width_in_blocks * c.height_in_blocks, 0);
      c.first.assign(c.height_in_blocks, 0);
    } else {
      c.coef.assign((size_t)c.blocks_w * c.blocks_h * 64, 0);
    }
  }
  d->frame = true;
  return kOk;
}

static int parse_dht(Decoder* d, const uint8_t* p, int len) {
  int off = 0;
  while (off < len) {
    if (off + 17 > len) return kBadStream;
    int tc = p[off] >> 4, th = p[off] & 15;
    if (tc > 1 || th > 3) return kBadStream;
    int n = 0;
    for (int i = 0; i < 16; i++) n += p[off + 1 + i];
    if (n > 256 || off + 17 + n > len) return kBadStream;
    Huffman* t = tc == 0 ? &d->dc[th] : &d->ac[th];
    memcpy(t->counts, p + off + 1, 16);
    memcpy(t->vals, p + off + 17, n);
    t->nvals = n;
    t->defined = true;
    t->built = false;
    off += 17 + n;
  }
  return kOk;
}

// jdmarker.c get_dac: pairs of Tc Tb, then L and U (DC) or Kx (AC).
static int parse_dac(Decoder* d, const uint8_t* p, int len) {
  for (int k = 0; k + 1 < len; k += 2) {
    int index = p[k], val = p[k + 1];
    if (index >= 32) return kBadStream;
    if (index >= 16) {
      d->arith_ac_K[index - 16] = (uint8_t)val;
    } else {
      d->arith_dc_L[index] = (uint8_t)(val & 15);
      d->arith_dc_U[index] = (uint8_t)(val >> 4);
      if ((val & 15) > (val >> 4)) return kBadStream;
    }
  }
  return len & 1 ? kBadStream : kOk;
}

static int parse_dqt(Decoder* d, const uint8_t* p, int len) {
  int off = 0;
  while (off < len) {
    int pq = p[off] >> 4, tq = p[off] & 15;
    if (tq > 3) return kBadStream;
    int size = pq ? 128 : 64;
    if (off + 1 + size > len) return kBadStream;
    for (int i = 0; i < 64; i++)
      d->qt[tq][kNatural[i]] =
          pq ? (uint16_t)read16(p + off + 1 + 2 * i) : p[off + 1 + i];
    d->qt_defined[tq] = true;
    off += 1 + size;
  }
  return kOk;
}

// One block of a sequential scan (jdhuff.c decode_mcu).
// The DC difference of size s (a corrupt size above 16 reads as 0).
static inline int dc_diff(Decoder* d, int s) {
  return s > 0 && s <= 16 ? extend(get_bits(d, s), s) : 0;
}

static void decode_block_sequential(Decoder* d, Component& c, int16_t* blk) {
  int s = dc_diff(d, decode_symbol(d, &d->dc[c.dc_tbl]));
  c.dc_pred += s;
  blk[0] = (int16_t)c.dc_pred;
  const Huffman* ac = &d->ac[c.ac_tbl];
  for (int k = 1; k < 64; k++) {
    int rs = decode_symbol(d, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(get_bits(d, s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// jdphuff.c: decode_mcu_DC_first / DC_refine / AC_first / AC_refine.
static void decode_block_progressive(Decoder* d, Component& c, int16_t* blk,
                                     int ss, int se, int ah, int al) {
  if (ss == 0) {
    if (ah == 0) {
      int s = dc_diff(d, decode_symbol(d, &d->dc[c.dc_tbl]));
      c.dc_pred += s;
      blk[0] = (int16_t)(c.dc_pred * (1 << al));
    } else if (get_bit(d)) {
      blk[0] = (int16_t)(blk[0] | (1 << al));
    }
    return;
  }
  const Huffman* ac = &d->ac[c.ac_tbl];
  if (ah == 0) {
    if (d->eobrun > 0) {
      d->eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = decode_symbol(d, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)(extend(get_bits(d, s), s) * (1 << al));
      } else {
        if (r == 15) {
          k += 15;
        } else {
          d->eobrun = 1 << r;
          if (r) d->eobrun += get_bits(d, r);
          d->eobrun--;
          break;
        }
      }
    }
    return;
  }
  int p1 = 1 << al, m1 = -1 * (1 << al);
  int k = ss;
  if (d->eobrun == 0) {
    for (; k <= se; k++) {
      int rs = decode_symbol(d, ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bit(d) ? p1 : m1;
      } else if (r != 15) {
        d->eobrun = 1 << r;
        if (r) d->eobrun += get_bits(d, r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (get_bit(d) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= se);
      if (s) blk[kNatural[k]] = (int16_t)s;  // k may overrun: kNatural pads
    }
  }
  if (d->eobrun > 0) {
    for (; k <= se; k++) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0 && get_bit(d) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
    }
    d->eobrun--;
  }
}

// jdcoefct.c consume_data: an iMCU row of the input (an MCU row of an
// interleaved scan, v block rows of a component's own scan) that starts
// before the entropy decoder has run out of data is the last good one.
static inline void input_row_starts(Decoder* d, int v, int my) {
  if (my % v == 0 && !d->insufficient) d->last_good = my / v;
}

// Restart: skip to the RSTn marker, reset the predictions and the EOB run;
// the out-of-data state is cleared only where a marker was found (libjpeg
// leaves it set when the stream has ended).
static void restart(Decoder* d) {
  d->bitbuf = 0;
  d->bitcnt = 0;
  d->real_bits = 0;
  while (d->pos + 1 < d->length &&
         !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] >= 0xD0 &&
           d->data[d->pos + 1] <= 0xD7))
    d->pos++;
  if (d->pos + 1 < d->length) {
    d->pos += 2;
    d->insufficient = false;
  }
  d->hit_marker = false;
  for (int i = 0; i < d->ncomp; i++) d->comp[i].dc_pred = 0;
  d->eobrun = 0;
}

// A scan: its header (jdmarker.c get_sos: the length, a count of 1 to 4,
// each component's id found once), the checks of its start (jdphuff.c,
// jdarith.c start_pass: JERR_BAD_PROGRESSION), then its entropy-coded data
// from start.
static int decode_scan(Decoder* d, const uint8_t* p, int len,
                       const uint8_t* data, size_t length, size_t start) {
  if (!d->frame || len < 1) return kBadStream;
  int ns = p[0];
  if (ns < 1 || ns > 4 || len != 2 * ns + 4) return kBadStream;
  Component* sc[4];
  for (int i = 0; i < ns; i++) {
    int id = p[1 + 2 * i];
    sc[i] = nullptr;
    for (int j = 0; j < d->ncomp; j++)
      if (d->comp[j].id == id) sc[i] = &d->comp[j];
    for (int j = 0; j < i; j++)
      if (sc[j] == sc[i]) return kBadStream;
    if (!sc[i]) return kBadStream;
    sc[i]->dc_tbl = p[2 + 2 * i] >> 4;
    sc[i]->ac_tbl = p[2 + 2 * i] & 15;
    if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) return kBadStream;
  }
  int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
  int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
  if (d->lossless)
    return decode_lossless_scan(d, sc, ns, ss, se, ah, al, data, length,
                                start);
  if (!d->progressive) {
    ss = 0;
    se = 63;
    ah = al = 0;
  } else if (ss > se || se > 63 || (ss == 0 && se != 0) ||
             (ss > 0 && ns != 1) || (ah != 0 && al != ah - 1) || al > 13) {
    return kBadStream;
  }
  // jdinput.c per_scan_setup: JERR_BAD_MCU_SIZE (D_MAX_BLOCKS_IN_MCU 10)
  int mcu_blocks = 0;
  for (int i = 0; i < ns; i++) mcu_blocks += sc[i]->h * sc[i]->v;
  if (ns > 1 && mcu_blocks > 10) return kSampling;
  for (int i = 0; i < ns; i++) {  // jdinput.c latch_quant_tables
    Component& c = *sc[i];
    if (c.latched) continue;
    if (!d->qt_defined[c.tq]) return kBadStream;
    memcpy(c.qt, d->qt[c.tq], sizeof(c.qt));
    c.latched = true;
  }
  if (d->progressive) {  // start_pass: the progression status
    for (int i = 0; i < ns; i++) {
      int ci = (int)(sc[i] - d->comp);
      for (int k = ss == 0 ? 0 : 1; k < 10; k++)
        d->prev_bits[ci][k] = d->scans > 1 ? d->coef_bits[ci][k] : 0;
      for (int k = ss; k <= se && k < 10; k++) d->coef_bits[ci][k] = al;
    }
  }
  if (d->arithmetic)
    return decode_arith_scan(d, sc, ns, ss, se, ah, al, data, length, start);
  for (int i = 0; i < ns; i++) {
    bool need_dc = ss == 0 && ah == 0;
    bool need_ac = !d->progressive || ss > 0;
    if ((need_dc && !huffman_table(d, true, sc[i]->dc_tbl)) ||
        (need_ac && !huffman_table(d, false, sc[i]->ac_tbl)))
      return kBadStream;
    sc[i]->dc_pred = 0;
  }
  d->data = data;
  d->length = length;
  d->pos = start;
  d->bitbuf = 0;
  d->bitcnt = 0;
  d->real_bits = 0;
  d->insufficient = false;
  d->hit_marker = false;
  d->eobrun = 0;
  int mcus_x, mcus_y;
  if (ns == 1) {  // non-interleaved: one block per MCU over the samples
    mcus_x = sc[0]->width_in_blocks;
    mcus_y = sc[0]->height_in_blocks;
  } else {
    mcus_x = d->mcus_x;
    mcus_y = d->mcus_y;
  }
  int todo = d->restart_interval;
  for (int my = 0; my < mcus_y; my++) {
    input_row_starts(d, ns == 1 ? sc[0]->v : 1, my);
    for (int mx = 0; mx < mcus_x; mx++) {
      if (d->restart_interval) {
        if (todo == 0) {
          restart(d);
          todo = d->restart_interval;
        }
        todo--;
      }
      // jdhuff.c / jdphuff.c: once the data has run out, the MCU is left
      // as it is (uniform grey in a sequential scan)
      if (d->insufficient) continue;
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; by++) {
          for (int bx = 0; bx < bw; bx++) {
            int row = ns == 1 ? my : my * c.v + by;
            int col = ns == 1 ? mx : mx * c.h + bx;
            int16_t* blk = &c.coef[((size_t)row * c.blocks_w + col) * 64];
            if (d->progressive)
              decode_block_progressive(d, c, blk, ss, se, ah, al);
            else
              decode_block_sequential(d, c, blk);
          }
        }
      }
    }
  }
  return kOk;
}

// The orientation tag (0x0112) of EXIF data's first IFD, as OpenCV's
// ExifReader reads it, from the TIFF header at t (tn bytes); 1 when it holds
// no readable tag.
static int exif_orientation(const uint8_t* t, int tn) {
  if (tn < 8) return 1;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return 1;
  auto u16 = [&](uint32_t o) {
    return le ? t[o] | t[o + 1] << 8 : t[o] << 8 | t[o + 1];
  };
  auto u32 = [&](uint32_t o) {
    return le ? (uint32_t)u16(o) | (uint32_t)u16(o + 2) << 16
              : (uint32_t)u16(o) << 16 | (uint32_t)u16(o + 2);
  };
  if (u16(2) != 0x2A) return 1;
  uint32_t ifd = u32(4);
  if (ifd > (uint32_t)tn - 2) return 1;
  int entries = u16(ifd);
  for (int i = 0; i < entries; i++) {
    uint32_t e = ifd + 2 + 12 * (uint32_t)i;
    if (e + 12 > (uint32_t)tn) return 1;
    if (u16(e) == 0x0112) return u16(e + 8);
  }
  return 1;
}

// libjpeg's colour-space guess (jdapimin.c default_decompress_parms), from
// the markers seen before the first scan. Three components: JFIF means
// YCbCr; else the Adobe marker's transform (0 RGB, else YCbCr); else the ids
// 'R', 'G', 'B' mean RGB. Four: the Adobe marker's transform 0 means CMYK,
// any other YCCK (libjpeg warns of a transform other than 2 and takes
// YCCK); no Adobe marker means CMYK, whatever else the file holds.
// A lossless frame's three components without those markers are RGB
// whatever their ids (libjpeg-turbo assumes no colour transform there).
static void guess_space(Decoder* d) {
  if (d->ncomp == 4) {
    d->space = d->saw_adobe && d->adobe_transform != 0 ? kYcck : kCmyk;
    return;
  }
  if (d->ncomp != 3 || d->saw_jfif) return;
  bool rgb = d->saw_adobe ? d->adobe_transform == 0
                          : d->lossless || (d->comp[0].id == 'R' &&
                                            d->comp[1].id == 'G' &&
                                            d->comp[2].id == 'B');
  d->space = rgb ? kRgb : kYcc;
}

// Byte i of what libjpeg reads from a stream of n bytes: the stream's, then
// the fake EOI markers (FF D9) that its source hands out at every read past
// the end (jdatasrc.c's file source, which cv2.imread's JPEG reader uses,
// and libtiff's JPEG codec).
static inline uint8_t fed(const uint8_t* data, size_t n, size_t i) {
  return i < n ? data[i] : ((i - n) & 1 ? 0xD9 : 0xFF);
}

// Parse a whole JPEG and entropy-decode every scan into d->comp[*].coef.
// tables_only: the stream is a tables-only one (SOI, DQT, DHT, DRI, EOI:
// a TIFF's JPEGTables tag), whose tables stay in d for the abbreviated
// streams decoded after it; no frame is needed.
//
// A stream cut short inside a marker segment is read as libjpeg reads it:
// the segment is completed with the fake EOI's bytes and parsed by the
// marker's own rule (jdmarker.c: get_dht's count sum, get_dqt's and
// get_dac's table index, get_dri's length, get_sos's count and component
// ids, then start_pass's progression checks; skip_variable for COM and
// APPn). Where that fails the stream is refused (kTruncated); else the next
// marker is the fake EOI. A stream that ends in 0xFF reads: libjpeg skips
// fill bytes before the fake EOI.
static int decode(Decoder* d, const uint8_t* data, size_t length,
                  bool headers_only, bool tables_only = false) {
  if (length < 4 || data[0] != 0xFF || data[1] != 0xD8) return kBadStream;
  size_t pos = 2;
  std::vector<uint8_t> completed;  // a cut segment and 4 fed bytes after it
  while (pos + 1 < length) {
    if (data[pos] != 0xFF) {  // entropy data left after a scan: skip it
      pos++;
      continue;
    }
    int marker = data[pos + 1];
    if (marker == 0xFF) {
      pos++;
      continue;
    }
    if (marker == 0x00) {  // a stuffed byte of entropy data
      pos += 2;
      continue;
    }
    if (marker == 0xD9) break;  // EOI
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
      pos += 2;
      continue;
    }
    int len = fed(data, length, pos + 2) << 8 | fed(data, length, pos + 3);
    if (len < 2) return kTruncated;
    const bool cut = pos + 2 + len > length;
    const uint8_t* p = data + pos + 4;
    int n = len - 2;
    if (cut) {
      completed.resize((size_t)n + 4);
      for (size_t k = 0; k < completed.size(); k++)
        completed[k] = fed(data, length, pos + 4 + k);
      p = completed.data();
    }
    int err = kOk;
    switch (marker) {
      case 0xC0:
      case 0xC1:
        if (tables_only) return kBadStream;
        err = parse_sof(d, p, n, false);
        break;
      case 0xC2:
        if (tables_only) return kBadStream;
        err = parse_sof(d, p, n, true);
        break;
      case 0xC3:
        if (tables_only) return kBadStream;
        err = parse_sof(d, p, n, false, false, true);
        break;
      case 0xC9:
      case 0xCA:
        if (tables_only) return kBadStream;
        err = parse_sof(d, p, n, marker == 0xCA, true);
        break;
      case 0xCB:
        return kArithmetic;
      // jdmarker.c: SOF5-7 and SOF13-15 are JERR_SOF_UNSUPPORTED, DHP and
      // EXP unknown markers
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
      case 0xDE: case 0xDF:
        return kHierarchical;
      case 0xC4:
        err = parse_dht(d, p, n);
        break;
      case 0xCC:
        err = parse_dac(d, p, n);
        break;
      case 0xDB:
        err = parse_dqt(d, p, n);
        break;
      case 0xDD:  // get_dri: a length of 4
        if (n != 2) return cut ? kTruncated : kBadStream;
        d->restart_interval = read16(p);
        break;
      case 0xE0:  // jdmarker.c examine_app0: 14 bytes or more, "JFIF\0"
        if (d->scans == 0 && n >= 14 && !memcmp(p, "JFIF", 5))
          d->saw_jfif = true;
        break;
      case 0xE1:  // OpenCV reads the EXIF of the first APP1 segment only
        if (d->scans == 0 && !d->saw_app1) {
          // the TIFF header follows "Exif\0\0"
          d->orientation = n < 6 ? 1 : exif_orientation(p + 6, n - 6);
          d->saw_app1 = true;
        }
        break;
      case 0xEE:  // examine_app14: 12 bytes or more, "Adobe", transform
        if (d->scans == 0 && n >= 12 && !memcmp(p, "Adobe", 5)) {
          d->saw_adobe = true;
          d->adobe_transform = p[11];
        }
        break;
      case 0xDA:
        if (tables_only) return kBadStream;
        if (d->frame && d->scans++ == 0) guess_space(d);
        if (headers_only) return d->frame ? kOk : kBadStream;
        // a cut header's scan reads the fed bytes after it: none, or the
        // fake EOI's second byte
        err = cut ? decode_scan(d, p, n, p, (size_t)n + 4, (size_t)n)
                  : decode_scan(d, p, n, data, length, pos + 2 + len);
        if (err == kOk && !cut) {
          pos = d->pos;  // resume at the marker that ended the scan
          continue;
        }
        break;
      default:  // APPn, COM and the rest carry nothing the decode needs
        break;
    }
    if (cut) {  // the next marker is the fake EOI
      if (err != kOk) return kTruncated;
      break;
    }
    if (err != kOk) return err;
    pos += 2 + len;
  }
  if (tables_only) return d->frame ? kBadStream : kOk;
  // a frame and no scan (a file cut before its first): libjpeg's
  // JERR_NO_IMAGE
  if (!d->frame || d->scans == 0) return kBadStream;
  if (d->lossless) {  // no quantization; every component coded
    for (int i = 0; i < d->ncomp; i++)
      if (!d->comp[i].predictor) return kBadStream;
    // libjpeg-turbo converts no colour in lossless mode: cv2 asks for BGR
    // or grey (or CMYK of four components), so YCbCr and YCCK fail in both
    return (d->ncomp == 3 && d->space == kYcc) ||
                   (d->ncomp == 4 && d->space == kYcck)
               ? kLosslessColour
               : kOk;
  }
  return kOk;
}

// What a decode tells its caller (jpeg_codec.cu jpeg_host_decode says
// which; kInfoLen ints).
enum { kInfoLen = 50 };
static void host_info(const Decoder* d, int* info) {
  memset(info, 0, kInfoLen * sizeof(int));
  info[0] = d->ncomp;
  info[1] = d->width;
  info[2] = d->height;
  info[3] = d->orientation;
  info[4] = d->space;
  info[5] = d->hmax;
  info[6] = d->vmax;
  for (int i = 0; i < d->ncomp; i++) {
    const Component& c = d->comp[i];
    int* ci = info + 7 + 8 * i;
    ci[0] = (d->width * c.h + d->hmax - 1) / d->hmax;
    ci[1] = (d->height * c.v + d->vmax - 1) / d->vmax;
    ci[2] = c.blocks_w;
    ci[3] = c.blocks_h;
    ci[4] = c.width_in_blocks;
    ci[5] = c.height_in_blocks;
    ci[6] = c.h;
    ci[7] = c.v;
    info[42 + 2 * i] = c.predictor;
    info[43 + 2 * i] = c.pt;
  }
  info[39] = d->lossless;
  info[40] = d->precision;
  info[41] = d->arithmetic;
}

// What jdcoefct.c smoothing_ok latches when the output pass starts (after
// the whole file is read), as jpeg_smooth.h's Params take it: out[0] 1
// where libjpeg smooths the image's blocks, then per component
// kSmoothInts ints: its coefficient array's blocks across and down, the
// blocks that cover its samples across and down, its v factor, the
// frame's iMCU rows, the last good one, its ten coefficients' status
// (coef_bits), the ten before its latest scan (-1 while the file has had
// one scan) and their quantization entries. libjpeg smooths a progressive
// image only, when every component's DC and first nine AC quantization
// entries are non-zero, every DC is at least partly known, and one of
// those AC coefficients is not exact.
enum { kSmoothInts = 37, kSmoothLen = 1 + 4 * kSmoothInts };
static void smoothing(const Decoder* d, int* out) {
  memset(out, 0, kSmoothLen * sizeof(int));
  if (!d->progressive || d->lossless) return;
  static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int i = 0; i < d->ncomp; i++) {
    const Component& c = d->comp[i];
    if (!c.latched || d->coef_bits[i][0] < 0) return;
    int* p = out + 1 + kSmoothInts * i;
    p[0] = c.blocks_w;
    p[1] = c.blocks_h;
    p[2] = c.width_in_blocks;
    p[3] = c.height_in_blocks;
    p[4] = c.v;
    p[5] = d->mcus_y;
    p[6] = d->last_good;
    for (int k = 0; k < 10; k++) {
      p[7 + k] = d->coef_bits[i][k];
      p[17 + k] = k == 0 ? 0 : (d->scans > 1 ? d->prev_bits[i][k] : -1);
      p[27 + k] = c.qt[pos[k]];
      if (p[27 + k] == 0) return;
      if (k > 0 && p[7 + k] != 0) useful = true;
    }
  }
  out[0] = useful;
}

}  // namespace jpeg_entropy

#include "jpeg_arith.h"
#include "jpeg_lossless.h"

// The orientation of EXIF data that starts with its TIFF header (a PNG's
// eXIf chunk), as for a JPEG's APP1 segment.
extern "C" int exif_orientation_tiff(const unsigned char* p, int n) {
  return jpeg_entropy::exif_orientation(p, n);
}
