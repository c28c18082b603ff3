// Host-side JPEG parsing and entropy decoding to quantized DCT coefficients,
// for mpmvs_torch/csrc/jpeg_codec.cu.
//
// The card's decode must give what cv2.imread gives, and OpenCV decodes with
// libjpeg-turbo: its integer inverse DCT (jidctint.c) and fancy upsampling.
// nvJPEG's inverse DCT is another, so the coefficients are decoded here, on
// the host, as libjpeg's jdhuff.c / jdphuff.c decode them, and the card runs
// jidctint's arithmetic (idct_islow_kernel in jpeg_codec.cu).
//
// Supported: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2) JPEGs of 8-bit samples with one, three or four
// components, interleaved or not, with restart intervals, at every sampling
// layout libjpeg takes: factors 1 to 4 that divide the largest of their
// axis, at most 10 blocks in an interleaved MCU. Refused, each with its own
// code: 12-bit samples, arithmetic coding, lossless and hierarchical
// processes, 2 or more than 4 components, and the sampling layouts libjpeg
// refuses too. Two things that make cv2.imread give another image than the
// planes are reported with the coefficients, for the caller to apply: the
// EXIF orientation (OpenCV rotates or mirrors by 2..8) and the colour space
// libjpeg takes the components for (jdapimin.c default_decompress_parms,
// from the JFIF and Adobe markers and the component ids): YCbCr or RGB for
// three, CMYK or YCCK for four. Every coefficient is stored in natural
// (row-major) order, as libjpeg's coefficient buffer holds it, with each
// component's blocks padded to whole MCUs.

#pragma once

#include <stdint.h>
#include <string.h>

#include <vector>

namespace jpeg_entropy {

enum Error {
  kOk = 0,
  kTruncated = 2001,     // the stream ended inside a marker segment
  kUnsupported = 2002,   // a coding process or layout this decoder refuses
  kBadStream = 2003,     // a malformed segment or an undefined table
  kPrecision = 2006,     // samples of another precision than 8 bits
  kArithmetic = 2007,    // arithmetic coding (SOF9-11, SOF13-15)
  kLossless = 2008,      // lossless or hierarchical Huffman (SOF3, SOF5-7)
  kSampling = 2011,      // sampling factors libjpeg refuses too
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

struct Huffman {
  bool defined = false;
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
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // of the image's samples
  int blocks_w = 0, blocks_h = 0;                 // padded to whole MCUs
  int dc_pred = 0;
  std::vector<int16_t> coef;                      // blocks_h x blocks_w x 64
};

struct Decoder {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  bool progressive = false;
  int restart_interval = 0;
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
  bool hit_marker = false;
  int eobrun = 0;
  // what the markers before the first scan say of the image's layout
  bool saw_jfif = false, saw_adobe = false, saw_app1 = false;
  int adobe_transform = 1, orientation = 1;
  int space = kYcc;  // libjpeg's guess from the markers and ids (Space)
  int scans = 0;
};

static inline int read16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// False for a table whose code lengths overflow (libjpeg's
// JERR_BAD_HUFF_TABLE).
static bool build_huffman(Huffman* t, const uint8_t* counts,
                          const uint8_t* vals, int nvals) {
  memcpy(t->vals, vals, nvals);
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
  t->defined = true;
  return true;
}

// One byte of entropy-coded data: 0xFF 0x00 is a data 0xFF; any other
// marker stops the segment, and from there on zeros are fed (as libjpeg
// does when data runs out).
static inline void fill_bits(Decoder* d) {
  while (d->bitcnt <= 24) {
    uint32_t byte = 0;
    if (!d->hit_marker && d->pos < d->length) {
      byte = d->data[d->pos];
      if (byte == 0xFF) {
        uint8_t next = d->pos + 1 < d->length ? d->data[d->pos + 1] : 0xD9;
        if (next == 0x00) {
          d->pos += 2;
        } else {
          d->hit_marker = true;
          byte = 0;
        }
      } else {
        d->pos++;
      }
    }
    d->bitbuf |= byte << (24 - d->bitcnt);
    d->bitcnt += 8;
  }
}

static inline int get_bits(Decoder* d, int n) {
  if (n == 0) return 0;
  if (d->bitcnt < n) fill_bits(d);
  int v = (int)(d->bitbuf >> (32 - n));
  d->bitbuf <<= n;
  d->bitcnt -= n;
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
    return 0;
  }
  d->bitbuf <<= l;
  d->bitcnt -= l;
  return t->vals[t->valptr[l] + code - t->mincode[l]];
}

static int parse_sof(Decoder* d, const uint8_t* p, int len, bool progressive) {
  if (len < 6) return kBadStream;
  if (p[0] != 8) return kPrecision;
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
  d->mcus_x = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mcus_y = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  for (int i = 0; i < d->ncomp; i++) {
    Component& c = d->comp[i];
    // jdinput.c: width_in_blocks = ceil(image_width * h / (hmax * 8))
    c.width_in_blocks = (d->width * c.h + 8 * d->hmax - 1) / (8 * d->hmax);
    c.height_in_blocks = (d->height * c.v + 8 * d->vmax - 1) / (8 * d->vmax);
    c.blocks_w = d->mcus_x * c.h;
    c.blocks_h = d->mcus_y * c.v;
    c.coef.assign((size_t)c.blocks_w * c.blocks_h * 64, 0);
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
    if (!build_huffman(tc == 0 ? &d->dc[th] : &d->ac[th], p + off + 1,
                       p + off + 17, n))
      return kBadStream;
    off += 17 + n;
  }
  return kOk;
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

// Restart: skip to the RSTn marker, reset the predictions and the EOB run.
static void restart(Decoder* d) {
  d->bitbuf = 0;
  d->bitcnt = 0;
  while (d->pos + 1 < d->length &&
         !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] >= 0xD0 &&
           d->data[d->pos + 1] <= 0xD7))
    d->pos++;
  if (d->pos + 1 < d->length) d->pos += 2;
  d->hit_marker = false;
  for (int i = 0; i < d->ncomp; i++) d->comp[i].dc_pred = 0;
  d->eobrun = 0;
}

static int decode_scan(Decoder* d, const uint8_t* p, int len,
                       const uint8_t* data, size_t length, size_t start) {
  if (!d->frame || len < 1) return kBadStream;
  int ns = p[0];
  if (ns < 1 || ns > d->ncomp || len < 1 + 2 * ns + 3) return kBadStream;
  Component* sc[4];
  for (int i = 0; i < ns; i++) {
    int id = p[1 + 2 * i];
    sc[i] = nullptr;
    for (int j = 0; j < d->ncomp; j++)
      if (d->comp[j].id == id) sc[i] = &d->comp[j];
    if (!sc[i]) return kBadStream;
    sc[i]->dc_tbl = p[2 + 2 * i] >> 4;
    sc[i]->ac_tbl = p[2 + 2 * i] & 15;
    if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) return kBadStream;
  }
  int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
  int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
  if (!d->progressive) {
    ss = 0;
    se = 63;
    ah = al = 0;
  } else if (ss > se || se > 63 || (ss == 0 && se != 0) ||
             (ss > 0 && ns != 1)) {
    return kBadStream;
  }
  // jdinput.c per_scan_setup: JERR_BAD_MCU_SIZE (D_MAX_BLOCKS_IN_MCU 10)
  int mcu_blocks = 0;
  for (int i = 0; i < ns; i++) mcu_blocks += sc[i]->h * sc[i]->v;
  if (ns > 1 && mcu_blocks > 10) return kSampling;
  for (int i = 0; i < ns; i++) {
    bool need_dc = ss == 0 && ah == 0;
    bool need_ac = !d->progressive || ss > 0;
    if ((need_dc && !d->dc[sc[i]->dc_tbl].defined) ||
        (need_ac && !d->ac[sc[i]->ac_tbl].defined))
      return kBadStream;
    sc[i]->dc_pred = 0;
  }
  d->data = data;
  d->length = length;
  d->pos = start;
  d->bitbuf = 0;
  d->bitcnt = 0;
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
    for (int mx = 0; mx < mcus_x; mx++) {
      if (d->restart_interval) {
        if (todo == 0) {
          restart(d);
          todo = d->restart_interval;
        }
        todo--;
      }
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
static void guess_space(Decoder* d) {
  if (d->ncomp == 4) {
    d->space = d->saw_adobe && d->adobe_transform != 0 ? kYcck : kCmyk;
    return;
  }
  if (d->ncomp != 3 || d->saw_jfif) return;
  bool rgb = d->saw_adobe ? d->adobe_transform == 0
                          : d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
                                d->comp[2].id == 'B';
  d->space = rgb ? kRgb : kYcc;
}

// Parse a whole JPEG and entropy-decode every scan into d->comp[*].coef.
static int decode(Decoder* d, const uint8_t* data, size_t length,
                  bool headers_only) {
  if (length < 4 || data[0] != 0xFF || data[1] != 0xD8) return kBadStream;
  size_t pos = 2;
  while (pos + 4 <= length) {
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
    int len = read16(data + pos + 2);
    if (len < 2 || pos + 2 + len > length) return kTruncated;
    const uint8_t* p = data + pos + 4;
    int n = len - 2;
    int err = kOk;
    switch (marker) {
      case 0xC0:
      case 0xC1:
        err = parse_sof(d, p, n, false);
        break;
      case 0xC2:
        err = parse_sof(d, p, n, true);
        break;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        return kLossless;
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return kArithmetic;
      case 0xC4:
        err = parse_dht(d, p, n);
        break;
      case 0xDB:
        err = parse_dqt(d, p, n);
        break;
      case 0xDD:
        if (n < 2) return kBadStream;
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
        if (d->frame && d->scans++ == 0) guess_space(d);
        if (headers_only) return d->frame ? kOk : kBadStream;
        err = decode_scan(d, p, n, data, length, pos + 2 + len);
        if (err == kOk) {
          pos = d->pos;  // resume at the marker that ended the scan
          continue;
        }
        break;
      default:  // APPn, COM and the rest carry nothing the decode needs
        break;
    }
    if (err != kOk) return err;
    pos += 2 + len;
  }
  if (!d->frame) return kBadStream;
  for (int i = 0; i < d->ncomp; i++)
    if (!d->qt_defined[d->comp[i].tq]) return kBadStream;
  return kOk;
}

}  // namespace jpeg_entropy

// The orientation of EXIF data that starts with its TIFF header (a PNG's
// eXIf chunk), as for a JPEG's APP1 segment.
extern "C" int exif_orientation_tiff(const unsigned char* p, int n) {
  return jpeg_entropy::exif_orientation(p, n);
}
