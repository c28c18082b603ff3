// The host half of the card's JPEG 2000 reads: a JP2 file or a raw
// codestream (ISO/IEC 15444-1) parsed and entropy-decoded as OpenJPEG 2.5,
// the decoder inside cv2.imread, decodes it, into the wavelet coefficients
// that j2k_idwt_kernel transforms:
//   * the JP2 boxes: the signature, then ftyp, jp2h with its ihdr and its
//     first colr (an enumerated colour space: sRGB, greyscale; CMYK, sYCC
//     and e-sYCC refused; any other space, an ICC profile, another method
//     or no colr read as a raw codestream is, which cv2 takes by the
//     number of components), cdef where it reorders nothing; pclr and cmap
//     (palettes) are refused, as are a file whose second box is not ftyp,
//     a jp2h without ihdr and a codestream that no jp2c box after jp2h
//     holds, which OpenJPEG refuses;
//   * the codestream's main header: SIZ, COD, COC, QCD, QCC (each
//     component's precinct sizes, code-block size and style, wavelet and
//     step sizes, derived or expounded), TLM, PLM, CRG and COM read past;
//     RGN, POC, PPM, a CAP marker (HTJ2K) and a code-block style other than
//     0 refused;
//   * tiles and tile-parts (SOT, SOD; PLT and COM read past; coding
//     markers in a tile-part header refused), each tile's parts
//     concatenated in stream order;
//   * tier-2: the packets of every layer, resolution, component and
//     precinct in the tile's progression (LRCP, RLCP, RPCL, PCRL, CPRL,
//     the position-driven ones as OpenJPEG's pi.c steps through the tile),
//     SOP and EPH markers read past, each packet header's inclusion and
//     zero bit-plane tag trees, pass counts and Lblock lengths;
//   * tier-1 (j2k_t1.h) of every code-block that any layer includes, and
//     OpenJPEG's conversion of its values: halved (C division) for the
//     reversible 5/3 wavelet; for the irreversible 9/7 one, times half the
//     band's step, (1 + mantissa / 2048) 2^(precision - exponent) (no band
//     gain: OpenJPEG's decoder folds it into its 9/7 lifting's 2/K), in
//     single precision.
// Each tile-component's coefficients are written into its own rectangle
// of one array of 32-bit words (int32 for 5/3, float for 9/7), each
// resolution's bands in OpenJPEG's layout: LL at the origin, HL to its
// right, LH below it, HH across, at the offsets of the resolution below.
// A codestream that stops right after the marker that follows a tile-part
// (its two bytes and nothing more) ends there, as OpenJPEG ends it: the
// tiles it holds are decoded, the rest are left 0. What cv2 refuses is
// refused, naming why: a codestream cut short anywhere else (OpenJPEG's
// strict mode, cv2's setting), or before its first tile-part, an image or
// component offset or subsampled components (OpenCV's "tiles are not
// supported"), components of unequal or signed precision or of fewer than
// 8 bits.
//
// Errors are 6001-6012 and 6014 (images.py names each).

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "j2k_t1.h"

namespace j2k {

enum Err {
  kOk = 0,
  kTruncated = 6001,   // cut short: a box, marker segment or tile-part ends
                       // past the end of the data, no EOC can follow, or
                       // neither SOT nor EOC follows a tile
  kMalformed = 6002,   // not a JP2 file or codestream, or a field out of
                       // range
  kCodeStyle = 6003,   // a code-block style other than 0
  kHt = 6004,          // HTJ2K (Part 15)
  kMarker = 6005,      // RGN, POC, PPM, PPT or a tile-part coding marker
  kColour = 6006,      // CMYK, sYCC, e-sYCC
  kPalette = 6007,     // pclr / cmap, or a cdef that reorders channels
  kOffset = 6008,      // image offset or subsampled components
  kPrecision = 6009,   // signed components or under 8 bits (cv2 refuses
                       // these), or over 16
  kPackets = 6010,     // a packet whose header or data breaks the rules
  kMct = 6011,         // a colour transform OpenJPEG skips or refuses
  kTooLarge = 6012,    // over 2^28 samples, or a partition of over 2^24
                       // precincts or code-blocks
  kUnequal = 6014,     // components of unequal precision (cv2 reads them)
};

enum { kInfoLen = 16, kTcInts = 10, kLevelInts = 8 };

static inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
static inline int ceildivpow2(int a, int n) {
  return (int)(((int64_t)a + ((int64_t)1 << n) - 1) >> n);
}
static inline int floordivpow2(int a, int n) { return a >> n; }
static inline int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) {
    a >>= 1;
    l++;
  }
  return l;
}
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int imin(int a, int b) { return a < b ? a : b; }

static inline uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
static inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

struct Coding {  // COD / COC of a component
  int numres = 1, cbw = 6, cbh = 6, style = 0, qmf = 1;
  uint8_t ppx[33], ppy[33];
};

struct Quant {  // QCD / QCC of a component
  int style = 0, guard = 2, n = 0;
  int expn[97] = {}, mant[97] = {};  // bands not given: 0, as OpenJPEG
};

struct Tree {  // a tag tree (OpenJPEG's tgt.c)
  std::vector<int> parent, value, low;
  void build(int w, int h) {
    std::vector<int> ws, hs;
    int n = 0, cw = w, ch = h;
    for (;;) {
      ws.push_back(cw);
      hs.push_back(ch);
      n += cw * ch;
      if (cw * ch <= 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    parent.assign(n, -1);
    value.assign(n, 999);
    low.assign(n, 0);
    int base = 0;
    for (size_t k = 0; k + 1 < ws.size(); k++) {
      const int next = base + ws[k] * hs[k];
      for (int j = 0; j < hs[k]; j++)
        for (int i = 0; i < ws[k]; i++)
          parent[base + j * ws[k] + i] = next + (j / 2) * ws[k + 1] + i / 2;
      base = next;
    }
  }
};

struct Bio {  // packet header bits (OpenJPEG's bio.c)
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  void init(const uint8_t* p, size_t n) {
    start = bp = p;
    end = p + n;
    buf = 0;
    ct = 0;
  }
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; i--) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return (size_t)(bp - start); }
};

static int tree_decode(Bio& bio, Tree& t, int leaf, int threshold) {
  int stk[32], sp = 0, node = leaf;
  while (t.parent[node] >= 0) {
    stk[sp++] = node;
    node = t.parent[node];
  }
  int low = 0;
  for (;;) {
    if (low > t.low[node])
      t.low[node] = low;
    else
      low = t.low[node];
    while (low < threshold && low < t.value[node]) {
      if (bio.bit())
        t.value[node] = low;
      else
        ++low;
    }
    t.low[node] = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.value[node] < threshold ? 1 : 0;
}

struct Chunk {
  size_t at, len;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, lenbits = 0, passes = 0, newpasses = 0;
  uint32_t newlen = 0, newskip = 0;  // a packet's bytes: segment 0, later
  bool seen = false;
  std::vector<Chunk> chunks;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Cblk> blocks;
  Tree incl, imsb;
};

struct Band {
  int x0, y0, x1, y1, no;
  int mb;            // Mb: the band's bit-planes
  float step_half;   // 9/7: half the band's step
  std::vector<Precinct> precs;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Res {
  int x0, y0, x1, y1;
  int ppx, ppy, pw, ph, nbands;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1, numres, qmf;
  size_t offset;  // in words, into the image's coefficient array
  std::vector<Res> res;
};

struct Tile {
  int x0, y0, x1, y1;
  std::vector<uint8_t> data;
  int parts = 0;
  std::vector<TileComp> comps;
};

struct Image {
  // SIZ
  int X, Y, X0, Y0, XT, YT, XT0, YT0, nc;
  std::vector<int> prec, sgnd, dx, dy;
  // COD / QCD
  int prog = 0, layers = 1, mct = 0, csty = 0;
  std::vector<Coding> cod;
  std::vector<Quant> qnt;
  // JP2
  bool jp2 = false;
  int enumcs = 0;
  uint32_t ihdr_w = 0, ihdr_h = 0;
  // tiles
  int tw = 0, th = 0;
  std::vector<Tile> tiles;
  size_t words = 0;
  std::vector<uint32_t> coef;  // every tile-component's words
  int maxres = 0;
  size_t precincts = 0, cblks = 0;
};

// ---- JP2 boxes ----

static const uint8_t kJp2Sig[12] = {0, 0, 0, 0x0c, 'j', 'P', ' ', ' ',
                                    0x0d, 0x0a, 0x87, 0x0a};

// Walks boxes in [p, end); calls fn(type, payload, payload_end) for each.
template <typename F>
static int walk_boxes(const uint8_t* p, const uint8_t* end, F fn) {
  while (p < end) {
    if (end - p < 8) return kTruncated;
    uint64_t len = be32(p);
    const uint32_t type = be32(p + 4);
    size_t head = 8;
    if (len == 1) {
      if (end - p < 16) return kTruncated;
      len = ((uint64_t)be32(p + 8) << 32) | be32(p + 12);
      head = 16;
    } else if (len == 0) {
      len = (uint64_t)(end - p);
    }
    if (len < head) return kMalformed;
    const uint8_t* pe = len > (uint64_t)(end - p) ? end : p + len;
    int err = fn(type, p + head, pe, len > (uint64_t)(end - p));
    if (err) return err < 0 ? kOk : err;  // negative: stop walking
    p = pe;
  }
  return kOk;
}

static uint32_t fourcc(const char* s) {
  return ((uint32_t)s[0] << 24) | (s[1] << 16) | (s[2] << 8) | s[3];
}

// The codestream of a JP2 file, and its colour space.
static int read_jp2(const uint8_t* d, size_t n, Image* img,
                    const uint8_t** cs, size_t* cs_len) {
  bool first = true, header = false, ihdr = false, colr = false;
  const uint8_t* code = nullptr;
  int err = walk_boxes(
      d + 12, d + n,
      [&](uint32_t type, const uint8_t* p, const uint8_t* pe, bool cut) {
        if (first && type != fourcc("ftyp")) return (int)kMalformed;
        first = false;
        if (type == fourcc("jp2c")) {
          code = p;  // the codestream runs to the end of the file
          return -1;
        }
        if (cut) return (int)kTruncated;
        if (type != fourcc("jp2h")) return 0;
        header = true;
        return walk_boxes(p, pe, [&](uint32_t t, const uint8_t* q,
                                     const uint8_t* qe, bool qcut) {
          if (qcut) return (int)kTruncated;
          if (t == fourcc("ihdr")) {
            // OpenJPEG checks its size and component count; the width
            // and height must be the codestream's (checked after SIZ)
            if (qe - q != 14) return (int)kMalformed;
            const uint32_t nc = be16(q + 8);
            img->ihdr_h = be32(q);
            img->ihdr_w = be32(q + 4);
            if (nc < 1 || nc > 16384 || img->ihdr_h < 1 || img->ihdr_w < 1)
              return (int)kMalformed;
            ihdr = true;
          } else if (t == fourcc("colr") && !colr) {
            // OpenJPEG reads the space of the first colr box's method 1
            // and ignores an ICC profile (method 2) or another method
            if (qe - q < 3) return (int)kMalformed;
            colr = true;
            if (q[0] == 1) {
              if (qe - q < 7) return (int)kMalformed;
              img->enumcs = (int)be32(q + 3);
            }
          } else if (t == fourcc("pclr") || t == fourcc("cmap")) {
            return (int)kPalette;
          } else if (t == fourcc("cdef")) {
            if (qe - q < 2) return (int)kMalformed;
            const int m = (int)be16(q);
            if (qe - q < 2 + 6 * m) return (int)kMalformed;
            for (int i = 0; i < m; i++) {
              const int cn = (int)be16(q + 2 + 6 * i);
              const int asoc = (int)be16(q + 6 + 6 * i);
              if (asoc != 0 && asoc != 65535 && asoc - 1 != cn)
                return (int)kPalette;
            }
          }
          return 0;
        });
      });
  if (err) return err;
  if (!code) return kTruncated;
  if (!header || !ihdr) return kMalformed;
  // sRGB (16) and greyscale (17) as they are; CMYK (12), sYCC (18) and
  // e-sYCC (24) refused; any other space, an ignored colr box or none: 0,
  // which OpenCV takes by the number of components, as a raw codestream
  if (img->enumcs == 12 || img->enumcs == 18 || img->enumcs == 24)
    return kColour;
  if (img->enumcs != 16 && img->enumcs != 17) img->enumcs = 0;
  img->jp2 = true;
  *cs = code;
  *cs_len = (size_t)(d + n - code);
  return kOk;
}

// ---- the codestream ----

static int read_spcod(const uint8_t* p, size_t n, bool precincts,
                      Coding* c) {
  if (n < 5) return kMalformed;
  c->numres = p[0] + 1;
  c->cbw = p[1] + 2;
  c->cbh = p[2] + 2;
  c->style = p[3];
  c->qmf = p[4];
  if (c->numres > 33 || c->cbw > 10 || c->cbh > 10 || c->cbw + c->cbh > 12 ||
      c->qmf > 1)
    return kMalformed;
  if (c->style & 0x40) return kHt;
  if (c->style) return kCodeStyle;
  for (int r = 0; r < 33; r++) c->ppx[r] = c->ppy[r] = 15;
  if (precincts) {
    if (n < (size_t)(5 + c->numres)) return kMalformed;
    for (int r = 0; r < c->numres; r++) {
      c->ppx[r] = p[5 + r] & 0xf;
      c->ppy[r] = p[5 + r] >> 4;
      if (r > 0 && (c->ppx[r] == 0 || c->ppy[r] == 0)) return kMalformed;
    }
  }
  // OpenJPEG refuses a segment with bytes left over
  if (n != (size_t)(5 + (precincts ? c->numres : 0))) return kMalformed;
  return kOk;
}

// OpenJPEG's reading: style 0 a byte a band, 1 (derived) one pair of
// bytes, any other style a pair a band (as 2, expounded); a segment with
// bytes left over is refused.
static int read_sqcd(const uint8_t* p, size_t n, Quant* q) {
  if (n < 1) return kMalformed;
  q->style = p[0] & 0x1f;
  q->guard = p[0] >> 5;
  p++;
  n--;
  if (q->style == 0) {
    q->n = (int)(n > 97 ? 97 : n);
    for (int i = 0; i < q->n; i++) {
      q->expn[i] = p[i] >> 3;
      q->mant[i] = 0;
    }
  } else {
    if (q->style != 1) q->style = 2;
    q->n = q->style == 1 ? 1 : (int)(n / 2 > 97 ? 97 : n / 2);
    if (n < 2 || n != (q->style == 1 ? 2 : n / 2 * 2)) return kMalformed;
    for (int i = 0; i < q->n; i++) {
      const uint32_t v = be16(p + 2 * i);
      q->expn[i] = v >> 11;
      q->mant[i] = v & 0x7ff;
    }
    if (q->style == 1) {  // derived: OpenJPEG's rule
      for (int b = 1; b < 97; b++) {
        const int e = q->expn[0] - (b - 1) / 3;
        q->expn[b] = e > 0 ? e : 0;
        q->mant[b] = q->mant[0];
      }
      q->n = 97;
    }
  }
  return kOk;
}

static int component_index(const uint8_t** p, size_t* n, int nc) {
  int c;
  if (nc < 257) {
    if (*n < 1) return -1;
    c = (*p)[0];
    *p += 1;
    *n -= 1;
  } else {
    if (*n < 2) return -1;
    c = (int)be16(*p);
    *p += 2;
    *n -= 2;
  }
  return c < nc ? c : -1;
}

// The markers OpenJPEG 2.5 knows (j2k.c's handler table): 0 for one it
// does not, 1 for one it takes in the main header, 2 for one it does not
// (SIZ again, PLT, PPT, SOP).
static int known_marker(uint32_t m) {
  switch (m) {
    case 0xff90: case 0xff52: case 0xff53: case 0xff5e: case 0xff5c:
    case 0xff5d: case 0xff5f: case 0xff55: case 0xff57: case 0xff60:
    case 0xff63: case 0xff64: case 0xff74: case 0xff78: case 0xff50:
    case 0xff59: case 0xff75: case 0xff77:
      return 1;
    case 0xff51: case 0xff58: case 0xff61: case 0xff91:
      return 2;
    default:
      return 0;
  }
}

static int read_main_header(const uint8_t* d, size_t n, size_t* pos,
                            Image* img) {
  if (n < 4 || be16(d) != 0xff4f) return n < 4 ? kTruncated : kMalformed;
  if (be16(d + 2) != 0xff51) return kMalformed;
  size_t at = 4;
  if (n < at + 2) return kTruncated;
  size_t len = be16(d + at);
  if (n < at + len) return kTruncated;
  if (len < 41) return kMalformed;
  const uint8_t* s = d + at + 2;
  img->X = (int)be32(s + 2);
  img->Y = (int)be32(s + 6);
  img->X0 = (int)be32(s + 10);
  img->Y0 = (int)be32(s + 14);
  // the tile sizes are unsigned: one past the image is the image's
  const int64_t XT = be32(s + 18), YT = be32(s + 22);
  img->XT0 = (int)be32(s + 26);
  img->YT0 = (int)be32(s + 30);
  img->nc = (int)be16(s + 34);
  if (img->X <= 0 || img->Y <= 0 || img->X0 < 0 || img->Y0 < 0 ||
      img->X0 >= img->X || img->Y0 >= img->Y || XT <= 0 || YT <= 0 ||
      img->XT0 < 0 || img->YT0 < 0 || img->XT0 > img->X0 ||
      img->YT0 > img->Y0 || img->XT0 + XT <= img->X0 ||
      img->YT0 + YT <= img->Y0 || img->nc < 1 || img->nc > 16384 ||
      len != (size_t)(38 + 3 * img->nc))
    return kMalformed;
  img->XT = (int)(XT < img->X ? XT : img->X);
  img->YT = (int)(YT < img->Y ? YT : img->Y);
  for (int c = 0; c < img->nc; c++) {
    const uint8_t* q = s + 36 + 3 * c;
    img->prec.push_back((q[0] & 0x7f) + 1);
    img->sgnd.push_back(q[0] >> 7);
    img->dx.push_back(q[1]);
    img->dy.push_back(q[2]);
    if (q[1] == 0 || q[2] == 0 || img->prec.back() > 38) return kMalformed;
  }
  at += len;
  img->cod.assign(img->nc, Coding());
  img->qnt.assign(img->nc, Quant());
  std::vector<char> coc(img->nc, 0), qcc(img->nc, 0);
  bool have_cod = false, have_qcd = false;
  for (;;) {
    if (n < at + 2) return kTruncated;
    const uint32_t m = be16(d + at);
    if (m == 0xff90) break;  // SOT
    if (m < 0xff00) return kMalformed;
    if (!known_marker(m)) {
      // OpenJPEG's opj_j2k_read_unk: on, two bytes at a time, to the next
      // marker it knows, which must belong in the main header
      do {
        at += 2;
        if (n < at + 2) return kTruncated;
      } while (be16(d + at) < 0xff00 || !known_marker(be16(d + at)));
      if (known_marker(be16(d + at)) != 1) return kMalformed;
      continue;
    }
    if (n < at + 4) return kTruncated;
    len = be16(d + at + 2);
    if (len < 2) return kMalformed;
    if (n < at + 2 + len) return kTruncated;
    const uint8_t* p = d + at + 4;
    size_t pl = len - 2;
    switch (m) {
      case 0xff52: {  // COD
        if (pl < 5) return kMalformed;
        img->csty = p[0];
        img->prog = p[1];
        img->layers = (int)be16(p + 2);
        img->mct = p[4];
        if (img->csty > 7 || img->prog > 4 || img->layers < 1)
          return kMalformed;
        if (img->mct > 1) return kMct;
        Coding c;
        int err = read_spcod(p + 5, pl - 5, img->csty & 1, &c);
        if (err) return err;
        for (int k = 0; k < img->nc; k++)
          if (!coc[k]) img->cod[k] = c;
        have_cod = true;
        break;
      }
      case 0xff53: {  // COC
        const int k = component_index(&p, &pl, img->nc);
        if (k < 0 || pl < 1) return kMalformed;
        Coding c;
        int err = read_spcod(p + 1, pl - 1, p[0] & 1, &c);
        if (err) return err;
        img->cod[k] = c;
        coc[k] = 1;
        break;
      }
      case 0xff5c: {  // QCD
        Quant q;
        int err = read_sqcd(p, pl, &q);
        if (err) return err;
        for (int k = 0; k < img->nc; k++)
          if (!qcc[k]) img->qnt[k] = q;
        have_qcd = true;
        break;
      }
      case 0xff5d: {  // QCC
        const int k = component_index(&p, &pl, img->nc);
        if (k < 0) return kMalformed;
        Quant q;
        int err = read_sqcd(p, pl, &q);
        if (err) return err;
        img->qnt[k] = q;
        qcc[k] = 1;
        break;
      }
      case 0xff5e: case 0xff5f: case 0xff60:  // RGN, POC, PPM
        return kMarker;
      case 0xff50:  // CAP: Part 15 (HTJ2K)
        return kHt;
      case 0xff63:  // CRG: OpenJPEG checks its size
        if (pl != 4 * (size_t)img->nc) return kMalformed;
        break;
      case 0xff55: case 0xff57: case 0xff64: case 0xff59:
        break;  // TLM, PLM, COM, CPF
      default:
        return kMalformed;
    }
    at += 2 + len;
  }
  if (!have_cod || !have_qcd) return kMalformed;
  *pos = at;
  return kOk;
}

static int read_tile_parts(const uint8_t* d, size_t n, size_t at,
                           Image* img) {
  img->tw = (int)ceildiv((int64_t)img->X - img->XT0, img->XT);
  img->th = (int)ceildiv((int64_t)img->Y - img->YT0, img->YT);
  if ((int64_t)img->tw * img->th > 65535) return kMalformed;
  img->tiles.assign((size_t)img->tw * img->th, Tile());
  size_t tiles_done = 0;  // tiles whose TNsot parts have all been read
  for (;;) {
    // at: a SOT marker
    const size_t sot = at;
    if (n < at + 12) return kTruncated;
    if (be16(d + at + 2) != 10) return kMalformed;
    const int isot = (int)be16(d + at + 4);
    uint64_t psot = be32(d + at + 6);
    if (isot >= (int)img->tiles.size()) return kMalformed;
    // OpenJPEG: the parts of a tile in order, fewer than TNsot where set
    const int tpsot = d[at + 10], tnsot = d[at + 11];
    if (tpsot != img->tiles[isot].parts || (tnsot && tpsot >= tnsot))
      return kMalformed;
    at += 12;
    for (;;) {  // the tile-part header
      if (n < at + 2) return kTruncated;
      const uint32_t m = be16(d + at);
      if (m == 0xff93) break;  // SOD
      if (n < at + 4) return kTruncated;
      const size_t len = be16(d + at + 2);
      if (len < 2) return kMalformed;
      if (n < at + 2 + len) return kTruncated;
      if (m == 0xff58 || m == 0xff64) {  // PLT, COM
        at += 2 + len;
        continue;
      }
      if (m == 0xff52 || m == 0xff53 || m == 0xff5c || m == 0xff5d ||
          m == 0xff5e || m == 0xff5f || m == 0xff61)
        return kMarker;
      return kMalformed;
    }
    at += 2;
    const size_t end = psot == 0 ? (n >= 2 ? n - 2 : 0) : sot + psot;
    if (end > n) return kTruncated;
    if (end < at) return kMalformed;
    Tile& t = img->tiles[isot];
    t.data.insert(t.data.end(), d + at, d + end);
    if (++t.parts == tnsot) tiles_done++;
    at = end;
    // OpenJPEG reads the next marker after each tile (opj_j2k_decode_tile):
    // EOC, or any marker with nothing after it (its state NEOC), ends the
    // codestream: the tiles read are decoded, the others left 0; another
    // marker than SOT with data after it is refused ("expected SOT"); a
    // SOT once every tile is complete (OpenJPEG has decoded them all) ends
    // it too
    if (n < at + 2) return kTruncated;
    const uint32_t next = be16(d + at);
    if (next == 0xffd9 || n == at + 2) break;
    if (next != 0xff90) return kTruncated;
    if (tiles_done == img->tiles.size()) break;
  }
  return kOk;
}

// ---- tile geometry (OpenJPEG's tcd.c) ----

static int build_tile(Image* img, int index) {
  Tile& t = img->tiles[index];
  const int p = index % img->tw, q = index / img->tw;
  t.x0 = imax(img->XT0 + p * img->XT, img->X0);
  t.y0 = imax(img->YT0 + q * img->YT, img->Y0);
  t.x1 = (int)((int64_t)img->XT0 + (int64_t)(p + 1) * img->XT < img->X
                   ? img->XT0 + (p + 1) * img->XT : img->X);
  t.y1 = (int)((int64_t)img->YT0 + (int64_t)(q + 1) * img->YT < img->Y
                   ? img->YT0 + (q + 1) * img->YT : img->Y);
  t.comps.assign(img->nc, TileComp());
  for (int c = 0; c < img->nc; c++) {
    TileComp& tc = t.comps[c];
    const Coding& cod = img->cod[c];
    const Quant& qn = img->qnt[c];
    tc.x0 = (int)ceildiv(t.x0, img->dx[c]);
    tc.y0 = (int)ceildiv(t.y0, img->dy[c]);
    tc.x1 = (int)ceildiv(t.x1, img->dx[c]);
    tc.y1 = (int)ceildiv(t.y1, img->dy[c]);
    tc.numres = cod.numres;
    tc.qmf = cod.qmf;
    tc.offset = img->words;
    img->words += (size_t)(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
    if (img->words > ((size_t)1 << 28)) return kTooLarge;
    if (tc.numres > img->maxres) img->maxres = tc.numres;
    const int nl = tc.numres - 1;
    tc.res.assign(tc.numres, Res());
    for (int r = 0; r < tc.numres; r++) {
      Res& rs = tc.res[r];
      const int lev = nl - r;
      rs.x0 = ceildivpow2(tc.x0, lev);
      rs.y0 = ceildivpow2(tc.y0, lev);
      rs.x1 = ceildivpow2(tc.x1, lev);
      rs.y1 = ceildivpow2(tc.y1, lev);
      rs.ppx = cod.ppx[r];
      rs.ppy = cod.ppy[r];
      const int tlx = floordivpow2(rs.x0, rs.ppx) << rs.ppx;
      const int tly = floordivpow2(rs.y0, rs.ppy) << rs.ppy;
      const int brx = ceildivpow2(rs.x1, rs.ppx) << rs.ppx;
      const int bry = ceildivpow2(rs.y1, rs.ppy) << rs.ppy;
      rs.pw = rs.x0 == rs.x1 ? 0 : (brx - tlx) >> rs.ppx;
      rs.ph = rs.y0 == rs.y1 ? 0 : (bry - tly) >> rs.ppy;
      img->precincts += (size_t)rs.pw * rs.ph;
      if (img->precincts > ((size_t)1 << 24)) return kTooLarge;
      int cbgx0, cbgy0, cbgw, cbgh;
      if (r == 0) {
        cbgx0 = tlx;
        cbgy0 = tly;
        cbgw = rs.ppx;
        cbgh = rs.ppy;
      } else {
        cbgx0 = ceildivpow2(tlx, 1);
        cbgy0 = ceildivpow2(tly, 1);
        cbgw = rs.ppx - 1;
        cbgh = rs.ppy - 1;
      }
      const int cbw = imin(cod.cbw, cbgw), cbh = imin(cod.cbh, cbgh);
      rs.nbands = r == 0 ? 1 : 3;
      for (int b = 0; b < rs.nbands; b++) {
        Band& bd = rs.bands[b];
        bd.no = r == 0 ? 0 : b + 1;
        if (r == 0) {
          bd.x0 = ceildivpow2(tc.x0, lev);
          bd.y0 = ceildivpow2(tc.y0, lev);
          bd.x1 = ceildivpow2(tc.x1, lev);
          bd.y1 = ceildivpow2(tc.y1, lev);
        } else {
          const int x0b = bd.no & 1, y0b = bd.no >> 1;
          bd.x0 = (int)(((int64_t)tc.x0 - ((int64_t)x0b << lev) +
                         ((int64_t)1 << (lev + 1)) - 1) >> (lev + 1));
          bd.y0 = (int)(((int64_t)tc.y0 - ((int64_t)y0b << lev) +
                         ((int64_t)1 << (lev + 1)) - 1) >> (lev + 1));
          bd.x1 = (int)(((int64_t)tc.x1 - ((int64_t)x0b << lev) +
                         ((int64_t)1 << (lev + 1)) - 1) >> (lev + 1));
          bd.y1 = (int)(((int64_t)tc.y1 - ((int64_t)y0b << lev) +
                         ((int64_t)1 << (lev + 1)) - 1) >> (lev + 1));
        }
        const int si = r == 0 ? 0 : 3 * (r - 1) + bd.no;
        const int expn = qn.expn[si], mant = qn.mant[si];
        bd.mb = expn + qn.guard - 1;
        {
          double step = (1.0 + mant / 2048.0);
          const int e = img->prec[c] - expn;
          for (int i = 0; i < e; i++) step *= 2.0;
          for (int i = 0; i > e; i--) step /= 2.0;
          bd.step_half = 0.5f * (float)step;
        }
        bd.precs.assign((size_t)rs.pw * rs.ph, Precinct());
        for (int pi = 0; pi < rs.pw * rs.ph; pi++) {
          Precinct& pr = bd.precs[pi];
          const int gx = cbgx0 + (pi % rs.pw) * (1 << cbgw);
          const int gy = cbgy0 + (pi / rs.pw) * (1 << cbgh);
          const int px0 = imax(gx, bd.x0), py0 = imax(gy, bd.y0);
          const int px1 = imin(gx + (1 << cbgw), bd.x1);
          const int py1 = imin(gy + (1 << cbgh), bd.y1);
          if (bd.empty()) continue;
          const int tcx = floordivpow2(px0, cbw) << cbw;
          const int tcy = floordivpow2(py0, cbh) << cbh;
          const int bcx = ceildivpow2(px1, cbw) << cbw;
          const int bcy = ceildivpow2(py1, cbh) << cbh;
          pr.cw = imax((bcx - tcx) >> cbw, 0);
          pr.ch = imax((bcy - tcy) >> cbh, 0);
          pr.blocks.assign((size_t)pr.cw * pr.ch, Cblk());
          for (int k = 0; k < pr.cw * pr.ch; k++) {
            Cblk& cb = pr.blocks[k];
            const int cx = tcx + (k % pr.cw) * (1 << cbw);
            const int cy = tcy + (k / pr.cw) * (1 << cbh);
            cb.x0 = imax(cx, px0);
            cb.y0 = imax(cy, py0);
            cb.x1 = imin(cx + (1 << cbw), px1);
            cb.y1 = imin(cy + (1 << cbh), py1);
          }
          img->cblks += pr.blocks.size();
          if (img->cblks > ((size_t)1 << 24)) return kTooLarge;
          if (pr.cw * pr.ch > 0) {
            pr.incl.build(pr.cw, pr.ch);
            pr.imsb.build(pr.cw, pr.ch);
          }
        }
      }
    }
  }
  return kOk;
}

// ---- tier-2 ----

static int getnumpasses(Bio& b) {
  if (!b.bit()) return 1;
  if (!b.bit()) return 2;
  int n = (int)b.read(2);
  if (n != 3) return 3 + n;
  n = (int)b.read(5);
  if (n != 31) return 6 + n;
  return 37 + (int)b.read(7);
}

// One packet at data[*pos]: its header, then its bodies' chunks.
static int read_packet(Image* img, Tile& t, int layer, int r, int c,
                       int precno, size_t* pos) {
  const uint8_t* d = t.data.data();
  const size_t n = t.data.size();
  size_t at = *pos;
  if ((img->csty & 2) && n >= at + 6 && d[at] == 0xff && d[at + 1] == 0x91)
    at += 6;  // SOP
  Res& rs = t.comps[c].res[r];
  Bio bio;
  bio.init(d + at, n - at);
  const bool present = bio.bit();
  if (present) {
    for (int b = 0; b < rs.nbands; b++) {
      Band& bd = rs.bands[b];
      if (bd.empty()) continue;
      Precinct& pr = bd.precs[precno];
      for (size_t k = 0; k < pr.blocks.size(); k++) {
        Cblk& cb = pr.blocks[k];
        int inc;
        if (!cb.seen)
          inc = tree_decode(bio, pr.incl, (int)k, layer + 1);
        else
          inc = (int)bio.bit();
        if (!inc) {
          cb.newpasses = 0;
          continue;
        }
        if (!cb.seen) {
          // OpenJPEG counts zero bit-planes with no limit of its own: a
          // count past the band's leaves the code-block 0, and the tag
          // tree's initial value (999) ends the count
          int i = 0;
          while (!tree_decode(bio, pr.imsb, (int)k, i)) i++;
          cb.numbps = bd.mb + 1 - i;
          cb.lenbits = 3;
          cb.seen = true;
        }
        cb.newpasses = getnumpasses(bio);
        int incr = 0;
        while (bio.bit()) {
          if (++incr > 32) return kPackets;
        }
        cb.lenbits += incr;
        // OpenJPEG's segments of code-block style 0 hold 109 passes each,
        // a length each; the passes past the first segment's are never
        // decoded (3 a bit-plane), so their bytes are skipped
        cb.newlen = cb.newskip = 0;
        for (int left = cb.newpasses, done = cb.passes; left > 0;) {
          const int take = imin(left, 109 - done % 109);
          const int bits = cb.lenbits + floorlog2((uint32_t)take);
          if (bits > 32) return kPackets;
          const uint32_t len = bio.read(bits);
          if (done < 109) {
            cb.newlen = len;
          } else {
            if (len > UINT32_MAX - cb.newskip) return kPackets;
            cb.newskip += len;
          }
          done += take;
          left -= take;
        }
      }
    }
  }
  bio.inalign();
  at += bio.numbytes();
  if ((img->csty & 4) && n >= at + 2 && d[at] == 0xff && d[at + 1] == 0x92)
    at += 2;  // EPH
  if (present) {
    for (int b = 0; b < rs.nbands; b++) {
      Band& bd = rs.bands[b];
      if (bd.empty()) continue;
      for (Cblk& cb : bd.precs[precno].blocks) {
        if (!cb.newpasses) continue;
        if ((size_t)cb.newlen > n - at) return kPackets;  // strict mode
        cb.chunks.push_back({at, (size_t)cb.newlen});
        at += cb.newlen;
        if ((size_t)cb.newskip > n - at) return kPackets;
        at += cb.newskip;
        cb.passes += cb.newpasses;
        cb.newpasses = 0;
      }
    }
  }
  *pos = at;
  return kOk;
}

// The packet order of a tile (OpenJPEG's pi.c, no POC): calls
// fn(layer, res, comp, precinct) for each packet, each once.
template <typename F>
static int each_packet(const Image* img, const Tile& t, F fn) {
  const int L = img->layers, C = img->nc;
  int R = 0, P = 0;
  for (const TileComp& tc : t.comps) {
    R = imax(R, tc.numres);
    for (const Res& rs : tc.res) P = imax(P, rs.pw * rs.ph);
  }
  auto res_of = [&](int c, int r) -> const Res* {
    return r < t.comps[c].numres ? &t.comps[c].res[r] : nullptr;
  };
  int err;
  if (img->prog == 0 || img->prog == 1) {  // LRCP, RLCP
    const int outer = img->prog == 0 ? L : R, inner = img->prog == 0 ? R : L;
    for (int o = 0; o < outer; o++)
      for (int i = 0; i < inner; i++)
        for (int c = 0; c < C; c++) {
          const int l = img->prog == 0 ? o : i, r = img->prog == 0 ? i : o;
          const Res* rs = res_of(c, r);
          if (!rs) continue;
          for (int p = 0; p < rs->pw * rs->ph; p++)
            if ((err = fn(l, r, c, p))) return err;
        }
    return kOk;
  }
  // position-driven orders: include[] keeps each packet to one visit
  const size_t packets = (size_t)L * R * C * (P > 0 ? P : 1);
  if (packets > ((size_t)1 << 30)) return kTooLarge;
  std::vector<uint8_t> include(packets, 0);
  auto visit = [&](int r, int c, uint32_t x, uint32_t y) -> int {
    const TileComp& tc = t.comps[c];
    if (r >= tc.numres) return 0;
    const Res& rs = tc.res[r];
    const int lev = tc.numres - 1 - r;
    const uint32_t dx = (uint32_t)img->dx[c], dy = (uint32_t)img->dy[c];
    const uint32_t tx0 = (uint32_t)t.x0, ty0 = (uint32_t)t.y0;
    const uint32_t trx0 = (uint32_t)ceildiv(t.x0, (int64_t)dx << lev);
    const uint32_t try0 = (uint32_t)ceildiv(t.y0, (int64_t)dy << lev);
    const uint32_t trx1 = (uint32_t)ceildiv(t.x1, (int64_t)dx << lev);
    const uint32_t try1 = (uint32_t)ceildiv(t.y1, (int64_t)dy << lev);
    const int rpx = rs.ppx + lev, rpy = rs.ppy + lev;
    if (rpx >= 31 || rpy >= 31) return 0;
    if (!((uint64_t)y % ((uint64_t)dy << rpy) == 0 ||
          (y == ty0 && (((uint64_t)try0 << lev) % ((uint64_t)1 << rpy)))))
      return 0;
    if (!((uint64_t)x % ((uint64_t)dx << rpx) == 0 ||
          (x == tx0 && (((uint64_t)trx0 << lev) % ((uint64_t)1 << rpx)))))
      return 0;
    if (rs.pw == 0 || rs.ph == 0) return 0;
    if (trx0 == trx1 || try0 == try1) return 0;
    const uint32_t prci =
        ((uint32_t)ceildiv(x, (int64_t)dx << lev) >> rs.ppx) -
        (trx0 >> rs.ppx);
    const uint32_t prcj =
        ((uint32_t)ceildiv(y, (int64_t)dy << lev) >> rs.ppy) -
        (try0 >> rs.ppy);
    const uint32_t precno = prci + prcj * (uint32_t)rs.pw;
    if (precno >= (uint32_t)(rs.pw * rs.ph)) return kPackets;
    for (int l = 0; l < L; l++) {
      const size_t idx = (((size_t)l * R + r) * C + c) * P + precno;
      if (include[idx]) continue;
      include[idx] = 1;
      int e = fn(l, r, c, (int)precno);
      if (e) return e;
    }
    return 0;
  };
  auto steps = [&](int c0, int c1, uint32_t* sdx, uint32_t* sdy) {
    uint32_t mx = 0, my = 0;
    for (int c = c0; c < c1; c++) {
      const TileComp& tc = t.comps[c];
      for (int r = 0; r < tc.numres; r++) {
        const int e = tc.res[r].ppx + tc.numres - 1 - r;
        const int f = tc.res[r].ppy + tc.numres - 1 - r;
        if (e < 32) {
          const uint32_t v = (uint32_t)img->dx[c] << e;
          mx = mx ? (v < mx ? v : mx) : v;
        }
        if (f < 32) {
          const uint32_t v = (uint32_t)img->dy[c] << f;
          my = my ? (v < my ? v : my) : v;
        }
      }
    }
    *sdx = mx;
    *sdy = my;
    return mx != 0 && my != 0;
  };
  const uint32_t x0 = t.x0, y0 = t.y0, x1 = t.x1, y1 = t.y1;
  uint32_t sx, sy;
  if (img->prog == 2) {  // RPCL
    if (!steps(0, C, &sx, &sy)) return kOk;
    for (int r = 0; r < R; r++)
      for (uint32_t y = y0; y < y1; y += sy - (y % sy))
        for (uint32_t x = x0; x < x1; x += sx - (x % sx))
          for (int c = 0; c < C; c++)
            if ((err = visit(r, c, x, y))) return err;
  } else if (img->prog == 3) {  // PCRL
    if (!steps(0, C, &sx, &sy)) return kOk;
    for (uint32_t y = y0; y < y1; y += sy - (y % sy))
      for (uint32_t x = x0; x < x1; x += sx - (x % sx))
        for (int c = 0; c < C; c++)
          for (int r = 0; r < t.comps[c].numres; r++)
            if ((err = visit(r, c, x, y))) return err;
  } else {  // CPRL
    for (int c = 0; c < C; c++) {
      if (!steps(c, c + 1, &sx, &sy)) return kOk;
      for (uint32_t y = y0; y < y1; y += sy - (y % sy))
        for (uint32_t x = x0; x < x1; x += sx - (x % sx))
          for (int r = 0; r < t.comps[c].numres; r++)
            if ((err = visit(r, c, x, y))) return err;
    }
  }
  return kOk;
}

// Tier-1 of every code-block of a tile, into the image's words.
static int decode_blocks(Image* img, Tile& t, j2k_t1::Decoder& t1,
                         std::vector<uint8_t>& buf) {
  for (TileComp& tc : t.comps) {
    const int w = tc.x1 - tc.x0;
    for (int r = 0; r < tc.numres; r++) {
      Res& rs = tc.res[r];
      int ox = 0, oy = 0;
      if (r > 0) {
        ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
        oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
      }
      for (int b = 0; b < rs.nbands; b++) {
        Band& bd = rs.bands[b];
        if (bd.empty()) continue;
        const int bx = (bd.no & 1) ? ox : 0, by = (bd.no & 2) ? oy : 0;
        for (Precinct& pr : bd.precs)
          for (Cblk& cb : pr.blocks) {
            const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            if (cw <= 0 || ch <= 0 || cb.passes == 0) continue;
            if (cb.numbps >= 31) return kPackets;
            size_t len = 0;
            for (const Chunk& k : cb.chunks) len += k.len;
            buf.resize(len + 2);
            size_t at = 0;
            for (const Chunk& k : cb.chunks) {
              memcpy(buf.data() + at, t.data.data() + k.at, k.len);
              at += k.len;
            }
            buf[len] = buf[len + 1] = 0xff;
            t1.decode(buf.data(), cw, ch, bd.no, cb.numbps, cb.passes);
            const int x = cb.x0 - bd.x0 + bx, y = cb.y0 - bd.y0 + by;
            for (int j = 0; j < ch; j++) {
              uint32_t* row = img->coef.data() + tc.offset +
                              (size_t)(y + j) * w + x;
              const int32_t* src = t1.data.data() + (size_t)j * cw;
              if (tc.qmf == 1) {
                for (int i = 0; i < cw; i++) row[i] = (uint32_t)(src[i] / 2);
              } else {
                for (int i = 0; i < cw; i++) {
                  const float v = (float)src[i] * bd.step_half;
                  memcpy(&row[i], &v, 4);
                }
              }
            }
          }
      }
    }
  }
  return kOk;
}

static int decode(const uint8_t* d, size_t n, Image* img) {
  const uint8_t* cs = d;
  size_t cn = n;
  if (n >= 12 && memcmp(d, kJp2Sig, 12) == 0) {
    int err = read_jp2(d, n, img, &cs, &cn);
    if (err) return err;
  } else if (n >= 4 && be32(d) == 0xff4fff51) {
    img->enumcs = 0;
  } else {
    return n < 12 ? kTruncated : kMalformed;
  }
  size_t at = 0;
  int err = read_main_header(cs, cn, &at, img);
  if (err) return err;
  if (img->X0 != 0 || img->Y0 != 0) return kOffset;
  if (img->jp2 && (img->ihdr_w != img->X || img->ihdr_h != img->Y))
    return kMalformed;
  for (int c = 0; c < img->nc; c++) {
    if (img->dx[c] != 1 || img->dy[c] != 1) return kOffset;
    if (img->sgnd[c]) return kPrecision;
  }
  for (int c = 0; c < img->nc; c++)
    if (img->prec[c] != img->prec[0]) return kUnequal;
  if (img->prec[0] < 8 || img->prec[0] > 16) return kPrecision;
  if ((int64_t)img->X * img->Y * img->nc > ((int64_t)1 << 28))
    return kTooLarge;
  err = read_tile_parts(cs, cn, at, img);
  if (err) return err;
  for (size_t i = 0; i < img->tiles.size(); i++)
    if ((err = build_tile(img, (int)i))) return err;
  if (img->mct && img->nc >= 3) {
    for (const Tile& t : img->tiles)
      if (t.comps[1].numres != t.comps[0].numres ||
          t.comps[2].numres != t.comps[0].numres ||
          t.comps[1].qmf != t.comps[0].qmf ||
          t.comps[2].qmf != t.comps[0].qmf)
        return kMct;
  }
  img->coef.assign(img->words, 0);
  j2k_t1::Decoder t1;
  std::vector<uint8_t> buf;
  for (Tile& t : img->tiles) {
    if (t.parts == 0) continue;
    size_t pos = 0;
    err = each_packet(img, t, [&](int l, int r, int c, int p) {
      return read_packet(img, t, l, r, c, p, &pos);
    });
    if (err) return err;
    if ((err = decode_blocks(img, t, t1, buf))) return err;
    t.data.clear();
    t.data.shrink_to_fit();
  }
  return kOk;
}

// info: X, Y, components, precision, colour (0 codestream, 16 sRGB, 17
// grey), tiles across, down, tile width, height, tile origin x, y, MCT,
// words, IDWT levels (the most resolutions less one), code-blocks,
// progression
static void fill_info(const Image& img, int* info) {
  info[0] = img.X;
  info[1] = img.Y;
  info[2] = img.nc;
  info[3] = img.prec[0];
  info[4] = img.enumcs;
  info[5] = img.tw;
  info[6] = img.th;
  info[7] = img.XT;
  info[8] = img.YT;
  info[9] = img.XT0;
  info[10] = img.YT0;
  info[11] = img.nc >= 3 ? img.mct : 0;
  info[12] = (int)img.words;
  info[13] = img.maxres > 0 ? img.maxres - 1 : 0;
  info[14] = (int)img.cblks;
  info[15] = img.prog;
}

// Per tile-component (tile-major): offset, width, height, x0, y0 (on the
// image grid), resolutions, wavelet (1: 5/3, 0: 9/7), tile, component,
// 1 if the codestream holds the tile (0: it stopped before it). Per level
// of each tile-component, lowest first (level 1 .. numres - 1):
// tile-component, level, width, height, low columns, low rows, column and
// row parity of the level's origin.
static void fill_tables(const Image& img, int* tcs, int* levels) {
  int i = 0, j = 0;
  for (size_t ti = 0; ti < img.tiles.size(); ti++)
    for (int c = 0; c < img.nc; c++) {
      const TileComp& tc = img.tiles[ti].comps[c];
      int* e = tcs + kTcInts * i;
      e[0] = (int)tc.offset;
      e[1] = tc.x1 - tc.x0;
      e[2] = tc.y1 - tc.y0;
      e[3] = tc.x0;
      e[4] = tc.y0;
      e[5] = tc.numres;
      e[6] = tc.qmf;
      e[7] = (int)ti;
      e[8] = c;
      e[9] = img.tiles[ti].parts > 0;
      for (int r = 1; r < tc.numres; r++) {
        int* l = levels + kLevelInts * j++;
        const Res &rs = tc.res[r], &lo = tc.res[r - 1];
        l[0] = i;
        l[1] = r;
        l[2] = rs.x1 - rs.x0;
        l[3] = rs.y1 - rs.y0;
        l[4] = lo.x1 - lo.x0;
        l[5] = lo.y1 - lo.y0;
        l[6] = rs.x0 & 1;
        l[7] = rs.y0 & 1;
      }
      i++;
    }
}

static int count_levels(const Image& img) {
  int n = 0;
  for (const Tile& t : img.tiles)
    for (const TileComp& tc : t.comps) n += tc.numres - 1;
  return n;
}

}  // namespace j2k

// The C interface, for the card's library and the host builds of the tests.
extern "C" int j2k_host_decode(const unsigned char* data, size_t length,
                               void** handle, int* info) {
  j2k::Image* img = new j2k::Image();
  const int err = j2k::decode(data, length, img);
  if (err) {
    delete img;
    *handle = nullptr;
    return err;
  }
  j2k::fill_info(*img, info);
  *handle = img;
  return 0;
}

extern "C" int j2k_host_levels(void* handle) {
  return j2k::count_levels(*(j2k::Image*)handle);
}

extern "C" int j2k_host_tables(void* handle, int* tcs, int* levels,
                               void* words) {
  j2k::Image* img = (j2k::Image*)handle;
  j2k::fill_tables(*img, tcs, levels);
  if (words) memcpy(words, img->coef.data(), img->coef.size() * 4);
  return 0;
}

extern "C" void j2k_host_free(void* handle) { delete (j2k::Image*)handle; }
