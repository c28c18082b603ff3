// The host half of the card's lossless WebP reads: a VP8L bitstream
// (RFC 9649) entropy-decoded as libwebp's dec/vp8l_dec.c, the decoder
// inside cv2.imread, decodes it, into what the card's inverse transforms
// (vp8l_transform.h: vp8l_predictor_kernel, vp8l_colour_kernel) take:
//   * the header: signature 0x2f, 14-bit width - 1 and height - 1, the
//     alpha hint, a 3-bit version that must be 0;
//   * the transforms in stream order, each type at most once, each with
//     its data: the predictor's and the cross-colour transform's block
//     size (2-9 bits) and sub-image of modes or multipliers; the colour
//     indexing transform's palette (1-256 entries, delta-coded in the
//     stream, stored here decoded and padded with 0x00000000 to the
//     2^(8 >> bits) entries its bundling width can index, as libwebp's
//     ExpandColorMap pads it) and its bundling bits (0, 1, 2, 3 for > 16,
//     > 4, > 2, <= 2 colours), which narrow the coded width; subtract
//     green, which has no data;
//   * each image (the sub-images and the main one): its colour cache
//     (1-11 bits; hash (0x1e35a7bd argb) >> (32 - bits)), for the main one
//     its meta prefix codes (an entropy image of 2-9 bits whose red and
//     green give each block's group), then the five prefix codes of each
//     group (green with the length prefixes and the cache's codes, red,
//     blue, alpha, distance): simple codes of one or two symbols (a code
//     of one symbol reads no bits), or normal codes whose lengths come
//     from a code-length code (lengths read in the order 17, 18, 0, 1, 2,
//     3, 4, 5, 16, 6, 7, ..., 15; 16 repeats the last non-zero length,
//     17 and 18 repeat zeros; an optional max_symbol); libwebp's
//     BuildHuffmanTable rejects a code whose lengths are all 0, one that is
//     over-subscribed and one that is incomplete (but a single used
//     symbol), and so does this;
//   * the pixels: literals, colour cache hits and LZ77 back-references,
//     whose lengths and distances are prefix-coded with extra bits, the
//     distance mapped through the 120-entry 2-D neighbourhood map
//     (kCodeToPlane; a distance below 1 becomes 1). A reference that
//     reaches before the first pixel or past the last is an error.
// libwebp's reader sees bits past the end of the chunk as zeros and fails
// the decode when it has used more bits than the chunk holds (or than 64,
// for a chunk shorter than 8 bytes), whatever it was decoding; so does this.
//
// The output is the coded image (the main image's pixels at its coded
// width, before any inverse transform) as ARGB words, and per transform
// its type, bits, width and data. The container (RIFF, VP8X, ANIM/ANMF) is
// read in mpmvs_torch/io/images.py, which hands this the VP8L chunk's
// payload.
//
// Errors are 5008-5011 (images.py names each).

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <vector>

namespace webp_lossless {

enum Err {
  kOk = 0,
  kBadHeader = 5008,   // not the VP8L signature, version not 0, too short
  kTruncated = 5009,   // the decode used more bits than the chunk holds
  kBadCode = 5010,     // a prefix code libwebp rejects
  kMalformed = 5011,   // a transform repeated, cache bits out of range, a
                       // back-reference outside the image
};

enum TransformType { kPredictor = 0, kCrossColour = 1, kSubtractGreen = 2,
                     kColourIndexing = 3 };

// What vp8l_host_decode reports beside the pixels (vp8l_host_decode's
// stats, in this order): the fixtures' checks read them.
enum Stat {
  kStatCacheBits,        // the main image's colour cache bits (0: none)
  kStatMetaBits,         // its entropy image's bits (0: no meta codes)
  kStatGroups,           // its prefix code groups
  kStatSimpleCodes,      // simple codes read, all images
  kStatSingleCodes,      // codes of one used symbol (no bits a symbol)
  kStatNormalCodes,      // normal codes read
  kStatBackRefs,         // back-references, main image
  kStatPlaneRefs,        // of those, distances through the 2-D map
  kStatCacheHits,        // colour cache symbols, main image
  kStatLiterals,         // literal pixels, main image
  kStatColours,          // the colour indexing transform's palette size
  kStatCount
};

static const int kNumLiteralCodes = 256, kNumLengthCodes = 24,
                 kNumDistanceCodes = 40, kMaxCacheBits = 11,
                 kMaxCodeLength = 15, kRootBits = 8;
static const int kCodeLengthCodes = 19;
static const uint8_t kCodeLengthOrder[kCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// RFC 9649 section 4.2.2's distance map: (dy << 4) | (8 - dx) per code.
static const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

static inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

// LSB-first bits of the chunk; past its end, zeros. eos once more bits
// were used than libwebp's reader holds (the chunk, or 64 bits).
struct BitReader {
  std::vector<uint8_t> buf;  // the chunk and 8 zero bytes
  uint64_t pos = 0, limit = 0;
  bool eos = false;

  void init(const uint8_t* d, size_t n) {
    buf.assign(d, d + n);
    buf.resize(n + 8, 0);
    limit = 8 * (uint64_t)(n > 8 ? n : 8);
  }
  uint32_t peek(int n) const {  // n <= 32
    const uint64_t byte = pos >> 3;
    if (byte + 8 > buf.size()) return 0;
    uint64_t v;
    memcpy(&v, buf.data() + byte, 8);
    return (uint32_t)((v >> (pos & 7)) & ((1ull << n) - 1));
  }
  void skip(int n) {
    pos += n;
    if (pos > limit) {
      eos = true;
      pos = limit;
    }
  }
  uint32_t read(int n) {
    if (eos) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return eos ? 0 : v;
  }
};

// A canonical prefix code as a two-level table: kRootBits of the next
// bits index the root; an entry is (length << 16) | symbol, or for codes
// longer than the root a link, 0x80000000 | (sub-table bits << 24) |
// offset, to a sub-table indexed by the bits after the root.
struct Code {
  std::vector<uint32_t> table;
  int single = -1;  // the symbol of a one-symbol code (no bits read)
};

static uint32_t reverse_bits(uint32_t c, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) r |= ((c >> i) & 1) << (n - 1 - i);
  return r;
}

// libwebp's BuildHuffmanTable: false for all-zero lengths, an
// over-subscribed or an incomplete code (a single used symbol is a code of
// no bits, whatever its length).
static bool build_code(const int* lengths, int n, Code* code) {
  int count[kMaxCodeLength + 1] = {0};
  int used = 0, last = -1;
  for (int s = 0; s < n; s++) {
    if (lengths[s] > kMaxCodeLength) return false;
    count[lengths[s]]++;
    if (lengths[s]) {
      used++;
      last = s;
    }
  }
  code->table.clear();
  code->single = -1;
  if (used == 0) return false;
  if (used == 1) {
    code->single = last;
    return true;
  }
  int left = 1;  // Kraft: open slots at each length
  for (int len = 1; len <= kMaxCodeLength; len++) {
    left = 2 * left - count[len];
    if (left < 0) return false;  // over-subscribed
  }
  if (left != 0) return false;  // incomplete
  int next[kMaxCodeLength + 1] = {0};  // the first code of each length
  for (int len = 1, c = 0; len <= kMaxCodeLength; len++) {
    next[len] = c;
    c = (c + count[len]) << 1;
  }
  std::vector<uint32_t> codes(n, 0);
  for (int s = 0; s < n; s++)
    if (lengths[s]) codes[s] = reverse_bits(next[lengths[s]]++, lengths[s]);
  const int root = 1 << kRootBits;
  std::vector<int> sub_bits(root, 0);
  for (int s = 0; s < n; s++)
    if (lengths[s] > kRootBits) {
      int& b = sub_bits[codes[s] & (root - 1)];
      if (lengths[s] - kRootBits > b) b = lengths[s] - kRootBits;
    }
  std::vector<int> offset(root, 0);
  size_t size = root;
  for (int i = 0; i < root; i++)
    if (sub_bits[i]) {
      offset[i] = (int)size;
      size += (size_t)1 << sub_bits[i];
    }
  code->table.assign(size, 0);
  for (int i = 0; i < root; i++)
    if (sub_bits[i])
      code->table[i] = 0x80000000u | ((uint32_t)sub_bits[i] << 24) |
                       (uint32_t)offset[i];
  for (int s = 0; s < n; s++) {
    const int len = lengths[s];
    if (!len) continue;
    const uint32_t entry = ((uint32_t)len << 16) | (uint32_t)s;
    if (len <= kRootBits) {
      for (uint32_t j = codes[s]; j < (uint32_t)root; j += 1u << len)
        code->table[j] = entry;
    } else {
      const uint32_t r = codes[s] & (root - 1);
      const int sb = sub_bits[r];
      const uint32_t hi = codes[s] >> kRootBits;
      const int own = len - kRootBits;
      for (uint32_t j = hi; j < (1u << sb); j += 1u << own)
        code->table[offset[r] + j] = entry;
    }
  }
  return true;
}

static int read_symbol(const Code& code, BitReader& br) {
  if (code.single >= 0) return code.single;
  const uint32_t v = br.peek(kMaxCodeLength);
  uint32_t e = code.table[v & ((1u << kRootBits) - 1)];
  if (e & 0x80000000u) {
    const int sb = (e >> 24) & 0x7f;
    e = code.table[(e & 0xffffff) + ((v >> kRootBits) & ((1u << sb) - 1))];
  }
  br.skip((int)(e >> 16));
  return (int)(e & 0xffff);
}

struct Decoder {
  BitReader br;
  int stats[kStatCount];
  int seen = 0;  // transform types read
};

static const int kAlphabet[5] = {kNumLiteralCodes + kNumLengthCodes,
                                 kNumLiteralCodes, kNumLiteralCodes,
                                 kNumLiteralCodes, kNumDistanceCodes};

// ReadHuffmanCode: one prefix code of an alphabet of n symbols.
static int read_code(Decoder* dec, int n, Code* code) {
  BitReader& br = dec->br;
  std::vector<int> lengths(n > 256 ? n : 256, 0);
  if (br.read(1)) {  // simple: 1 or 2 symbols of length 1
    dec->stats[kStatSimpleCodes]++;
    const int num = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
  } else {
    dec->stats[kStatNormalCodes]++;
    int cl_lengths[kCodeLengthCodes] = {0};
    const int num = br.read(4) + 4;
    for (int i = 0; i < num; i++) cl_lengths[kCodeLengthOrder[i]] = br.read(3);
    Code cl;
    if (!build_code(cl_lengths, kCodeLengthCodes, &cl))
      return br.eos ? kTruncated : kBadCode;
    int max_symbol = n;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > n) return br.eos ? kTruncated : kBadCode;
    }
    int prev = 8;
    for (int s = 0; s < n;) {
      if (max_symbol-- == 0) break;
      const int c = read_symbol(cl, br);
      if (c < 16) {
        lengths[s++] = c;
        if (c) prev = c;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int repeat = br.read(extra[c - 16]) + offset[c - 16];
        if (s + repeat > n) return br.eos ? kTruncated : kBadCode;
        const int len = c == 16 ? prev : 0;
        while (repeat-- > 0) lengths[s++] = len;
      }
    }
  }
  if (br.eos) return kTruncated;
  if (!build_code(lengths.data(), n, code)) return kBadCode;
  if (code->single >= 0) dec->stats[kStatSingleCodes]++;
  return kOk;
}

static int copy_value(int symbol, BitReader& br) {  // GetCopyDistance
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

static int plane_distance(int xsize, int code) {  // PlaneCodeToDistance
  if (code > 120) return code - 120;
  const int d = kCodeToPlane[code - 1];
  const int dist = (d >> 4) * xsize + 8 - (d & 0xf);
  return dist >= 1 ? dist : 1;
}

// DecodeImageStream: an image of xsize x ysize (its transforms, if main,
// already read), its colour cache, prefix codes and pixels.
static int decode_image(Decoder* dec, int xsize, int ysize, bool main,
                        std::vector<uint32_t>* out) {
  BitReader& br = dec->br;
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (br.eos) return kTruncated;
    if (cache_bits < 1 || cache_bits > kMaxCacheBits) return kMalformed;
  }
  int meta_bits = 0, meta_w = 0;
  std::vector<uint32_t> meta;
  int groups = 1;
  if (main && br.read(1)) {
    meta_bits = 2 + br.read(3);
    meta_w = subsample(xsize, meta_bits);
    int err = decode_image(dec, meta_w, subsample(ysize, meta_bits), false,
                           &meta);
    if (err) return err;
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if ((int)m + 1 > groups) groups = (int)m + 1;
    }
  }
  if (br.eos) return kTruncated;
  if (main) {
    dec->stats[kStatCacheBits] = cache_bits;
    dec->stats[kStatMetaBits] = meta_bits;
    dec->stats[kStatGroups] = groups;
  }
  // every group's codes are read and checked, used or not (libwebp too)
  std::vector<Code> codes((size_t)groups * 5);
  for (int g = 0; g < groups; g++)
    for (int j = 0; j < 5; j++) {
      const int n = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      int err = read_code(dec, n, &codes[(size_t)g * 5 + j]);
      if (err) return err;
    }
  const size_t total = (size_t)xsize * ysize;
  out->assign(total, 0);
  uint32_t* px = out->data();
  std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
  size_t cached = 0;  // pixels inserted into the cache so far
  auto insert = [&](size_t upto) {
    for (; cached < upto; cached++)
      cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
  };
  const int len_limit = kNumLiteralCodes + kNumLengthCodes;
  size_t i = 0;
  while (i < total) {
    const int x = (int)(i % xsize), y = (int)(i / xsize);
    const int g = meta_bits ? (int)meta[(size_t)(y >> meta_bits) * meta_w +
                                        (x >> meta_bits)]
                            : 0;
    const Code* c = &codes[(size_t)g * 5];
    const int green = read_symbol(c[0], br);
    if (green < kNumLiteralCodes) {
      const int red = read_symbol(c[1], br);
      const int blue = read_symbol(c[2], br);
      const int alpha = read_symbol(c[3], br);
      px[i++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) |
                ((uint32_t)green << 8) | (uint32_t)blue;
      if (main) dec->stats[kStatLiterals]++;
    } else if (green < len_limit) {
      const int length = copy_value(green - kNumLiteralCodes, br);
      const int dist_code = copy_value(read_symbol(c[4], br), br);
      const int dist = plane_distance(xsize, dist_code);
      if (br.eos) return kTruncated;
      if ((size_t)dist > i || total - i < (size_t)length) return kMalformed;
      for (int k = 0; k < length; k++, i++) px[i] = px[i - dist];
      if (main) {
        dec->stats[kStatBackRefs]++;
        dec->stats[kStatPlaneRefs] += dist_code <= 120;
      }
    } else {
      const int key = green - len_limit;
      if (key >= (int)cache.size()) return kMalformed;  // not reached
      insert(i);
      px[i++] = cache[key];
      if (main) dec->stats[kStatCacheHits]++;
    }
    if (br.eos) return kTruncated;
  }
  return br.eos ? kTruncated : kOk;
}

struct Transform {
  int type, bits, xsize;        // xsize: the width the transform outputs
  std::vector<uint32_t> data;   // modes or multipliers; the palette
};

struct Image {
  int width = 0, height = 0, alpha = 0, coded_width = 0;
  std::vector<Transform> transforms;  // stream order
  std::vector<uint32_t> argb;         // coded_width x height
};

// The 5-byte header of a VP8L payload (VP8LCheckSignature and
// ReadImageInfo).
static int read_header(const uint8_t* d, size_t n, int* w, int* h,
                       int* alpha) {
  if (n < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) return kBadHeader;
  const uint32_t bits = d[1] | (d[2] << 8) | (d[3] << 16) |
                        ((uint32_t)d[4] << 24);
  *w = (int)(bits & 0x3fff) + 1;
  *h = (int)((bits >> 14) & 0x3fff) + 1;
  *alpha = (int)((bits >> 28) & 1);
  return kOk;
}

static int decode(const uint8_t* d, size_t n, Image* img, int* stats) {
  Decoder* dec = new Decoder();
  memset(dec->stats, 0, sizeof(dec->stats));
  int err = read_header(d, n, &img->width, &img->height, &img->alpha);
  if (!err) {
    dec->br.init(d, n);
    dec->br.skip(40);
    int xsize = img->width;
    const int ysize = img->height;
    while (!err && dec->br.read(1)) {
      Transform t;
      t.type = (int)dec->br.read(2);
      t.bits = 0;
      t.xsize = xsize;
      if (dec->seen & (1 << t.type)) {
        err = kMalformed;
        break;
      }
      dec->seen |= 1 << t.type;
      if (t.type == kPredictor || t.type == kCrossColour) {
        t.bits = (int)dec->br.read(3) + 2;
        err = decode_image(dec, subsample(xsize, t.bits),
                           subsample(ysize, t.bits), false, &t.data);
      } else if (t.type == kColourIndexing) {
        const int colours = (int)dec->br.read(8) + 1;
        dec->stats[kStatColours] = colours;
        t.bits = colours > 16 ? 0 : colours > 4 ? 1 : colours > 2 ? 2 : 3;
        std::vector<uint32_t> delta;
        err = decode_image(dec, colours, 1, false, &delta);
        if (!err) {  // ExpandColorMap: delta-decoded per byte, 0-padded
          t.data.assign((size_t)1 << (8 >> t.bits), 0);
          t.data[0] = delta[0];
          for (int i = 1; i < colours; i++) {
            uint32_t v = 0;
            for (int s = 0; s < 32; s += 8)
              v |= (((delta[i] >> s) + (t.data[i - 1] >> s)) & 0xff) << s;
            t.data[i] = v;
          }
        }
        xsize = subsample(xsize, t.bits);
      }
      img->transforms.push_back(t);
    }
    if (!err && dec->br.eos) err = kTruncated;
    if (!err) {
      img->coded_width = xsize;
      err = decode_image(dec, xsize, ysize, true, &img->argb);
    }
  }
  if (stats) memcpy(stats, dec->stats, sizeof(dec->stats));
  delete dec;
  return err;
}

}  // namespace webp_lossless

// Decode a VP8L payload on the host. info (5 + 4 x 4 ints) receives the
// width, height, alpha hint, coded width and number of transforms, then
// per transform (stream order) its type, bits, width and number of data
// words; argb (width x height words, at least) the coded image
// (coded width x height); data the transforms' data, one after another;
// stats (webp_lossless::kStatCount ints, or NULL) what the decode met.
extern "C" int vp8l_host_decode(const unsigned char* vp8l, size_t length,
                                int* info, unsigned int* argb,
                                unsigned int* data, int* stats) {
  webp_lossless::Image* img = new webp_lossless::Image();
  int err = webp_lossless::decode(vp8l, length, img, stats);
  if (!err) {
    info[0] = img->width;
    info[1] = img->height;
    info[2] = img->alpha;
    info[3] = img->coded_width;
    info[4] = (int)img->transforms.size();
    size_t at = 0;
    for (size_t i = 0; i < img->transforms.size(); i++) {
      const webp_lossless::Transform& t = img->transforms[i];
      int* ti = info + 5 + 4 * i;
      ti[0] = t.type;
      ti[1] = t.bits;
      ti[2] = t.xsize;
      ti[3] = (int)t.data.size();
      memcpy(data + at, t.data.data(), t.data.size() * 4);
      at += t.data.size();
    }
    memcpy(argb, img->argb.data(), img->argb.size() * 4);
  }
  delete img;
  return err;
}
