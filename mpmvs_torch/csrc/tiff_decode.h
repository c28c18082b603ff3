// TIFF reading on the host, for the card's TIFF reads
// (mpmvs_torch/io/images.py: tiff_rows). The samples it leaves are
// converted to BGR and grey on the card by raster_to_bgr_kernel.
//
// What is read is what cv2.imread reads of a TIFF into an 8-bit image
// (OpenCV 5.0 over libtiff 4.7.1):
//   * classic TIFF and BigTIFF, either byte order; the first IFD only (cv2
//     reads the first page);
//   * strips or tiles (edge tiles overhang the image and are cropped),
//     PlanarConfiguration 1 (chunky) or 2 (a plane a sample);
//   * Compression 1 (none), 5 (LZW), 8 and 32946 (Deflate: the chunks are
//     inflated in Python with zlib and handed back here) and 32773
//     (PackBits); FillOrder 2 (bits reversed within each byte);
//   * Predictor 2 (horizontal differencing) on 8- and 16-bit samples, in the
//     file's byte order;
//   * Photometric 0 and 1 (min-is-white, min-is-black) at 1, 8 and 16 bits,
//     2 (RGB) at 8 and 16 bits, 3 (palette) at 1, 4 and 8 bits, 5
//     (separated) with InkSet 1 (CMYK) at 8 bits and four samples, which
//     libtiff's RGBA reader converts for OpenCV; one extra sample (alpha) of
//     grey or RGB is kept for the card to drop or premultiply by;
//   * the Orientation tag, which the card applies after the conversion as
//     cv2 does. libtiff's tile reader mirrors each tile on its own where the
//     orientation flips left-right (2, 3, 6, 7) and OpenCV mirrors no more,
//     so in that case the tiles are laid out here in mirrored order, each
//     tile's columns left as they are, and the card's orientation then
//     mirrors the whole image: cv2's pixels.
// What cv2 reads through other conversions, and what it does not read, is
// refused with a code of its own (tiff_decode::Error).
//
// LZW and PackBits are serial, byte by byte. LZW here is libtiff's: codes
// most significant bit first, 9 to 12 bits wide, one bit wider one code
// before GIF's rule; the pre-1991 bit-reversed form (first byte 0, next bit
// 1) is refused, not misread.
//
// The raster left in `out`: planes (1 for chunky data, one a sample for
// planar) of height rows of ceil(width * samples * bits / 8) bytes, samples
// packed most significant bit first below 8 bits, 16-bit samples in the
// file's byte order.
//
// The C interface needs no CUDA; the tests build this header with g++.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

namespace tiff_decode {

enum Error {
  kOk = 0,
  kTruncated = 4001,   // header, IFD, values or image data past the end
  kMalformed = 4002,   // a required tag missing or a value out of range
  kJpeg = 4003,        // Compression 6 or 7: JPEG in TIFF
  kCompression = 4004, // another compression (CCITT, JPEG 2000, ZSTD, ...)
  kOldLzw = 4005,      // the pre-1991 bit-reversed LZW
  kLzw = 4006,         // LZW data that is corrupt
  kShort = 4007,       // a strip or tile that holds fewer bytes than rows
  kFloat = 4008,       // SampleFormat 2 or 3: signed or float samples
  kPredictor3 = 4009,  // Predictor 3: the floating-point predictor
  kPredictor = 4010,   // Predictor 2 on other than 8- or 16-bit samples
  kInkSet = 4011,      // Photometric 5 of another InkSet than CMYK
  kYcbcr = 4012,       // Photometric 6
  kLab = 4013,         // Photometric 8, 9 or 10 (CIELab, ICCLab, ITULab)
  kPhotometric = 4014, // another photometric (mask, LogL, LogLuv, raw)
  kDeep = 4015,        // more than 16 bits a sample
  kBits = 4016,        // a bit depth OpenCV does not read into 8 bits
  kSampleCount = 4017, // a sample count the photometric does not take
  kChannels = 4018,    // CMYK with an extra sample: five samples a pixel
};

enum Info {
  kWidth, kHeight, kBitsPerSample, kSamples, kPhotometricTag, kPlanar,
  kCompressionTag, kPredictorTag, kOrientation, kTiled, kChunkWidth,
  kChunkHeight, kChunks, kAlpha, kLittle, kColormap, kBigTiff, kFillOrder,
  kInfoLen
};

struct Reader {
  const uint8_t* p;
  size_t n;
  bool little, big_tiff;
  uint64_t u(size_t at, int bytes, bool* ok) const {
    if (at + bytes > n || at + bytes < at) {
      *ok = false;
      return 0;
    }
    uint64_t v = 0;
    for (int i = 0; i < bytes; i++) {
      int k = little ? bytes - 1 - i : i;
      v = (v << 8) | p[at + k];
    }
    return v;
  }
};

struct Entry {
  uint16_t tag = 0, type = 0;
  uint64_t count = 0, at = 0;  // where the values lie
};

static inline int type_size(int type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: case 13: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}

struct Tiff {
  Reader r;
  Entry e[32];
  int n_entries = 0;
  int64_t info[kInfoLen];
  const Entry* find(int tag) const {
    for (int i = 0; i < n_entries; i++)
      if (e[i].tag == tag) return &e[i];
    return nullptr;
  }
  // value i of an entry as an unsigned integer (rationals are not read)
  uint64_t value(const Entry* en, uint64_t i, bool* ok) const {
    int s = type_size(en->type);
    if (s == 0 || i >= en->count) {
      *ok = false;
      return 0;
    }
    if (en->type == 5 || en->type == 10 || en->type == 12) s = 4;
    return r.u(en->at + i * s, s, ok);
  }
  uint64_t scalar(int tag, uint64_t dflt, bool* ok) const {
    const Entry* en = find(tag);
    return en ? value(en, 0, ok) : dflt;
  }
};

// The tags this reader reads; the rest of an IFD (EXIF, XMP, GeoTIFF, ...)
// is passed over unread, as a broken one does not stop libtiff either.
static inline bool wanted(int tag) {
  static const int kTags[] = {256, 257, 258, 259, 262, 266, 273, 274, 277,
                              278, 279, 284, 317, 320, 322, 323, 324, 325,
                              332, 338, 339};
  for (int k : kTags)
    if (k == tag) return true;
  return false;
}

static int parse(const uint8_t* data, size_t len, Tiff* t) {
  Reader& r = t->r;
  r.p = data;
  r.n = len;
  if (len < 8) return kTruncated;
  if (data[0] == 'I' && data[1] == 'I') r.little = true;
  else if (data[0] == 'M' && data[1] == 'M') r.little = false;
  else return kMalformed;
  bool ok = true;
  uint64_t version = r.u(2, 2, &ok), ifd;
  if (version == 42) {
    r.big_tiff = false;
    ifd = r.u(4, 4, &ok);
  } else if (version == 43) {
    r.big_tiff = true;
    if (r.u(4, 2, &ok) != 8 || r.u(6, 2, &ok) != 0) return kMalformed;
    ifd = r.u(8, 8, &ok);
  } else {
    return kMalformed;
  }
  int cnt_bytes = r.big_tiff ? 8 : 2, entry = r.big_tiff ? 20 : 12;
  int inline_bytes = r.big_tiff ? 8 : 4, count_bytes = r.big_tiff ? 8 : 4;
  uint64_t n = r.u(ifd, cnt_bytes, &ok);
  if (!ok) return kTruncated;
  if (n > 4096) return kMalformed;
  for (uint64_t i = 0; i < n; i++) {
    size_t at = ifd + cnt_bytes + i * entry;
    Entry en;
    en.tag = (uint16_t)r.u(at, 2, &ok);
    en.type = (uint16_t)r.u(at + 2, 2, &ok);
    en.count = r.u(at + 4, count_bytes, &ok);
    if (!ok) return kTruncated;
    int s = type_size(en.type);
    if (s == 0 || !wanted(en.tag)) continue;
    if (en.count > len) return kTruncated;
    uint64_t bytes = en.count * s;
    en.at = bytes <= (uint64_t)inline_bytes
                ? at + 4 + count_bytes
                : r.u(at + 4 + count_bytes, inline_bytes, &ok);
    if (!ok || en.at + bytes > len) return kTruncated;
    if (t->n_entries < 32) t->e[t->n_entries++] = en;
  }
  return kOk;
}

// Read the first IFD and check the image is one cv2 reads as this reader
// does; fills t->info.
static int describe(const uint8_t* data, size_t len, Tiff* t) {
  int err = parse(data, len, t);
  if (err) return err;
  bool ok = true;
  int64_t* in = t->info;
  memset(in, 0, sizeof t->info);
  in[kWidth] = (int64_t)t->scalar(256, 0, &ok);
  in[kHeight] = (int64_t)t->scalar(257, 0, &ok);
  in[kSamples] = (int64_t)t->scalar(277, 1, &ok);
  in[kBitsPerSample] = (int64_t)t->scalar(258, 1, &ok);
  in[kCompressionTag] = (int64_t)t->scalar(259, 1, &ok);
  in[kPhotometricTag] =
      (int64_t)t->scalar(262, in[kSamples] >= 3 ? 2 : 1, &ok);
  in[kPlanar] = (int64_t)t->scalar(284, 1, &ok);
  in[kPredictorTag] = (int64_t)t->scalar(317, 1, &ok);
  in[kOrientation] = (int64_t)t->scalar(274, 1, &ok);
  in[kFillOrder] = (int64_t)t->scalar(266, 1, &ok);
  in[kLittle] = t->r.little;
  in[kBigTiff] = t->r.big_tiff;
  uint64_t sample_format = t->scalar(339, 1, &ok);
  if (!ok) return kTruncated;
  int64_t W = in[kWidth], H = in[kHeight], spp = in[kSamples];
  int64_t bits = in[kBitsPerSample], pm = in[kPhotometricTag];
  if (W < 1 || H < 1 || W > (1 << 24) || H > (1 << 24) || spp < 1 ||
      W * H > ((int64_t)1 << 30))
    return kMalformed;
  int64_t comp = in[kCompressionTag];
  if (comp == 6 || comp == 7) return kJpeg;
  if (comp != 1 && comp != 5 && comp != 8 && comp != 32946 && comp != 32773)
    return kCompression;
  if (sample_format == 2 || sample_format == 3) return kFloat;
  if (sample_format != 1 && sample_format != 4) return kMalformed;
  if (in[kPredictorTag] == 3) return kPredictor3;
  if (in[kPredictorTag] != 1 && in[kPredictorTag] != 2) return kMalformed;
  if (pm == 6) return kYcbcr;
  if (pm == 8 || pm == 9 || pm == 10) return kLab;
  if (pm < 0 || (pm > 3 && pm != 5)) return kPhotometric;
  // libtiff's TIFFRGBAImageOK: a separated image of InkSet 1 (CMYK) only
  if (pm == 5 && t->scalar(332, 1, &ok) != 1) return kInkSet;
  if (bits > 16) return kDeep;
  // what OpenCV reads into an 8-bit image: grey at 1, 8, 16 bits, RGB at
  // 8, 16, a palette at 1, 4, 8, CMYK at 8 (libtiff's RGBA reader has no
  // 16-bit CMYK)
  bool bits_ok = pm <= 1 ? (bits == 1 || bits == 8 || bits == 16)
                 : pm == 2 ? (bits == 8 || bits == 16)
                 : pm == 5 ? bits == 8
                           : (bits == 1 || bits == 4 || bits == 8);
  if (!bits_ok) return kBits;
  int colour = pm == 2 ? 3 : pm == 5 ? 4 : 1;
  // OpenCV takes at most four channels (normalizeChannelsNumber)
  if (pm == 5 && spp > 4) return kChannels;
  if (spp < colour || spp > colour + 1 || (pm == 3 && spp != 1))
    return kSampleCount;
  if (in[kPredictorTag] == 2 && bits != 8 && bits != 16) return kPredictor;
  if (in[kPlanar] != 1 && in[kPlanar] != 2) return kMalformed;
  if (spp == 1) in[kPlanar] = 1;  // one plane either way
  // the extra sample: 0 unspecified, 1 associated alpha, 2 unassociated
  const Entry* extra = t->find(338);
  in[kAlpha] = spp > colour && extra ? (int64_t)t->value(extra, 0, &ok) : 0;
  if (in[kOrientation] < 1 || in[kOrientation] > 8) in[kOrientation] = 1;
  const Entry* cmap = t->find(320);
  if (pm == 3) {
    if (!cmap || cmap->count < (uint64_t)(3 << bits)) return kMalformed;
    in[kColormap] = (int64_t)1 << bits;
  }
  bool tiled = t->find(322) != nullptr;
  in[kTiled] = tiled;
  int64_t planes = in[kPlanar] == 2 ? spp : 1, chunks;
  if (tiled) {
    in[kChunkWidth] = (int64_t)t->scalar(322, 0, &ok);
    in[kChunkHeight] = (int64_t)t->scalar(323, 0, &ok);
    if (in[kChunkWidth] < 1 || in[kChunkHeight] < 1 ||
        in[kChunkWidth] > (1 << 24) || in[kChunkHeight] > (1 << 24))
      return kMalformed;
    chunks = ((W + in[kChunkWidth] - 1) / in[kChunkWidth]) *
             ((H + in[kChunkHeight] - 1) / in[kChunkHeight]) * planes;
  } else {
    uint64_t rps = t->scalar(278, 0xFFFFFFFFu, &ok);
    in[kChunkWidth] = W;
    in[kChunkHeight] = rps == 0 || rps > (uint64_t)H ? H : (int64_t)rps;
    chunks = (H + in[kChunkHeight] - 1) / in[kChunkHeight] * planes;
  }
  in[kChunks] = chunks;
  const Entry* offs = t->find(tiled ? 324 : 273);
  const Entry* counts = t->find(tiled ? 325 : 279);
  if (!ok) return kTruncated;
  if (!offs || !counts || offs->count < (uint64_t)chunks ||
      counts->count < (uint64_t)chunks)
    return kMalformed;
  return kOk;
}

// ------------------------------ decompression ------------------------------

// LZW as libtiff decodes it into exactly `want` bytes; kShort if the data
// ends (or an EOI comes) first.
static int lzw(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return kOldLzw;
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  for (int i = 0; i < 256; i++) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  size_t pos = 0, got = 0;
  uint64_t acc = 0;
  int nacc = 0, nbits = 9, free_ent = 258, old = -1;
  while (got < want) {
    while (nacc < nbits && pos < n) {
      acc = (acc << 8) | in[pos++];
      nacc += 8;
    }
    if (nacc < nbits) break;
    int code = (int)((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
    nacc -= nbits;
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      free_ent = 258;
      old = -1;
      continue;
    }
    if (old == -1) {
      if (code > 255) return kLzw;
      out[got++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code > free_ent || free_ent >= 4096) return kLzw;
    prefix[free_ent] = (uint16_t)old;
    first[free_ent] = first[old];
    suffix[free_ent] = code < free_ent ? first[code] : first[old];
    length[free_ent] = (uint16_t)(length[old] + 1);
    free_ent++;
    if (free_ent > (1 << nbits) - 2 && nbits < 12) nbits++;
    int len = length[code];
    size_t end = got + len;
    int c = code;
    // write the string backwards, dropping what lies past `want`
    for (size_t k = end; k > got; k--) {
      if (k - 1 < want) out[k - 1] = suffix[c];
      c = prefix[c];
    }
    got = end < want ? end : want;
    old = code;
  }
  return got < want ? kShort : kOk;
}

// PackBits into exactly `want` bytes (a run past it is cut, as libtiff
// cuts it); kShort if the data ends first.
static int packbits(const uint8_t* in, size_t n, uint8_t* out, size_t want) {
  size_t pos = 0, got = 0;
  while (got < want && pos < n) {
    int c = (int8_t)in[pos++];
    if (c == -128) continue;
    if (c < 0) {
      if (pos >= n) break;
      size_t run = (size_t)(1 - c);
      uint8_t v = in[pos++];
      for (size_t k = 0; k < run && got < want; k++) out[got++] = v;
    } else {
      size_t run = (size_t)c + 1;
      for (size_t k = 0; k < run && got < want && pos < n; k++)
        out[got++] = in[pos++];
    }
  }
  return got < want ? kShort : kOk;
}

static inline uint8_t reverse_bits(uint8_t b) {
  b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

// Predictor 2 undone over rows of `count` samples, `stride` samples a pixel.
static void undo_predictor(uint8_t* buf, int rows, size_t rowbytes,
                           size_t count, int stride, int bits, bool little) {
  for (int r = 0; r < rows; r++) {
    uint8_t* row = buf + (size_t)r * rowbytes;
    if (bits == 8) {
      for (size_t i = stride; i < count; i++)
        row[i] = (uint8_t)(row[i] + row[i - stride]);
      continue;
    }
    int lo = little ? 0 : 1, hi = little ? 1 : 0;
    for (size_t i = stride; i < count; i++) {
      uint8_t* a = row + 2 * i;
      const uint8_t* b = row + 2 * (i - stride);
      unsigned v = ((unsigned)a[hi] << 8 | a[lo]) +
                   ((unsigned)b[hi] << 8 | b[lo]);
      a[hi] = (uint8_t)(v >> 8);
      a[lo] = (uint8_t)v;
    }
  }
}

// n_bits bits of src from bit s0 to dst from bit d0, most significant first.
static void copy_bits(const uint8_t* src, size_t s0, uint8_t* dst, size_t d0,
                      size_t n_bits) {
  if (((s0 | d0 | n_bits) & 7) == 0) {
    memcpy(dst + d0 / 8, src + s0 / 8, n_bits / 8);
    return;
  }
  for (size_t k = 0; k < n_bits; k++) {
    size_t s = s0 + k, d = d0 + k;
    int bit = (src[s >> 3] >> (7 - (s & 7))) & 1;
    uint8_t m = (uint8_t)(0x80 >> (d & 7));
    dst[d >> 3] = (uint8_t)(bit ? dst[d >> 3] | m : dst[d >> 3] & ~m);
  }
}

// Decode every chunk into the raster `out` (see the header comment).
// inflated[i], inflated_len[i]: chunk i inflated (Deflate only, else NULL).
static int decode(const uint8_t* data, size_t len,
                  const uint8_t* const* inflated, const size_t* inflated_len,
                  uint8_t* out) {
  Tiff t;
  int err = describe(data, len, &t);
  if (err) return err;
  const int64_t* in = t.info;
  int64_t W = in[kWidth], H = in[kHeight], bits = in[kBitsPerSample];
  int64_t spp = in[kSamples], cw = in[kChunkWidth], ch = in[kChunkHeight];
  bool planar = in[kPlanar] == 2, tiled = in[kTiled];
  int64_t planes = planar ? spp : 1, per_pixel = planar ? 1 : spp;
  size_t out_row = (size_t)((W * per_pixel * bits + 7) / 8);
  size_t chunk_row = (size_t)((cw * per_pixel * bits + 7) / 8);
  int64_t across = (W + cw - 1) / cw, down = (H + ch - 1) / ch;
  int64_t comp = in[kCompressionTag];
  int o = (int)in[kOrientation];
  bool mirror_tiles = tiled && (o == 2 || o == 3 || o == 6 || o == 7);
  const Entry* offs = t.find(tiled ? 324 : 273);
  const Entry* counts = t.find(tiled ? 325 : 279);
  size_t buf_size = chunk_row * (size_t)ch;
  uint8_t* buf = (uint8_t*)malloc(buf_size ? buf_size : 1);
  uint8_t* raw = nullptr;
  if (!buf) return kMalformed;
  memset(out, 0, out_row * (size_t)H * planes);
  bool ok = true;
  for (int64_t c = 0; c < in[kChunks] && err == kOk; c++) {
    int64_t p = c / (across * down), k = c % (across * down);
    int64_t ty = tiled ? k / across : k, tx = tiled ? k % across : 0;
    int64_t rows = tiled ? ch : (H - ty * ch < ch ? H - ty * ch : ch);
    size_t want = chunk_row * (size_t)rows;
    uint64_t off = t.value(offs, c, &ok), cnt = t.value(counts, c, &ok);
    if (!ok || off > len) {
      err = kTruncated;
      break;
    }
    if (cnt > len - off) cnt = len - off;  // as libtiff: read what is there
    const uint8_t* src = data + off;
    if (in[kFillOrder] == 2 && comp != 8 && comp != 32946) {
      raw = (uint8_t*)realloc(raw, cnt ? cnt : 1);
      for (uint64_t i = 0; i < cnt; i++) raw[i] = reverse_bits(src[i]);
      src = raw;
    }
    if (comp == 5) {
      err = lzw(src, cnt, buf, want);
    } else if (comp == 32773) {
      err = packbits(src, cnt, buf, want);
    } else if (comp == 1) {
      if (cnt < want) err = kShort;
      else memcpy(buf, src, want);
    } else {
      if (!inflated || !inflated[c] || inflated_len[c] < want) err = kShort;
      else memcpy(buf, inflated[c], want);
    }
    if (err) break;
    if (in[kPredictorTag] == 2)
      undo_predictor(buf, (int)rows, chunk_row, (size_t)(cw * per_pixel),
                     (int)per_pixel, (int)bits, in[kLittle]);
    uint8_t* plane = out + (size_t)p * out_row * H;
    int64_t x0 = tx * cw, y0 = ty * ch;
    int64_t n = W - x0 < cw ? W - x0 : cw;
    int64_t dx = mirror_tiles ? W - x0 - n : x0;
    size_t px_bits = (size_t)(per_pixel * bits);
    for (int64_t r = 0; r < rows && y0 + r < H; r++)
      copy_bits(buf + (size_t)r * chunk_row, 0,
                plane + (size_t)(y0 + r) * out_row, (size_t)dx * px_bits,
                (size_t)n * px_bits);
  }
  free(buf);
  free(raw);
  return err;
}

}  // namespace tiff_decode

// The first IFD's fields, tiff_decode::Info order, into info (kInfoLen
// values). Returns 0 or an error of tiff_decode::Error.
extern "C" int tiff_host_info(const unsigned char* data, size_t len,
                              long long* info) {
  tiff_decode::Tiff t;
  int err = tiff_decode::describe(data, len, &t);
  if (err) return err;
  for (int i = 0; i < tiff_decode::kInfoLen; i++) info[i] = t.info[i];
  return 0;
}

// The chunks' offsets and byte counts (info[kChunks] each), and the colour
// map (3 x 2^bits values, red then green then blue) of a palette image.
extern "C" int tiff_host_layout(const unsigned char* data, size_t len,
                                unsigned long long* offsets,
                                unsigned long long* counts,
                                unsigned short* colormap) {
  tiff_decode::Tiff t;
  int err = tiff_decode::describe(data, len, &t);
  if (err) return err;
  bool ok = true, tiled = t.info[tiff_decode::kTiled];
  const tiff_decode::Entry* o = t.find(tiled ? 324 : 273);
  const tiff_decode::Entry* c = t.find(tiled ? 325 : 279);
  for (int64_t i = 0; i < t.info[tiff_decode::kChunks]; i++) {
    offsets[i] = t.value(o, i, &ok);
    counts[i] = t.value(c, i, &ok);
  }
  if (colormap && t.info[tiff_decode::kColormap]) {
    const tiff_decode::Entry* m = t.find(320);
    for (int64_t i = 0; i < 3 * t.info[tiff_decode::kColormap]; i++)
      colormap[i] = (unsigned short)t.value(m, i, &ok);
  }
  return ok ? 0 : tiff_decode::kTruncated;
}

// Decode the image into out (see the header comment for its layout).
extern "C" int tiff_host_decode(const unsigned char* data, size_t len,
                                const unsigned char* const* inflated,
                                const size_t* inflated_len,
                                unsigned char* out) {
  return tiff_decode::decode(data, len, inflated, inflated_len, out);
}
