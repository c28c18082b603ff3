// JPEG-compressed TIFFs (Compression 7) on the host, for the card's TIFF
// reads (mpmvs_torch/io/images.py: tiff_jpeg_coefficients): every strip or
// tile is a JPEG stream of its own, decoded here to quantized DCT
// coefficients (jpeg_entropy.h), which the card turns into samples with
// idct_islow_kernel and into cv2.imread's BGR and grey with
// ycc_to_bgr_kernel's chunked forms (jpeg_colour.h).
//
// What cv2.imread reads (OpenCV 5.0 over libtiff 4.7.1's JPEG codec and
// RGBA reader), and so what this reads:
//   * each chunk's stream is decoded on its own, with the tables of the
//     JPEGTables tag (347) loaded first where the streams are abbreviated;
//   * its frame must fit the tags as libtiff's JPEGPreDecode checks them:
//     one component for grey, three for RGB and YCbCr; for YCbCr the first
//     component's sampling factors are YCbCrSubSampling (taken from the
//     first stream's frame where the tag is absent: JPEGFixupTags) and the
//     others 1 x 1, for every other photometric all are 1 x 1 ("Improper
//     JPEG sampling factors"); a stream larger than its strip or tile is
//     refused as libtiff refuses it, except a last strip coded at full
//     height, of which libtiff reads the first rows (the card's colour
//     kernel upsamples each chunk over its stream's rows); one of fewer
//     rows libtiff decodes into the zeroed buffer of cv2's read, so the
//     rows past it are black (tiff_jpeg_host_info gives each chunk's
//     rows); one of another width is refused;
//   * a stream cut short, or cut inside a marker segment, is read as
//     libjpeg reads it from libtiff's source, which feeds a fake EOI past
//     the end (jpeg_entropy.h);
//   * the colour space is libtiff's, not libjpeg's guess from the markers:
//     YCbCr is converted by libjpeg, every other photometric's components
//     are taken as they are (JCS_UNKNOWN).
// Not read (kJpegLayout): planar data, other photometrics, extra samples,
// quantization tables that differ from one chunk to another (the card
// runs one IDCT launch a component, with one table), and lossless (SOF3)
// chunks.
//
// The coefficients of every chunk are concatenated, chunk after chunk, in
// one array a component, each chunk's blocks padded to the largest chunk's
// blocks down (the last strip's stream may be shorter or taller), so that
// one IDCT launch a component decodes every chunk at once.
//
// The C interface needs no CUDA; the tests build this header with g++.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "jpeg_entropy.h"
#include "tiff_decode.h"

namespace tiff_jpeg {

// tiff_jpeg_host_info's output, in order
enum Info {
  kChunks, kComponents, kHmax, kVmax,
  kComp0,  // then per component: h, v, blocks across, blocks down
  kInfoLen = kComp0 + 4 * 3
};

struct Stream {
  const uint8_t* p;
  size_t n;
};

// The TIFF's description and each chunk's stream.
struct File {
  tiff_decode::Tiff t;
  std::vector<Stream> chunks;
  jpeg_entropy::Decoder tables;  // the JPEGTables' tables (or none)
};

static int open(const uint8_t* data, size_t len, File* f) {
  int err = tiff_decode::describe(data, len, &f->t);
  if (err) return err;
  const int64_t* in = f->t.info;
  if (in[tiff_decode::kCompressionTag] != 7) return tiff_decode::kMalformed;
  bool tiled = in[tiff_decode::kTiled], ok = true;
  const tiff_decode::Entry* o = f->t.find(tiled ? 324 : 273);
  const tiff_decode::Entry* c = f->t.find(tiled ? 325 : 279);
  f->chunks.resize((size_t)in[tiff_decode::kChunks]);
  for (size_t i = 0; i < f->chunks.size(); i++) {
    uint64_t off = f->t.value(o, i, &ok), cnt = f->t.value(c, i, &ok);
    if (!ok || off > len) return tiff_decode::kTruncated;
    if (cnt > len - off) cnt = len - off;  // as libtiff: read what is there
    f->chunks[i] = {data + off, (size_t)cnt};
  }
  if (in[tiff_decode::kTablesLen] > 0) {
    err = jpeg_entropy::decode(&f->tables, data + in[tiff_decode::kTablesAt],
                               (size_t)in[tiff_decode::kTablesLen], false,
                               true);
    if (err) return err;
  }
  return tiff_decode::kOk;
}

// Decode chunk i's stream (its headers only, or whole) into *d, with the
// JPEGTables' tables, and check its frame against the tags. sub: the
// YCbCr subsampling in force (set from the first frame where the tag is
// absent).
static int chunk(const File& f, size_t i, bool headers_only,
                 jpeg_entropy::Decoder* d, int64_t sub[2]) {
  using namespace tiff_decode;
  const int64_t* in = f.t.info;
  *d = f.tables;
  d->restart_interval = 0;  // libjpeg's get_soi resets it at each stream
  int err = jpeg_entropy::decode(d, f.chunks[i].p, f.chunks[i].n,
                                 headers_only);
  if (err) return err;
  if (d->lossless) return kJpegLayout;  // libtiff reads DCT data only
  int64_t pm = in[kPhotometricTag];
  if (d->ncomp != (pm == 1 ? 1 : 3)) return kJpegTags;
  if (pm == 6 && sub[0] == 0) {  // JPEGFixupTags: the first frame's factors
    sub[0] = d->comp[0].h;
    sub[1] = d->comp[0].v;
  }
  int want_h = pm == 6 ? (int)sub[0] : 1, want_v = pm == 6 ? (int)sub[1] : 1;
  for (int k = 0; k < d->ncomp; k++)
    if (d->comp[k].h != (k ? 1 : want_h) || d->comp[k].v != (k ? 1 : want_v))
      return kJpegTags;
  int64_t W = in[kWidth], H = in[kHeight];
  int64_t cw = in[kChunkWidth], ch = in[kChunkHeight];
  if (in[kTiled]) {
    if (d->width != cw || d->height > ch) return kJpegSize;
  } else {
    int64_t rows = H - (int64_t)i * ch < ch ? H - (int64_t)i * ch : ch;
    bool last = i + 1 == f.chunks.size();
    if (d->width != W || (d->height > rows && !last)) return kJpegSize;
  }
  return kOk;
}

}  // namespace tiff_jpeg

// What the card needs to lay out a JPEG-compressed TIFF's coefficients
// (tiff_jpeg::Info order, kInfoLen values) and each chunk's stream's rows
// (its frame's height; rows holds the TIFF's chunk count, tiff_host_info's
// kChunks): from every chunk's headers.
extern "C" int tiff_jpeg_host_info(const unsigned char* data, size_t len,
                                   long long* info, int* rows) {
  tiff_jpeg::File f;
  int err = tiff_jpeg::open(data, len, &f);
  if (err) return err;
  int64_t sub[2] = {f.t.info[tiff_decode::kSubH],
                    f.t.info[tiff_decode::kSubV]};
  memset(info, 0, sizeof(long long) * tiff_jpeg::kInfoLen);
  info[tiff_jpeg::kChunks] = (long long)f.chunks.size();
  for (size_t i = 0; i < f.chunks.size(); i++) {
    jpeg_entropy::Decoder d;
    err = tiff_jpeg::chunk(f, i, true, &d, sub);
    if (err) return err;
    info[tiff_jpeg::kComponents] = d.ncomp;
    info[tiff_jpeg::kHmax] = d.hmax;
    info[tiff_jpeg::kVmax] = d.vmax;
    rows[i] = d.height;
    for (int k = 0; k < d.ncomp; k++) {
      long long* ci = info + tiff_jpeg::kComp0 + 4 * k;
      ci[0] = d.comp[k].h;
      ci[1] = d.comp[k].v;
      ci[2] = d.comp[k].blocks_w;
      if (d.comp[k].blocks_h > ci[3]) ci[3] = d.comp[k].blocks_h;
    }
  }
  return 0;
}

// Entropy-decode every chunk: coefs[k] receives component k's coefficients
// (chunks x blocks down x blocks across x 64, natural order, the blocks
// that tiff_jpeg_host_info gave in info), qt[64 k ..] its quantization
// table. A component whose chunks carry different tables is refused
// (kJpegLayout).
extern "C" int tiff_jpeg_host_decode(const unsigned char* data, size_t len,
                                     const long long* info,
                                     short* const* coefs,
                                     unsigned short* qt) {
  tiff_jpeg::File f;
  int err = tiff_jpeg::open(data, len, &f);
  if (err) return err;
  int64_t sub[2] = {f.t.info[tiff_decode::kSubH],
                    f.t.info[tiff_decode::kSubV]};
  if (info[tiff_jpeg::kChunks] != (long long)f.chunks.size())
    return tiff_decode::kJpegLayout;
  for (size_t i = 0; i < f.chunks.size(); i++) {
    jpeg_entropy::Decoder d;
    err = tiff_jpeg::chunk(f, i, false, &d, sub);
    if (err) return err;
    for (int k = 0; k < d.ncomp; k++) {
      const jpeg_entropy::Component& c = d.comp[k];
      const long long* ci = info + tiff_jpeg::kComp0 + 4 * k;
      size_t per_chunk = (size_t)ci[2] * ci[3] * 64;
      if (k >= info[tiff_jpeg::kComponents] || c.coef.size() > per_chunk)
        return tiff_decode::kJpegLayout;  // not the info of this file
      short* out = coefs[k] + per_chunk * i;
      memcpy(out, c.coef.data(), c.coef.size() * sizeof(int16_t));
      memset(out + c.coef.size(), 0,
             (per_chunk - c.coef.size()) * sizeof(int16_t));
      const uint16_t* table = c.qt;
      if (i == 0)
        memcpy(qt + 64 * k, table, 64 * sizeof(uint16_t));
      else if (memcmp(qt + 64 * k, table, 64 * sizeof(uint16_t)))
        return tiff_decode::kJpegLayout;
    }
  }
  return 0;
}
