// Host side of the card's JPEG encoder (mpmvs_torch/csrc/jpeg_codec.cu):
// the quantization tables, the entropy coding and the file's markers, as
// libjpeg-turbo writes them for cv2.imencode(".jpg", img, [quality]).
//
// The card converts BGR to YCbCr and subsamples the chroma 2x2
// (bgr_to_ycc_kernel), then runs the forward DCT and quantization of every
// block (fdct_islow_quant_kernel); the quantized coefficients come here.
// Huffman coding is bit-serial, so it stays on the host, as entropy decoding
// does (jpeg_entropy.h). What OpenCV asks of libjpeg, and so what this writes:
//
//   * jpeg_set_defaults + jpeg_set_quality(quality, force_baseline TRUE):
//     jcparam.c's scaled standard tables, clamped to 1..255; the standard
//     Huffman tables of jstdhuff.c, not optimised; no restart interval;
//   * colour: three components, ids 1, 2, 3, Y sampled 2x2 (4:2:0), Cb and
//     Cr 1x1, tables 0 / 1 / 1, one interleaved scan of MCUs Y0 Y1 Y2 Y3 Cb
//     Cr; grey: one component, id 1, one block an MCU;
//   * markers: SOI, JFIF APP0 (version 1.01, no density units, 1:1), DQT per
//     table, SOF0, DHT per table (DC0, AC0, DC1, AC1), SOS, the scan, EOI.
//
// jccoefct.c fills an MCU that crosses the image's last block column or row
// with dummy blocks: all AC zero and the DC of the block before it in the
// MCU, not the DCT of replicated samples. The card computes only the blocks
// that hold samples (width_in_blocks x height_in_blocks of each component);
// the dummies are made here.
//
// The C interface (extern "C", bound with ctypes by
// mpmvs_torch/io/images.py) needs no CUDA: the tests build this header with
// g++ alone and hold its bytes to OpenCV's.

#pragma once

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <vector>

#include "jpeg_entropy.h"  // kNatural: zig-zag position -> natural index

namespace jpeg_encode {

// jcparam.c: std_luminance_quant_tbl, std_chrominance_quant_tbl (natural
// order)
static const int kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// jstdhuff.c: code counts by length 1..16, then the symbols; [0] DC, [1] AC
// of table 0 (luminance) and table 1 (chrominance)
static const uint8_t kBits[2][2][16] = {
    {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
     {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d}},
    {{0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
     {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}}};
static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline):
// qt[t] in natural order, t = 0 luminance, 1 chrominance.
static void quality_tables(int quality, uint16_t qt[2][64]) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int t = 0; t < 2; t++) {
    for (int i = 0; i < 64; i++) {
      long v = ((long)kStdQuant[t][i] * scale + 50L) / 100L;
      if (v <= 0L) v = 1L;
      if (v > 255L) v = 255L;
      qt[t][i] = (uint16_t)v;
    }
  }
}

// jchuff.c jpeg_make_c_derived_tbl: each symbol's code and its length
struct Code {
  uint16_t code[256];
  uint8_t size[256];
};

static void derive(const uint8_t* bits, const uint8_t* vals, Code* c) {
  uint8_t huffsize[257];
  uint16_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = (uint8_t)l;
  huffsize[p] = 0;
  int last = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = (uint16_t)code++;
    code <<= 1;
    si++;
  }
  memset(c, 0, sizeof(Code));
  for (p = 0; p < last; p++) {
    c->code[vals[p]] = huffcode[p];
    c->size[vals[p]] = huffsize[p];
  }
}

// The entropy-coded segment: bits MSB first, a 0x00 after every 0xFF byte
// (jchuff.c emit_byte), the last byte padded with 1-bits (flush_bits).
struct Writer {
  std::vector<uint8_t>* out;
  uint32_t acc = 0;  // pending bits, right-aligned
  int n = 0;         // how many

  void put(uint32_t bits, int size) {
    acc = (acc << size) | (bits & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      uint8_t b = (uint8_t)(acc >> (n - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      n -= 8;
    }
    acc &= (1u << n) - 1;
  }

  void flush() {
    if (n > 0) put(0x7F, 7 - ((n - 1) % 8));  // fill the byte with 1-bits
  }
};

// jchuff.c encode_one_block: one block in natural order, its DC coded as
// the difference from the component's last
static inline void encode_block(Writer* w, const int16_t* blk, int* last_dc,
                                const Code* dc, const Code* ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  w->put(dc->code[nbits], dc->size[nbits]);
  if (nbits) w->put((uint32_t)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[jpeg_entropy::kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      w->put(ac->code[0xF0], ac->size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    w->put(ac->code[i], ac->size[i]);
    w->put((uint32_t)temp2, nbits);
    r = 0;
  }
  if (r > 0) w->put(ac->code[0], ac->size[0]);
}

static void marker(std::vector<uint8_t>* o, int m, const uint8_t* body,
                   int n) {
  const uint8_t head[4] = {0xFF, (uint8_t)m, (uint8_t)((n + 2) >> 8),
                           (uint8_t)((n + 2) & 0xFF)};
  o->insert(o->end(), head, head + 4);
  o->insert(o->end(), body, body + n);
}

// One component's quantized blocks: bh x bw x 64 int16, natural order,
// the blocks that hold samples (width_in_blocks x height_in_blocks).
struct Plane {
  const int16_t* coef;
  int bw, bh;
};

// A block of the MCU at block (row, col) of the plane, or a dummy beyond it:
// AC zero, DC that of the block before it in the MCU (jccoefct.c).
static inline const int16_t* mcu_block(const Plane& p, int row, int col,
                                       const int16_t* prev, int16_t* dummy) {
  if (row < p.bh && col < p.bw)
    return p.coef + ((size_t)row * p.bw + col) * 64;
  memset(dummy, 0, 64 * sizeof(int16_t));
  dummy[0] = prev[0];
  return dummy;
}

// The whole file. comps 3: planes Y (ceil(H/8) x ceil(W/8) blocks), Cb and
// Cr (ceil(H/16) x ceil(W/16)); comps 1: Y alone.
static void encode(const Plane* planes, int comps, int width, int height,
                   int quality, std::vector<uint8_t>* o) {
  uint16_t qt[2][64];
  quality_tables(quality, qt);
  int ntab = comps == 3 ? 2 : 1;
  o->push_back(0xFF);
  o->push_back(0xD8);
  static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1,
                                   0,   0,   1,   0,   1, 0, 0};
  marker(o, 0xE0, jfif, 14);
  for (int t = 0; t < ntab; t++) {
    uint8_t body[65];
    body[0] = (uint8_t)t;
    for (int k = 0; k < 64; k++)
      body[1 + k] = (uint8_t)qt[t][jpeg_entropy::kNatural[k]];
    marker(o, 0xDB, body, 65);
  }
  uint8_t sof[6 + 9] = {8, (uint8_t)(height >> 8), (uint8_t)height,
                        (uint8_t)(width >> 8), (uint8_t)width,
                        (uint8_t)comps};
  for (int c = 0; c < comps; c++) {
    sof[6 + 3 * c] = (uint8_t)(c + 1);
    sof[7 + 3 * c] = comps == 3 && c == 0 ? 0x22 : 0x11;
    sof[8 + 3 * c] = (uint8_t)(c > 0);
  }
  marker(o, 0xC0, sof, 6 + 3 * comps);
  Code dc[2], ac[2];
  for (int t = 0; t < ntab; t++) {
    for (int k = 0; k < 2; k++) {
      const uint8_t* vals = k ? kAcVals[t] : kDcVals;
      int nv = 0;
      for (int l = 0; l < 16; l++) nv += kBits[t][k][l];
      uint8_t body[17 + 162];
      body[0] = (uint8_t)((k << 4) | t);
      memcpy(body + 1, kBits[t][k], 16);
      memcpy(body + 17, vals, nv);
      marker(o, 0xC4, body, 17 + nv);
      derive(kBits[t][k], vals, k ? &ac[t] : &dc[t]);
    }
  }
  uint8_t sos[1 + 6 + 3];
  sos[0] = (uint8_t)comps;
  for (int c = 0; c < comps; c++) {
    sos[1 + 2 * c] = (uint8_t)(c + 1);
    sos[2 + 2 * c] = c > 0 ? 0x11 : 0x00;
  }
  sos[1 + 2 * comps] = 0;
  sos[2 + 2 * comps] = 63;
  sos[3 + 2 * comps] = 0;
  marker(o, 0xDA, sos, 4 + 2 * comps);

  Writer w;
  w.out = o;
  int last[3] = {0, 0, 0};
  int16_t dummy[4][64];
  if (comps == 1) {  // a non-interleaved scan: the blocks in raster order
    const Plane& y = planes[0];
    for (size_t b = 0; b < (size_t)y.bw * y.bh; b++)
      encode_block(&w, y.coef + 64 * b, &last[0], &dc[0], &ac[0]);
  } else {
    int mcus_x = (width + 15) / 16, mcus_y = (height + 15) / 16;
    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        const int16_t* prev = nullptr;
        for (int i = 0; i < 4; i++) {
          const int16_t* blk = mcu_block(planes[0], 2 * my + i / 2,
                                         2 * mx + i % 2, prev, dummy[i]);
          encode_block(&w, blk, &last[0], &dc[0], &ac[0]);
          prev = blk;
        }
        for (int c = 1; c < 3; c++)
          encode_block(&w, planes[c].coef +
                               ((size_t)my * planes[c].bw + mx) * 64,
                       &last[c], &dc[1], &ac[1]);
      }
    }
  }
  w.flush();
  o->push_back(0xFF);
  o->push_back(0xD9);
}

}  // namespace jpeg_encode

// The quantization tables of `quality` (128 values: luminance, then
// chrominance, natural order), as the encoder writes them.
extern "C" void jpeg_quality_tables(int quality, unsigned short* out) {
  uint16_t qt[2][64];
  jpeg_encode::quality_tables(quality, qt);
  memcpy(out, qt, sizeof(qt));
}

// Encode quantized coefficients (comps 3: y, cb, cr; comps 1: y alone, cb
// and cr NULL) of a width x height image into a file held by *handle until
// jpeg_host_encode_free; *data and *length give its bytes. Returns 0, or
// 2010 for blocks that do not fit the image's size.
extern "C" int jpeg_host_encode(const short* y, int y_bw, int y_bh,
                                const short* cb, const short* cr, int c_bw,
                                int c_bh, int comps, int width, int height,
                                int quality, void** handle,
                                const unsigned char** data, size_t* length) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535 ||
      (comps != 1 && comps != 3) || y_bw != (width + 7) / 8 ||
      y_bh != (height + 7) / 8 ||
      (comps == 3 && (c_bw != (width + 15) / 16 ||
                      c_bh != (height + 15) / 16 || !cb || !cr)))
    return 2010;
  jpeg_encode::Plane planes[3] = {{(const int16_t*)y, y_bw, y_bh},
                                  {(const int16_t*)cb, c_bw, c_bh},
                                  {(const int16_t*)cr, c_bw, c_bh}};
  std::vector<uint8_t>* out = new std::vector<uint8_t>();
  out->reserve(1024 + (size_t)y_bw * y_bh * 64);
  jpeg_encode::encode(planes, comps, width, height, quality, out);
  *handle = out;
  *data = out->data();
  *length = out->size();
  return 0;
}

extern "C" void jpeg_host_encode_free(void* handle) {
  delete (std::vector<uint8_t>*)handle;
}
