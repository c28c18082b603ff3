// PNG row unfiltering and Adam7 de-interlacing on the host, for the card's
// PNG reads (mpmvs_torch/io/images.py: the chunks are parsed and the image
// data inflated in Python, the rows unfiltered here, the samples converted
// to BGR and grey on the card by raster_to_bgr_kernel).
//
// Each scanline starts with its filter type: None, Sub, Up, Average or
// Paeth (PNG specification, section 9). Sub, Average and Paeth predict a
// byte from the byte bpp to its left (bpp = ceil(bits a pixel / 8), 1 below
// 8 bits), so a row is undone byte after byte: serial work, at a few cycles
// a byte here, where a Python loop over rows would take seconds at
// 3200x2130. Every bit depth (1, 2, 4, 8, 16) is unfiltered the same way,
// bytes being bytes.
//
// An Adam7-interlaced image holds seven passes, each a small image of its
// own with its own filtered rows (a pass with no pixel in a small image has
// no bytes at all, not even filter bytes). Each pass is unfiltered into a
// scratch buffer and its pixels are scattered into the full raster, bit by
// bit below 8 bits a pixel.
//
// The C interface needs no CUDA; the tests build this header with g++.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

namespace png_unfilter {

enum Error {
  kOk = 0,
  kShort = 3001,      // less image data than the header implies
  kBadFilter = 3002,  // a filter type above 4
};

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// in: height scanlines of 1 + rowbytes bytes; out: height x rowbytes.
static int unfilter(const uint8_t* in, size_t in_len, uint8_t* out,
                    int height, size_t rowbytes, int bpp) {
  if (in_len < (size_t)height * (rowbytes + 1)) return kShort;
  for (int r = 0; r < height; r++) {
    const uint8_t* s = in + (size_t)r * (rowbytes + 1);
    int type = s[0];
    s++;
    uint8_t* o = out + (size_t)r * rowbytes;
    const uint8_t* up = r > 0 ? o - rowbytes : nullptr;
    switch (type) {
      case 0:
        for (size_t x = 0; x < rowbytes; x++) o[x] = s[x];
        break;
      case 1:
        for (size_t x = 0; x < rowbytes; x++)
          o[x] = (uint8_t)(s[x] + (x >= (size_t)bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (size_t x = 0; x < rowbytes; x++)
          o[x] = (uint8_t)(s[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (size_t x = 0; x < rowbytes; x++) {
          int a = x >= (size_t)bpp ? o[x - bpp] : 0, b = up ? up[x] : 0;
          o[x] = (uint8_t)(s[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < rowbytes; x++) {
          int a = x >= (size_t)bpp ? o[x - bpp] : 0, b = up ? up[x] : 0;
          int c = up && x >= (size_t)bpp ? up[x - bpp] : 0;
          o[x] = (uint8_t)(s[x] + paeth(a, b, c));
        }
        break;
      default:
        return kBadFilter;
    }
  }
  return kOk;
}

static inline size_t row_bytes(size_t width, int pixel_bits) {
  return (width * (size_t)pixel_bits + 7) / 8;
}

// The seven passes: first row, first column, row step, column step.
static const int kAdam7[7][4] = {{0, 0, 8, 8}, {0, 4, 8, 8}, {4, 0, 8, 4},
                                 {0, 2, 4, 4}, {2, 0, 4, 2}, {0, 1, 2, 2},
                                 {1, 0, 2, 1}};

// Pixel i of a row of pixel_bits-bit pixels (below 8 bits) from src, into
// pixel j of dst.
static inline void copy_sub_byte(const uint8_t* src, size_t i, uint8_t* dst,
                                 size_t j, int pixel_bits) {
  int mask = (1 << pixel_bits) - 1;
  size_t si = i * pixel_bits, di = j * pixel_bits;
  int v = (src[si >> 3] >> (8 - pixel_bits - (int)(si & 7))) & mask;
  int shift = 8 - pixel_bits - (int)(di & 7);
  dst[di >> 3] = (uint8_t)((dst[di >> 3] & ~(mask << shift)) | (v << shift));
}

// out: height x row_bytes(width, pixel_bits), its padding bits zero.
static int adam7(const uint8_t* in, size_t in_len, uint8_t* out, int width,
                 int height, int pixel_bits) {
  size_t out_row = row_bytes(width, pixel_bits);
  memset(out, 0, out_row * (size_t)height);
  int bpp = pixel_bits >= 8 ? pixel_bits / 8 : 1;
  size_t pos = 0;
  uint8_t* pass = (uint8_t*)malloc(out_row * (size_t)((height + 1) / 2) + 1);
  if (!pass) return kShort;
  int err = kOk;
  for (int p = 0; p < 7 && err == kOk; p++) {
    int r0 = kAdam7[p][0], c0 = kAdam7[p][1], dy = kAdam7[p][2],
        dx = kAdam7[p][3];
    int pw = width > c0 ? (width - c0 + dx - 1) / dx : 0;
    int ph = height > r0 ? (height - r0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;
    size_t rb = row_bytes(pw, pixel_bits);
    if (pos > in_len) {
      err = kShort;
      break;
    }
    err = unfilter(in + pos, in_len - pos, pass, ph, rb, bpp);
    pos += (size_t)ph * (rb + 1);
    for (int r = 0; r < ph && err == kOk; r++) {
      const uint8_t* src = pass + (size_t)r * rb;
      uint8_t* dst = out + (size_t)(r0 + r * dy) * out_row;
      if (pixel_bits >= 8) {
        for (int i = 0; i < pw; i++)
          memcpy(dst + (size_t)(c0 + i * dx) * bpp, src + (size_t)i * bpp,
                 bpp);
      } else {
        for (int i = 0; i < pw; i++)
          copy_sub_byte(src, i, dst, c0 + (size_t)i * dx, pixel_bits);
      }
    }
  }
  free(pass);
  return err;
}

}  // namespace png_unfilter

// Unfilter the inflated image data `in` (in_len bytes) of a non-interlaced
// PNG of `height` rows of `rowbytes` bytes, filter distance `bpp` bytes,
// into `out`. Returns 0 or an error of png_unfilter::Error.
extern "C" int png_unfilter_rows(const unsigned char* in, size_t in_len,
                                 unsigned char* out, int height,
                                 size_t rowbytes, int bpp) {
  return png_unfilter::unfilter(in, in_len, out, height, rowbytes, bpp);
}

// De-interlace the inflated image data of an Adam7 PNG of width x height
// pixels of pixel_bits bits into `out` (height rows of
// ceil(width * pixel_bits / 8) bytes). Returns 0 or an error of
// png_unfilter::Error.
extern "C" int png_adam7_rows(const unsigned char* in, size_t in_len,
                              unsigned char* out, int width, int height,
                              int pixel_bits) {
  return png_unfilter::adam7(in, in_len, out, width, height, pixel_bits);
}
