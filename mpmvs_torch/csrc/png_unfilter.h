// PNG row unfiltering on the host, for the card's PNG reads
// (mpmvs_torch/io/images.py: the chunks are parsed and the image data
// inflated in Python, the rows unfiltered here, the samples converted to
// BGR on the card).
//
// Each scanline starts with its filter type: None, Sub, Up, Average or
// Paeth (PNG specification, section 9). Sub, Average and Paeth predict a
// byte from the byte bpp to its left, so a row is undone byte after byte:
// serial work, at a few cycles a byte here, where a Python loop over rows
// would take seconds at 3200x2130.
//
// The C interface needs no CUDA; the tests build this header with g++.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

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

}  // namespace png_unfilter

// Unfilter the inflated image data `in` (in_len bytes) of a non-interlaced
// PNG of `height` rows of `rowbytes` bytes, `bpp` bytes a pixel, into `out`.
// Returns 0 or an error of png_unfilter::Error.
extern "C" int png_unfilter_rows(const unsigned char* in, size_t in_len,
                                 unsigned char* out, int height,
                                 size_t rowbytes, int bpp) {
  return png_unfilter::unfilter(in, in_len, out, height, rowbytes, bpp);
}
