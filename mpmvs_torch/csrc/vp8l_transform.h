// The arithmetic of the card's lossless WebP kernels (jpeg_codec.cu):
// VP8L's inverse transforms (RFC 9649 section 4, as libwebp's
// dsp/lossless.c computes them) and cv2.imread's BGR and grey of the
// result, one pixel at a time. Shared by the kernels and by the host, where
// the tests build it with g++; the plain PyTorch versions are
// mpmvs_torch/io/images.py's vp8l_predictor_plain, vp8l_colour_plain and
// webp_argb_to_bgr_plain.
//
//   * the predictor (vp8l_predictor_kernel): pixel (x, y) is its residual
//     plus, channel by channel mod 256, a prediction from its left (L),
//     top-left (TL), top (T) and top-right (TR) neighbours, already
//     rebuilt: 0xff000000 at (0, 0), L along the top row, T down the left
//     column, elsewhere the mode of its block (the green byte of the
//     sub-image): 0 black, 1 L, 2 T, 3 TR, 4 TL, 5-10 averages, 11 Select,
//     12 ClampAddSubtractFull, 13 ClampAddSubtractHalf; 14 and 15, which no
//     encoder writes, are black (libwebp's padding of its table). The
//     rightmost column's TR is the leftmost pixel of its own row (libwebp
//     reads one past the row above);
//   * cross-colour: red += d(g2r, green), blue += d(g2b, green) + d(r2b,
//     new red), d(t, c) = (int8 t x int8 c) >> 5, each mod 256, the
//     multipliers from the pixel's block;
//   * add green (the inverse of subtract green): green added to red and
//     blue, mod 256;
//   * colour indexing: the green byte of a coded pixel holds 1, 2, 4 or 8
//     indices of 8, 4, 2 or 1 bits (least significant first), each
//     looked up in the palette; an index past the palette gives
//     0x00000000;
//   * to cv2's arrays: ARGB's B, G, R, alpha dropped (not premultiplied),
//     and the grey of that BGR by OpenCV 5's cvtColor (webp_colour.h's
//     15-bit rule), both at an offset on a canvas of zeros (the first frame
//     of an animated file; a still file's canvas is its frame).
// All integer.

#pragma once

#include <stddef.h>
#include <stdint.h>

#include "vp8_recon.h"

namespace vp8l {

enum { kPredictor = 0, kCrossColour = 1, kSubtractGreen = 2,
       kColourIndexing = 3 };

VP8_HD uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

VP8_HD uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

VP8_HD int channel(uint32_t p, int s) { return (int)((p >> s) & 0xff); }

// Per-byte saturating add and subtract and the sum of absolute byte
// differences: the card's SIMD video instructions, the same on the host
// byte by byte.
VP8_HD uint32_t add_sat(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __vaddus4(a, b);
#else
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = channel(a, s) + channel(b, s);
    out |= (uint32_t)(v > 255 ? 255 : v) << s;
  }
  return out;
#endif
}

VP8_HD uint32_t sub_sat(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __vsubus4(a, b);
#else
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = channel(a, s) - channel(b, s);
    out |= (uint32_t)(v < 0 ? 0 : v) << s;
  }
  return out;
#endif
}

VP8_HD int sad(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return (int)__vsadu4(a, b);
#else
  int out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = channel(a, s) - channel(b, s);
    out += v < 0 ? -v : v;
  }
  return out;
#endif
}

// Select: T where sum |L - TL| <= sum |T - TL|, else L.
VP8_HD uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
  return sad(l, tl) - sad(t, tl) <= 0 ? t : l;
}

// Per byte clip(a + b - c): a + (b - c)+ saturated, less (c - b)+.
VP8_HD uint32_t clamp_add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  return sub_sat(add_sat(a, sub_sat(b, c)), sub_sat(c, b));
}

// Per byte clip(a + (a - b) / 2), the division toward zero: a + ((a -
// b)+ >> 1) saturated, less ((b - a)+ >> 1).
VP8_HD uint32_t clamp_add_subtract_half(uint32_t a, uint32_t b) {
  const uint32_t up = (sub_sat(a, b) >> 1) & 0x7f7f7f7fu;
  const uint32_t down = (sub_sat(b, a) >> 1) & 0x7f7f7f7fu;
  return sub_sat(add_sat(a, up), down);
}

// Every mode's prediction is computed and the pixel's picked by a tree of
// selects on the mode's bits, so the lanes of a warp, whose pixels lie in
// blocks of different modes, do not diverge.
VP8_HD uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tl,
                        uint32_t tr) {
  const uint32_t black = 0xff000000u;  // 0, and 14-15
  const uint32_t avg_l_tl = average2(l, tl), avg_t_tr = average2(t, tr);
  const uint32_t avg_l_t = average2(l, t);
  const bool b0 = mode & 1, b1 = mode & 2;
  const uint32_t m0 = b1 ? (b0 ? tr : t) : (b0 ? l : black);
  const uint32_t m4 = b1 ? (b0 ? avg_l_t : avg_l_tl)
                         : (b0 ? average2(average2(l, tr), t) : tl);
  const uint32_t m8 = b1 ? (b0 ? select(t, l, tl)
                               : average2(avg_l_tl, avg_t_tr))
                         : (b0 ? avg_t_tr : average2(tl, t));
  const uint32_t m12 = b1 ? black
                          : (b0 ? clamp_add_subtract_half(avg_l_t, tl)
                                : clamp_add_subtract_full(l, t, tl));
  return (mode & 8) ? ((mode & 4) ? m12 : m8) : ((mode & 4) ? m4 : m0);
}

// Pixel (x, y) of the predictor's output from its residual, its
// neighbours (tr already the row's first pixel at the right edge) and its
// block's mode (the green byte's low 4 bits); the borders by selects.
VP8_HD uint32_t predictor_pixel(uint32_t residual, int x, int y, uint32_t l,
                                uint32_t t, uint32_t tl, uint32_t tr,
                                int mode) {
  uint32_t pred = predict(mode, l, t, tl, tr);
  pred = x == 0 ? t : pred;
  pred = y == 0 ? (x == 0 ? 0xff000000u : l) : pred;
  return add_pixels(residual, pred);
}

// The mode of pixel (x, y) from the sub-image of modes, tiles_per_row
// blocks of 2^bits a row.
VP8_HD int predictor_mode(const uint32_t* modes, int bits, int tiles_per_row,
                          int x, int y) {
  return (int)((modes[(size_t)(y >> bits) * tiles_per_row + (x >> bits)] >>
                8) & 15);
}

// One inverse transform of a run, as the colour kernel takes it: its
// type, bits, output width (xsize) and data (multipliers or palette).
struct Transform {
  int type, bits, xsize;
  const uint32_t* data;
};

// Consecutive element-wise inverse transforms (cross-colour, add green,
// colour indexing), in the order they are applied: in is in_w x h, the
// output out_w x h.
struct Run {
  Transform t[3];
  int n, in_w, out_w, h;
};

VP8_HD int delta(uint32_t t, uint32_t c) {  // ColorTransformDelta
  return ((int)(int8_t)(uint8_t)t * (int)(int8_t)(uint8_t)c) >> 5;
}

// Transform t on pixel p at column x (of its output) of row y.
VP8_HD uint32_t apply(const Transform& t, uint32_t p, int x, int y) {
  if (t.type == kSubtractGreen) {
    const uint32_t g = (p >> 8) & 0xff;
    return (p & 0xff00ff00u) | (((p & 0x00ff00ffu) + ((g << 16) | g)) &
                                0x00ff00ffu);
  }
  if (t.type == kCrossColour) {
    const int tiles = (t.xsize + (1 << t.bits) - 1) >> t.bits;
    const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
    const uint32_t green = (p >> 8) & 0xff;
    const int red = ((int)((p >> 16) & 0xff) + delta(m, green)) & 0xff;
    const int blue = ((int)(p & 0xff) + delta(m >> 8, green) +
                      delta(m >> 16, (uint32_t)red)) & 0xff;
    return (p & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
  }
  // colour indexing: index number (x mod 2^bits) of the packed pixel
  const int bpp = 8 >> t.bits;
  const int sub = x & ((1 << t.bits) - 1);
  const uint32_t index = (((p >> 8) & 0xff) >> (sub * bpp)) & ((1u << bpp) - 1);
  return t.data[index];  // 2^bpp entries, 0 past the palette
}

// Output pixel (x, y) of a run: the coded pixel it comes from, then each
// transform in turn at the column of its own output.
// (Loops of a fixed 3 and unrolled: the run stays in registers.)
VP8_HD uint32_t colour_pixel(const Run& run, const uint32_t* in, int x,
                             int y) {
  int xs[3] = {x, x, x};
  int cx = x;
#pragma unroll
  for (int j = 2; j >= 0; j--)
    if (j < run.n) {
      xs[j] = cx;
      if (run.t[j].type == kColourIndexing) cx >>= run.t[j].bits;
    }
  uint32_t p = in[(size_t)y * run.in_w + cx];
#pragma unroll
  for (int j = 0; j < 3; j++)
    if (j < run.n) p = apply(run.t[j], p, xs[j], y);
  return p;
}

// Canvas pixel (cx, cy) of cv2's BGR and grey: the frame's pixel (w x h
// ARGB at (ox, oy)) or 0 off the frame.
VP8_HD void canvas_pixel(const uint32_t* argb, int w, int h, int ox, int oy,
                         int cx, int cy, uint8_t* bgr, uint8_t* grey) {
  const int x = cx - ox, y = cy - oy;
  uint32_t p = 0;
  if (x >= 0 && x < w && y >= 0 && y < h) p = argb[(size_t)y * w + x];
  const int r = (p >> 16) & 0xff, g = (p >> 8) & 0xff, b = p & 0xff;
  bgr[0] = (uint8_t)b;
  bgr[1] = (uint8_t)g;
  bgr[2] = (uint8_t)r;
  *grey = (uint8_t)((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15);
}

}  // namespace vp8l
