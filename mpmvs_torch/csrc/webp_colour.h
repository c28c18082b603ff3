// The arithmetic of webp_yuv_to_bgr_kernel (jpeg_codec.cu): cv2.imread's
// BGR and grey pixels of a lossy WebP from its filtered Y, U and V planes
// (4:2:0, rebuilt on the card: vp8_recon.h, vp8_filter.h), one pixel at a
// time. Shared by the kernel and by the host, where the tests build it
// with g++; the plain PyTorch version is
// mpmvs_torch/io/images.py::webp_yuv_to_bgr_plain.
//
// cv2 decodes through libwebp's WebPDecodeBGRInto (or BGRA where the file
// has alpha, then drops it), whose default output is "fancy" upsampled:
//   * libwebp's dsp/upsampling.c UpsampleRgbLinePair: output rows pair
//     around each chroma row; a sample's chroma is the (9, 3, 3, 1) / 16
//     mix of the nearest chroma sample, its horizontal and vertical
//     neighbours and the diagonal one, computed as libwebp does, in two
//     roundings ((avg + 2 (b + c)) >> 3, then (that + a) >> 1, avg the
//     four's sum + 8); the first and (width even) last columns mix only
//     vertically, (3 a + c + 2) >> 2; the first row and (height even) the
//     last take their chroma row as both neighbours (io_dec.c
//     EmitFancyRGB);
//   * libwebp's dsp/yuv.h VP8YUVToR/G/B: 14-bit fixed point, MultHi(v, c)
//     = (v c) >> 8, constants 19077, 26149, 6419, 13320, 33050 and offsets
//     -14234, 8708, -17685, VP8Clip8 of the result >> 6;
//   * the grey image is OpenCV's cvtColor(BGR2GRAY) of that BGR (cv2's
//     IMREAD_GRAYSCALE of a WebP): (r 9798 + g 19235 + b 3735 + 16384)
//     >> 15 in OpenCV 5 (checked on all 2^24 triples), not the 14-bit
//     4899, 9617, 1868 of its image readers' own conversion (a TIFF's).
// All integer: no fast math or contraction applies.

#pragma once

#include "vp8_recon.h"

namespace webp_colour {

VP8_HD int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }

VP8_HD int clip8(int v) {
  return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255;
}

// The fancy upsampler's chroma at column c of a row, from the near chroma
// row n and the far one f (both chroma_w wide), for an image w wide.
VP8_HD int upsample(const uint8_t* n, const uint8_t* f, int c, int w) {
  const int nc = c >> 1;
  if (c == 0 || (c == w - 1 && !(w & 1)))
    return (3 * n[nc] + f[nc] + 2) >> 2;
  const int fc = (c & 1) ? nc + 1 : nc - 1;
  const int avg = n[nc] + n[fc] + f[nc] + f[fc] + 8;
  return (((avg + 2 * (n[fc] + f[nc])) >> 3) + n[nc]) >> 1;
}

// Pixel (r, c) of a w x h image from planes of row strides ys and uvs:
// B, G, R at bgr[0..2] and the grey at *grey.
VP8_HD void pixel(const uint8_t* Y, const uint8_t* U, const uint8_t* V,
                  int ys, int uvs, int w, int h, int r, int c, uint8_t* bgr,
                  uint8_t* grey) {
  const int ch = (h + 1) >> 1;
  const int nr = r >> 1;
  int fr = r == 0 ? 0 : (r & 1) ? (r + 1) >> 1 : (r >> 1) - 1;
  if (fr > ch - 1) fr = ch - 1;
  const int u = upsample(U + (size_t)nr * uvs, U + (size_t)fr * uvs, c, w);
  const int v = upsample(V + (size_t)nr * uvs, V + (size_t)fr * uvs, c, w);
  const int y = Y[(size_t)r * ys + c];
  const int red = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  const int green = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) -
                          mult_hi(v, 13320) + 8708);
  const int blue = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  bgr[0] = (uint8_t)blue;
  bgr[1] = (uint8_t)green;
  bgr[2] = (uint8_t)red;
  *grey = (uint8_t)((red * 9798 + green * 19235 + blue * 3735 + 16384) >> 15);
}

}  // namespace webp_colour
