// The arithmetic of vp8_loop_filter_kernel (jpeg_codec.cu): RFC 6386's
// loop filter (sections 9.6 and 15) of a lossy WebP's reconstructed Y, U
// and V planes, in place, one macroblock (MB) at a time, as libwebp
// (dsp/dec.c, dec/frame_dec.c DoFilter) filters them. Shared by the kernel
// and by the host, where the tests build it with g++; the plain PyTorch
// version is mpmvs_torch/io/images.py::vp8_loop_filter_plain.
//
// Per MB, with its segment's limits for its form (vp8_recon.h Params:
// limit 2 level + interior, the interior limit, the high-edge-variance
// threshold; a limit of 0 filters nothing):
//   * the simple filter (type 1) filters luma only: across the MB's left
//     edge (not at the frame's left) with limit + 4, across its inner
//     vertical edges (4, 8, 12) with limit, then its top edge (not at the
//     frame's top) and its inner horizontal edges; an edge sample pair is
//     filtered where 4 |p0 - q0| + |p1 - q1| <= 2 limit + 1, by
//     libwebp's DoFilter2;
//   * the normal filter (type 2), in the same order, luma and chroma
//     (inner edge 4), where also every interior difference is at most the
//     interior limit: on MB edges DoFilter6 (or DoFilter2 where the edge
//     variance is high), on inner edges DoFilter4 (or DoFilter2);
//   * inner edges are filtered only where the record says (sub-block
//     modes, or any coefficients).
// The filter of MB (x, y) reads and writes 3 (normal) samples into MB
// (x - 1, y) and MB (x, y - 1), whose right columns MB (x + 1, y - 1)'s
// left edge rewrites: MBs are filtered in raster order, or in any order
// that keeps those three before (x, y). Within an MB the vertical edges
// (one row at a time) come before the horizontal ones (one column at a
// time), as a function here takes (lane, lanes) to share them. All
// integer: no fast math or contraction applies.

#pragma once

#include "vp8_recon.h"

namespace vp8 {

VP8_HD int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
VP8_HD int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
VP8_HD int iabs(int v) { return v < 0 ? -v : v; }

// libwebp's DoFilter2_C, DoFilter4_C, DoFilter6_C at p (q0), samples
// `step` apart across the edge; v holds p3..q3 as read.
VP8_HD void do_filter2(uint8_t* p, int step, const int* v) {
  const int p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
}

VP8_HD void do_filter4(uint8_t* p, int step, const int* v) {
  const int p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip8(p1 + a3);
  p[-step] = (uint8_t)clip8(p0 + a2);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a3);
}

VP8_HD void do_filter6(uint8_t* p, int step, const int* v) {
  const int p2 = v[1], p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5], q2 = v[6];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip8(p2 + a3);
  p[-2 * step] = (uint8_t)clip8(p1 + a2);
  p[-step] = (uint8_t)clip8(p0 + a1);
  p[0] = (uint8_t)clip8(q0 - a1);
  p[step] = (uint8_t)clip8(q1 - a2);
  p[2 * step] = (uint8_t)clip8(q2 - a3);
}

// One sample line across an edge at p (q0): kind 0 the simple filter, 1 a
// normal MB edge, 2 a normal inner edge, with the edge limit `thresh`
// (limit + 4 on MB edges), the interior limit and the variance threshold.
VP8_HD void filter_line(uint8_t* p, int step, int kind, int thresh,
                        int ithresh, int hev_thresh) {
  int v[8];
  const int lo = kind == 0 ? 2 : 0, hi = kind == 0 ? 6 : 8;
  for (int k = lo; k < hi; k++) v[k] = VP8_LD(p + (k - 4) * step);
  const int p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5];
  if (4 * iabs(p0 - q0) + iabs(p1 - q1) > 2 * thresh + 1) return;
  if (kind == 0) {
    do_filter2(p, step, v);
    return;
  }
  for (int k = 0; k < 3; k++)
    if (iabs(v[k] - v[k + 1]) > ithresh || iabs(v[7 - k] - v[6 - k]) > ithresh)
      return;
  if (iabs(p1 - p0) > hev_thresh || iabs(q1 - q0) > hev_thresh)
    do_filter2(p, step, v);
  else if (kind == 1)
    do_filter6(p, step, v);
  else
    do_filter4(p, step, v);
}

// Filter MB (mbx, mby) in the planes (type 1 or 2; params: its segment's
// and form's limits). The vertical edges of its rows (16 luma, and for the
// normal filter 8 of U and 8 of V), then the horizontal edges of its
// columns, lines shared among the lanes.
VP8_HD void filter_mb(const Record& rec, const Params& prm, const Planes& pl,
                      int mbx, int mby, int lane, int lanes) {
  const int seg = (rec.flags >> kSegmentShift) & 3;
  const int* fl = prm.filter[seg][rec.flags & kI4x4];
  const int limit = fl[0], ilevel = fl[1], hev = fl[2];
  if (prm.filter_type == 0 || limit == 0) return;
  const bool simple = prm.filter_type == 1;
  const bool inner = rec.flags & kInner;
  const int lines = simple ? 16 : 32;
  const int ys = 16 * pl.mb_w, uvs = 8 * pl.mb_w;
  for (int pass = 0; pass < 2; pass++) {  // 0: vertical edges, 1: horizontal
    for (int i = lane; i < lines; i += lanes) {
      const int n = i < 16 ? 16 : 8, j = i < 16 ? i : (i - 16) & 7;
      const int stride = i < 16 ? ys : uvs;
      uint8_t* base = i < 16 ? pl.y + (size_t)16 * mby * ys + 16 * mbx
                             : (i < 24 ? pl.u : pl.v) +
                                   (size_t)8 * mby * uvs + 8 * mbx;
      // along the edge: rows (pass 0) or columns (pass 1); across: step
      uint8_t* line = pass == 0 ? base + (size_t)j * stride : base + j;
      const int step = pass == 0 ? 1 : stride;
      if (pass == 0 ? mbx > 0 : mby > 0)
        filter_line(line, step, simple ? 0 : 1, limit + 4, ilevel, hev);
      if (inner)
        for (int e = 4; e < n; e += 4)
          filter_line(line + e * step, step, simple ? 0 : 2, limit, ilevel,
                      hev);
    }
    VP8_SYNC();
  }
}

}  // namespace vp8
