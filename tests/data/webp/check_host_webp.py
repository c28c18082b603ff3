"""Hold the card's WebP reads to OpenCV without the card.

    python tests/data/webp/check_host_webp.py

Builds the host half (``mpmvs_torch/csrc/webp_decode.h``) and the
arithmetic of the three kernels (``vp8_recon.h``, ``vp8_filter.h``,
``webp_colour.h``, compiled for the host: one lane does a warp's work, the
MBs taken in anti-diagonal order, x + 2 y, as the card's row wavefront
allows) with ``g++`` into a temporary directory, then for every fixture
here:

* reads it through the host build and counts the grey and BGR entries that
  differ from ``cv2.imdecode``'s stored arrays (``cv2_arrays.npz``);
* runs the plain twins (``io.images.vp8_reconstruct_plain``,
  ``vp8_loop_filter_plain``, ``webp_yuv_to_bgr_plain``) on the same frame
  and counts the entries that differ from the host build's, stage by
  stage;
* the same for every lossless and animated fixture (``lossless/``,
  ``make_lossless.py``): the host decode of ``csrc/webp_lossless.h`` and
  the arithmetic of the three lossless kernels (``vp8l_transform.h``:
  ``vp8l_predictor_kernel`` in its order, band by band, step by step, lane
  by lane; ``vp8l_colour_kernel``; ``webp_argb_to_bgr_kernel``), each
  twin (``vp8l_predictor_plain``, ``vp8l_colour_plain``,
  ``webp_argb_to_bgr_plain``) against it launch by launch;
* checks that what stays refused (``refused/``, ``lossless/refused/``)
  raises, naming its cause.

It needs g++ (and for the stored arrays nothing else). Exit code 0 when
nothing differs.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)
from mpmvs_torch.io import images  # noqa: E402

# what the card refuses, under tests/data: the cause its error names
REFUSED = {
    "webp/refused/truncated.webp": "truncated WebP",
    "webp/refused/not_webp.webp": "not a WebP",
    "webp/refused/canvas.webp": "canvas"}
LOSSLESS = os.path.join(HERE, "lossless")
# what cv2 refuses of lossless and animated files (make_lossless.py), under
# tests/data: (the host decoder's code, or None where the container check
# refuses it, before any library load; the cause its error names)
LOSSLESS_REFUSED = {
    "webp/lossless/refused/frame_past_canvas.webp": (None, "past its canvas"),
    "webp/lossless/refused/animated_no_anmf.webp": (None, "no ANMF"),
    "webp/lossless/refused/anmf_before_anim.webp": (None, "before its ANIM"),
    "webp/lossless/refused/bad_signature.webp": (5008, "signature 0x2f"),
    "webp/lossless/refused/bad_version.webp": (5008, "version 0"),
    "webp/lossless/refused/truncated_vp8l.webp": (5009, "truncated lossless"),
    "webp/lossless/refused/oversubscribed.webp": (5010, "prefix code"),
    "webp/lossless/refused/incomplete.webp": (5010, "prefix code"),
    "webp/lossless/refused/repeated_transform.webp": (5011, "repeated"),
    "webp/lossless/refused/cache_bits_12.webp": (5011, "cache bits"),
    "webp/lossless/refused/backref_before_first_pixel.webp": (
        5011, "back-reference outside")}

SHIM = r'''
#include "jpeg_encode.h"
#include "jpeg_entropy.h"
#include "png_unfilter.h"
#include "tiff_decode.h"
#include "vp8_filter.h"
#include "vp8_recon.h"
#include "vp8l_transform.h"
#include "webp_colour.h"
#include "webp_decode.h"
#include "webp_lossless.h"
// vp8_reconstruct_kernel's (filter 0) or vp8_loop_filter_kernel's (filter
// 1) work, MB by MB in anti-diagonal order
extern "C" void vp8_host_planes(const int* records, const short* coefs,
                                const int* params, int mb_w, int mb_h,
                                unsigned char* y, unsigned char* u,
                                unsigned char* v, int filter) {
  vp8::Params prm = vp8::params_of(params);
  vp8::Planes pl = {y, u, v, mb_w, mb_h};
  vp8::MBBuf buf;
  for (int d = 0; d < mb_w + 2 * (mb_h - 1); d++)
    for (int mby = 0; mby < mb_h; mby++) {
      const int mbx = d - 2 * mby;
      if (mbx < 0 || mbx >= mb_w) continue;
      const size_t i = (size_t)mby * mb_w + mbx;
      const vp8::Record& rec = ((const vp8::Record*)records)[i];
      if (filter)
        vp8::filter_mb(rec, prm, pl, mbx, mby, 0, 1);
      else
        vp8::reconstruct_mb(rec, (const int16_t*)coefs + 400 * i, prm, pl,
                            mbx, mby, buf, 0, 1);
    }
}
// webp_yuv_to_bgr_kernel's work, thread by thread
extern "C" void webp_host_colour(const unsigned char* y,
                                 const unsigned char* u,
                                 const unsigned char* v, int mb_w, int w,
                                 int h, unsigned char* bgr,
                                 unsigned char* grey) {
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      const size_t i = (size_t)r * w + c;
      webp_colour::pixel(y, u, v, 16 * mb_w, 8 * mb_w, w, h, r, c,
                         bgr + 3 * i, grey + i);
    }
}
// vp8l_predictor_kernel's work in its order: band by band (32 rows),
// step by step, lane by lane (lane i at column s - 2 i), each pixel's
// neighbours read back from what was rebuilt
extern "C" void vp8l_host_predictor(const unsigned* res,
                                    const unsigned* modes, int bits, int W,
                                    int H, unsigned* out) {
  const int tiles = (W + (1 << bits) - 1) >> bits;
  for (int y0 = 0; y0 < H; y0 += 32) {
    const int rows = H - y0 < 32 ? H - y0 : 32;
    for (int s = 0; s < W + 2 * (rows - 1); s++)
      for (int lane = 0; lane < rows; lane++) {
        const int x = s - 2 * lane, y = y0 + lane;
        if (x < 0 || x >= W) continue;
        const unsigned* up = out + (size_t)(y > 0 ? y - 1 : 0) * W;
        const unsigned* row = out + (size_t)y * W;
        const unsigned l = x ? row[x - 1] : 0, t = up[x];
        const unsigned tl = x ? up[x - 1] : 0;
        const unsigned tr = x == W - 1 ? row[0] : up[x + 1];
        out[(size_t)y * W + x] = vp8l::predictor_pixel(
            res[(size_t)y * W + x], x, y, l, t, tl, tr,
            vp8l::predictor_mode(modes, bits, tiles, x, y));
      }
  }
}
// vp8l_colour_kernel's work (desc and data as vp8l_colour_launch takes
// them), thread by thread
extern "C" void vp8l_host_colour(const unsigned* in, const int* desc,
                                 const unsigned* const* data,
                                 unsigned* out) {
  vp8l::Run run = {};
  run.n = desc[0];
  run.in_w = desc[1];
  run.out_w = desc[2];
  run.h = desc[3];
  for (int j = 0; j < run.n; j++)
    run.t[j] = {desc[4 + 3 * j], desc[5 + 3 * j], desc[6 + 3 * j], data[j]};
  for (int y = 0; y < run.h; y++)
    for (int x = 0; x < run.out_w; x++)
      out[(size_t)y * run.out_w + x] = vp8l::colour_pixel(run, in, x, y);
}
// webp_argb_to_bgr_kernel's work, thread by thread
extern "C" void webp_host_argb(const unsigned* argb, int w, int h, int ox,
                               int oy, int cw, int ch, unsigned char* bgr,
                               unsigned char* grey) {
  for (int i = 0; i < cw * ch; i++)
    vp8l::canvas_pixel(argb, w, h, ox, oy, i % cw, i / cw, bgr + 3 * i,
                       grey + i);
}
'''


def build(tmp):
    src, lib = os.path.join(tmp, "webp.cpp"), os.path.join(tmp, "webp.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I",
                    os.path.join(REPO, "mpmvs_torch", "csrc"), "-o", lib,
                    src], check=True)
    lib = images.bind_host(ctypes.CDLL(lib))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.vp8_host_planes.argtypes = [vp, vp, vp, i, i, vp, vp, vp, i]
    lib.vp8_host_planes.restype = None
    lib.webp_host_colour.argtypes = [vp, vp, vp, i, i, i, vp, vp]
    lib.webp_host_colour.restype = None
    lib.vp8l_host_predictor.argtypes = [vp, vp, i, i, i, vp]
    lib.vp8l_host_colour.argtypes = [vp, vp, vp, vp]
    lib.webp_host_argb.argtypes = [vp, i, i, i, i, i, i, vp, vp]
    for fn in ("vp8l_host_predictor", "vp8l_host_colour", "webp_host_argb"):
        getattr(lib, fn).restype = None
    return lib


def host_stages(lib, frame: images.VP8Frame):
    """The three kernels' arithmetic on the host: the unfiltered planes,
    the filtered planes, and (grey, BGR) before the orientation."""
    mb_h, mb_w = frame.mbs
    H, W = frame.size
    planes = [np.zeros((16 * mb_h, 16 * mb_w), np.uint8)] + [
        np.zeros((8 * mb_h, 8 * mb_w), np.uint8) for _ in range(2)]
    args = [frame.records.ctypes.data, frame.coefs.ctypes.data,
            frame.params.ctypes.data, mb_w, mb_h] + [p.ctypes.data
                                                     for p in planes]
    lib.vp8_host_planes(*args, 0)
    unfiltered = [p.copy() for p in planes]
    lib.vp8_host_planes(*args, 1)
    bgr = np.zeros((H, W, 3), np.uint8)
    g = np.zeros((H, W), np.uint8)
    lib.webp_host_colour(*[p.ctypes.data for p in planes], mb_w, W, H,
                         bgr.ctypes.data, g.ctypes.data)
    return unfiltered, planes, (g, bgr)


def _colour_args(run):
    """vp8l_colour_launch's desc and data pointers for a run (numpy data)."""
    desc = []
    data = (ctypes.c_void_p * 3)()
    for j, t in enumerate(run):
        desc += [t.type, t.bits, t.xsize]
        if t.type != images.VP8L_SUBTRACT_GREEN:
            data[j] = t.data.ctypes.data
    return desc, data


def lossless_stages(lib, img: images.VP8LImage):
    """The lossless kernels' arithmetic on the host: the image after each
    launch of the inverse transforms (images.vp8l_runs' order), uint32."""
    argb, stages = img.argb, []
    for run in images.vp8l_runs(img.transforms):
        H, W = argb.shape
        argb = np.ascontiguousarray(argb)
        out = np.zeros((H, run[-1].xsize), np.uint32)
        if run[0].type == images.VP8L_PREDICTOR:
            lib.vp8l_host_predictor(argb.ctypes.data, run[0].data.ctypes.data,
                                    run[0].bits, W, H, out.ctypes.data)
        else:
            desc, data = _colour_args(run)
            desc = [len(run), W, run[-1].xsize, H] + desc
            lib.vp8l_host_colour(argb.ctypes.data,
                                 (ctypes.c_int * len(desc))(*desc), data,
                                 out.ctypes.data)
        stages.append(out)
        argb = out
    return stages


def host_canvas(lib, argb: np.ndarray, info: images.WebPFile):
    """webp_argb_to_bgr_kernel's arithmetic on the host: (grey, BGR) of
    the ARGB frame on the file's canvas."""
    (cw, ch), (ox, oy) = info.canvas, info.offset
    argb = np.ascontiguousarray(argb)
    bgr = np.zeros((ch, cw, 3), np.uint8)
    g = np.zeros((ch, cw), np.uint8)
    lib.webp_host_argb(argb.ctypes.data, argb.shape[1], argb.shape[0], ox,
                       oy, cw, ch, bgr.ctypes.data, g.ctypes.data)
    return g, bgr


def read(lib, data: bytes):
    """The card's read with the kernels' host-built arithmetic: (grey, BGR)
    numpy arrays of a lossy, lossless or animated file; raises ValueError,
    naming the cause, as the card does."""
    info = images.webp_container(data)
    if info.kind == "lossy":
        frame, orientation = images.webp_frame(data, lib)
        g, bgr = (torch.from_numpy(a) for a in host_stages(lib, frame)[2])
        if info.animated:
            g, bgr = images._on_canvas(g, info), images._on_canvas(bgr, info)
    else:
        img, info, orientation = images.vp8l_frame(data, lib)
        stages = lossless_stages(lib, img)
        g, bgr = (torch.from_numpy(a) for a in host_canvas(
            lib, stages[-1] if stages else img.argb, info))
    return (images.orient(g, orientation).numpy(),
            images.orient(bgr, orientation).numpy())


def lossless_plain_mismatches(lib, data: bytes):
    """Entries of each lossless twin's output that differ from the host
    build's, each on the host build's input of its stage: one count a
    launch of the inverse transforms (images.vp8l_runs' order), then the
    conversion to grey and BGR on the canvas. A lossy animated file's
    frame: plain_mismatches of its VP8 chunk as a still file."""
    info = images.webp_container(data)
    if info.kind == "lossy":
        return plain_mismatches(lib, images._riff([(b"VP8 ", info.frame)]))
    img, info, _ = images.vp8l_frame(data, lib)
    stages = lossless_stages(lib, img)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    out, argb = [], img.argb
    for run, want in zip(images.vp8l_runs(img.transforms), stages):
        run = [r._replace(data=t(r.data)) for r in run]
        if run[0].type == images.VP8L_PREDICTOR:
            got = images.vp8l_predictor_plain(t(argb), run[0].data,
                                              run[0].bits)
        else:
            got = images.vp8l_colour_plain(t(argb), run)
        out.append(int((got.numpy().view(np.uint32) != want).sum()))
        argb = want
    got = images.webp_argb_to_bgr_plain(t(argb), info.canvas, info.offset)
    want = host_canvas(lib, argb, info)
    out.append(sum(int((a.numpy() != b).sum()) for a, b in zip(got, want)))
    return tuple(out)


def plain_mismatches(lib, data: bytes):
    """Entries of each plain twin's output that differ from the host
    build's: (reconstruction, loop filter, colour), each the twin on the
    host build's input of its stage."""
    frame, _ = images.webp_frame(data, lib)
    mb_h, mb_w = frame.mbs
    H, W = frame.size
    unf, filt, out = host_stages(lib, frame)
    rec = torch.from_numpy(frame.records)
    prm = torch.from_numpy(frame.params)
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]
    got = (images.vp8_reconstruct_plain(rec, torch.from_numpy(frame.coefs),
                                        prm, mb_w, mb_h),
           images.vp8_loop_filter_plain(*t(unf), rec, prm, mb_w, mb_h),
           images.webp_yuv_to_bgr_plain(*t(filt), W, H))
    return tuple(sum(int((a.numpy() != b).sum()) for a, b in zip(g, w))
                 for g, w in zip(got, (unf, filt, out)))


def fixtures():
    """(name, bytes, cv2's grey, cv2's BGR) of every lossy fixture."""
    want = np.load(os.path.join(HERE, "cv2_arrays.npz"))
    for name in sorted(os.listdir(HERE)):
        if name.endswith(".webp"):
            with open(os.path.join(HERE, name), "rb") as f:
                data = f.read()
            stem = name[:-5]
            yield stem, data, want[f"gray_{stem}"], want[f"bgr_{stem}"]


def lossless_fixtures():
    """(name, bytes, cv2's grey, cv2's BGR) of every lossless and animated
    fixture (make_lossless.py)."""
    want = np.load(os.path.join(LOSSLESS, "cv2_arrays.npz"))
    for name in sorted(os.listdir(LOSSLESS)):
        if name.endswith(".webp"):
            with open(os.path.join(LOSSLESS, name), "rb") as f:
                data = f.read()
            stem = name[:-5]
            yield stem, data, want[f"gray_{stem}"], want[f"bgr_{stem}"]


def header_fields():
    """fixtures.json: the frame header fields make_fixtures.py read."""
    with open(os.path.join(HERE, "fixtures.json")) as f:
        return json.load(f)


def main() -> int:
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for name, data, want_g, want_bgr in fixtures():
            g, bgr = read(lib, data)
            n_cv2 = (int((g != want_g).sum()) if g.shape == want_g.shape
                     else -1, int((bgr != want_bgr).sum())
                     if bgr.shape == want_bgr.shape else -1)
            n_plain = plain_mismatches(lib, data)
            print(f"{name}: vs cv2 (grey, BGR) {n_cv2}; plain twins vs host "
                  f"(reconstruction, filter, colour) {n_plain}")
            bad += any(n_cv2) + any(n_plain)
        for name, data, want_g, want_bgr in lossless_fixtures():
            g, bgr = read(lib, data)
            n_cv2 = (int((g != want_g).sum()) if g.shape == want_g.shape
                     else -1, int((bgr != want_bgr).sum())
                     if bgr.shape == want_bgr.shape else -1)
            n_plain = lossless_plain_mismatches(lib, data)
            print(f"lossless/{name}: vs cv2 (grey, BGR) {n_cv2}; plain twins "
                  f"vs host (each launch, conversion) {n_plain}")
            bad += any(n_cv2) + any(n_plain)
        data_dir = os.path.dirname(HERE)
        for rel, cause in list(REFUSED.items()) + [
                (r, c) for r, (_, c) in LOSSLESS_REFUSED.items()]:
            with open(os.path.join(data_dir, rel), "rb") as f:
                data = f.read()
            try:
                read(lib, data)
                print(f"{rel}: read, not refused")
                bad += 1
            except ValueError as e:
                ok = cause in str(e)
                print(f"{rel}: refused ({e}){'' if ok else ' WRONG CAUSE'}")
                bad += not ok
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
