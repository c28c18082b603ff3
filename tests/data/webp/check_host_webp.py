"""Hold the card's lossy WebP reads to OpenCV without the card.

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
* checks that what stays refused (``refused/``) raises, naming its cause.

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
    "webp/refused/lossless.webp": "lossless WebP",
    "webp/refused/animated.webp": "animated WebP",
    "webp/refused/truncated.webp": "truncated WebP",
    "webp/refused/not_webp.webp": "not a WebP",
    "webp/refused/canvas.webp": "canvas",
    "png/refused/image.webp": "lossless WebP"}

SHIM = r'''
#include "jpeg_encode.h"
#include "jpeg_entropy.h"
#include "png_unfilter.h"
#include "tiff_decode.h"
#include "vp8_filter.h"
#include "vp8_recon.h"
#include "webp_colour.h"
#include "webp_decode.h"
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


def read(lib, data: bytes):
    """The card's read with the kernels' host-built arithmetic: (grey, BGR)
    numpy arrays; raises ValueError, naming the cause, as the card does."""
    frame, orientation = images.webp_frame(data, lib)
    g, bgr = host_stages(lib, frame)[2]
    return (images.orient(torch.from_numpy(g), orientation).numpy(),
            images.orient(torch.from_numpy(bgr), orientation).numpy())


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
        data_dir = os.path.dirname(HERE)
        for rel, cause in REFUSED.items():
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
