"""Hold the card's JPEG 2000 reads to OpenCV without the card.

    python tests/data/jp2/check_host_jp2.py

Builds the host half (``mpmvs_torch/csrc/j2k_decode.h``, ``j2k_t1.h``) and
the arithmetic of the two kernels (``j2k_idwt.h``, ``j2k_colour.h``,
compiled for the host: j2k_idwt_kernel's launches thread by thread, every
row of a level and then every column; j2k_colour_kernel's pixel by pixel),
with the codec's other host headers that ``io.images.bind_host`` binds,
with ``g++`` into a temporary directory, then:

* reads every fixture here through the host build and counts the grey and
  BGR entries that differ from ``cv2.imread``'s stored arrays
  (``cv2_arrays.npz``);
* runs the plain twins (``io.images.j2k_idwt_plain``,
  ``j2k_colour_plain``) on the same words and counts the entries that
  differ from the host build's, launch by launch;
* checks that what stays refused (``refused/``) raises with its code, and
  that the grey of what cv2 reads in grey only is cv2's;
* sweeps ``cuts.json``'s two files over every length short of the whole:
  refused, or cv2's arrays where cv2 reads the cut file;
* reads the three 3200x2130 sources of ``conversion/`` to the sha-256 of
  cv2's arrays in ``conversion/cv2.json``, with the time of the host's
  parse and tier-1.

It needs g++ (and for the stored arrays nothing else). Exit code 0 when
nothing differs.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)
from mpmvs_torch.io import images  # noqa: E402

CSRC = os.path.join(REPO, "mpmvs_torch", "csrc")
REFUSED = os.path.join(HERE, "refused")
CONVERSION = os.path.join(HERE, "conversion")
NAMES = sorted(f for f in os.listdir(HERE) if f.endswith((".jp2", ".j2k")))

SHIM = r'''
#include "j2k_colour.h"
#include "j2k_decode.h"
#include "j2k_idwt.h"
#include "j2k_t1.h"
#include "jpeg_encode.h"
#include "png_unfilter.h"
#include "tiff_decode.h"
// j2k_idwt_kernel's two launches of one level, thread by thread: every row
// of every job (a into b), then every column (b into a)
extern "C" void j2k_host_idwt_level(uint32_t* a, uint32_t* b,
                                    const int* jobs, int njobs, int form) {
  for (int pass = 0; pass < 2; pass++)
    for (int j = 0; j < njobs; j++) {
      const int* J = jobs + 8 * j;
      const long off = J[0], w = J[1];
      const int lines = pass ? J[2] : J[3];
      for (long k = 0; k < lines; k++) {
        if (form == 53) {
          int32_t *A = (int32_t*)a + off, *B = (int32_t*)b + off;
          if (pass == 0)
            j2k_idwt::line53(A + k * w, 1, B + k * w, 1, J[4], J[2], J[6]);
          else
            j2k_idwt::line53(B + k, w, A + k, w, J[5], J[3], J[7]);
        } else {
          float *A = (float*)a + off, *B = (float*)b + off;
          if (pass == 0)
            j2k_idwt::line97(A + k * w, 1, B + k * w, 1, J[4], J[2], J[6]);
          else
            j2k_idwt::line97(B + k, w, A + k, w, J[5], J[3], J[7]);
        }
      }
    }
}
// j2k_colour_kernel's work, pixel by pixel
extern "C" void j2k_host_colour(const uint32_t* coef, const int* tiles,
                                const int* params, uint8_t* bgr,
                                uint8_t* grey) {
  j2k_colour::Params p;
  memcpy(&p, params, sizeof p);
  for (int y = 0; y < p.H; y++)
    for (int x = 0; x < p.W; x++) {
      const size_t i = (size_t)y * p.W + x;
      j2k_colour::pixel(coef, tiles, p, x, y, bgr + 3 * i, grey + i);
    }
}
'''


def build(out_dir: str) -> str:
    """g++ the host halves into ``out_dir``; the library's path."""
    src = os.path.join(out_dir, "j2k_host.cpp")
    with open(src, "w") as f:
        f.write(SHIM)
    lib = os.path.join(out_dir, "libj2k_host.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-I", CSRC, "-o", lib, src],
                   check=True)
    return lib


def load(path: str):
    lib = images.bind_host(ctypes.CDLL(path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.j2k_host_idwt_level.argtypes = [vp, vp, vp, i, i]
    lib.j2k_host_idwt_level.restype = None
    lib.j2k_host_colour.argtypes = [vp, vp, vp, vp, vp]
    lib.j2k_host_colour.restype = None
    return lib


def host_idwt(lib, coef: np.ndarray, lv) -> None:
    """One level's launches of the host build, in place on ``coef``."""
    jobs = np.ascontiguousarray(lv.jobs, np.int32)
    scratch = np.zeros_like(coef)
    lib.j2k_host_idwt_level(coef.ctypes.data, scratch.ctypes.data,
                            jobs.ctypes.data, len(jobs), lv.form)


def host_colour(lib, coef: np.ndarray, col):
    W, H = col.params[:2]
    tiles = np.ascontiguousarray(col.tiles, np.int32)
    params = np.array(col.params, np.int32)
    bgr = np.zeros((H, W, 3), np.uint8)
    grey = np.zeros((H, W), np.uint8)
    lib.j2k_host_colour(coef.ctypes.data, tiles.ctypes.data,
                        params.ctypes.data, bgr.ctypes.data, grey.ctypes.data)
    return grey, bgr


def read(lib, data: bytes, colour: bool = True, twins: bool = False):
    """(grey, BGR) of a file through the host build; with ``twins``, also
    the entries in which each plain twin differs from it, launch by launch
    ({"idwt": [...], "colour": n})."""
    img = images.j2k_host_image(data, lib)
    coef = img.coef.copy()
    diffs = {"idwt": []}
    for lv in images.j2k_schedule(img):
        before = torch.from_numpy(coef.view(np.int32).copy())
        host_idwt(lib, coef, lv)
        if twins:
            got = images.j2k_idwt_plain(before, lv)
            diffs["idwt"].append(int((got.numpy().view(np.uint32) !=
                                      coef).sum()))
    col = images.j2k_colour_form(img, colour)
    grey, bgr = host_colour(lib, coef, col)
    if twins:
        g2, b2 = images.j2k_colour_plain(
            torch.from_numpy(coef.view(np.int32)), col)
        diffs["colour"] = int((g2.numpy() != grey).sum() +
                              (b2.numpy() != bgr).sum())
        return grey, bgr, diffs
    return grey, bgr


def refused_record() -> dict:
    with open(os.path.join(REFUSED, "refused.json")) as f:
        return json.load(f)


def main() -> int:
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = load(build(tmp))
        want = np.load(os.path.join(HERE, "cv2_arrays.npz"))
        for name in NAMES:
            with open(os.path.join(HERE, name), "rb") as f:
                grey, bgr, d = read(lib, f.read(), twins=True)
            n = int((grey != want[f"gray_{name}"]).sum() +
                    (bgr != want[f"bgr_{name}"]).sum())
            if n or any(d["idwt"]) or d["colour"]:
                bad += 1
                print(f"{name}: {n} entries differ from cv2; twins {d}")
        print(f"{len(NAMES)} fixtures read")
        for name, rec in refused_record().items():
            with open(os.path.join(REFUSED, name), "rb") as f:
                data = f.read()
            try:
                read(lib, data)
                bad += 1
                print(f"refused/{name} read")
            except ValueError as e:
                if images._CODE_ERRORS[rec["code"]] not in str(e):
                    bad += 1
                    print(f"refused/{name}: {e}")
        with open(os.path.join(HERE, "cuts.json")) as f:
            cuts = json.load(f)
        arrays = np.load(os.path.join(HERE, "cuts_arrays.npz"))
        for name, rec in cuts.items():
            with open(os.path.join(HERE, name), "rb") as f:
                data = f.read()
            for length in range(rec["length"]):
                try:
                    grey, bgr = read(lib, data[:length])
                except ValueError:
                    if length in rec["cv2_reads"]:
                        bad += 1
                        print(f"{name} cut to {length} refused")
                    continue
                if length not in rec["cv2_reads"] or \
                        (grey != arrays[f"gray_{name}_{length}"]).any() or \
                        (bgr != arrays[f"bgr_{name}_{length}"]).any():
                    bad += 1
                    print(f"{name} cut to {length} is not cv2's read")
            print(f"{name}: {rec['length']} lengths")
        with open(os.path.join(CONVERSION, "cv2.json")) as f:
            conv = json.load(f)
        for key, name in (("lossless", "plane_3200x2130_lossless.jp2"),
                          ("97_rpcl", "plane_3200x2130_97_rpcl.jp2"),
                          ("53_rct", "plane_3200x2130_53_rct.jp2")):
            with open(os.path.join(CONVERSION, name), "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            images.j2k_host_image(data, lib)
            host_s = time.perf_counter() - t0
            grey, bgr = read(lib, data)
            sha = lambda a: hashlib.sha256(a.tobytes()).hexdigest()
            ok = sha(grey) == conv[key]["gray_sha256"] and \
                sha(bgr) == conv[key]["bgr_sha256"]
            bad += not ok
            print(f"{name}: host parse and tier-1 {host_s:.2f} s (this "
                  f"host's CPU, g++ -O2), equal to cv2's hashes: {ok}")
    print("nothing differs" if bad == 0 else f"{bad} cases differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
