"""Hold the card's lossless and arithmetic-coded JPEG reads to OpenCV
without the card.

    python tests/data/jpeg/check_host_lossless.py

Builds the host halves with ``g++`` into a temporary directory: the
decoder (``mpmvs_torch/csrc/jpeg_entropy.h`` with ``jpeg_arith.h`` and
``jpeg_lossless.h``) and the lossless kernels' arithmetic
(``jpeg_lossless_pred.h``) run as the kernels run it: the scan form's two
passes (a row's prefix sums, then each band's lanes walking its columns or
diagonals) and the wavefront form band by band, step by step, lane by lane,
the lanes' neighbours handed on as the warp's shuffles and the band
above's tagged edge words hand them on. It reads every fixture under
``lossless/`` and ``arith/`` (the arithmetic ones through
``check_host_decoder.py``'s IDCT build) with the plain twins
(``io.images.ljpeg_undiff_plain``, ``colour_plain``) and prints, per file
and in all, the entries that differ from ``cv2_arrays.npz`` beside them
(each mode cv2 reads), the modes the port refuses against those cv2
refuses, the files under ``lossless/refused/`` and the refused arithmetic
and hierarchical files with their codes, and the two forms' host-built
arithmetic against the twin on random differences at every predictor, with
restarts. It needs g++ and numpy (OpenCV only for ``--cv2``, which checks
the stored arrays against cv2 itself).
"""

import ctypes
import glob
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

SHIM = r'''
#include <vector>
#include "jpeg_entropy.h"
#include "jpeg_lossless_pred.h"
using namespace jpeg_entropy;
extern "C" int jpeg_host_decode(const uint8_t* data, size_t len, void** out,
                                int* info) {
  Decoder* d = new Decoder();
  int err = decode(d, data, len, false);
  if (err) { delete d; return err; }
  host_info(d, info);
  *out = d;
  return 0;
}
extern "C" int jpeg_host_lossless(void* img, int comp, int16_t* diff,
                                  uint8_t* first) {
  return lossless_planes((Decoder*)img, comp, diff, first);
}
extern "C" void jpeg_host_free(void* img) { delete (Decoder*)img; }
// ljpeg_scan_kernel as it runs: pass A's prefix sums of the rows the
// predictor needs (the warp's scan: sums mod 2^16), then pass B's lanes of
// each band (its first row to the next first row), each walking its column
// or diagonal.
extern "C" void scan_host(int p, const int16_t* d, const uint8_t* first,
                          int w, int h, int pt, int init, uint8_t* out) {
  std::vector<uint16_t> r((size_t)w * h);
  ljpeg::Plane q = {d, r.data(), out, first, w, h, pt, init};
  for (int row = 0; row < h; row++) {
    if (!ljpeg::scan_row_needed(p, q, row)) continue;
    uint32_t acc = 0;
    for (int c = 0; c < w; c++) {
      acc += (uint16_t)d[(size_t)row * w + c];
      r[(size_t)row * w + c] = (uint16_t)acc;
    }
  }
  for (int r0 = 0; r0 < h;) {
    int r1 = r0 + 1;
    while (r1 < h && !first[r1]) r1++;
    int lanes = p == 3 ? w + (r1 - r0) - 1 : w;
    for (int lane = 0; lane < lanes; lane++)
      ljpeg::scan_walk(p, q, r0, r1, p == 3 ? lane - (r1 - r0 - 1) : lane);
    r0 = r1;
  }
}
// ljpeg_wavefront_kernel as it runs: bands of 32 rows in ticket order, 32
// steps at a time, lane i at column 32 c + j - i; Rb from lane i - 1's last
// sample (the shuffle) or, for lane 0, the band above's edge words, which
// must carry that band's tag (the kernel polls until they do).
extern "C" int wave_host(int p, const int16_t* d, const uint8_t* first,
                         int w, int h, int pt, int init, uint8_t* out) {
  std::vector<int> edge_v(w, 0), edge_tag(w, 0);
  for (int band = 0; 32 * band < h; band++) {
    const int y0 = 32 * band, rows = h - y0 < 32 ? h - y0 : 32;
    const bool need_above = band > 0 && !first[y0];
    int h1[32] = {0}, rb_prev[32] = {0};
    for (int c = 0, steps = w + rows - 1; 32 * c < steps; c++) {
      int above[32];
      for (int lane = 0; lane < 32; lane++) {
        const int col = 32 * c + lane;
        above[lane] = 0;
        if (need_above && col < w) {
          if (edge_tag[col] != band) return 1;  // the kernel would wait
          above[lane] = edge_v[col];
        }
      }
      for (int j = 0; j < 32; j++) {
        int up[32];
        for (int lane = 0; lane < 32; lane++)
          up[lane] = h1[lane ? lane - 1 : 0];
        for (int lane = 0; lane < 32; lane++) {
          const int x = 32 * c + j - lane, y = y0 + lane;
          const int ym = y < h ? y : h - 1;
          const int diff = lane < rows && x >= 0 && x < w
                               ? d[(size_t)y * w + x] : 0;
          const int v = ljpeg::wave_step(p, diff, x, first[ym] != 0, init,
                                         lane ? up[lane] : above[j],
                                         &h1[lane], &rb_prev[lane]);
          if (lane < rows && x >= 0 && x < w) {
            out[(size_t)y * w + x] = ljpeg::narrow(v, pt);
            if (lane == rows - 1) {
              edge_v[x] = v;
              edge_tag[x] = band + 1;
            }
          }
        }
      }
    }
  }
  return 0;
}
'''


def build(tmp):
    src, lib = os.path.join(tmp, "lossless.cpp"), os.path.join(
        tmp, "lossless.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I",
                    os.path.join(REPO, "mpmvs_torch", "csrc"), "-o", lib,
                    src], check=True)
    lib = ctypes.CDLL(lib)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.jpeg_host_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.POINTER(vp), vp]
    lib.jpeg_host_lossless.argtypes = [vp, i, vp, vp]
    lib.jpeg_host_free.argtypes = [vp]
    lib.jpeg_host_free.restype = None
    for fn in ("scan_host", "wave_host"):
        getattr(lib, fn).argtypes = [i, vp, vp, i, i, i, i, vp]
    lib.scan_host.restype = None
    return lib


def host_decode(lib, data: bytes):
    """The host decoder's (code, handle, info) of a JPEG; the handle, where
    the code is 0, is for :func:`images.lossless_image` to free."""
    handle = ctypes.c_void_p()
    info = (ctypes.c_int * images.JPEG_INFO_LEN)()
    code = lib.jpeg_host_decode(data, len(data), ctypes.byref(handle), info)
    return code, handle, info


def status(lib, data: bytes) -> int:
    """The host decoder's code for a JPEG: 0, or the error it refuses it
    with (``io.images._CODE_ERRORS``)."""
    code, handle, _ = host_decode(lib, data)
    if code == 0:
        lib.jpeg_host_free(handle)
    return code


def lossless(lib, data: bytes) -> images.LosslessImage:
    """A lossless JPEG's :class:`images.LosslessImage` from the host build;
    ValueError naming the cause where the decoder refuses it."""
    code, handle, info = host_decode(lib, data)
    images._check(code, "JPEG decode")
    if not info[images.INFO_LOSSLESS]:
        lib.jpeg_host_free(handle)
        raise ValueError("not a lossless JPEG")
    return images.lossless_image(handle, info, lib)


def planes(img: images.LosslessImage):
    """The component planes of a lossless image through the plain twin."""
    return [images.ljpeg_undiff_plain(
        torch.from_numpy(d), torch.from_numpy(f), p, img.precision, pt)
        for d, f, p, pt in zip(img.diffs, img.firsts, img.predictors,
                               img.pts)]


def read(lib, data: bytes, grey: bool = True):
    """(grey, BGR) numpy arrays of a lossless JPEG as the card's read makes
    them (host decode, the plain twins of the lossless and colour kernels,
    the orientation); ``grey`` False for the colour-only read
    (``decode_colour``), whose grey is None. Raises as the card raises
    where cv2 refuses a mode the read takes."""
    img = lossless(lib, data)
    images.lossless_check_modes(len(img.diffs), grey)
    g, bgr = images.colour_plain(planes(img), img.factors, img.size,
                                 img.space, fancy=False)
    o = img.orientation
    return (images.orient(g, o).numpy() if grey else None,
            images.orient(bgr, o).numpy())


def grey_plane(lib, data: bytes) -> np.ndarray:
    """A one-component lossless JPEG's grey (cv2's IMREAD_GRAYSCALE: the
    plane itself, oriented) through the host decode and the plain twin:
    the read cv2 makes of it that no entry of the card's takes."""
    img = lossless(lib, data)
    assert len(img.diffs) == 1
    return images.orient(planes(img)[0], img.orientation).numpy()


def form_host(lib, diff: np.ndarray, first: np.ndarray, predictor: int,
              precision: int, pt: int) -> np.ndarray:
    """The samples a form's host-built arithmetic makes (the scan form for
    predictors 1-4, the wavefront for 5-7)."""
    h, w = diff.shape
    diff = np.ascontiguousarray(diff, np.int16)
    first = np.ascontiguousarray(first, np.uint8)
    out = np.zeros((h, w), np.uint8)
    args = (predictor, diff.ctypes.data, first.ctypes.data, w, h, pt,
            1 << (precision - pt - 1), out.ctypes.data)
    if predictor <= 4:
        lib.scan_host(*args)
    else:
        assert lib.wave_host(*args) == 0, "a band's edge was not ready"
    return out


def random_case(rng, h: int, w: int, restarts: int = 0):
    """Random int16 differences of every magnitude and first-row marks:
    row 0, and each row with probability 1 / restarts."""
    diff = rng.integers(-32768, 32768, (h, w)).astype(np.int16)
    small = rng.integers(-40, 41, (h, w)).astype(np.int16)
    diff = np.where(rng.random((h, w)) < 0.7, small, diff)
    first = np.zeros(h, np.uint8)
    first[0] = 1
    if restarts:
        first[rng.random(h) < 1 / restarts] = 1
    return diff, first


def form_mismatches(lib, diff, first, predictor, precision=8, pt=0) -> int:
    """Samples where a form's host-built arithmetic differs from
    ``images.ljpeg_undiff_plain``."""
    want = images.ljpeg_undiff_plain(torch.from_numpy(diff),
                                     torch.from_numpy(first), predictor,
                                     precision, pt).numpy()
    got = form_host(lib, diff, first, predictor, precision, pt)
    return int((got != want).sum())


def arrays(folder: str) -> dict:
    return dict(np.load(os.path.join(HERE, folder, "cv2_arrays.npz")))


def main() -> int:
    sys.path.insert(0, HERE)
    import check_host_decoder as chd

    total, bad_refusals = 0, []
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        dlib = chd.build(tmp)
        want = arrays("lossless")
        for path in sorted(glob.glob(os.path.join(HERE, "lossless",
                                                  "*.jpg"))):
            name = os.path.basename(path)[:-4]
            with open(path, "rb") as f:
                data = f.read()
            n = 0
            if f"gray_{name}" in want and f"bgr_{name}" in want:
                g, c = read(lib, data)
                n = int((g != want[f"gray_{name}"]).sum()
                        + (c != want[f"bgr_{name}"]).sum())
            elif f"bgr_{name}" in want:
                _, c = read(lib, data, grey=False)
                n = int((c != want[f"bgr_{name}"]).sum())
            else:
                n = int((grey_plane(lib, data) != want[f"gray_{name}"]).sum())
            total += n
            print(f"lossless/{name:28s} {n} entries differ")
        for path in sorted(glob.glob(os.path.join(HERE, "lossless", "refused",
                                                  "*.jpg"))
                           + [os.path.join(HERE, "refused", f)
                              for f in ("lossless.jpg",
                                        "arithmetic_lossless.jpg",
                                        "hierarchical.jpg")]):
            with open(path, "rb") as f:
                code = status(lib, f.read())
            print(f"{os.path.relpath(path, HERE):36s} code {code}")
            if code == 0:
                bad_refusals.append(path)
        want = arrays("arith")
        for path in sorted(glob.glob(os.path.join(HERE, "arith", "*.jpg"))):
            name = os.path.basename(path)[:-4]
            with open(path, "rb") as f:
                g, c = chd.decode(dlib, f.read())
            n = int((g != want[f"gray_{name}"]).sum()
                    + (c != want[f"bgr_{name}"]).sum())
            total += n
            print(f"arith/{name:31s} {n} entries differ")
        rng = np.random.default_rng(0)
        forms = 0
        for p in range(1, 8):
            for h, w, restarts in ((1, 1, 0), (33, 70, 0), (70, 33, 5),
                                   (65, 97, 1), (100, 40, 17)):
                diff, first = random_case(rng, h, w, restarts)
                forms += form_mismatches(lib, diff, first, p)
        total += forms
        print(f"the forms' host-built arithmetic vs the twin: {forms} "
              f"samples differ")
    print(f"in all: {total} entries differ, {len(bad_refusals)} files "
          f"that must be refused were read")
    return 0 if total == 0 and not bad_refusals else 1


if __name__ == "__main__":
    sys.exit(main())
