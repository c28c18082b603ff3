"""Hold the card's JPEG decoder to OpenCV without the card.

    python tests/data/jpeg/check_host_decoder.py

Builds the decoder's host sources (``mpmvs_torch/csrc/jpeg_entropy.h`` and
``jpeg_idct.h``, the IDCT the card's kernel runs) with ``g++`` into a
temporary directory, decodes the fixtures beside this file and JPEGs that
OpenCV encodes from a seed (4:2:0, 4:2:2, 4:4:0, progressive, restart
intervals, optimised Huffman tables, grey, 17x9 to 3200x2130) and the
files under ``layouts/`` (EXIF orientations 2..8, RGB components),
upsamples and converts them with the colour kernel's plain versions
(``io.images.ycc_to_bgr_plain``, ``rgb_to_bgr_plain``), applies the EXIF
orientation (``io.images.orient``), and prints, per file and in all, the
entries that differ from ``cv2.imread``'s grey and BGR arrays. A JPEG under
``refused/`` with arrays in ``cv2_arrays.npz`` must decode to them; the
others must be refused (a non-zero code, printed). It needs g++ and OpenCV.
"""

import ctypes
import glob
import os
import subprocess
import sys
import tempfile

import cv2
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)
from mpmvs_torch.io import images  # noqa: E402

SHIM = r'''
#include "jpeg_entropy.h"
#include "jpeg_idct.h"
using namespace jpeg_entropy;
extern "C" int planes(const uint8_t* data, size_t len, int* info,
                      uint8_t** out) {
  Decoder* d = new Decoder();
  int err = decode(d, data, len, false);
  if (err) { delete d; return err; }
  info[0] = d->ncomp;
  info[7] = d->orientation;
  info[8] = d->rgb;
  for (int i = 0; i < d->ncomp; i++) {
    Component& c = d->comp[i];
    int pw = (d->width * c.h + d->hmax - 1) / d->hmax;
    int ph = (d->height * c.v + d->vmax - 1) / d->vmax;
    info[1 + 2 * i] = ph;
    info[2 + 2 * i] = pw;
    if (!out[i]) continue;
    for (int by = 0; by < c.height_in_blocks; by++)
      for (int bx = 0; bx < c.width_in_blocks; bx++) {
        int rows = ph - 8 * by, cols = pw - 8 * bx;
        jpeg_idct::idct_islow_block(
            &c.coef[((size_t)by * c.blocks_w + bx) * 64], d->qt[c.tq],
            out[i] + (size_t)8 * by * pw + 8 * bx, pw, rows < 8 ? rows : 8,
            cols < 8 ? cols : 8);
      }
  }
  delete d;
  return 0;
}
'''


def build(tmp):
    src, lib = os.path.join(tmp, "shim.cpp"), os.path.join(tmp, "shim.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I",
                    os.path.join(REPO, "mpmvs_torch", "csrc"), "-o", lib,
                    src], check=True)
    return ctypes.CDLL(lib)


def status(lib, data) -> int:
    """The host decoder's code for a JPEG: 0, or the error it refuses it
    with (``io.images._DECODE_ERRORS``)."""
    info = (ctypes.c_int * 9)()
    return lib.planes(data, len(data), info, (ctypes.c_void_p * 3)())


def decode(lib, data):
    """(grey, BGR) numpy arrays of a JPEG: the host decoder, the colour
    kernel's plain versions and the EXIF orientation."""
    info = (ctypes.c_int * 9)()
    none = (ctypes.c_void_p * 3)()
    assert lib.planes(data, len(data), info, none) == 0
    n = info[0]
    out = [np.zeros((info[1 + 2 * i], info[2 + 2 * i]), np.uint8)
           for i in range(n)]
    ptrs = (ctypes.c_void_p * 3)(*[p.ctypes.data for p in out])
    assert lib.planes(data, len(data), info, ptrs) == 0
    y = torch.as_tensor(out[0])
    if n == 1:
        gray, bgr = y, images.ycc_to_bgr_plain(y)
    else:
        cb, cr = torch.as_tensor(out[1]), torch.as_tensor(out[2])
        hs = 1 if cb.shape[1] == y.shape[1] else 2
        vs = 1 if cb.shape[0] == y.shape[0] else 2
        if info[8]:
            gray, bgr = images.rgb_to_bgr_plain(y, cb, cr, hs, vs)
        else:
            gray, bgr = y, images.ycc_to_bgr_plain(y, cb, cr, hs, vs)
    return (images.orient(gray, info[7]).numpy(),
            images.orient(bgr, info[7]).numpy())


def cases():
    for path in sorted(glob.glob(os.path.join(HERE, "*.jpg"))
                       + glob.glob(os.path.join(HERE, "layouts", "*.jpg"))):
        with open(path, "rb") as f:
            yield os.path.relpath(path, HERE), f.read()
    rng = np.random.default_rng(0)
    Q, S = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    settings = {"q95": [Q, 95],
                "q75 progressive": [Q, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                "q90 restart 3": [Q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
                "q100 4:2:2": [Q, 100, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
                "q60 4:4:0": [Q, 60, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
                "q85 optimised": [Q, 85, cv2.IMWRITE_JPEG_OPTIMIZE, 1]}
    for h, w in ((2130, 3200), (101, 203), (17, 9), (480, 640)):
        small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3))
        img = cv2.resize(small.astype(np.uint8), (w, h),
                         interpolation=cv2.INTER_CUBIC).astype(np.int64)
        img = np.clip(img + rng.integers(-30, 31, img.shape), 0,
                      255).astype(np.uint8)
        for name, flags in settings.items():
            yield f"{h}x{w} {name}", cv2.imencode(".jpg", img, flags)[1]
        yield f"{h}x{w} grey progressive", cv2.imencode(
            ".jpg", img[..., 1], [Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]


def main() -> int:
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for name, data in cases():
            data = bytes(data)
            buf = np.frombuffer(data, np.uint8)
            grey, bgr = decode(lib, data)
            n = (int((grey != cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)).sum())
                 + int((bgr != cv2.imdecode(buf, cv2.IMREAD_COLOR)).sum()))
            total += n
            print(f"{name:28s} {grey.shape}: {n} entries differ")
        accepted = []
        want = np.load(os.path.join(HERE, "cv2_arrays.npz"))
        for path in sorted(glob.glob(os.path.join(HERE, "refused", "*.jpg"))):
            name = f"refused/{os.path.basename(path)[:-4]}"
            with open(path, "rb") as f:
                data = f.read()
            if f"bgr_{name}" in want:
                grey, bgr = decode(lib, data)
                n = (int((grey != want[f"gray_{name}"]).sum())
                     + int((bgr != want[f"bgr_{name}"]).sum()))
                total += n
                print(f"{name:28s} {grey.shape}: {n} entries differ")
                continue
            code = status(lib, data)
            print(f"{name:28s} code {code}")
            if code == 0:
                accepted.append(path)
    print(f"in all: {total} entries differ, {len(accepted)} files that "
          f"must be refused were decoded")
    return 0 if total == 0 and not accepted else 1


if __name__ == "__main__":
    sys.exit(main())
