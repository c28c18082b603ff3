"""Hold the card's JPEG encoder to OpenCV without the card.

    python tests/data/jpeg/check_host_encoder.py

Builds the encoder's host sources (``mpmvs_torch/csrc/jpeg_encode.h``, with
the codec's other host headers, which ``io.images.bind_host`` binds) and
the arithmetic of the encoder's kernels (``jpeg_fdct.h``, compiled for the
host) with ``g++`` into a temporary directory, then:

* encodes the fixtures under ``encode/`` and images made from a seed (17x9
  to 2130x3200, qualities 30 to 100) with the kernels' plain versions
  (``io.images.bgr_to_ycc_plain``, ``fdct_islow_plain``) and the host's
  entropy coding, and counts the bytes that differ from ``cv2.imencode``'s;
* runs the kernels' host-compiled arithmetic on the same images and counts
  the plane and coefficient entries that differ from the plain versions.

The PNG and TIFF reads have their own check, ``../tiff/check_host_raster.py``.

It needs g++ and OpenCV. Exit code 0 when nothing differs.
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
#include "jpeg_encode.h"
#include "jpeg_fdct.h"
#include "png_unfilter.h"
#include "tiff_decode.h"
// bgr_to_ycc_kernel's and fdct_islow_quant_kernel's work, thread by thread
extern "C" void ycc_planes(const uint8_t* img, int H, int W, int channels,
                           uint8_t* y, int y_h, int y_w, uint8_t* cb,
                           uint8_t* cr, int g_h, int g_w) {
  for (int i = 0; i < g_h; i++)
    for (int j = 0; j < g_w; j++)
      jpeg_fdct::ycc_group(img, H, W, channels, i, j, y, y_h, y_w, cb, cr,
                           g_w);
}
extern "C" void fdct_plane(const uint8_t* plane, int bw, int bh,
                           const uint16_t* qt, int16_t* coef) {
  jpeg_fdct::Divisor div[64];
  for (int k = 0; k < 64; k++) div[k] = jpeg_fdct::divisor_of(8u * qt[k]);
  for (int b = 0; b < bw * bh; b++)
    jpeg_fdct::fdct_islow_block(plane + (size_t)(8 * (b / bw)) * 8 * bw +
                                    8 * (b % bw), 8 * bw, div, coef + 64 * b);
}
'''


def build(tmp):
    src, lib = os.path.join(tmp, "enc.cpp"), os.path.join(tmp, "enc.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I",
                    os.path.join(REPO, "mpmvs_torch", "csrc"), "-o", lib,
                    src], check=True)
    return images.bind_host(ctypes.CDLL(lib))


def encode_plain(lib, img: np.ndarray, quality: int) -> bytes:
    """The card's encoder with its kernels' plain versions."""
    t = torch.as_tensor(img)
    qt = images.quality_tables(quality, lib)
    y, cb, cr = images.bgr_to_ycc_plain(t)
    coefs = [images.fdct_islow_plain(y, qt[0])]
    if cb is not None:
        coefs += [images.fdct_islow_plain(cb, qt[1]),
                  images.fdct_islow_plain(cr, qt[1])]
    return images.encode_coefficients(coefs, img.shape[1], img.shape[0],
                                      quality, lib)


def kernels_host(lib, img: np.ndarray, quality: int):
    """The kernels' own arithmetic, built for the host: (planes,
    coefficients) as the card would make them."""
    img = np.ascontiguousarray(img)
    H, W = img.shape[:2]
    (yh, yw), (ch, cw) = images._encoder_shapes(H, W)
    y = np.zeros((yh, yw), np.uint8)
    colour = img.ndim == 3
    cb, cr = (np.zeros((ch, cw), np.uint8) for _ in range(2))
    gh, gw = (ch, cw) if colour else (yh // 2, yw // 2)
    lib.ycc_planes(ctypes.c_void_p(img.ctypes.data), H, W, 3 if colour else 1,
                   ctypes.c_void_p(y.ctypes.data), yh, yw,
                   ctypes.c_void_p(cb.ctypes.data if colour else None),
                   ctypes.c_void_p(cr.ctypes.data if colour else None),
                   gh, gw)
    planes = [y, cb, cr] if colour else [y]
    qt = images.quality_tables(quality, lib).numpy().view(np.uint16)
    coefs = []
    for k, p in enumerate(planes):
        c = np.zeros((p.shape[0] // 8, p.shape[1] // 8, 64), np.int16)
        lib.fdct_plane(ctypes.c_void_p(p.ctypes.data), p.shape[1] // 8,
                       p.shape[0] // 8, ctypes.c_void_p(
                           np.ascontiguousarray(qt[min(k, 1)]).ctypes.data),
                       ctypes.c_void_p(c.ctypes.data))
        coefs.append(c)
    return planes, coefs


def kernel_mismatches(lib, img: np.ndarray, quality: int) -> int:
    """Entries of the kernels' host-built planes and coefficients that
    differ from the plain versions'."""
    planes, coefs = kernels_host(lib, img, quality)
    t = torch.as_tensor(img)
    qt = images.quality_tables(quality, lib)
    want = [p for p in images.bgr_to_ycc_plain(t) if p is not None]
    n = sum(int((a != b.numpy()).sum()) for a, b in zip(planes, want))
    for k, (c, p) in enumerate(zip(coefs, want)):
        n += int((c != images.fdct_islow_plain(p, qt[min(k, 1)]).numpy())
                 .sum())
    return n


def encode_cases():
    sources = np.load(os.path.join(HERE, "encode", "sources.npz"))
    for path in sorted(glob.glob(os.path.join(HERE, "encode", "*.jpg"))):
        name = os.path.basename(path)[:-4]
        key, q = name.rsplit("_q", 1)
        with open(path, "rb") as f:
            yield name, sources[key], int(q), f.read()
    rng = np.random.default_rng(1)
    for h, w in ((2130, 3200), (17, 9), (33, 47), (480, 640)):
        small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3))
        img = cv2.resize(small.astype(np.uint8), (w, h),
                         interpolation=cv2.INTER_CUBIC).astype(np.int64)
        img = np.clip(img + rng.integers(-30, 31, img.shape), 0,
                      255).astype(np.uint8)
        for q in (30, 50, 85, 97):
            for kind, a in (("bgr", img), ("gray", img[..., 1].copy())):
                yield (f"{kind} {h}x{w} q{q}", a, q, cv2.imencode(
                    ".jpg", a, [cv2.IMWRITE_JPEG_QUALITY, q])[1].tobytes())


def main() -> int:
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for name, img, q, want in encode_cases():
            got = encode_plain(lib, img, q)
            n = (sum(a != b for a, b in zip(got, want))
                 + abs(len(got) - len(want)))
            k = kernel_mismatches(lib, img, q) if img.size < 10 ** 6 else 0
            total += n + k
            print(f"{name:28s} {len(want):8d} bytes: {n} differ; kernels vs "
                  f"plain: {k} entries differ")
    print(f"in all: {total} mismatches")
    return 0 if total == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
