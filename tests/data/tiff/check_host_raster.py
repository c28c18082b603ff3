"""Hold the card's PNG and TIFF reads to OpenCV without the card.

    python tests/data/tiff/check_host_raster.py

Builds the reads' host sources (``mpmvs_torch/csrc/png_unfilter.h``,
``tiff_decode.h``) and the arithmetic of ``raster_to_bgr_kernel``
(``raster_bgr.h``, compiled for the host) with ``g++`` into a temporary
directory, then:

* reads the PNGs under ``../png`` and the TIFFs here through
  ``io.images.png_rows`` / ``tiff_rows`` and ``raster_to_bgr_plain`` and
  counts the grey and BGR entries that differ from ``cv2.imread``'s stored
  arrays (``cv2_arrays.npz`` beside each);
* runs the kernel's host-compiled arithmetic on the same samples and
  counts the entries that differ from the plain version;
* checks that what stays refused raises, naming its cause;
* holds the grey of every 8-bit RGB triple (one 4096x4096 image, made
  here) to cv2's, as a PNG without and with a gAMA chunk and as a TIFF,
  and of every 16-bit value in each channel of a PNG with a gAMA chunk.

It needs g++ and OpenCV. Exit code 0 when nothing differs.
"""

import ctypes
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
PNG_DIR = os.path.join(os.path.dirname(HERE), "png")
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
from mpmvs_torch.io import images  # noqa: E402
from tiff_file import tiff_bytes  # noqa: E402

# what the card refuses, under tests/data: the cause its error names
REFUSED = {
    "png/refused/image.bmp": "BMP", "png/refused/image.webp": "WebP",
    "tiff/refused/jpeg.tif": "JPEG-compressed",
    "tiff/refused/float.tif": "float", "tiff/refused/int32.tif": "signed or float",
    "tiff/refused/signed16.tif": "signed",
    "tiff/refused/predictor3.tif": "floating-point predictor",
    "tiff/refused/ycbcr.tif": "YCbCr",
    "tiff/refused/lab.tif": "CIELab",
    "tiff/refused/old_lzw.tif": "old-style LZW",
    "tiff/refused/grey2.tif": "bit depth", "tiff/refused/grey4.tif":
        "bit depth", "tiff/refused/grey12.tif": "bit depth",
    "tiff/refused/palette16.tif": "bit depth",
    "tiff/refused/rgb1.tif": "bit depth",
    "tiff/refused/cmyk16.tif": "bit depth",
    "tiff/refused/inkset2.tif": "InkSet",
    "tiff/refused/cmyk_alpha.tif": "five channels",
    "tiff/refused/cmyk3.tif": "sample count"}

SHIM = r'''
#include "jpeg_encode.h"
#include "jpeg_entropy.h"
#include "png_unfilter.h"
#include "raster_bgr.h"
#include "tiff_decode.h"
// raster_to_bgr_kernel's work, thread by thread
extern "C" void raster_pixels(const uint8_t* raster, const int* ints,
                              const long long* sizes, const uint8_t* tables,
                              uint8_t* bgr, uint8_t* grey) {
  raster_bgr::Form f = raster_bgr::form_of(ints, sizes);
  for (int y = 0; y < f.height; y++)
    for (int x = 0; x < f.width; x++) {
      size_t i = (size_t)y * f.width + x;
      raster_bgr::pixel(raster, f, tables, y, x, bgr + 3 * i, grey + i);
    }
}
'''


def build(tmp):
    src, lib = os.path.join(tmp, "raster.cpp"), os.path.join(tmp,
                                                             "raster.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I",
                    os.path.join(REPO, "mpmvs_torch", "csrc"), "-o", lib,
                    src], check=True)
    lib = images.bind_host(ctypes.CDLL(lib))
    lib.raster_pixels.restype = None
    return lib


def read(lib, data: bytes):
    """The card's read with its kernel's plain version: (grey, BGR) numpy
    arrays; raises ValueError, naming the cause, as the card does."""
    r = images.raster_rows(data, lib)
    g, bgr = images.raster_to_bgr_plain(torch.from_numpy(r.samples), r.form,
                                        torch.from_numpy(r.tables))
    return (images.orient(g, r.orientation).numpy(),
            images.orient(bgr, r.orientation).numpy())


def kernel_host(lib, r: images.Raster):
    """raster_to_bgr_kernel's arithmetic on the host: (grey, BGR) before
    the orientation."""
    f = r.form
    bgr = np.zeros((f.height, f.width, 3), np.uint8)
    g = np.zeros((f.height, f.width), np.uint8)
    ints = (ctypes.c_int * 11)(*f[:11])
    sizes = (ctypes.c_longlong * 2)(f.rowbytes, f.plane_bytes)
    samples = np.ascontiguousarray(r.samples)
    lib.raster_pixels(ctypes.c_void_p(samples.ctypes.data), ints, sizes,
                      ctypes.c_void_p(r.tables.ctypes.data),
                      ctypes.c_void_p(bgr.ctypes.data),
                      ctypes.c_void_p(g.ctypes.data))
    return g, bgr


def kernel_mismatches(lib, data: bytes) -> int:
    """Entries of the kernel's host-built grey and BGR that differ from the
    plain version's."""
    r = images.raster_rows(data, lib)
    want = images.raster_to_bgr_plain(torch.from_numpy(r.samples), r.form,
                                      torch.from_numpy(r.tables))
    return sum(int((a != b.numpy()).sum())
               for a, b in zip(kernel_host(lib, r), want))


def fixtures():
    """(label, bytes, cv2's grey, cv2's BGR) of every PNG and TIFF fixture
    the card reads."""
    for folder, ext in ((PNG_DIR, ".png"), (HERE, ".tif")):
        want = np.load(os.path.join(folder, "cv2_arrays.npz"))
        for name in sorted(os.listdir(folder)):
            if not name.endswith(ext):
                continue
            stem = name[:-4]
            with open(os.path.join(folder, name), "rb") as f:
                data = f.read()
            yield (f"{os.path.basename(folder)}/{name}", data,
                   want[f"gray_{stem}"], want[f"bgr_{stem}"])


def every_triple():
    """(4096, 4096, 3) uint8 RGB holding each 8-bit triple once."""
    i = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(i >> 16) & 255, (i >> 8) & 255, i & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)


def png_of(rgb: np.ndarray, extra: bytes = b"") -> bytes:
    """An 8- or 16-bit RGB PNG (filter 0 rows) with ``extra`` chunks before
    the image data."""
    h, w = rgb.shape[:2]
    depth = 8 * rgb.itemsize
    rows = rgb.astype(">u2").view(np.uint8) if depth == 16 else rgb
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)],
                         1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0,
                                         0))
            + extra + chunk(b"IDAT", zlib.compress(raw, 1))
            + chunk(b"IEND", b""))


def gama_chunk(gamma: int) -> bytes:
    body = struct.pack(">I", gamma)
    return (struct.pack(">I", 4) + b"gAMA" + body
            + struct.pack(">I", zlib.crc32(b"gAMA" + body)))


def every16() -> np.ndarray:
    """(512, 256, 3) uint16 RGB: every 16-bit value in each channel, in
    three orders, then 256 rows of random triples."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    rng = np.random.default_rng(16)
    return np.concatenate([np.stack([v, v[::-1, ::-1], v.T], -1),
                           rng.integers(0, 65536, (256, 256, 3)).astype(
                               np.uint16)])


def dense_cases():
    """(label, file bytes) of the 2^24-triple images and of the 16-bit
    colour PNG whose grey goes through libpng's 16-bit gamma tables."""
    rgb = every_triple()
    yield "png rgb8", png_of(rgb)
    yield "png rgb8 gAMA 45455", png_of(rgb, gama_chunk(45455))
    yield "tiff rgb8", tiff_bytes(rgb, compression=8, rows_per_strip=256)
    yield "png rgb16 gAMA 45455", png_of(every16(), gama_chunk(45455))
    yield "png rgb16 gAMA 200000", png_of(every16(), gama_chunk(200000))


def dense_mismatches(lib, data: bytes, rows=slice(None)):
    """Grey entries of the kernel's host-built arithmetic, and of the plain
    version on ``rows``, that differ from cv2.imread's."""
    import cv2

    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    r = images.raster_rows(data, lib)
    g, _ = kernel_host(lib, r)
    f = r.form
    n_rows = len(range(f.height)[rows])
    sub = r.samples.reshape(-1, f.height, f.rowbytes)[:, rows]
    form = f._replace(height=n_rows, plane_bytes=f.rowbytes * n_rows)
    plain, _ = images.raster_to_bgr_plain(
        torch.from_numpy(np.ascontiguousarray(sub)), form,
        torch.from_numpy(r.tables))
    return int((g != want).sum()), int((plain.numpy() != want[rows]).sum())


def main() -> int:
    import cv2

    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for label, data, g, bgr in fixtures():
            try:
                got_g, got_bgr = read(lib, data)
            except ValueError as e:
                total += 1
                print(f"{label}: raised {e}")
                continue
            n = sum(int((a != b).sum()) if a.shape == b.shape else b.size
                    for a, b in ((got_bgr, bgr), (got_g, g)))
            k = kernel_mismatches(lib, data)
            total += n + k
            print(f"{label:44s} {bgr.shape}: {n} entries differ from cv2; "
                  f"kernel vs plain {k}")
        for path, cause in REFUSED.items():
            with open(os.path.join(os.path.dirname(HERE), path), "rb") as f:
                data = f.read()
            try:
                read(lib, data)
            except ValueError as e:
                ok = cause in str(e)
                total += not ok
                print(f"{path}: raises ({e}){'' if ok else ' NOT ' + cause}")
            else:
                total += 1
                print(f"{path} was read")
        for label, data in dense_cases():
            k, p = dense_mismatches(lib, data, slice(None, None, 8))
            total += k + p
            print(f"{label}: grey entries differing from cv2: kernel "
                  f"arithmetic {k}, plain (every 8th row) {p}")
    print(f"in all: {total} mismatches")
    return 0 if total == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
