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
  and of every 16-bit value in each channel of a PNG with a gAMA chunk,
  and the grey and BGR of every (Y, Cb, Cr) triple as a YCbCr TIFF, of
  every 8-bit (L*, a*, b*) triple as a CIELab TIFF and of 2^20 seeded
  16-bit ones;
* reads the BMPs under ``../bmp`` and PNMs under ``../pnm`` as the PNGs
  and TIFFs, and the JPEG-compressed TIFFs through the host JPEG decode
  (``tiff_jpeg.h``), the IDCT's and the chunked colour form's plain
  versions, holding the chunked form's host-built arithmetic to its
  twin.

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

# what the card refuses, under tests/data: the cause its error names. The
# BMP, the JPEG-compressed and YCbCr TIFFs (Pillow's) and the signed 16-bit
# TIFF once here now read (../bmp/image.bmp, pil_jpeg.tif, pil_ycbcr.tif,
# signed16_*.tif); a GIF, an old-style JPEG TIFF and what libtiff refuses
# of the new layouts stand here
REFUSED = {
    "png/refused/image.gif": "GIF",
    # cv2's lossless WebP, once png/refused/image.webp, now reads
    # (webp/lossless/imencode_45x37.webp); a WebP cv2 refuses stands here
    "webp/lossless/refused/frame_past_canvas.webp": "WebP",
    "tiff/refused/old_jpeg.tif": "old-style JPEG",
    "tiff/refused/float.tif": "float", "tiff/refused/int32.tif": "signed or float",
    "tiff/refused/predictor3.tif": "floating-point predictor",
    # Pillow's CIELab and the old-style LZW file once here read now
    # (pil_lab.tif, old_lzw.tif); what stays refused of them stands here
    "tiff/refused/icclab.tif": "ICCLab",
    "tiff/refused/old_lzw_corrupt.tif": "old-style LZW",
    "tiff/refused/itulab.tif": "ITULab",
    "tiff/refused/lab_planar2.tif": "CIELab TIFF of planar",
    "tiff/refused/lab_alpha.tif": "CIELab TIFF of other than three",
    "tiff/refused/lab_l_only.tif": "CIELab TIFF of other than three",
    "tiff/refused/lab4.tif": "CIELab TIFF of other than 8 or 16",
    "tiff/refused/short_none.tif": "uncompressed data",
    "tiff/refused/short_none_tile3.tif": "uncompressed data",
    "tiff/refused/short_none_strip2_count0.tif": "uncompressed data",
    "tiff/refused/short_none_strip3_past_end.tif": "uncompressed data",
    "tiff/refused/jpeg_short_whole_strip1_cut_in_dht.tif": "no scan",
    "tiff/refused/short_none_rows7_estimate_past_end.tif":
        "uncompressed data",
    "tiff/refused/grey2.tif": "bit depth", "tiff/refused/grey4.tif":
        "bit depth", "tiff/refused/grey12.tif": "bit depth",
    "tiff/refused/palette16.tif": "bit depth",
    "tiff/refused/rgb1.tif": "bit depth",
    "tiff/refused/cmyk16.tif": "bit depth",
    "tiff/refused/inkset2.tif": "InkSet",
    "tiff/refused/cmyk_alpha.tif": "five channels",
    "tiff/refused/cmyk3.tif": "sample count",
    "tiff/refused/jpeg_rgb420.tif": "sampling factors",
    "tiff/refused/jpeg_strip_taller.tif": "larger than its strip",
    "tiff/refused/jpeg12.tif": "12-bit",
    "tiff/refused/ycbcr24.tif": "YCbCr samples of a layout",
    "tiff/refused/ycbcr22_planar2.tif": "YCbCr samples of a layout",
    "tiff/refused/ycbcr11_alpha.tif": "YCbCr samples of a layout",
    "tiff/refused/ycbcr22_tiles_orient2.tif": "mirrors them"}

SHIM = r'''
#include "jpeg_colour.h"
#include "jpeg_encode.h"
#include "jpeg_entropy.h"
#include "png_unfilter.h"
#include "raster_bgr.h"
#include "tiff_decode.h"
#include "tiff_jpeg.h"
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
// ycc_to_bgr_kernel's chunked work, thread by thread: n planes, n x 6
// ints (jpeg_colour::Plane), form (YccForm bits), chunks (7 ints), rows
// (each chunk's stream's rows)
extern "C" void chunk_pixels(const uint8_t* const* ptrs, const int* geo,
                             int n, int form, const int* chunks,
                             const int* rows, int H, int W, uint8_t* bgr,
                             uint8_t* grey) {
  jpeg_colour::Planes pl = {};
  for (int i = 0; i < n; i++) {
    const int* g = geo + 6 * i;
    pl.c[i] = {ptrs[i], g[0], g[1], g[2], g[3], g[4], g[5]};
  }
  jpeg_colour::Chunks ck = {chunks[0], chunks[1], chunks[2], chunks[3],
                            chunks[4], chunks[5], chunks[6], rows};
  for (int r = 0; r < H; r++)
    for (int col = 0; col < W; col++) {
      size_t i = (size_t)r * W + col;
      jpeg_colour::ycc_pixel(pl, n, form, jpeg_colour::spot(ck, r, col),
                             bgr + 3 * i, grey + i);
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
    lib.chunk_pixels.restype = None
    return lib


def tiff_jpeg_planes(lib, data: bytes):
    """A JPEG-compressed TIFF's host decode and its planes from the IDCT's
    plain version (the card's layout: every chunk's samples in one plane a
    component): (TiffJpeg, planes)."""
    tj = images.tiff_jpeg_coefficients(data, lib)
    return tj, [images.idct_islow_plain(
        torch.from_numpy(c), torch.from_numpy(q.view(np.int16)),
        8 * c.shape[0], 8 * c.shape[1]) for c, q in zip(tj.coefs, tj.qt)]


def read(lib, data: bytes):
    """The card's read with its kernels' plain versions: (grey, BGR) numpy
    arrays; raises ValueError, naming the cause, as the card does."""
    if images.image_format(data) == "TIFF" and \
            images.tiff_compression(data, lib) == 7:
        tj, planes = tiff_jpeg_planes(lib, data)
        g, bgr = images.colour_plain(planes, tj.factors, tj.size, tj.space,
                                     tj.chunks)
        return (images.orient(g, tj.orientation).numpy(),
                images.orient(bgr, tj.orientation).numpy())
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
    ints = images.form_ints(f)
    sizes = (ctypes.c_longlong * 2)(f.rowbytes, f.plane_bytes)
    samples = np.ascontiguousarray(r.samples)
    lib.raster_pixels(ctypes.c_void_p(samples.ctypes.data), ints, sizes,
                      ctypes.c_void_p(r.tables.ctypes.data),
                      ctypes.c_void_p(bgr.ctypes.data),
                      ctypes.c_void_p(g.ctypes.data))
    return g, bgr


def chunk_kernel_host(lib, tj, planes):
    """ycc_to_bgr_kernel's chunked arithmetic on the host: (grey, BGR)
    before the orientation."""
    H, W = tj.size
    ints = images.plane_ints(planes, tj.factors, images._chunk_planes(
        planes, tj.factors, tj.size, tj.chunks))
    planes = [np.ascontiguousarray(p.numpy()) for p in planes]
    ptrs = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes])
    form = (images.FORM_RGB if tj.space == images.SPACE_RGB and
            len(planes) == 3 else 0) | images.FORM_OPENCV_GREY
    bgr = np.zeros((H, W, 3), np.uint8)
    g = np.zeros((H, W), np.uint8)
    rows = (ctypes.c_int * len(tj.chunks.rows))(*tj.chunks.rows)
    lib.chunk_pixels(ptrs, ints, len(planes), form,
                     (ctypes.c_int * 7)(*tj.chunks[:7]), rows, H, W,
                     ctypes.c_void_p(bgr.ctypes.data),
                     ctypes.c_void_p(g.ctypes.data))
    return g, bgr


def kernel_mismatches(lib, data: bytes) -> int:
    """Entries of the kernel's host-built grey and BGR that differ from the
    plain version's (the raster kernel's, or for a JPEG-compressed TIFF the
    colour kernel's chunked form)."""
    if images.image_format(data) == "TIFF" and \
            images.tiff_compression(data, lib) == 7:
        tj, planes = tiff_jpeg_planes(lib, data)
        want = images.colour_plain(planes, tj.factors, tj.size, tj.space,
                                   tj.chunks)
        return sum(int((a != b.numpy()).sum())
                   for a, b in zip(chunk_kernel_host(lib, tj, planes), want))
    r = images.raster_rows(data, lib)
    want = images.raster_to_bgr_plain(torch.from_numpy(r.samples), r.form,
                                      torch.from_numpy(r.tables))
    return sum(int((a != b.numpy()).sum())
               for a, b in zip(kernel_host(lib, r), want))


def fixtures():
    """(label, bytes, cv2's grey, cv2's BGR) of every PNG, TIFF, BMP and
    PNM fixture the card reads."""
    data_dir = os.path.dirname(HERE)
    for folder, ext in ((PNG_DIR, (".png",)), (HERE, (".tif",)),
                        (os.path.join(data_dir, "bmp"), (".bmp",)),
                        (os.path.join(data_dir, "pnm"),
                         (".pbm", ".pgm", ".ppm"))):
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


def every_triple_cielab() -> bytes:
    """A 4096x4096 8-bit CIELab TIFF holding every (L*, a*, b*) triple
    once."""
    return tiff_bytes(every_triple(), photometric=8, compression=8,
                      rows_per_strip=256)


def cielab16_sample(seed: int = 0) -> bytes:
    """A 1024x1024 16-bit CIELab TIFF of seeded random (L*, a*, b*)
    samples, the rows spanning L* from 0 to 65535."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 65536, (1024, 1024, 3)).astype(np.uint16)
    lab[..., 0] = np.linspace(0, 65535, 1024).astype(np.uint16)[:, None]
    return tiff_bytes(lab, photometric=8, compression=8, rows_per_strip=64)


def every_triple_ycbcr() -> bytes:
    """A 4096x4096 YCbCr TIFF at subsampling (1, 1) holding every 8-bit
    (Y, Cb, Cr) triple once."""
    return tiff_bytes(every_triple(), photometric=6, compression=8,
                      rows_per_strip=256, extra_tags={530: (3, [1, 1])})


def dense_mismatches(lib, data: bytes, rows=slice(None), colour=False):
    """Grey entries (and with ``colour`` BGR entries) of the kernel's
    host-built arithmetic, and of the plain version on ``rows``, that
    differ from cv2.imread's."""
    import cv2

    buf = np.frombuffer(data, np.uint8)
    want = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    want_bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR) if colour else None
    r = images.raster_rows(data, lib)
    g, bgr = kernel_host(lib, r)
    f = r.form
    n_rows = len(range(f.height)[rows])
    sub = r.samples.reshape(-1, f.height, f.rowbytes)[:, rows]
    form = f._replace(height=n_rows, plane_bytes=f.rowbytes * n_rows)
    if f.kind == images.RASTER_YCBCR and f.sub_h * f.sub_v > 1:
        raise ValueError("rows of subsampled data units are not pixel rows")
    plain, plain_bgr = images.raster_to_bgr_plain(
        torch.from_numpy(np.ascontiguousarray(sub)), form,
        torch.from_numpy(r.tables))
    k = int((g != want).sum())
    p = int((plain.numpy() != want[rows]).sum())
    if colour:
        k += int((bgr != want_bgr).sum())
        p += int((plain_bgr.numpy() != want_bgr[rows]).sum())
    return k, p


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
        for label, data in (("tiff ycbcr (1, 1)", every_triple_ycbcr()),
                            ("tiff cielab 8-bit", every_triple_cielab()),
                            ("tiff cielab 16-bit", cielab16_sample())):
            k, p = dense_mismatches(lib, data, slice(None, None, 8),
                                    colour=True)
            total += k + p
            print(f"{label}: grey and BGR entries differing from cv2: "
                  f"kernel arithmetic {k}, plain (every 8th row) {p}")
    print(f"in all: {total} mismatches")
    return 0 if total == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
