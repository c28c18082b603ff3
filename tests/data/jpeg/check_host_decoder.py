"""Hold the card's JPEG decoder to OpenCV without the card.

    python tests/data/jpeg/check_host_decoder.py

Builds the decoder's host sources (``mpmvs_torch/csrc/jpeg_entropy.h`` and
``jpeg_idct.h``, the IDCT the card's kernel runs) with ``g++`` into a
temporary directory, decodes the fixtures beside this file and JPEGs that
OpenCV encodes from a seed (4:2:0, 4:2:2, 4:4:0, progressive, restart
intervals, optimised Huffman tables, grey, 17x9 to 3200x2130) and the
files under ``layouts/`` (EXIF orientations 2..8, RGB components, CMYK and
YCCK, every sampling layout), upsamples and converts them with the colour
kernels' plain version (``io.images.colour_plain``), applies the EXIF
orientation (``io.images.orient``), and prints, per file and in all, the
entries that differ from ``cv2.imread``'s grey and BGR arrays, and those
where the colour kernels' arithmetic (``csrc/jpeg_colour.h``, built for the
host) differs from the plain version, on each file below 10^6 pixels and on
the sweeps of :func:`sweep_mismatches`. A JPEG under ``refused/`` with
arrays in ``cv2_arrays.npz`` must decode to them; the others must be
refused (a non-zero code, printed: 12-bit samples, an arithmetic-coded
lossless file, a hierarchical one, a lossless scan libjpeg refuses and two
sampling layouts). The build decodes arithmetic-coded files too
(``jpeg_arith.h``; ``check_host_lossless.py`` reads the fixtures under
``arith/`` and ``lossless/``). It needs g++ and OpenCV.
"""

import ctypes
import glob
import os
import struct
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
#include "jpeg_colour.h"
#include "jpeg_entropy.h"
#include "jpeg_idct.h"
#include "jpeg_smooth.h"
using namespace jpeg_entropy;
// Every block of each component smoothed as the card's jpeg_smooth_kernel
// smooths it, where libjpeg would (smoothing()'s latch).
static void smooth(Decoder* d) {
  int latch[kSmoothLen];
  smoothing(d, latch);
  if (!latch[0]) return;
  for (int i = 0; i < d->ncomp; i++) {
    Component& c = d->comp[i];
    jpeg_smooth::Params p =
        jpeg_smooth::params_of(latch + 1 + kSmoothInts * i);
    std::vector<int16_t> out(c.coef.size());
    for (int by = 0; by < c.blocks_h; by++)
      for (int bx = 0; bx < c.blocks_w; bx++)
        jpeg_smooth::smooth_block(c.coef.data(), p, bx, by,
                                  &out[((size_t)by * c.blocks_w + bx) * 64]);
    c.coef.swap(out);
  }
}
// The smoothing latch of a decode (jpeg_entropy::kSmoothLen ints).
extern "C" int smoothing_of(const uint8_t* data, size_t len, int* latch) {
  Decoder* d = new Decoder();
  int err = decode(d, data, len, false);
  if (!err) smoothing(d, latch);
  delete d;
  return err;
}
// jpeg_smooth_kernel's arithmetic over a component's whole coefficient
// array, a block at a time as its threads run it.
extern "C" void smooth_host(const int16_t* coef, const int* params,
                            int16_t* out) {
  jpeg_smooth::Params p = jpeg_smooth::params_of(params);
  for (int by = 0; by < p.blocks_h; by++)
    for (int bx = 0; bx < p.blocks_w; bx++)
      jpeg_smooth::smooth_block(coef, p, bx, by,
                                out + ((size_t)by * p.blocks_w + bx) * 64);
}
// info: ncomp, orientation, colour space, hmax, vmax, then per component
// its plane's height and width and its factors h, v
extern "C" int planes(const uint8_t* data, size_t len, int* info,
                      uint8_t** out) {
  Decoder* d = new Decoder();
  int err = decode(d, data, len, false);
  if (!err && d->lossless) err = -1;  // differences: check_host_lossless.py
  if (err) { delete d; return err; }
  smooth(d);
  info[0] = d->ncomp;
  info[1] = d->orientation;
  info[2] = d->space;
  info[3] = d->hmax;
  info[4] = d->vmax;
  for (int i = 0; i < d->ncomp; i++) {
    Component& c = d->comp[i];
    int pw = (d->width * c.h + d->hmax - 1) / d->hmax;
    int ph = (d->height * c.v + d->vmax - 1) / d->vmax;
    int* ci = info + 5 + 4 * i;
    ci[0] = ph;
    ci[1] = pw;
    ci[2] = c.h;
    ci[3] = c.v;
    if (!out[i]) continue;
    for (int by = 0; by < c.height_in_blocks; by++)
      for (int bx = 0; bx < c.width_in_blocks; bx++) {
        int rows = ph - 8 * by, cols = pw - 8 * bx;
        jpeg_idct::idct_islow_block(
            &c.coef[((size_t)by * c.blocks_w + bx) * 64], c.qt,
            out[i] + (size_t)8 * by * pw + 8 * bx, pw, rows < 8 ? rows : 8,
            cols < 8 ? cols : 8);
      }
  }
  delete d;
  return 0;
}
// The quantized coefficients a decode leaves: info as planes()'s, then per
// component its blocks down and across (padded to whole MCUs), its id and
// its quantization table's index; coef[i] (blocks x 64 int16, natural
// order) and qt (4 x 64) receive them where not NULL.
extern "C" int coefficients(const uint8_t* data, size_t len, int* info,
                            int16_t** coef, uint16_t* qt) {
  Decoder* d = new Decoder();
  int err = decode(d, data, len, false);
  if (err) { delete d; return err; }
  info[0] = d->ncomp;
  info[1] = d->width;
  info[2] = d->height;
  for (int i = 0; i < d->ncomp; i++) {
    Component& c = d->comp[i];
    int* ci = info + 3 + 6 * i;
    ci[0] = c.blocks_h;
    ci[1] = c.blocks_w;
    ci[2] = c.h;
    ci[3] = c.v;
    ci[4] = c.id;
    ci[5] = c.tq;
    if (coef && coef[i])
      memcpy(coef[i], c.coef.data(), c.coef.size() * sizeof(int16_t));
  }
  if (qt) memcpy(qt, d->qt, sizeof(d->qt));
  delete d;
  return 0;
}
// The colour kernels' per-pixel arithmetic (jpeg_colour.h) over a whole
// (H, W) image, as the kernels run it: n planes, n x 6 ints (w, rh, rv,
// fancy, pitch, stride), form: YccForm bits (n 1 or 3: bit 0 RGB, bit 1
// OpenCV's grey), 2 CMYK / 3 YCCK (n 4). A TIFF's chunks are
// tests/data/tiff/check_host_raster.py's chunk_pixels.
extern "C" void colour_pixels(const uint8_t* const* ptrs, const int* geo,
                              int n, int form, int H, int W, uint8_t* bgr,
                              uint8_t* grey) {
  jpeg_colour::Planes pl = {};
  for (int i = 0; i < n; i++) {
    const int* g = geo + 6 * i;
    pl.c[i] = {ptrs[i], g[0], g[1], g[2], g[3], g[4], g[5]};
  }
  for (int r = 0; r < H; r++)
    for (int col = 0; col < W; col++) {
      size_t i = (size_t)r * W + col;
      if (n == 4)
        jpeg_colour::cmyk_pixel(pl, form == 3, H, r, col, bgr + 3 * i,
                                grey + i);
      else
        jpeg_colour::ycc_pixel(pl, n, form, jpeg_colour::whole(H, r, col),
                               bgr + 3 * i, grey + i);
    }
}
// Element-wise steps: OpenCV's CMYK -> BGR channel of (x, k) pairs, and
// libjpeg's YCCK -> C, M, Y of (Y, Cb, Cr) triples.
extern "C" void cmyk_channels(const uint8_t* x, const uint8_t* k, int n,
                              uint8_t* out) {
  for (int i = 0; i < n; i++)
    out[i] = (uint8_t)jpeg_colour::cmyk_channel(x[i], k[i]);
}
extern "C" void ycck_cmys(const uint8_t* y, const uint8_t* cb,
                          const uint8_t* cr, int n, uint8_t* out) {
  for (int i = 0; i < n; i++) {
    int c, m, yy;
    jpeg_colour::ycck_cmy(y[i], cb[i], cr[i], &c, &m, &yy);
    out[3 * i] = (uint8_t)c;
    out[3 * i + 1] = (uint8_t)m;
    out[3 * i + 2] = (uint8_t)yy;
  }
}
'''


def build(tmp):
    src, lib = os.path.join(tmp, "shim.cpp"), os.path.join(tmp, "shim.so")
    with open(src, "w") as f:
        f.write(SHIM)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-I",
                    os.path.join(REPO, "mpmvs_torch", "csrc"), "-o", lib,
                    src], check=True)
    lib = ctypes.CDLL(lib)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.coefficients.argtypes = [ctypes.c_char_p, ctypes.c_size_t, vp, vp,
                                 vp]
    lib.colour_pixels.argtypes = [vp, vp, i, i, i, i, vp, vp]
    lib.smoothing_of.argtypes = [ctypes.c_char_p, ctypes.c_size_t, vp]
    lib.smooth_host.argtypes = [vp, vp, vp]
    lib.smooth_host.restype = None
    lib.cmyk_channels.argtypes = [vp, vp, i, vp]
    lib.ycck_cmys.argtypes = [vp, vp, vp, i, vp]
    for fn in ("colour_pixels", "cmyk_channels", "ycck_cmys"):
        getattr(lib, fn).restype = None
    return lib


def coefficients(lib, data):
    """A JPEG's quantized coefficients as the host decoder leaves them:
    ([(blocks down, blocks across, 64) int16 in natural order a component,
    padded to whole MCUs], [(h, v)], [id], [table index], (4, 64) uint16
    tables, (H, W))."""
    info = (ctypes.c_int * 27)()
    code = lib.coefficients(data, len(data), info, None, None)
    if code:
        raise ValueError(f"the host decoder refuses it: code {code}")
    n = info[0]
    comp = [info[3 + 6 * i:9 + 6 * i] for i in range(n)]
    coefs = [np.zeros((bh, bw, 64), np.int16) for bh, bw, *_ in comp]
    qt = np.zeros((4, 64), np.uint16)
    ptrs = (ctypes.c_void_p * 4)(*[c.ctypes.data for c in coefs])
    assert lib.coefficients(data, len(data), info, ptrs, qt.ctypes.data) == 0
    return (coefs, [(h, v) for _, _, h, v, _, _ in comp],
            [i for *_, i, _ in comp], [t for *_, t in comp], qt,
            (info[2], info[1]))


def smoothing(lib, data):
    """A JPEG's ``images.Smoothing`` per component where libjpeg-turbo
    smooths its blocks, else ()."""
    latch = (ctypes.c_int * images.JPEG_SMOOTH_LEN)()
    assert lib.smoothing_of(data, len(data), latch) == 0
    if not latch[0]:
        return ()
    n = images.SMOOTH_INTS
    return tuple(images.Smoothing.of(latch[1 + n * c:1 + n * (c + 1)])
                 for c in range(4) if latch[1 + n * c + 4])


def smooth_host(lib, coef: np.ndarray, p) -> np.ndarray:
    """``csrc/jpeg_smooth.h`` built for the host over a component's
    coefficients (blocks down, blocks across, 64) int16, as the kernel's
    threads run it."""
    coef = np.ascontiguousarray(coef, np.int16)
    out = np.empty_like(coef)
    lib.smooth_host(coef.ctypes.data, p.ints(), out.ctypes.data)
    return out


def status(lib, data) -> int:
    """The host decoder's code for a JPEG: 0, or the error it refuses it
    with (``io.images._CODE_ERRORS``)."""
    info = (ctypes.c_int * 21)()
    return lib.planes(data, len(data), info, (ctypes.c_void_p * 4)())


def planes(lib, data):
    """A JPEG's component planes (numpy uint8, at their sampled sizes),
    their ratios (hmax / h, vmax / v), the image's size (H, W), its colour
    space (``images.SPACE_*``) and EXIF orientation, from the host
    decoder."""
    info = (ctypes.c_int * 21)()
    none = (ctypes.c_void_p * 4)()
    assert lib.planes(data, len(data), info, none) == 0
    n = info[0]
    dims = [info[5 + 4 * i:9 + 4 * i] for i in range(n)]
    out = [np.zeros((ph, pw), np.uint8) for ph, pw, _, _ in dims]
    ptrs = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in out])
    assert lib.planes(data, len(data), info, ptrs) == 0
    factors = [(info[3] // h, info[4] // v) for _, _, h, v in dims]
    W, H = struct.unpack(">HH", sof_size(data))
    return out, factors, (H, W), info[2], info[1]


def sof_size(data: bytes) -> bytes:
    """The height and width bytes of a JPEG's first SOF segment."""
    pos = 2
    while pos < len(data):
        m, n = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            h, w = data[pos + 5:pos + 7], data[pos + 7:pos + 9]
            return w + h
        pos += 2 + n
    raise ValueError("no SOF segment")


def decode(lib, data):
    """(grey, BGR) numpy arrays of a JPEG: the host decoder, the colour
    kernels' plain version (``io.images.colour_plain``) and the EXIF
    orientation."""
    out, factors, size, space, orientation = planes(lib, data)
    gray, bgr = images.colour_plain([torch.as_tensor(p) for p in out],
                                    factors, size, space)
    return (images.orient(gray, orientation).numpy(),
            images.orient(bgr, orientation).numpy())


def kernel_host(lib, data):
    """(grey, BGR) numpy arrays of a JPEG's planes through the colour
    kernels' arithmetic built for the host (``csrc/jpeg_colour.h``), before
    the orientation."""
    out, factors, (H, W), space, _ = planes(lib, data)
    ptrs = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in out])
    geo = images.plane_ints(out, factors)
    bgr = np.zeros((H, W, 3), np.uint8)
    grey = np.zeros((H, W), np.uint8)
    lib.colour_pixels(ptrs, geo, len(out), space, H, W,
                      bgr.ctypes.data,
                      grey.ctypes.data)
    return grey, bgr


def kernel_mismatches(lib, data) -> int:
    """Entries of a JPEG's grey and BGR where the kernels' host-built
    arithmetic differs from the plain version (a YCbCr JPEG's grey is its Y
    plane, which the kernel writes only where it is upsampled: compared
    here all the same)."""
    out, factors, size, space, _ = planes(lib, data)
    want = images.colour_plain([torch.as_tensor(p) for p in out], factors,
                               size, space)
    got = kernel_host(lib, data)
    return sum(int((g != w.numpy()).sum()) for g, w in zip(got, want))


def sweep_mismatches(lib, quads: int = 10 ** 7, seed: int = 0,
                     parts=("pairs", "triples", "quads")) -> dict:
    """The four-component kernel's arithmetic built for the host against
    the plain version, entries that differ: OpenCV's CMYK -> BGR rule on
    every (x, k) pair (``"pairs"``, 2^16), libjpeg's YCCK step on every
    (Y, Cb, Cr) triple (``"triples"``, 2^24, in chunks), and whole CMYK
    pixels, grey and BGR, on ``quads`` seeded quadruples (``"quads"``; all
    2^32 are too many); ``parts`` names which."""
    out = {}
    if "pairs" in parts:
        out["pairs"] = _pairs(lib)
    if "triples" in parts:
        out["triples"] = _triples(lib)
    if "quads" in parts:
        out["quads"] = _quads(lib, quads, seed)
    return out


def _pairs(lib) -> int:
    v = np.arange(1 << 16)
    x, k = (v & 255).astype(np.uint8), (v >> 8).astype(np.uint8)
    got = np.zeros(1 << 16, np.uint8)
    lib.cmyk_channels(x.ctypes.data, k.ctypes.data, len(x), got.ctypes.data)
    want = images.cmyk_bgr_plain(*[torch.as_tensor(a).long()
                                   for a in (x, x, x, k)])[3]
    return int((got != want.numpy()).sum())


def _triples(lib) -> int:
    bad, step = 0, 1 << 22
    for start in range(0, 1 << 24, step):
        t = np.arange(start, start + step)
        yc = [((t >> s) & 255).astype(np.uint8) for s in (16, 8, 0)]
        got = np.zeros((step, 3), np.uint8)
        lib.ycck_cmys(*[a.ctypes.data for a in yc], step, got.ctypes.data)
        want = torch.stack(images.ycck_to_cmy_plain(
            *[torch.as_tensor(a).long() for a in yc]), -1)
        bad += int((got != want.numpy()).sum())
    return bad


def _quads(lib, quads: int, seed: int) -> int:
    rng, bad, step = np.random.default_rng(seed), 0, 10 ** 6
    for start in range(0, quads, step):
        n = min(step, quads - start)
        cmyk = rng.integers(0, 256, (4, 1, n)).astype(np.uint8)
        ptrs = (ctypes.c_void_p * 4)(*[c.ctypes.data for c in cmyk])
        geo = (ctypes.c_int * 24)(*[n, 1, 1, 0, n, 1] * 4)
        bgr, grey = np.zeros((1, n, 3), np.uint8), np.zeros((1, n), np.uint8)
        lib.colour_pixels(ptrs, geo, 4, images.SPACE_CMYK, 1, n,
                          bgr.ctypes.data, grey.ctypes.data)
        want = images.cmyk_to_bgr_plain([torch.as_tensor(c) for c in cmyk],
                                        [(1, 1)] * 4, False)
        bad += int((grey != want[0].numpy()).sum()
                   + (bgr != want[1].numpy()).sum())
    return bad


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
            k = kernel_mismatches(lib, data) if grey.size < 1e6 else 0
            total += n + k
            print(f"{name:28s} {grey.shape}: {n} entries differ, kernel "
                  f"arithmetic vs plain {k}")
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
    sweep = sweep_mismatches(lib)
    total += sum(sweep.values())
    print(f"kernel arithmetic vs plain, entries differing: {sweep}")
    print(f"in all: {total} entries differ, {len(accepted)} files that "
          f"must be refused were decoded")
    return 0 if total == 0 and not accepted else 1


if __name__ == "__main__":
    sys.exit(main())
