"""Write the JPEG fixtures of tests/test_torch_images.py and chip_smoke.py.

    python tests/data/jpeg/make_fixtures.py

Each fixture is one small colour (or grey) image made from a seed, encoded
by OpenCV with the settings its name gives; ``decoded.npz`` holds what
``cv2.imread`` returns for each (``gray_<name>`` with IMREAD_GRAYSCALE,
``bgr_<name>`` with IMREAD_COLOR), the target of the card's decoder.

``refused/`` held JPEGs that the card's decoder had to refuse, because
``cv2.imread`` gives another image than their planes: ``exif_orientation6``
(420_q95 with an EXIF APP1 segment whose orientation is 6, which OpenCV
rotates), ``adobe_rgb`` (444_q100 with its JFIF marker replaced by an Adobe
APP14 marker of transform 0, which libjpeg reads as RGB) and ``rgb_ids``
(444_q100 without its JFIF marker and with the component ids 'R', 'G', 'B').
These three were refused until the card's decoder learnt EXIF orientation and
RGB components; they now decode, and ``refused/`` also holds what the card
still refuses, each for a cause it names: ``twelve_bit`` (420_q95 with its
SOF0 sample precision set to 12), ``lossless`` (made SOF3: a lossless scan
of predictor 0, which libjpeg refuses), ``arithmetic_lossless`` (a true
arithmetic-coded lossless stream, SOF11), ``hierarchical`` (DHP, SOF9, EXP
and SOF13 frames) and two sampling layouts libjpeg refuses too
(``fractional``: Y at 2x1 under a Cb at 3x1; ``mcu_blocks``: Y at 3x3, 11
blocks in an interleaved MCU; written by ``jpeg_file.py``). 420_q95 made
SOF9, once ``refused/arithmetic``, reads as cv2 reads it and is
``arith/patched_sof9``, written by ``make_arith_lossless.py``.

``layouts/`` holds 420_q95 with EXIF orientations 2..8 (odd_101x203_q95 for
6, so that the rotation is not square), ``rgb_ids_420`` (420_q95 without
its JFIF marker and with the ids 'R', 'G', 'B': subsampled RGB components),
and (:func:`components`) four-component JPEGs and the sampling layouts the
card once refused: ``cmyk_pil`` (a four-component Adobe CMYK JPEG written
by PIL, once ``refused/cmyk``), PIL's progressive CMYK and the same re-marked
YCCK (Adobe transform 2), CMYK without an Adobe marker (under a JFIF one),
YCCK of transform 2 and of transform 1 (which libjpeg takes for YCCK),
YCCK with Y and K at 2x2 and Cb, Cr at 1x1 (also with restart intervals and
3 pixels wide), CMYK with a factor per axis on each component and with
factors of 3, CMYK with an EXIF orientation; three components at 4:1:1
(cv2's, also progressive and with restarts), Y at 1x4, 3x1, 1x3, 4x2 and
4x4 (in a scan a component), Y below the largest factor (Y 1x1 under a Cb
at 2x2; Y 1x2 under a Cb at 2x1), and 4:2:0 and 4:2:2 images 1 to 5
pixels wide, whose chroma libjpeg-turbo replicates up to 2 samples wide.
All but PIL's and cv2's are written by ``jpeg_file.py``.

``cv2_arrays.npz`` holds ``cv2.imread``'s grey and BGR arrays
(``gray_<dir>/<name>``, ``bgr_<dir>/<name>``) of every file under
``layouts/`` and ``refused/`` that the card must decode; a file under
``refused/`` without an entry must be refused.

``encode/`` holds the encoder's targets: ``sources.npz`` (``bgr_<h>x<w>``
and ``gray_<h>x<w>``, made from a seed) and ``cv2.imencode``'s bytes of each
at qualities 75, 90, 95 and 100 (``<kind>_<h>x<w>_q<q>.jpg``; colour at
4:2:0, OpenCV's default).

``../png/`` holds PNG sources of colour types 0, 2, 3, 4 and 6 at bit depth
8 and 101x203, written here row by row with the five filter types in turn
(``type<t>.png``, a palette with a tRNS chunk for type 3), three written by
``cv2.imwrite`` (``cv2_gray``, ``cv2_bgr``, ``cv2_bgra``), one with an eXIf
chunk of orientation 6 (``exif6``); the layouts the card once refused
(``interlaced``: Adam7, ``grey16``: 16-bit, by cv2, ``grey1``: 1-bit grey,
``palette4``: 4-bit palette); and at 37x45 or smaller every other colour
type and bit depth (``grey2``, ``grey4``, ``palette1``, ``palette2``,
``greyalpha16``, ``rgba16``; ``grey16_all`` and ``rgb16_all``, 256x256,
hold every 16-bit value in each channel), Adam7 at 1x1, 3x5, 7x9, 13x17 and
37x45 over several colour types and depths (``adam7_*``), tRNS chunks on
grey, RGB and palette images (``trns_*``), and gAMA or sRGB chunks
(``gama_*``, ``srgb_palette8``), which take cv2's grey of colour through
libpng's gamma tables. ``cv2_arrays.npz`` holds ``cv2.imread``'s BGR
(``bgr_<name>``) and grey (``gray_<name>``) arrays of each.
``../png/conversion/`` holds the workspace images the JAX converter writes
(``cv2.imwrite(dst, cv2.imread(src))``) for the sources of ``CONVERSION``
but the first, which it copies; and ``../png/refused/`` what the card
refuses: ``image.gif`` (Pillow's GIF of the same image, which cv2 reads).
cv2's BMP of it, refused here once, is ``../bmp/image.bmp``, and its
lossless WebP ``../webp/lossless/imencode_45x37.webp``; the card reads
both.

    python tests/data/jpeg/make_fixtures.py --part new

writes only what is listed after the first paragraph (the files from
before keep their bytes; ``--part all``, the default, rewrites them too),
and ``conversion/cv2.json``: what cv2 makes of chip_smoke.py phase 8's
YCCK source ``conversion/ycck_3200x2130.jpg``, which
``make_ycck_source.py`` writes on a card.
"""

import argparse
import io
import os
import struct
import zlib

import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
PNG_DIR = os.path.join(os.path.dirname(HERE), "png")
sys.path.insert(0, HERE)
from jpeg_file import adobe_app14, baseline_jpeg, jfif_app0  # noqa: E402


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth colour fields, a few sharp-edged blocks and faint noise."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3)).astype(
        np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    img = img.astype(np.int64)
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y0:y0 + h // 5, x0:x0 + w // 5] = rng.integers(0, 256, 3)
    img += rng.integers(-2, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


Q, S = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
FIXTURES = {
    "420_q95": ((48, 64), [Q, 95, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "444_q100": ((48, 64), [Q, 100, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "422_q90": ((48, 64), [Q, 90, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "gray_q95": ((48, 64), [Q, 95]),
    "progressive_q95": ((48, 64), [Q, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "odd_101x203_q95": ((101, 203), [Q, 95]),
}


def segment(marker: int, body: bytes) -> bytes:
    return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body


def without_jfif(data: bytes) -> bytes:
    """A JPEG's bytes with its leading JFIF APP0 segment taken out."""
    assert data[2:4] == b"\xff\xe0" and data[6:11] == b"JFIF\x00"
    return data[:2] + data[4 + struct.unpack(">H", data[4:6])[0]:]


def with_ids(data: bytes, ids: bytes) -> bytes:
    """A 3-component JPEG's bytes with the component ids of its SOF and SOS
    segments replaced by ``ids``."""
    out, pos = bytearray(data), 2
    while pos < len(out):
        marker, n = out[pos + 1], struct.unpack(">H", out[pos + 2:pos + 4])[0]
        body = pos + 4
        if marker in (0xC0, 0xC1, 0xC2):
            for i in range(3):
                out[body + 6 + 3 * i] = ids[i]
        if marker == 0xDA:
            for i in range(out[body]):
                out[body + 1 + 2 * i] = ids[i]
            break
        pos += 2 + n
    return bytes(out)


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment of EXIF data (big-endian) holding one tag, the
    orientation."""
    return segment(0xE1, b"Exif\x00\x00MM\x00\x2a" + struct.pack(
        ">IHHHIHHI", 8, 1, 0x0112, 3, 1, orientation, 0, 0))


def after_soi(data: bytes, seg: bytes) -> bytes:
    return data[:2] + seg + data[2:]


def refused(data_420: bytes, data_444: bytes) -> dict:
    bare = without_jfif(data_444)
    return {"exif_orientation6": after_soi(data_420, exif_app1(6)),
            "adobe_rgb": after_soi(bare, adobe_app14(0)),
            "rgb_ids": with_ids(bare, b"RGB")}


def with_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    """A JPEG's bytes with its first SOF segment's marker or sample
    precision replaced."""
    out, pos = bytearray(data), 2
    while pos < len(out):
        m, n = out[pos + 1], struct.unpack(">H", out[pos + 2:pos + 4])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if marker is not None:
                out[pos + 1] = marker
            if precision is not None:
                out[pos + 4] = precision
            return bytes(out)
        pos += 2 + n
    raise ValueError("no SOF segment")


def cmyk_jpeg(h: int, w: int, seed: int, progressive: bool = False) -> bytes:
    """A four-component (Adobe CMYK) JPEG, as PIL writes one."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 4)).astype(np.uint8),
                          "CMYK")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, progressive=progressive)
    return buf.getvalue()


def with_transform(data: bytes, transform: int) -> bytes:
    """A JPEG's bytes with its Adobe APP14 marker's transform replaced."""
    out = bytearray(data)
    at = out.index(b"Adobe")
    out[at + 11] = transform
    return bytes(out)


def plane(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth random (h, w) uint8 plane with faint noise."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2)).astype(np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img.astype(np.int64) + rng.integers(-4, 5, img.shape), 0,
                   255).astype(np.uint8)


def sampled(factors, h: int, w: int, seed: int, **kw) -> bytes:
    """A baseline JPEG (jpeg_file.baseline_jpeg) of smooth planes at
    ``factors`` ((h, v) a component), h x w; in a scan a component where an
    interleaved MCU would hold more than 10 blocks, unless ``kw`` says."""
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    planes = [plane(-(-h * v // vmax), -(-w * f // hmax), seed + i)
              for i, (f, v) in enumerate(factors)]
    kw.setdefault("interleave", sum(f * v for f, v in factors) <= 10)
    return baseline_jpeg(planes, factors, (h, w), **kw)


def stays_refused(data_420: bytes) -> dict:
    from jpeg_file import hierarchical_jpeg, sof11_constant

    return {"twelve_bit": with_sof(data_420, precision=12),
            "arithmetic_lossless": sof11_constant(16, 24),
            "hierarchical": hierarchical_jpeg(16, 24),
            "lossless": with_sof(data_420, marker=0xC3),
            "fractional": sampled([(2, 1), (3, 1), (1, 1)], 21, 27, 60),
            "mcu_blocks": sampled([(3, 3), (1, 1), (1, 1)], 21, 27, 63,
                                  interleave=True),
            # cut before its first scan: libjpeg's "no image"
            "no_scan": data_420[:data_420.index(b"\xff\xda")]}


def components() -> dict:
    """The four-component JPEGs and the sampling layouts of layouts/."""
    S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    s411 = [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]
    yk22 = [(2, 2), (1, 1), (1, 1), (2, 2)]
    progressive = cmyk_jpeg(19, 23, 3, progressive=True)
    made = {
        "cmyk_pil": cmyk_jpeg(24, 40, 7),
        "cmyk_pil_progressive": progressive,
        "ycck_pil_progressive": with_transform(progressive, 2),
        "cmyk_no_adobe_jfif": sampled([(1, 1)] * 4, 21, 27, 10,
                                      pre=jfif_app0()),
        "ycck_adobe2": sampled([(1, 1)] * 4, 37, 45, 14,
                               pre=adobe_app14(2)),
        "ycck_adobe1": sampled([(1, 1)] * 4, 21, 27, 18,
                               pre=adobe_app14(1)),
        "ycck_yk22_cc11": sampled(yk22, 37, 45, 22, pre=adobe_app14(2)),
        "ycck_yk22_cc11_restart3": sampled(yk22, 29, 51, 26,
                                           pre=adobe_app14(2), restart=3),
        "ycck_yk22_cc11_w3": sampled(yk22, 7, 3, 30, pre=adobe_app14(2)),
        "cmyk_each_axis": sampled([(2, 2), (1, 2), (2, 1), (1, 1)], 37, 45,
                                  34, pre=adobe_app14(0)),
        "cmyk_3x1": sampled([(3, 1), (1, 1), (3, 1), (1, 1)], 13, 29, 38,
                            pre=adobe_app14(0)),
        "cmyk_exif6": sampled([(1, 1)] * 4, 37, 45, 42,
                              pre=exif_app1(6) + adobe_app14(0)),
        "ycc_1x4": sampled([(1, 4), (1, 1), (1, 1)], 21, 27, 46),
        "ycc_3x1": sampled([(3, 1), (1, 1), (1, 1)], 21, 27, 49),
        "ycc_1x3": sampled([(1, 3), (1, 1), (1, 1)], 21, 27, 52),
        "ycc_4x2": sampled([(4, 2), (1, 1), (1, 1)], 37, 45, 55),
        "ycc_4x4_scans": sampled([(4, 4), (1, 1), (1, 1)], 37, 45, 58),
        "ycc_y1x1_cb2x2": sampled([(1, 1), (2, 2), (1, 1)], 21, 27, 64),
        "ycc_y1x1_cb2x2_w3": sampled([(1, 1), (2, 2), (1, 1)], 7, 3, 67),
        "ycc_y1x2_cb2x1": sampled([(1, 2), (2, 1), (1, 1)], 21, 27, 70),
    }
    img = picture(21, 27, seed=8)
    for name, flags in (("411", s411), ("411_restart2", s411 + [
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2]), ("411_progressive", s411 + [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1])):
        made[f"ycc_{name}_cv2"] = cv2.imencode(".jpg", img, flags)[1].tobytes()
    for w in range(1, 6):
        narrow = picture(22, 22, seed=80 + w)[:6, :w]
        for kind in ("420", "422"):
            made[f"ycc_{kind}_w{w}_cv2"] = cv2.imencode(
                ".jpg", narrow, [S, getattr(
                    cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{kind}")])[1].tobytes()
    return made


def layouts(data_420: bytes, data_odd: bytes) -> dict:
    made = {f"exif_orientation{o}": after_soi(
        data_odd if o == 6 else data_420, exif_app1(o)) for o in range(2, 9)}
    made["rgb_ids_420"] = with_ids(without_jfif(data_420), b"RGB")
    return made


def encode_source(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth random colours with noise and a sharp block, (h, w, 3)
    uint8, for any size down to 1x1."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 12 + 2, w // 12 + 2, 3))
    img = cv2.resize(small.astype(np.uint8), (w, h),
                     interpolation=cv2.INTER_CUBIC).astype(np.int64)
    img[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = rng.integers(0, 256, 3)
    img += rng.integers(-6, 7, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


ENCODE_SIZES = ((1, 1), (7, 9), (101, 203), (120, 176))
ENCODE_QUALITIES = (75, 90, 95, 100)


def write_encode_fixtures() -> None:
    folder = os.path.join(HERE, "encode")
    os.makedirs(folder, exist_ok=True)
    sources = {}
    for i, (h, w) in enumerate(ENCODE_SIZES):
        bgr = encode_source(h, w, seed=100 + i)
        sources[f"bgr_{h}x{w}"] = bgr
        sources[f"gray_{h}x{w}"] = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    np.savez_compressed(os.path.join(folder, "sources.npz"), **sources)
    for key, img in sources.items():
        for q in ENCODE_QUALITIES:
            ok, buf = cv2.imencode(".jpg", img, [Q, q])
            assert ok
            with open(os.path.join(folder, f"{key}_q{q}.jpg"), "wb") as f:
                f.write(buf.tobytes())


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def png_filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """Filtered scanlines of (H, rowbytes) uint8 rows, row r with filter
    r % 5 (None, Sub, Up, Average, Paeth)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for r, raw in enumerate(rows.astype(np.int64)):
        a = np.concatenate([np.zeros(bpp, np.int64), raw[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        kind = r % 5
        if kind == 0:
            pred = np.zeros_like(raw)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out.append(bytes([kind]) + ((raw - pred) & 255).astype(
            np.uint8).tobytes())
        prev = raw
    return b"".join(out)


def png_bytes(w: int, h: int, depth: int, colour_type: int, scanlines: bytes,
              extra: bytes = b"", interlace: int = 0,
              after: bytes = b"") -> bytes:
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                             colour_type, 0, 0, interlace))
            + extra + png_chunk(b"IDAT", zlib.compress(scanlines, 6))
            + after + png_chunk(b"IEND", b""))


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))  # row0, col0, dy, dx


def png_pack(px: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, C) samples -> (H, rowbytes) uint8 rows: 16-bit big-endian,
    below 8 bits packed most significant bit first, rows padded to a
    byte."""
    h = px.shape[0]
    s = px.reshape(h, -1)
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([s, np.zeros((h, -s.shape[1] % per), s.dtype)], 1)
    shifts = np.arange(per - 1, -1, -1) * depth
    return (s.astype(np.uint16).reshape(h, -1, per) << shifts).sum(
        -1).astype(np.uint8)


def png_scanlines(px: np.ndarray, depth: int, interlace: int = 0) -> bytes:
    """Filtered scanlines of (H, W, C) samples, the filter types cycling
    row by row (within each Adam7 pass when ``interlace``)."""
    bpp = max(1, px.shape[2] * depth // 8)
    if not interlace:
        return png_filter_rows(png_pack(px, depth), bpp)
    out = []
    for r0, c0, dy, dx in ADAM7:
        sub = px[r0::dy, c0::dx]
        if sub.size:
            out.append(png_filter_rows(png_pack(sub, depth), bpp))
    return b"".join(out)


def adam7_scanlines(img: np.ndarray) -> bytes:
    """Unfiltered scanlines of an 8-bit image's seven Adam7 passes."""
    out = []
    for r0, c0, dy, dx in ADAM7:
        sub = img[r0::dy, c0::dx]
        if sub.size:
            out += [b"\0" + row.tobytes() for row in sub]
    return b"".join(out)


def all16() -> np.ndarray:
    """(256, 256, 3) uint16: every 16-bit value once in each channel."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    return np.stack([v, v[::-1, ::-1], v.T], -1)


def gama(g: int) -> bytes:
    return png_chunk(b"gAMA", struct.pack(">I", g))


def more_png_fixtures(bgr: np.ndarray, alpha: np.ndarray,
                      palette: np.ndarray, index: np.ndarray):
    """The PNGs of every colour type at every bit depth, Adam7, tRNS and
    gamma: {name: bytes}."""
    rng = np.random.default_rng(12)
    ih, iw = 37, 45
    rgb = bgr[:ih, :iw, ::-1]
    grey = cv2.cvtColor(bgr[:ih, :iw], cv2.COLOR_BGR2GRAY)[..., None]
    a = alpha[:ih, :iw, None]
    rgb16 = rgb.astype(np.uint16) * 257 + rng.integers(
        0, 257, rgb.shape).astype(np.uint16)
    a16 = all16()
    pal = png_chunk(b"PLTE", palette.tobytes())
    idx = index[:ih, :iw, None]

    def png(px, depth, colour_type, extra=b"", interlace=0):
        h, w = px.shape[:2]
        return png_bytes(w, h, depth, colour_type,
                         png_scanlines(px, depth, interlace), extra,
                         interlace)

    f = {
        "grey2": png(grey >> 6, 2, 0),
        "grey4": png(grey >> 4, 4, 0),
        "grey16_all": png(a16[..., :1], 16, 0),
        "palette1": png(idx % 2, 1, 3, pal),
        "palette2": png(idx % 4, 2, 3, pal),
        "rgb16_all": png(a16, 16, 2),
        "greyalpha16": png(rgb16[..., :2], 16, 4),
        "rgba16": png(np.concatenate([rgb16, a.astype(np.uint16) * 257], -1),
                      16, 6),
        "adam7_1x1_rgb8": png(rgb[:1, :1], 8, 2, interlace=1),
        "adam7_3x5_palette2": png(idx[:3, :5] % 4, 2, 3, pal, 1),
        "adam7_7x9_greyalpha16": png(rgb16[:7, :9, :2], 16, 4, interlace=1),
        "adam7_13x17_grey4": png(grey[:13, :17] >> 4, 4, 0, interlace=1),
        "adam7_grey1": png(grey > 127, 1, 0, interlace=1),
        "adam7_rgba16": png(np.concatenate(
            [rgb16, a.astype(np.uint16) * 257], -1), 16, 6, interlace=1),
        "adam7_palette8": png(idx, 8, 3, pal, 1),
        "trns_grey8": png(grey, 8, 0, png_chunk(b"tRNS", b"\0\x80")),
        "trns_grey2": png(grey >> 6, 2, 0, png_chunk(b"tRNS", b"\0\x01")),
        "trns_rgb16": png(rgb16, 16, 2, png_chunk(
            b"tRNS", struct.pack(">HHH", *rgb16[0, 0].tolist()))),
        "trns_palette4": png(idx % 16, 4, 3, pal + png_chunk(
            b"tRNS", bytes(range(0, 160, 10)))),
        "gama_rgb8": png(rgb, 8, 2, gama(45455)),
        "gama_rgb8_200000": png(rgb, 8, 2, gama(200000)),
        "gama_rgb8_100000": png(rgb, 8, 2, gama(100000)),
        "srgb_palette8": png(idx, 8, 3, png_chunk(b"sRGB", b"\0") + pal),
        "gama_grey16": png(rgb16[..., :1], 16, 0, gama(45455)),
        "gama_rgba16": png(np.concatenate(
            [rgb16, a.astype(np.uint16) * 257], -1), 16, 6, gama(45455)),
    }
    return f


def write_png_fixtures() -> None:
    refused_dir = os.path.join(PNG_DIR, "refused")
    os.makedirs(refused_dir, exist_ok=True)
    h, w = 101, 203
    rng = np.random.default_rng(11)
    bgr = encode_source(h, w, seed=21)
    rgb = bgr[..., ::-1]
    grey = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    alpha = rng.integers(0, 256, (h, w)).astype(np.uint8)
    palette = rng.integers(0, 256, (200, 3)).astype(np.uint8)
    index = rng.integers(0, 210, (h, w)).astype(np.uint8)  # some past it
    trns = png_chunk(b"tRNS", bytes(rng.integers(0, 256, 200).astype(
        np.uint8)))
    files = {
        "type0": png_bytes(w, h, 8, 0, png_filter_rows(grey, 1)),
        "type2": png_bytes(w, h, 8, 2, png_filter_rows(
            rgb.reshape(h, 3 * w), 3)),
        "type3": png_bytes(w, h, 8, 3, png_filter_rows(index, 1),
                           png_chunk(b"PLTE", palette.tobytes()) + trns),
        "type4": png_bytes(w, h, 8, 4, png_filter_rows(
            np.stack([grey, alpha], -1).reshape(h, 2 * w), 2)),
        "type6": png_bytes(w, h, 8, 6, png_filter_rows(
            np.concatenate([rgb, alpha[..., None]], -1).reshape(h, 4 * w),
            4)),
        "exif6": png_bytes(w, h, 8, 2, png_filter_rows(
            rgb.reshape(h, 3 * w), 3), png_chunk(
            b"eXIf", b"MM\x00\x2a" + struct.pack(
                ">IHHHIHHI", 8, 1, 0x0112, 3, 1, 6, 0, 0))),
        "cv2_gray": cv2.imencode(".png", grey)[1].tobytes(),
        "cv2_bgr": cv2.imencode(".png", bgr)[1].tobytes(),
        "cv2_bgra": cv2.imencode(".png", np.concatenate(
            [bgr, alpha[..., None]], -1))[1].tobytes(),
    }
    # the files the card refused until it read every layout
    ih, iw = 37, 45
    small = bgr[:ih, :iw]
    bits = np.packbits(grey[:ih, :iw] > 127, axis=1)
    nibbles = index[:ih, :iw - 1:2] % 16 * 16 + index[:ih, 1:iw:2] % 16
    files.update({
        "interlaced": png_bytes(iw, ih, 8, 2, adam7_scanlines(
            small[..., ::-1].copy()), interlace=1),
        "grey16": cv2.imencode(".png", grey[:ih, :iw].astype(
            np.uint16) * 257)[1].tobytes(),
        "grey1": png_bytes(iw, ih, 1, 0, b"".join(
            b"\0" + r.tobytes() for r in bits)),
        "palette4": png_bytes(iw - 1, ih, 4, 3, b"".join(
            b"\0" + r.tobytes() for r in nibbles.astype(np.uint8)),
            png_chunk(b"PLTE", palette[:16].tobytes())),
    })
    files.update(more_png_fixtures(bgr, alpha, palette, index))
    arrays = {}
    for name, data in files.items():
        with open(os.path.join(PNG_DIR, f"{name}.png"), "wb") as f:
            f.write(data)
        buf = np.frombuffer(data, np.uint8)
        arrays[f"bgr_{name}"] = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        arrays[f"gray_{name}"] = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        assert all(arrays[k] is not None for k in arrays), name
    np.savez_compressed(os.path.join(PNG_DIR, "cv2_arrays.npz"), **arrays)
    # the interlaced file is a real one: cv2 reads back what was written
    assert np.array_equal(arrays["bgr_interlaced"], small)
    for name in os.listdir(refused_dir):
        os.remove(os.path.join(refused_dir, name))
    gif = io.BytesIO()
    Image.fromarray(small[..., ::-1]).save(gif, "GIF")
    refused = {"image.gif": gif.getvalue()}
    for name, data in refused.items():
        with open(os.path.join(refused_dir, name), "wb") as f:
            f.write(data)
    with open(os.path.join(HERE, os.pardir, "bmp", "image.bmp"), "wb") as f:
        f.write(cv2.imencode(".bmp", small)[1].tobytes())
    with open(os.path.join(HERE, os.pardir, "webp", "lossless",
                           "imencode_45x37.webp"), "wb") as f:
        f.write(cv2.imencode(".webp", small)[1].tobytes())


# a COLMAP model's image names -> the fixtures they are copied from
CONVERSION = {"img0.jpg": "jpeg/odd_101x203_q95.jpg",
              "img1.JPG": "jpeg/420_q95.jpg",
              "img2.png": "png/type3.png", "img3.png": "png/exif6.png"}


def write_conversion_fixtures() -> None:
    folder = os.path.join(PNG_DIR, "conversion")
    os.makedirs(folder, exist_ok=True)
    data_dir = os.path.dirname(HERE)
    for i, src in enumerate(list(CONVERSION.values())[1:], 1):
        img = cv2.imread(os.path.join(data_dir, src))
        ok, buf = cv2.imencode(".jpg", img, [Q, 95])
        assert ok
        with open(os.path.join(folder, f"{i:08d}.jpg"), "wb") as f:
            f.write(buf.tobytes())


def write_ycck_hashes() -> None:
    """conversion/cv2.json: the sha-256 of conversion/ycck_3200x2130.jpg
    (written on the card by make_ycck_source.py), of cv2.imread's grey and
    BGR arrays of it (their bytes, row-major) and of the workspace image
    the JAX converter writes of it, cv2.imwrite(dst, cv2.imread(src))."""
    import hashlib
    import json

    path = os.path.join(HERE, "conversion", "ycck_3200x2130.jpg")
    with open(path, "rb") as f:
        data = f.read()
    sha = lambda b: hashlib.sha256(b).hexdigest()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    ok, ws = cv2.imencode(".jpg", bgr)
    assert ok
    out = os.path.join(HERE, "conversion", "cv2.json")
    with open(out) as f:  # make_arith_lossless.py's entries stay
        record = json.load(f)
    record.update({"source_sha256": sha(data),
                   "gray_sha256": sha(cv2.imread(
                       path, cv2.IMREAD_GRAYSCALE).tobytes()),
                   "bgr_sha256": sha(bgr.tobytes()),
                   "workspace_sha256": sha(ws.tobytes())})
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")


def write_decode_fixtures() -> None:
    """layouts/, the new files of refused/ and cv2_arrays.npz."""
    def read(name):
        with open(os.path.join(HERE, f"{name}.jpg"), "rb") as f:
            return f.read()

    made = {"layouts": {**layouts(read("420_q95"), read("odd_101x203_q95")),
                        **components()},
            "refused": stays_refused(read("420_q95"))}
    arrays = {}
    for sub, files in made.items():
        os.makedirs(os.path.join(HERE, sub), exist_ok=True)
        for name, data in files.items():
            with open(os.path.join(HERE, sub, f"{name}.jpg"), "wb") as f:
                f.write(data)
    for sub in ("layouts", "refused"):
        for name in sorted(os.listdir(os.path.join(HERE, sub))):
            stem = f"{sub}/{name[:-4]}"
            if stem[8:] in made["refused"]:
                continue
            path = os.path.join(HERE, sub, name)
            arrays[f"gray_{stem}"] = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            arrays[f"bgr_{stem}"] = cv2.imread(path, cv2.IMREAD_COLOR)
    np.savez_compressed(os.path.join(HERE, "cv2_arrays.npz"), **arrays)


def write_first_fixtures() -> None:
    arrays = {}
    for i, (name, ((h, w), flags)) in enumerate(FIXTURES.items()):
        img = picture(h, w, seed=i)
        if name.startswith("gray"):
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        path = os.path.join(HERE, f"{name}.jpg")
        assert cv2.imwrite(path, img, flags)
        arrays[f"gray_{name}"] = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        arrays[f"bgr_{name}"] = cv2.imread(path, cv2.IMREAD_COLOR)
    np.savez_compressed(os.path.join(HERE, "decoded.npz"), **arrays)
    with open(os.path.join(HERE, "420_q95.jpg"), "rb") as f420, \
            open(os.path.join(HERE, "444_q100.jpg"), "rb") as f444:
        made = refused(f420.read(), f444.read())
    os.makedirs(os.path.join(HERE, "refused"), exist_ok=True)
    for name, data in made.items():
        with open(os.path.join(HERE, "refused", f"{name}.jpg"), "wb") as f:
            f.write(data)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "new"), default="all")
    if ap.parse_args().part == "all":
        write_first_fixtures()
    write_decode_fixtures()
    write_ycck_hashes()
    write_encode_fixtures()
    write_png_fixtures()
    write_conversion_fixtures()


if __name__ == "__main__":
    main()
