"""Write the TIFF fixtures of tests/test_torch_raster.py and chip_smoke.py.

    python tests/data/tiff/make_fixtures.py

Each ``<name>.tif`` is one image of at most 256x256, assembled field by
field by ``tiff_file.py`` (layouts that cv2.imencode and PIL cannot write:
tiles, BigTIFF, planar configuration 2, min-is-white, 16-bit colour maps,
predictor 2 on 16-bit samples), written by PIL (``pil_*``) or by
cv2.imencode (``image.tif``). ``cv2_arrays.npz`` holds ``cv2.imdecode``'s
grey (``gray_<name>``, IMREAD_GRAYSCALE) and BGR (``bgr_<name>``,
IMREAD_COLOR) arrays of each, the target of the card's TIFF reader. They
are ``cv2.imread``'s of the file too, but for the 14 files of orientations
5 to 8 (``orient5_lzw.tif`` to ``orient8_tiles_lzw.tif``,
``orient7_grey1_tiles_lzw.tif``, ``cmyk8_inkset1_packbits_orient6.tif``,
``jpeg_ycbcr22_orient6.tif``, ``jpeg_ycbcr22_tiles_orient7.tif``,
``ycbcr22_notag_orient8.tif``, ``lab16_mm_deflate_pred2_orient6.tif``), on
which cv2 5.0.0's ``imread`` fails in both modes (an internal assertion):
a fault of that cv2, not copied, so ``imdecode`` is their oracle. The
``short_none_*`` files (``--part short``), uncompressed strips cut short,
whose read depends on how libtiff opens the file, hold ``cv2.imread``'s
arrays of the file.

The cases: strips (RowsPerStrip dividing the height or not) and tiles
(overhanging the edges), planar configurations 1 and 2, compressions 1, 5,
8, 32946 and 32773, predictor 2 on 8 and 16 bits, both byte orders and
BigTIFF; min-is-black and min-is-white at 1, 8 and 16 bits; RGB at 8 and 16
bits; 8-bit CMYK (libtiff's RGBA rule); palettes of 1, 4 and 8 bits with
8- and 16-bit colour maps (libtiff
takes a map whose entries are all below 256 for 8-bit); alpha, associated,
unassociated (which libtiff premultiplies) and unspecified; FillOrder 2;
40 private tags besides the image's own;
orientations 2..8 on strips and tiles; all 65,536 16-bit values in the grey
and RGB ``*_all`` images.

JPEG-compressed TIFFs (``jpeg_*``, and ``pil_jpeg``, Pillow's, once
``refused/jpeg``): each strip or tile a ``cv2.imencode`` stream of its own,
abbreviated with one JPEGTables tag or whole; strips and tiles of odd image
sizes, Photometric YCbCr at subsampling (2, 2), (2, 1) and (1, 1) (and
without the tag, which libtiff takes from the first frame), RGB (4:4:4
streams, components as they are) and grey, a restart interval,
orientations on strips and on tiles (libtiff mirrors each tile on its
own), strips 1 and 2 chroma samples wide, and a last strip coded at full
height. YCbCr TIFFs (``ycbcr*``, and ``pil_ycbcr``, once ``refused/ycbcr``):
libtiff's data units at every subsampling its RGBA reader takes, at sizes
that are not multiples of the unit, uncompressed, LZW, Deflate and
PackBits, strips and tiles, planar at (1, 1), without the subsampling tag,
and with a ReferenceBlackWhite and YCbCrCoefficients of their own. Signed
samples (``signed*``, negative values; SampleFormat 2) at 8 and 16 bits,
grey and RGB, which cv2 reads as the unsigned samples of the same bits.

``refused/`` holds TIFFs the card refuses, each for a cause it names:
old-style JPEG (Compression 6), float and 32-bit integer (PIL),
predictor 3, 2-bit grey, 4-bit grey,
12-bit grey, 16-bit palette and 1-bit RGB (of which cv2 reads none of the
last five into an 8-bit image either), and separated samples cv2 does not
read either: 16-bit CMYK, InkSet 2, CMYK with an alpha sample and three
samples; and what libtiff refuses too: an RGB JPEG TIFF of 4:2:0 streams,
a JPEG stream taller than its strip, a 12-bit JPEG stream, YCbCr at
subsampling (2, 4), planar and subsampled, with an extra sample, and
uncompressed subsampled tiles under a mirroring orientation. CMYK itself
(8-bit, InkSet 1, four samples) reads: ``pil_cmyk`` (once
``refused/cmyk``) and ``cmyk8_*``, contiguous and planar, over every
compression, with an explicit InkSet and an orientation.

    python tests/data/tiff/make_fixtures.py --part new

writes only the files of the JPEG, YCbCr and signed cases and the
refusals that go with them, adding their arrays to ``cv2_arrays.npz``;
``--part conversion`` writes ``conversion/plane_3200x2130_jpeg.tif``
(chip_smoke.py's phase 8d source) and its ``conversion/cv2.json``.

    python tests/data/tiff/make_fixtures.py --part rare

writes the rarer TIFFs' fixtures only (:func:`rare_fixtures`: CIELab at 8
and 16 bits, old-style LZW, compressed strips and tiles cut short, and the
refusals of :func:`rare_refused`), adding their arrays to
``cv2_arrays.npz``, and cv2's hashes of chip_smoke.py phase 8f's run-time
CIELab and old-style LZW TIFFs to ``conversion/cv2.json``.
"""

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from tiff_file import (LONG, RATIONAL, SHORT, UNDEFINED,  # noqa: E402
                       cut_chunk,
                       rare_conversion_sources, tags_of, tiff_bytes)

DATA = os.path.dirname(HERE)


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth RGB fields with sharp-edged blocks and faint noise."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(
        np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    img = img.astype(np.int64)
    for _ in range(3):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        img[y0:y0 + h // 4, x0:x0 + w // 4] = rng.integers(0, 256, 3)
    img += rng.integers(-3, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def all16() -> np.ndarray:
    """(256, 256, 3) uint16: every 16-bit value once in each channel."""
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    return np.stack([v, v[::-1, ::-1], v.T], -1)


def cmyk_of(rgb: np.ndarray, rng) -> np.ndarray:
    """(H, W, 4) uint8 CMYK of RGB: C, M, Y the inverted colours, less a
    random black, and the black."""
    k = rng.integers(0, 160, rgb.shape[:2] + (1,))
    return np.concatenate([np.clip(255 - rgb.astype(np.int64) - k, 0, 255),
                           k], -1).astype(np.uint8)


def pil_bytes(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def fixtures():
    rgb = picture(37, 45, 1)
    grey = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    rng = np.random.default_rng(7)
    alpha = rng.integers(0, 256, (37, 45, 1)).astype(np.uint8)
    rgb16 = rgb.astype(np.uint16) * 257 + rng.integers(0, 257, rgb.shape
                                                       ).astype(np.uint16)
    idx8 = rng.integers(0, 256, (37, 45)).astype(np.uint8)
    idx4 = (idx8 % 16).astype(np.uint8)
    idx1 = (grey > 127).astype(np.uint8)
    map16 = rng.integers(0, 65536, (3, 256)).astype(np.uint16)
    map8 = rng.integers(0, 256, (3, 256)).astype(np.uint16)
    a16 = all16()
    cmyk = cmyk_of(rgb, np.random.default_rng(9))
    f = {
        "rgb8_none": tiff_bytes(rgb),
        "rgb8_lzw_pred2_strips5_mm": tiff_bytes(
            rgb, compression=5, predictor=2, rows_per_strip=5, big=True),
        "rgb8_lzw_tiles": tiff_bytes(rgb, compression=5, tile=(16, 16),
                                     pad=255),
        "rgb8_deflate_tiles_planar2_pred2": tiff_bytes(
            rgb, compression=8, predictor=2, tile=(16, 32), planar=2),
        "rgb8_packbits_planar2_mm": tiff_bytes(
            rgb, compression=32773, planar=2, big=True, rows_per_strip=8),
        "rgb8_adobe_deflate": tiff_bytes(rgb, compression=32946,
                                         rows_per_strip=16),
        "rgb8_bigtiff_lzw": tiff_bytes(rgb, compression=5, bigtiff=True,
                                       rows_per_strip=7),
        "rgb8_bigtiff_mm_tiles_pred2": tiff_bytes(
            rgb, compression=5, predictor=2, bigtiff=True, big=True,
            tile=(32, 16)),
        "rgb8_fillorder2_lzw": tiff_bytes(rgb, compression=5, fill_order=2),
        "rgb16_all_lzw_pred2": tiff_bytes(a16, compression=5, predictor=2,
                                          rows_per_strip=40),
        "rgb16_all_mm_planar2_deflate_pred2": tiff_bytes(
            a16, compression=8, predictor=2, planar=2, big=True,
            tile=(64, 48)),
        "rgb16_packbits": tiff_bytes(rgb16, compression=32773),
        "grey16_all_mm_lzw_pred2": tiff_bytes(a16[..., 0], photometric=1,
                                              compression=5, predictor=2,
                                              big=True),
        "grey16_miniswhite_packbits": tiff_bytes(
            rgb16[..., 2], photometric=0, compression=32773,
            rows_per_strip=10),
        "grey8_miniswhite_lzw": tiff_bytes(grey, photometric=0,
                                           compression=5),
        "grey8_tiles_deflate_pred2": tiff_bytes(
            grey, photometric=1, compression=8, predictor=2, tile=(16, 16)),
        "grey1_packbits": tiff_bytes(idx1, bits=1, photometric=1,
                                     compression=32773),
        "grey1_miniswhite_none_mm": tiff_bytes(idx1, bits=1, photometric=0,
                                               big=True, rows_per_strip=6),
        "grey1_tiles_lzw": tiff_bytes(idx1, bits=1, photometric=1,
                                      compression=5, tile=(16, 16)),
        "palette8_map16_lzw": tiff_bytes(idx8, photometric=3,
                                         compression=5, colormap=map16),
        "palette8_map8_none_mm": tiff_bytes(idx8, photometric=3,
                                            colormap=map8, big=True),
        "palette4_map16_packbits": tiff_bytes(
            idx4, bits=4, photometric=3, compression=32773,
            colormap=map16[:, :16]),
        "palette4_map8_tiles_lzw": tiff_bytes(
            idx4, bits=4, photometric=3, compression=5, tile=(16, 16),
            colormap=map8[:, :16]),
        "palette1_map8_deflate": tiff_bytes(
            idx1, bits=1, photometric=3, compression=8,
            colormap=map8[:, :2]),
        "rgba8_unassociated_lzw": tiff_bytes(
            np.concatenate([rgb, alpha], -1), compression=5,
            extra_samples=(2,)),
        "rgba8_associated_planar2": tiff_bytes(
            np.concatenate([rgb, alpha], -1), extra_samples=(1,), planar=2),
        "rgba8_unspecified_mm": tiff_bytes(
            np.concatenate([rgb, alpha], -1), extra_samples=(0,), big=True),
        "rgba16_unassociated_planar2_deflate": tiff_bytes(
            np.concatenate([rgb16, alpha.astype(np.uint16) * 257], -1),
            compression=8, extra_samples=(2,), planar=2),
        "greyalpha8_unassociated": tiff_bytes(
            np.concatenate([grey[..., None], alpha], -1), photometric=1,
            extra_samples=(2,), compression=5),
        "greyalpha16_mm": tiff_bytes(
            np.concatenate([rgb16[..., :1], rgb16[..., 1:2]], -1),
            photometric=1, extra_samples=(0,), big=True),
        # 40 private tags beyond the reader's own (it keeps only those)
        "rgb8_many_tags": tiff_bytes(rgb, compression=5, extra_tags={
            40000 + k: (3, [k, k, k]) for k in range(40)}),
        "pil_lzw": pil_bytes(Image.fromarray(rgb), compression="tiff_lzw"),
        "pil_deflate": pil_bytes(Image.fromarray(rgb),
                                 compression="tiff_adobe_deflate"),
        "pil_grey16": pil_bytes(Image.fromarray(rgb16[..., 1])),
        "image": cv2.imencode(".tif", rgb[..., ::-1])[1].tobytes(),
        # 8-bit CMYK, which libtiff's RGBA reader converts for cv2
        "pil_cmyk": pil_bytes(Image.fromarray(picture(21, 27, 2)).convert(
            "CMYK")),
        "cmyk8_none": tiff_bytes(cmyk, photometric=5),
        "cmyk8_lzw_pred2_strips7": tiff_bytes(
            cmyk, photometric=5, compression=5, predictor=2,
            rows_per_strip=7),
        "cmyk8_planar2_lzw": tiff_bytes(cmyk, photometric=5, compression=5,
                                        planar=2),
        "cmyk8_planar2_none_mm": tiff_bytes(cmyk, photometric=5, planar=2,
                                            big=True, rows_per_strip=9),
        "cmyk8_tiles_deflate": tiff_bytes(cmyk, photometric=5,
                                          compression=8, tile=(16, 16)),
        "cmyk8_inkset1_packbits_orient6": tiff_bytes(
            cmyk, photometric=5, compression=32773, orientation=6,
            extra_tags={332: (3, [1])}),
    }
    for o in range(2, 9):
        f[f"orient{o}_lzw"] = tiff_bytes(rgb, compression=5, orientation=o,
                                         rows_per_strip=9)
        f[f"orient{o}_tiles_lzw"] = tiff_bytes(
            rgb, compression=5, orientation=o, tile=(16, 16))
    f["orient2_tiles_planar2_deflate"] = tiff_bytes(
        rgb, compression=8, orientation=2, tile=(16, 32), planar=2)
    f["orient7_grey1_tiles_lzw"] = tiff_bytes(
        idx1, bits=1, photometric=1, compression=5, orientation=7,
        tile=(16, 16))
    return f


def refused():
    rgb = picture(21, 27, 2)
    grey = rgb[..., 1]
    rng = np.random.default_rng(8)
    cmyk = cmyk_of(rgb, np.random.default_rng(9))
    return {
        "float": pil_bytes(Image.fromarray(grey.astype(np.float32))),
        "int32": pil_bytes(Image.fromarray(grey.astype(np.int32))),
        "predictor3": tiff_bytes(grey.astype(np.uint16), photometric=1,
                                 compression=8, extra_tags={317: (3, [3])}),
        # separated samples cv2 does not read: 16-bit, another InkSet, an
        # extra (alpha) sample, three samples
        "cmyk16": tiff_bytes(cmyk.astype(np.uint16) * 257, photometric=5),
        "inkset2": tiff_bytes(cmyk, photometric=5,
                              extra_tags={332: (3, [2])}),
        "cmyk_alpha": tiff_bytes(np.concatenate(
            [cmyk, cmyk[..., :1]], -1), photometric=5, extra_samples=(2,)),
        "cmyk3": tiff_bytes(cmyk[..., :3], photometric=5),
        "grey2": tiff_bytes((grey >> 6).astype(np.uint8), bits=2,
                            photometric=1),
        "grey4": tiff_bytes((grey >> 4).astype(np.uint8), bits=4,
                            photometric=1),
        "grey12": tiff_bytes(grey.astype(np.uint16), photometric=1,
                             extra_tags={258: (3, [12])}),
        # a 16-bit palette with its full colour map (65,536 entries a
        # colour), which cv2 refuses too
        "palette16": tiff_bytes(rng.integers(0, 65536, grey.shape).astype(
            np.uint16), photometric=3, colormap=rng.integers(
            0, 65536, (3, 65536)).astype(np.uint16)),
        "rgb1": tiff_bytes((rgb > 127).astype(np.uint8), bits=1),
    }


def jpeg_stream(img: np.ndarray, quality: int = 75, sampling=None,
                restart: int = 0) -> bytes:
    """cv2.imencode's JPEG of a BGR or grey image."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    return cv2.imencode(".jpg", img, params)[1].tobytes()


def split_tables(stream: bytes):
    """(tables, abbreviated): a JPEG's DQT and DHT segments as a
    tables-only stream (SOI, tables, EOI: a JPEGTables tag), and the stream
    without them."""
    pos, keep, tables = 2, [b"\xff\xd8"], [b"\xff\xd8"]
    while stream[pos + 1] != 0xDA:
        n = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        (tables if stream[pos + 1] in (0xDB, 0xC4) else keep).append(
            stream[pos:pos + 2 + n])
        pos += 2 + n
    return b"".join(tables) + b"\xff\xd9", b"".join(keep) + stream[pos:]


def jpeg_tiff(bgr: np.ndarray, photometric: int = 6, rows: int = 16,
              tile=None, sub=(2, 2), tag530: bool = True,
              abbreviated: bool = True, sampling=None, restart: int = 0,
              orientation: int = None, last_rows: int = None,
              quality: int = 75, frame_rows: dict = None,
              cut: dict = None) -> bytes:
    """A JPEG-compressed TIFF (Compression 7) of a BGR (or, Photometric 1,
    grey) image: strips of ``rows`` rows or ``tile`` (width, length)
    tiles, each cv2.imencode's stream of its pixels (tiles padded with
    zeros), abbreviated under one JPEGTables tag or whole. Photometric 2
    streams are coded so that their Y, Cb, Cr are about the image's R, G,
    B: the components libtiff hands on as they are.
    ``last_rows``: the last strip's stream coded at that many rows (the
    image's rows, then zeros). ``frame_rows`` {chunk: rows}: those chunks'
    streams coded at their first rows only; ``cut`` {chunk: bytes}: those
    streams cut to their first bytes (the byte count set so)."""
    H, W = bgr.shape[:2]
    if tile:
        tw, th = tile
        full = np.zeros((-(-H // th) * th, -(-W // tw) * tw) + bgr.shape[2:],
                        np.uint8)
        full[:H, :W] = bgr
        parts = [full[y:y + th, x:x + tw] for y in range(0, H, th)
                 for x in range(0, W, tw)]
    else:
        parts = [bgr[y:y + rows] for y in range(0, H, rows)]
        if last_rows:
            last = np.zeros((last_rows,) + bgr.shape[1:], np.uint8)
            last[:len(parts[-1])] = parts[-1]
            parts[-1] = last
    if photometric == 2:  # the streams' Y, Cb, Cr are the R, G, B samples
        parts = [cv2.cvtColor(np.ascontiguousarray(p[..., [2, 0, 1]]),
                              cv2.COLOR_YCrCb2BGR) for p in parts]
    chunks, tables = [], None
    for i, p in enumerate(parts):
        if frame_rows and i in frame_rows:
            p = p[:frame_rows[i]]
        stream = jpeg_stream(p, quality, sampling, restart)
        if abbreviated:
            tables, stream = split_tables(stream)
        if cut and i in cut:
            stream = stream[:cut[i]]
        chunks.append(stream)
    tags = {}
    if tables:
        tags[347] = (UNDEFINED, list(tables))
    if photometric == 6 and tag530:
        tags[530] = (SHORT, list(sub))
    samples = bgr[..., ::-1].copy() if bgr.ndim == 3 else bgr
    layout = dict(tile=tile) if tile else dict(rows_per_strip=rows)
    return tiff_bytes(samples, photometric=photometric, compression=7,
                      chunks=chunks, extra_tags=tags,
                      orientation=orientation, **layout)


def ycbcr_units(y, cb, cr, hs: int, vs: int) -> np.ndarray:
    """libtiff's data units of Y (H, W) and chroma (ceil(H / vs),
    ceil(W / hs)): per unit hs vs Y samples (edge units padded with
    zeros), then Cb, then Cr; one row of units per vs image rows."""
    H, W = y.shape
    hu, wu = -(-H // vs), -(-W // hs)
    yp = np.zeros((hu * vs, wu * hs), np.uint8)
    yp[:H, :W] = y
    units = yp.reshape(hu, vs, wu, hs).transpose(0, 2, 1, 3).reshape(
        hu, wu, hs * vs)
    return np.concatenate([units, cb[..., None], cr[..., None]],
                          -1).reshape(hu, -1)


def ycbcr_tiff(y, cb, cr, hs: int, vs: int, rows: int = None, tile=None,
               compression: int = 1, tag530: bool = True, extra=None,
               orientation: int = None) -> bytes:
    """An uncompressed or losslessly compressed YCbCr TIFF of libtiff's
    data units, in strips of ``rows`` rows or ``tile`` tiles."""
    H, W = y.shape
    tags = {530: (SHORT, [hs, vs])} if tag530 else {}
    tags.update(extra or {})
    if tile:
        tw, th = tile
        hp, wp = -(-H // th) * th, -(-W // tw) * tw
        full = [np.zeros((hp // d, wp // e), np.uint8)
                for d, e in ((1, 1), (vs, hs), (vs, hs))]
        for f, p in zip(full, (y, cb, cr)):
            f[:p.shape[0], :p.shape[1]] = p
        chunks = [ycbcr_units(full[0][ty:ty + th, tx:tx + tw],
                              full[1][ty // vs:(ty + th) // vs,
                                      tx // hs:(tx + tw) // hs],
                              full[2][ty // vs:(ty + th) // vs,
                                      tx // hs:(tx + tw) // hs],
                              hs, vs).tobytes()
                  for ty in range(0, H, th) for tx in range(0, W, tw)]
        layout = dict(tile=tile)
    else:
        rows = rows or H
        units = ycbcr_units(y, cb, cr, hs, vs)
        chunks = [units[r // vs:(r + rows) // vs if r + rows < H else None
                        ].tobytes() for r in range(0, H, rows)]
        layout = dict(rows_per_strip=rows)
    return tiff_bytes(np.zeros((H, W, 3), np.uint8), photometric=6,
                      compression=compression, chunks=chunks,
                      extra_tags=tags, orientation=orientation, **layout)


def rationals(values, den: int):
    """RATIONAL values of a tag: (numerator, denominator) pairs, flat."""
    return [v for x in values for v in (int(round(x * den)), den)]


def new_fixtures():
    """The JPEG-compressed, YCbCr and signed TIFFs."""
    bgr = picture(37, 45, 3)[..., ::-1].copy()
    grey = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    s444 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444
    s422 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422
    rng = np.random.default_rng(17)
    f = {
        "jpeg_ycbcr22_strips16_tables": jpeg_tiff(bgr),
        "jpeg_ycbcr22_strips8_whole": jpeg_tiff(bgr, rows=8,
                                                abbreviated=False),
        "jpeg_ycbcr21_tiles_tables": jpeg_tiff(bgr, tile=(16, 16),
                                               sub=(2, 1), sampling=s422),
        "jpeg_ycbcr11_strips16_q90": jpeg_tiff(bgr, sub=(1, 1),
                                               sampling=s444, quality=90),
        "jpeg_ycbcr21_strips16_notag": jpeg_tiff(bgr, tag530=False,
                                                 sampling=s422),
        "jpeg_rgb_strips16_tables": jpeg_tiff(bgr, photometric=2,
                                              sampling=s444),
        "jpeg_grey_tiles32x16": jpeg_tiff(grey, photometric=1,
                                          tile=(32, 16)),
        "jpeg_ycbcr22_restart": jpeg_tiff(bgr, rows=32, restart=2),
        "jpeg_ycbcr22_orient6": jpeg_tiff(bgr, orientation=6),
        "jpeg_ycbcr22_tiles_orient7": jpeg_tiff(bgr, tile=(16, 16),
                                                orientation=7),
        "jpeg_ycbcr22_tiles_orient2": jpeg_tiff(bgr, tile=(32, 16),
                                                orientation=2),
        "jpeg_ycbcr22_width3": jpeg_tiff(bgr[:, :3].copy()),
        "jpeg_ycbcr22_width2": jpeg_tiff(bgr[:, :2].copy(), rows=8),
        "jpeg_ycbcr22_last_strip_tall": jpeg_tiff(bgr, last_rows=16),
        "pil_jpeg": pil_bytes(Image.fromarray(picture(21, 27, 2)),
                              compression="jpeg"),
        "pil_ycbcr": pil_bytes(Image.fromarray(picture(21, 27, 2)).convert(
            "YCbCr")),
    }
    H, W = 37, 45
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    for (hs, vs), comp, rows in (((1, 1), 1, None), ((2, 1), 5, 8),
                                 ((2, 2), 8, 8), ((4, 1), 32773, 5),
                                 ((4, 2), 1, 6), ((4, 4), 5, 12),
                                 ((1, 2), 32946, 10)):
        cb, cr = rng.integers(0, 256, (2, -(-H // vs), -(-W // hs))).astype(
            np.uint8)
        name = {1: "none", 5: "lzw", 8: "deflate", 32773: "packbits",
                32946: "adobe_deflate"}[comp]
        f[f"ycbcr{hs}{vs}_{name}"] = ycbcr_tiff(y, cb, cr, hs, vs, rows,
                                                compression=comp)
    cb, cr = rng.integers(0, 256, (2, 19, 23)).astype(np.uint8)
    f["ycbcr22_tiles_lzw"] = ycbcr_tiff(y, cb, cr, 2, 2, tile=(16, 16),
                                        compression=5)
    f["ycbcr22_notag_orient8"] = ycbcr_tiff(y, cb, cr, 2, 2, tag530=False,
                                            orientation=8)
    f["ycbcr22_refbw_luma"] = ycbcr_tiff(y, cb, cr, 2, 2, extra={
        532: (RATIONAL, rationals((16, 235, 128, 240, 100.5, 220.25), 4)),
        529: (RATIONAL, rationals((0.2126, 0.7152, 0.0722), 8192))})
    f["ycbcr11_planar2_lzw"] = tiff_bytes(
        rng.integers(0, 256, (H, W, 3)).astype(np.uint8), photometric=6,
        planar=2, compression=5, extra_tags={530: (SHORT, [1, 1])})
    s16 = rng.integers(-32768, 32768, (H, W, 3)).astype(np.int16)
    s8 = rng.integers(-128, 128, (H, W, 3)).astype(np.int8)
    f["signed8_grey"] = tiff_bytes(s8[..., 0].view(np.uint8),
                                   photometric=1, sample_format=2)
    f["signed8_rgb_lzw"] = tiff_bytes(s8.view(np.uint8), compression=5,
                                      sample_format=2)
    f["signed16_grey_packbits_mm"] = tiff_bytes(
        s16[..., 0].view(np.uint16), photometric=1, compression=32773,
        sample_format=2, big=True)
    f["signed16_rgb_planar2_deflate"] = tiff_bytes(
        s16.view(np.uint16), planar=2, compression=8, sample_format=2)
    return f


def new_refused():
    """What libtiff (so cv2) refuses of the new layouts, and an old-style
    JPEG TIFF (Compression 6, made only to be refused)."""
    bgr = picture(21, 27, 2)[..., ::-1].copy()
    rng = np.random.default_rng(18)
    with open(os.path.join(DATA, "jpeg", "refused", "twelve_bit.jpg"),
              "rb") as fh:
        twelve = fh.read()
    y = rng.integers(0, 256, (21, 27)).astype(np.uint8)
    cb, cr = rng.integers(0, 256, (2, 11, 14)).astype(np.uint8)
    return {
        "old_jpeg": tiff_bytes(bgr[..., ::-1].copy(), photometric=6,
                               compression=6, chunks=[jpeg_stream(bgr)],
                               extra_tags={530: (SHORT, [2, 2])}),
        "jpeg_rgb420": jpeg_tiff(bgr, photometric=2),
        "jpeg_strip_taller": _taller_strip(bgr),
        "jpeg12": tiff_bytes(np.zeros((48, 64, 3), np.uint8),
                             photometric=6, compression=7, chunks=[twelve],
                             extra_tags={530: (SHORT, [1, 1])}),
        "ycbcr24": ycbcr_tiff(y, rng.integers(0, 256, (6, 14)).astype(
            np.uint8), rng.integers(0, 256, (6, 14)).astype(np.uint8), 2, 4),
        "ycbcr22_planar2": tiff_bytes(
            rng.integers(0, 256, (21, 27, 3)).astype(np.uint8),
            photometric=6, planar=2, extra_tags={530: (SHORT, [2, 2])}),
        "ycbcr11_alpha": tiff_bytes(
            rng.integers(0, 256, (21, 27, 4)).astype(np.uint8),
            photometric=6, extra_samples=(0,),
            extra_tags={530: (SHORT, [1, 1])}),
        "ycbcr22_tiles_orient2": ycbcr_tiff(y, cb, cr, 2, 2, tile=(16, 16),
                                            orientation=2),
    }


def _taller_strip(bgr: np.ndarray) -> bytes:
    """A JPEG TIFF of 8-row strips whose second strip's stream is 16 rows
    tall: libtiff's "JPEG strip/tile size exceeds expected dimensions"."""
    H, W = bgr.shape[:2]
    parts = [bgr[y:y + 8] for y in range(0, H, 8)]
    parts[1] = bgr[8:24]
    chunks, tables = [], None
    for p in parts:
        tables, stream = split_tables(jpeg_stream(p))
        chunks.append(stream)
    return tiff_bytes(bgr[..., ::-1].copy(), photometric=6, compression=7,
                      chunks=chunks, rows_per_strip=8,
                      extra_tags={347: (UNDEFINED, list(tables)),
                                  530: (SHORT, [2, 2])})


def _lab(rgb: np.ndarray) -> np.ndarray:
    """8-bit L*, a*, b* samples of an RGB picture (a* and b* as signed
    bytes' bits)."""
    return np.asarray(Image.fromarray(rgb).convert("LAB"))


def _short(data: bytes, index: int = -1, keep: float = 2 / 3) -> bytes:
    """``data`` with strip or tile ``index`` cut to ``keep`` of its bytes
    (the last: the file cut short there)."""
    t = tags_of(data)
    counts = t[325 if 325 in t else 279]
    index %= len(counts)
    return cut_chunk(data, index, int(counts[index] * keep))


def rare_fixtures():
    """CIELab TIFFs at 8 and 16 bits (libtiff's RGBA reader converts them
    for cv2), old-style LZW, and compressed strips and tiles cut short
    (libtiff reads what they hold, zero-fills the rest and skips their
    predictor and byte swap)."""
    rgb = picture(21, 27, 2)
    big = picture(96, 128, 23)
    lab = _lab(picture(37, 53, 20))
    rng = np.random.default_rng(21)
    lab16 = rng.integers(0, 65536, (29, 35, 3)).astype(np.uint16)
    lab16[..., 0] = np.linspace(0, 65535, 35).astype(np.uint16)
    grey16 = (picture(33, 41, 22)[..., 0].astype(np.uint16) * 257 +
              rng.integers(0, 256, (33, 41)).astype(np.uint16))
    d65 = {318: (RATIONAL, [3127, 10000, 3290, 10000])}
    return {
        # Pillow's CIELab, once refused/lab
        "pil_lab": pil_bytes(Image.fromarray(rgb).convert("LAB")),
        "lab8_strips5": tiff_bytes(lab, photometric=8, rows_per_strip=5),
        "lab8_lzw_pred2": tiff_bytes(lab, photometric=8, compression=5,
                                     predictor=2),
        "lab8_tiles_deflate": tiff_bytes(lab, photometric=8, compression=8,
                                         tile=(16, 16)),
        "lab8_whitepoint_d65": tiff_bytes(lab, photometric=8,
                                          extra_tags=d65),
        "lab8_signed_packbits_mm": tiff_bytes(lab, photometric=8,
                                              compression=32773, big=True,
                                              sample_format=2),
        "lab16": tiff_bytes(lab16, photometric=8),
        "lab16_mm_deflate_pred2_orient6": tiff_bytes(
            lab16, photometric=8, compression=8, predictor=2, big=True,
            orientation=6),
        # old-style LZW: once refused/old_lzw; strips and tiles, a
        # predictor, and an image long enough for 12-bit codes and Clear
        "old_lzw": tiff_bytes(rgb, compression=5, old_lzw=True),
        "old_lzw_strips7_pred2": tiff_bytes(rgb, compression=5,
                                            old_lzw=True, predictor=2,
                                            rows_per_strip=7),
        "old_lzw_tiles_grey16_mm": tiff_bytes(grey16, photometric=1,
                                              compression=5, old_lzw=True,
                                              tile=(16, 16), big=True),
        "old_lzw_96x128": tiff_bytes(big, compression=5, old_lzw=True),
        "old_lzw_lab8": tiff_bytes(lab, photometric=8, compression=5,
                                   old_lzw=True),
        # compressed strips and tiles whose data ends before their rows
        "short_lzw": _short(tiff_bytes(rgb, compression=5)),
        "short_lzw_pred2_grey16_mm": _short(tiff_bytes(
            grey16, photometric=1, compression=5, predictor=2, big=True)),
        "short_deflate_pred2": _short(tiff_bytes(rgb, compression=8,
                                                 predictor=2)),
        "short_packbits_grey8": _short(tiff_bytes(
            rgb[..., 1], photometric=1, compression=32773), keep=1 / 2),
        "short_lzw_first_of_3_strips": _short(tiff_bytes(
            big, compression=5, rows_per_strip=40), index=0, keep=1 / 2),
        "short_deflate_tile": _short(tiff_bytes(
            big, compression=8, tile=(32, 48)), index=4, keep=1 / 3),
        "short_packbits_planar2": _short(tiff_bytes(
            rgb, compression=32773, planar=2)),
        "short_old_lzw": _short(tiff_bytes(big, compression=5,
                                           old_lzw=True)),
        "short_lzw_lab16": _short(tiff_bytes(lab16, photometric=8,
                                             compression=5)),
    }


def rare_refused():
    """What stays refused of the rarer TIFFs, each for a cause named: the
    CIELab layouts libtiff's RGBA reader (so cv2) does not read, ICCLab and
    ITULab, corrupt old-style LZW data, an uncompressed strip cut short."""
    lab = _lab(picture(21, 27, 2))
    rgb = picture(21, 27, 2)
    old = tiff_bytes(rgb, compression=5, old_lzw=True)
    at = tags_of(old)[273][0]
    return {
        "icclab": tiff_bytes(lab, photometric=9),
        "itulab": tiff_bytes(lab, photometric=10),
        "lab_planar2": tiff_bytes(lab, photometric=8, planar=2),
        "lab_alpha": tiff_bytes(np.concatenate([lab, lab[..., :1]], -1),
                                photometric=8, extra_samples=(2,)),
        "lab_l_only": tiff_bytes(lab[..., 0], photometric=8),
        "lab4": tiff_bytes(lab >> 4, bits=4, photometric=8),
        # three 0xFF bytes in the codes: a code past the table (cv2 reads
        # it with libtiff's "Corrupted LZW table" error)
        "old_lzw_corrupt": old[:at + 8] + b"\xff" * 3 + old[at + 11:],
        "short_none": _short(tiff_bytes(rgb)),
    }


def write_rare() -> None:
    path = os.path.join(HERE, "cv2_arrays.npz")
    arrays = dict(np.load(path))
    made = rare_fixtures()
    t = {k: tags_of(v) for k, v in made.items()}
    assert t["lab8_whitepoint_d65"][318] == (3127, 10000, 3290, 10000)
    assert t["lab16"][258] == (16, 16, 16) and t["lab16"][262] == (8,)
    for name, data in made.items():
        at = t[name].get(273, t[name].get(324))[0]
        assert ("old_lzw" in name) == (data[at] == 0 and data[at + 1] & 1), \
            name
        with open(os.path.join(HERE, f"{name}.tif"), "wb") as fh:
            fh.write(data)
        arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = cv2_arrays(data,
                                                                   name)
    # the old-style LZW file is a real one: cv2 (libtiff) reads its pixels
    assert np.array_equal(arrays["bgr_old_lzw"],
                          picture(21, 27, 2)[..., ::-1])
    np.savez_compressed(path, **arrays)
    for name, data in rare_refused().items():
        with open(os.path.join(HERE, "refused", f"{name}.tif"), "wb") as fh:
            fh.write(data)
        buf = np.frombuffer(data, np.uint8)
        readable = name == "old_lzw_corrupt"
        assert (cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None) == \
            readable, name


def _with_count(data: bytes, index: int, count: int) -> bytes:
    """A classic little-endian TIFF with chunk ``index``'s byte count set
    to ``count``, its bytes left in place."""
    t = tags_of(data)
    tag = 325 if 325 in t else 279
    ifd = struct.unpack("<I", data[4:8])[0]
    out = bytearray(data)
    for at in range(ifd + 2, ifd + 2 + 12 * struct.unpack(
            "<H", data[ifd:ifd + 2])[0], 12):
        if struct.unpack("<H", data[at:at + 2])[0] != tag:
            continue
        typ, n = struct.unpack("<HI", data[at + 2:at + 8])
        fmt = {SHORT: "H", LONG: "I"}[typ]
        size = struct.calcsize(fmt)
        pos = at + 8 if size * n <= 4 else struct.unpack(
            "<I", data[at + 8:at + 12])[0]
        out[pos + size * index:pos + size * (index + 1)] = struct.pack(
            "<" + fmt, count)
    return bytes(out)


def short_uncompressed():
    """Uncompressed TIFFs whose strip or tile holds fewer bytes than its
    rows, among several, as cv2.imread (libtiff, the file mapped) reads
    them, and those it refuses: ({name: TIFF}, {name: refused TIFF}).

    libtiff replaces every byte count by its estimate (a whole tile, or
    H / strips rows) where there are more than two contiguous chunks whose
    first two counts differ, or one strip whose count is short of the
    image; it fails the read of a count of 0 or one past the end of the
    file, and of a tile short of its rows; a strip short of its rows reads
    as zeros (DumpModeDecode fails and the read keeps its zeroed
    buffer)."""
    rgb = picture(40, 27, 5)
    grey = rgb[..., 1].copy()
    g16 = rgb[..., 0].astype(np.uint16) * 257 + 3
    cmap = (np.arange(3 * 256).reshape(3, 256) * 85 % 65536).astype(
        np.uint16)
    strips = lambda img, **kw: tiff_bytes(img, rows_per_strip=10, **kw)
    rows7 = tiff_bytes(rgb, rows_per_strip=7)
    tiles = tiff_bytes(rgb, tile=(16, 16))
    whole = tiff_bytes(rgb)
    read = {
        # strips 2, 3: their rows read as zeros
        "short_none_strip2_of_4": _short(strips(rgb), index=2, keep=1 / 2),
        "short_none_strip3_of_4_last": _short(strips(rgb), index=3,
                                              keep=1 / 2),
        "short_none_grey_strip2_1byte": _short(strips(grey, photometric=1),
                                               index=2, keep=1 / 200),
        "short_none_miniswhite_strip3": _short(strips(
            grey, photometric=0), index=3, keep=1 / 3),
        "short_none_grey16_mm_strip2": _short(strips(
            g16, photometric=1, big=True), index=2, keep=1 / 2),
        "short_none_palette_strip2": _short(strips(
            grey, photometric=3, colormap=cmap), index=2, keep=1 / 2),
        "short_none_rgba_strip3": _short(strips(
            np.concatenate([rgb, rgb[..., :1]], -1), extra_samples=(2,)),
            index=3, keep=1 / 2),
        "short_none_planar2_strip1": _short(tiff_bytes(rgb, planar=2),
                                            index=1, keep=1 / 2),
        "short_none_two_strips_first": _short(tiff_bytes(
            rgb, rows_per_strip=20), index=0, keep=1 / 2),
        # strip 0 or 1: every count estimated, each strip's whole rows read
        "short_none_strip0_of_4_estimated": _short(strips(rgb), index=0,
                                                   keep=1 / 2),
        "short_none_tile1_estimated": _short(tiles, index=1, keep=1 / 5),
        # a single strip short of the image, its data there: estimated
        "short_none_single_strip_data_there": _with_count(
            whole + bytes(64), 0, 100),
        # 40 / 6 = 6 rows estimated for strips of 7: all but the last (of
        # 5 rows, bytes after it in the file) read as zeros
        "short_none_rows7_estimated_short": _with_count(
            rows7 + bytes(200), 1, 100),
    }
    bgr = picture(40, 48, 9)[..., ::-1]
    stream = tags_of(jpeg_tiff(bgr))[279][1]
    dht = jpeg_stream(bgr[16:32]).find(b"\xff\xc4") + 25
    read.update({
        # JPEG streams of fewer rows than their chunk: the rows past them
        # black; streams cut short, in their data or a segment
        "jpeg_short_strip1_frame10": jpeg_tiff(bgr, frame_rows={1: 10}),
        "jpeg_short_last_strip_frame4": jpeg_tiff(bgr, frame_rows={2: 4}),
        "jpeg_short_grey_strip0_frame7": jpeg_tiff(
            bgr[..., 1].copy(), photometric=1, frame_rows={0: 7}),
        "jpeg_rgb_short_strip1_frame9": jpeg_tiff(
            bgr, photometric=2, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            frame_rows={1: 9}),
        "jpeg_short_tile1_frame10": jpeg_tiff(bgr, tile=(16, 16),
                                              frame_rows={1: 10}),
        "jpeg_short_tiles_orient2_frame5": jpeg_tiff(
            bgr, tile=(16, 16), orientation=2, frame_rows={0: 5, 4: 12}),
        "jpeg_short_strip1_stream_cut": jpeg_tiff(bgr,
                                                  cut={1: stream - 100}),
        "jpeg_short_strip1_cut_after_ff": jpeg_tiff(bgr,
                                                    cut={1: stream - 1}),
    })
    refused = {
        # a stream cut before its first scan: libjpeg finds no image
        "jpeg_short_whole_strip1_cut_in_dht": jpeg_tiff(
            bgr, abbreviated=False, cut={1: dht}),
        "short_none_tile3": _short(tiles, index=3, keep=1 / 5),
        "short_none_strip2_count0": _with_count(strips(rgb), 2, 0),
        "short_none_strip3_past_end": _with_count(strips(rgb), 3, 900),
        # the estimate of the last strip (40 / 6 = 6 rows; it holds 5)
        # runs past the end of the file
        "short_none_rows7_estimate_past_end": _short(rows7, index=0,
                                                     keep=1 / 2),
    }
    return read, refused


def write_short() -> None:
    """The ``short_none_*`` fixtures of :func:`short_uncompressed`, their
    ``cv2.imread`` arrays added to ``cv2_arrays.npz``, the refused ones
    under ``refused/``."""
    path = os.path.join(HERE, "cv2_arrays.npz")
    arrays = dict(np.load(path))
    read, refused = short_uncompressed()
    for folder, made in ((HERE, read), (os.path.join(HERE, "refused"),
                                        refused)):
        for name, data in made.items():
            file = os.path.join(folder, f"{name}.tif")
            with open(file, "wb") as fh:
                fh.write(data)
            g = cv2.imread(file, cv2.IMREAD_GRAYSCALE)
            c = cv2.imread(file, cv2.IMREAD_COLOR)
            assert (g is None) == (c is None) == (folder != HERE), name
            if folder == HERE:
                arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = g, c
    np.savez_compressed(path, **arrays)


def write_rare_conversion() -> None:
    """Phase 8f's TIFFs, made here from cv2's BGR of the lossy WebP
    conversion source as the phase makes them from the card's read of it,
    and cv2's hashes of them (and of their sources' bytes) added to
    conversion/cv2.json."""
    path = os.path.join(DATA, "webp", "conversion", "plane_3200x2130.webp")
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                   ).hexdigest()
    record_path = os.path.join(HERE, "conversion", "cv2.json")
    with open(record_path) as fh:
        record = json.load(fh)
    for name, data in rare_conversion_sources(bgr).items():
        g, c = cv2_arrays(data, name)
        converted = cv2.imencode(".jpg", c)[1].tobytes()
        record[name] = {"from": "webp/conversion/plane_3200x2130.webp as "
                        "cv2 reads it, made by tiff_file."
                        "rare_conversion_sources (not committed)",
                        "source": hashlib.sha256(data).hexdigest(),
                        "gray": sha(g), "bgr": sha(c),
                        "converted": hashlib.sha256(converted).hexdigest(),
                        "shape": list(c.shape)}
    with open(record_path, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")


def cv2_arrays(data: bytes, name: str):
    buf = np.frombuffer(data, np.uint8)
    g = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    c = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    assert g is not None and c is not None, name
    return g, c


def conversion_source() -> bytes:
    """chip_smoke.py's phase 8d source: cv2's decode of the lossy WebP
    conversion source (3200x2130) as a YCbCr JPEG TIFF at subsampling
    (2, 2), strips of 16 rows, one JPEGTables tag and abbreviated streams
    (tiffcp -c jpeg -r 16's layout), each stream cv2.imencode's at quality
    75."""
    path = os.path.join(DATA, "webp", "conversion", "plane_3200x2130.webp")
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    return jpeg_tiff(bgr, rows=16)


def write_conversion() -> None:
    folder = os.path.join(HERE, "conversion")
    os.makedirs(folder, exist_ok=True)
    data = conversion_source()
    name = "plane_3200x2130_jpeg.tif"
    with open(os.path.join(folder, name), "wb") as fh:
        fh.write(data)
    g, c = cv2_arrays(data, name)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                   ).hexdigest()
    # the JAX converter's workspace image: cv2.imwrite(dst, cv2.imread(src))
    converted = cv2.imencode(".jpg", c)[1].tobytes()
    with open(os.path.join(folder, "cv2.json"), "w") as fh:
        json.dump({name: {"gray": sha(g), "bgr": sha(c),
                          "converted": hashlib.sha256(converted).hexdigest(),
                          "shape": list(c.shape)}}, fh, indent=1)
        fh.write("\n")


def _frames(data: bytes):
    """The SOF segments of every chunk's stream of a JPEG TIFF (and whether
    each holds a DRI): what a fixture's streams were coded with."""
    t = tags_of(data)
    offs, counts = t.get(273, t.get(324)), t.get(279, t.get(325))
    out = []
    for off, cnt in zip(offs, counts):
        stream = data[off:off + cnt]
        at = next(stream.find(m) for m in (b"\xff\xc0", b"\xff\xc1",
                                           b"\xff\xc2") if m in stream)
        out.append((stream[at + 5:at + 9], stream[at + 11:at + 20:3],
                    b"\xff\xdd" in stream))
    return out


def check_new(f: dict) -> None:
    """Each option of the new fixtures, in the bytes written."""
    t = {k: tags_of(v) for k, v in f.items()}
    for name, tags in t.items():
        if name.startswith("jpeg_"):
            assert tags[259] == (7,), name
            abbreviated = "whole" not in name
            assert (347 in tags) == abbreviated, name
    assert t["jpeg_ycbcr22_strips16_tables"][530] == (2, 2)
    assert t["jpeg_ycbcr21_tiles_tables"][530] == (2, 1)
    assert 322 in t["jpeg_ycbcr21_tiles_tables"]
    assert 530 not in t["jpeg_ycbcr21_strips16_notag"]
    assert t["jpeg_rgb_strips16_tables"][262] == (2,)
    assert t["jpeg_grey_tiles32x16"][262] == (1,)
    assert t["jpeg_ycbcr22_orient6"][274] == (6,)
    assert t["jpeg_ycbcr22_tiles_orient2"][274] == (2,)
    assert all(f[2] for f in _frames(f["jpeg_ycbcr22_restart"]))
    assert [s for s, _, _ in _frames(f["jpeg_ycbcr22_last_strip_tall"])][
        -1][:2] == b"\x00\x10"  # the last stream: 16 rows for 5
    assert {v for _, v, _ in _frames(f["jpeg_ycbcr21_strips16_notag"])} == {
        bytes([0x21, 0x11, 0x11])}
    for name in ("ycbcr11_none", "ycbcr21_lzw", "ycbcr22_deflate",
                 "ycbcr41_packbits", "ycbcr42_none", "ycbcr44_lzw",
                 "ycbcr12_adobe_deflate"):
        hs, vs = int(name[5]), int(name[6])
        assert t[name][530] == (hs, vs) and t[name][262] == (6,), name
    assert 530 not in t["ycbcr22_notag_orient8"]
    assert t["ycbcr22_refbw_luma"][532][::2] == (64, 940, 512, 960, 402,
                                                 881)
    assert t["ycbcr11_planar2_lzw"][284] == (2,)
    for name in ("signed8_grey", "signed8_rgb_lzw",
                 "signed16_grey_packbits_mm",
                 "signed16_rgb_planar2_deflate"):
        assert set(t[name][339]) == {2}, name


def write_new() -> None:
    path = os.path.join(HERE, "cv2_arrays.npz")
    arrays = dict(np.load(path))
    fixtures_new = new_fixtures()
    check_new(fixtures_new)
    for name, data in fixtures_new.items():
        with open(os.path.join(HERE, f"{name}.tif"), "wb") as fh:
            fh.write(data)
        arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = cv2_arrays(data,
                                                                   name)
    np.savez_compressed(path, **arrays)
    for name, data in new_refused().items():
        with open(os.path.join(HERE, "refused", f"{name}.tif"), "wb") as fh:
            fh.write(data)
        buf = np.frombuffer(data, np.uint8)
        assert cv2.imdecode(buf, cv2.IMREAD_COLOR) is None, name
        assert cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE) is None, name


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("all", "new", "rare", "short",
                                           "conversion"), default="all")
    part = parser.parse_args().part
    if part == "short":
        return write_short()
    if part == "conversion":
        return write_conversion()
    if part == "new":
        return write_new()
    if part == "rare":
        write_rare()
        return write_rare_conversion()
    arrays = {}
    for name, data in fixtures().items():
        with open(os.path.join(HERE, f"{name}.tif"), "wb") as fh:
            fh.write(data)
        buf = np.frombuffer(data, np.uint8)
        g = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        c = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        assert g is not None and c is not None, name
        arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = g, c
    np.savez_compressed(os.path.join(HERE, "cv2_arrays.npz"), **arrays)
    os.makedirs(os.path.join(HERE, "refused"), exist_ok=True)
    for name, data in refused().items():
        with open(os.path.join(HERE, "refused", f"{name}.tif"), "wb") as fh:
            fh.write(data)
    write_new()
    write_rare()
    write_rare_conversion()
    write_short()


if __name__ == "__main__":
    main()
