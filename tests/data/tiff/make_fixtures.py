"""Write the TIFF fixtures of tests/test_torch_raster.py and chip_smoke.py.

    python tests/data/tiff/make_fixtures.py

Each ``<name>.tif`` is one image of at most 256x256, assembled field by
field by ``tiff_file.py`` (layouts that cv2.imencode and PIL cannot write:
tiles, BigTIFF, planar configuration 2, min-is-white, 16-bit colour maps,
predictor 2 on 16-bit samples), written by PIL (``pil_*``) or by
cv2.imencode (``image.tif``). ``cv2_arrays.npz`` holds ``cv2.imread``'s
grey (``gray_<name>``, IMREAD_GRAYSCALE) and BGR (``bgr_<name>``,
IMREAD_COLOR) arrays of each, the target of the card's TIFF reader.

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

``refused/`` holds TIFFs the card refuses, each for a cause it names:
JPEG-compressed (PIL), float and 32-bit integer (PIL), signed 16-bit,
predictor 3, YCbCr and CIELab (PIL), old-style LZW, 2-bit grey, 4-bit grey,
12-bit grey, 16-bit palette and 1-bit RGB (of which cv2 reads none of the
last five into an 8-bit image either), and separated samples cv2 does not
read either: 16-bit CMYK, InkSet 2, CMYK with an alpha sample and three
samples. CMYK itself (8-bit, InkSet 1, four samples) reads: ``pil_cmyk``
(once ``refused/cmyk``) and ``cmyk8_*``, contiguous and planar, over every
compression, with an explicit InkSet and an orientation.
"""

import io
import os
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from tiff_file import tiff_bytes  # noqa: E402


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
        "jpeg": pil_bytes(Image.fromarray(rgb), compression="jpeg"),
        "float": pil_bytes(Image.fromarray(grey.astype(np.float32))),
        "int32": pil_bytes(Image.fromarray(grey.astype(np.int32))),
        "signed16": tiff_bytes(grey.astype(np.uint16), photometric=1,
                               sample_format=2),
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
        "ycbcr": pil_bytes(Image.fromarray(rgb).convert("YCbCr")),
        "lab": pil_bytes(Image.fromarray(rgb).convert("LAB")),
        "old_lzw": tiff_bytes(rgb, compression=5, old_lzw=True),
        "grey2": tiff_bytes((grey >> 6).astype(np.uint8), bits=2,
                            photometric=1),
        "grey4": tiff_bytes((grey >> 4).astype(np.uint8), bits=4,
                            photometric=1),
        "grey12": tiff_bytes(grey.astype(np.uint16), photometric=1,
                             extra_tags={258: (3, [12])}),
        # a 16-bit palette (its colour map cut to 16 entries a colour)
        "palette16": tiff_bytes(rng.integers(0, 16, grey.shape).astype(
            np.uint16), photometric=3, colormap=rng.integers(
            0, 65536, (3, 16)).astype(np.uint16)),
        "rgb1": tiff_bytes((rgb > 127).astype(np.uint8), bits=1),
    }


def main() -> None:
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
    # the old-style LZW file is a real one: cv2 (libtiff) reads it
    with open(os.path.join(HERE, "refused", "old_lzw.tif"), "rb") as fh:
        back = cv2.imdecode(np.frombuffer(fh.read(), np.uint8),
                            cv2.IMREAD_COLOR)
    assert np.array_equal(back, picture(21, 27, 2)[..., ::-1])


if __name__ == "__main__":
    main()
