"""Write the JPEG fixtures of tests/test_torch_images.py and chip_smoke.py.

    python tests/data/jpeg/make_fixtures.py

Each fixture is one small colour (or grey) image made from a seed, encoded
by OpenCV with the settings its name gives; ``decoded.npz`` holds what
``cv2.imread`` returns for each (``gray_<name>`` with IMREAD_GRAYSCALE,
``bgr_<name>`` with IMREAD_COLOR), the target of the card's decoder.

``refused/`` holds JPEGs that the card's decoder must refuse, because
``cv2.imread`` gives another image than their planes: ``exif_orientation6``
(420_q95 with an EXIF APP1 segment whose orientation is 6, which OpenCV
rotates), ``adobe_rgb`` (444_q100 with its JFIF marker replaced by an Adobe
APP14 marker of transform 0, which libjpeg reads as RGB) and ``rgb_ids``
(444_q100 without its JFIF marker and with the component ids 'R', 'G', 'B').
"""

import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


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


def adobe_app14(transform: int) -> bytes:
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                transform))


def after_soi(data: bytes, seg: bytes) -> bytes:
    return data[:2] + seg + data[2:]


def refused(data_420: bytes, data_444: bytes) -> dict:
    bare = without_jfif(data_444)
    return {"exif_orientation6": after_soi(data_420, exif_app1(6)),
            "adobe_rgb": after_soi(bare, adobe_app14(0)),
            "rgb_ids": with_ids(bare, b"RGB")}


def main() -> None:
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


if __name__ == "__main__":
    main()
