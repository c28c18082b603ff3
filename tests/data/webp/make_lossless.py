"""Write the lossless (VP8L) and animated WebP fixtures of the card's WebP
reads, what cv2 refuses of them, and cv2's arrays.

    python tests/data/webp/make_lossless.py

Needs OpenCV, Pillow (whose bundled libwebp encodes) and g++ (the host
build of ``csrc/webp_lossless.h``, through ``check_host_webp.build``, reads
back what each file holds). The files are libwebp's: Pillow's ``save``
(lossless, ``exact``, ``EXIF``, animation), libwebp's own ``WebPEncode``
through ``ctypes`` (``make_fixtures.py``'s binding) for the options Pillow
does not expose (near-lossless, the method and quality of each size), and,
for what no encoder writes (predictor modes 14 and 15, broken prefix
codes, a repeated transform, colour cache bits out of range), VP8L
streams written here bit by bit (:class:`BitWriter`). Animated files with
an offset first frame are assembled from those frames (``VP8X``, ``ANIM``,
``ANMF``).

Written into ``lossless/``:

* ``*.webp``: lossless stills of every transform (predictor, cross-colour,
  subtract green, colour indexing at 2, 4, 16 and 256 colours, so every
  bundling width), the colour cache on and off, meta prefix codes, simple
  and single-symbol codes, 2-D distance codes, sizes 1x1, 3x5, odd widths
  and widths that are not a multiple of the block, alpha with and without
  ``exact``, near-lossless, ``VP8X`` + ``VP8L`` with EXIF orientations 1-8,
  and animated files whose first frame is lossy (with and without
  ``ALPH``) or lossless, at offset 0 and at an offset, under each
  blend/dispose flag; each option is checked in the bitstream written
  (the transforms, bits and the decode's counts in ``fixtures.json``);
* ``cv2_arrays.npz``: cv2.imdecode's grey and BGR of each;
* ``refused/``: what cv2 refuses (a frame past the canvas, an animated file
  without ANMF or with ANMF before ANIM, a VP8L signature or version that
  is wrong, a truncated VP8L, an over-subscribed and an incomplete prefix
  code, a repeated transform, 12 colour cache bits), each shown to be
  refused by cv2 here.

``--part hand`` writes the two streams of :func:`hand_fixtures` alone,
with cv2.imread's arrays of the file or its refusal: 1200 prefix-code
groups (libwebp maps more than 1000 to the used ones) and a backward
reference before the first pixel (refused).
"""

import argparse
import io
import json
import os
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "lossless")
sys.path.insert(0, HERE)
import check_host_webp  # noqa: E402
import make_fixtures as mf  # noqa: E402


# ----------------------------- encoders -----------------------------

def libwebp_lossless(img: np.ndarray, quality: float = 75, method: int = 4,
                     **options) -> bytes:
    """A simple-format lossless WebP of a uint8 BGR or BGRA image by
    libwebp's WebPEncode (WebPConfig fields from ``options``)."""
    import ctypes

    lib = mf._libwebp()
    cfg = mf._Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(quality), mf._ABI):
        raise RuntimeError("WebPConfigInit")
    cfg.lossless, cfg.method = 1, method
    for k, v in options.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses {options}")
    pic = mf._Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), mf._ABI):
        raise RuntimeError("WebPPictureInit")
    H, W, C = img.shape
    pic.width, pic.height, pic.use_argb = W, H, 1
    a = np.ascontiguousarray(img, np.uint8)
    wr = mf._Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    try:
        imp = lib.WebPPictureImportBGRA if C == 4 else \
            lib.WebPPictureImportBGR
        if not imp(ctypes.byref(pic), a.ctypes.data_as(mf._P), C * W):
            raise RuntimeError("WebPPictureImport")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, mf._P).value
        pic.custom_ptr = ctypes.addressof(wr)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode: error {pic.error_code}")
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(wr))


def pillow(img: np.ndarray, frames=None, **save) -> bytes:
    """Pillow's WebP of a BGR or BGRA image (and more frames, animated)."""
    from PIL import Image

    def pil(a):
        rgb = np.ascontiguousarray(a[..., [2, 1, 0] + ([3] if a.shape[2] == 4
                                                       else [])])
        return Image.fromarray(rgb, "RGBA" if a.shape[2] == 4 else "RGB")

    f = io.BytesIO()
    if frames:
        save.update(save_all=True, append_images=[pil(a) for a in frames])
    pil(img).save(f, "WEBP", **save)
    return f.getvalue()


class BitWriter:
    """VP8L's LSB-first bit stream, for hand-written streams."""

    def __init__(self):
        self.bits = []

    def put(self, v: int, n: int):
        self.bits += [(v >> i) & 1 for i in range(n)]

    def code(self, c: int, n: int):  # a prefix code, its first bit first
        self.bits += [(c >> i) & 1 for i in reversed(range(n))]

    def data(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(sum(b[i + k] << k for k in range(8))
                     for i in range(0, len(b), 8))


def _flat_code(w: BitWriter, n: int, used: int = 256):
    """A normal prefix code of an n-symbol alphabet whose first ``used``
    symbols have length 8 (256 used: complete; fewer: incomplete; more:
    over-subscribed): a code-length code of lengths 0 and 8 (one bit
    each), no max_symbol."""
    w.put(0, 1)                      # normal
    order = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8]
    w.put(len(order) - 4, 4)
    for s in order:
        w.put(1 if s in (0, 8) else 0, 3)
    w.put(0, 1)                      # no max_symbol
    for s in range(n):
        w.code(1 if s < used else 0, 1)  # length 8 is code 1, 0 is code 0


def _one_symbol(w: BitWriter, symbol: int):
    w.put(1, 1), w.put(0, 1), w.put(1, 1), w.put(symbol, 8)


def _two_symbols(w: BitWriter, n: int, a: int, b: int):
    """A normal prefix code of an n-symbol alphabet whose symbols a and b
    have length 1 (complete): a code-length code of lengths 0 and 1, one
    bit each, no max_symbol."""
    w.put(0, 1)                      # normal
    w.put(0, 4)                      # 4 code-length codes: 17, 18, 0, 1
    for length in (0, 0, 1, 1):
        w.put(length, 3)
    w.put(0, 1)                      # no max_symbol
    for s in range(n):
        w.code(1 if s in (a, b) else 0, 1)


def backref_before_first_pixel() -> bytes:
    """A 4x4 VP8L image whose second pixel is a backward reference of
    length 1 and distance 4 (distance code 1: a row up), which points
    before the first pixel."""
    w = BitWriter()
    w.put(0x2F, 8), w.put(3, 14), w.put(3, 14), w.put(1, 1), w.put(0, 3)
    w.put(0, 1), w.put(0, 1), w.put(0, 1)  # no transform, cache or meta
    _two_symbols(w, 280, 0, 256)     # green: literal 0, length prefix 0
    for _ in range(4):               # red, blue, alpha; distance prefix 0
        _one_symbol(w, 0)
    w.code(0, 1)                     # pixel 0: green 0 (the rest trivial)
    w.code(1, 1)                     # pixel 1: a backward reference
    return riff([(b"VP8L", w.data())])


def many_groups(groups: int = 1200, size: int = 32,
                bits: int = 2) -> bytes:
    """A VP8L image of ``groups`` prefix-code groups (libwebp maps them to
    the used ones when there are more than 1000): a size x size image in
    blocks of 2^bits, each block's group one of 63 spread over them and
    the last, every code of each group one symbol (the group's colour), so
    the pixels take no bits."""
    blocks = (-(-size >> bits)) ** 2
    used = [k * (groups // blocks) for k in range(blocks - 1)] + [
        groups - 1]
    w = BitWriter()
    w.put(0x2F, 8), w.put(size - 1, 14), w.put(size - 1, 14), w.put(1, 1)
    w.put(0, 3)
    w.put(0, 1), w.put(0, 1)         # no transform, no colour cache
    w.put(1, 1), w.put(bits - 2, 3)  # meta prefix codes
    _image(w, [(g & 255) << 8 | (g >> 8) << 16 for g in used], main=False)
    for g in range(groups):
        for v in (g & 255, (7 * g) & 255, (13 * g) & 255, 255, 0):
            _one_symbol(w, v)
    return riff([(b"VP8L", w.data())])


def _image(w: BitWriter, pixels, cache_bits: int = 0, green_used: int = 256,
           main: bool = True):
    """An image stream of ARGB literals: flat 8-bit codes for green, red,
    blue and alpha (green's ``green_used`` symbols), one symbol for
    distance."""
    if cache_bits:
        w.put(1, 1), w.put(cache_bits, 4)
    else:
        w.put(0, 1)
    if main:
        w.put(0, 1)                  # no meta prefix codes
    _flat_code(w, 280 + (1 << cache_bits if cache_bits else 0), green_used)
    for _ in range(3):
        _flat_code(w, 256)
    _one_symbol(w, 0)
    for p in pixels:
        for s in (8, 16, 0, 24):     # green, red, blue, alpha
            w.code((int(p) >> s) & 255, 8)


def vp8l_stream(width: int, height: int, transforms, pixels,
                **image) -> bytes:
    """A VP8L payload: header, the transforms ((type, bits, sub-image
    pixels) or (2, None, None)), the main image of ``pixels``."""
    w = BitWriter()
    w.put(0x2F, 8), w.put(width - 1, 14), w.put(height - 1, 14)
    w.put(1, 1), w.put(0, 3)
    for kind, bits, sub in transforms:
        w.put(1, 1), w.put(kind, 2)
        if kind in (0, 1):
            w.put(bits - 2, 3)
            _image(w, sub, main=False)
    w.put(0, 1)
    _image(w, pixels, **image)
    return w.data()


def riff(chunks) -> bytes:
    return mf.riff(chunks)


def chunk(data: bytes, fourcc: bytes) -> bytes:
    return dict(mf.chunks(data))[fourcc]


def anmf(x: int, y: int, w: int, h: int, flags: int, frame) -> bytes:
    """An ANMF payload: offset (2 x, 2 y), size, duration 100, flags, then
    the frame's chunks."""
    head = b"".join((v).to_bytes(3, "little") for v in
                    (x // 2, y // 2, w - 1, h - 1, 100)) + bytes([flags])
    return head + b"".join(f + struct.pack("<I", len(p)) + p +
                           b"\x00" * (len(p) & 1) for f, p in frame)


def animated(canvas, frames, background=(0, 0, 0, 0)) -> bytes:
    """An animated file: VP8X (animation, alpha), ANIM, one ANMF per
    (x, y, w, h, flags, frame chunks)."""
    cw, ch = canvas
    return riff([(b"VP8X", mf.vp8x(0x12, cw, ch)),
                 (b"ANIM", bytes(background) + b"\x00\x00")] +
                [(b"ANMF", anmf(*f)) for f in frames])


# ----------------------------- the images -----------------------------

def palette_image(h: int, w: int, colours: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    idx = rng.integers(0, colours, (h, w))
    idx[: h // 2] = (np.arange(w)[None] // 3 + np.arange(h // 2)[:, None]
                     // 2) % colours
    return pal[idx]


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients, edges, flat areas and noise: many predictor modes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(x / (5 + c) + y / 9) for c in range(3)],
                   -1)
    img[(x // 8 + y // 8) % 3 == 0] += rng.normal(0, 25, (3,))
    img[(x - y) % 17 < 3] = (20, 200, 90)
    img += rng.normal(0, 6, img.shape) * ((x // 16) % 2 == 0)[..., None]
    img[: h // 4, w // 2:] = rng.integers(0, 256, (h // 4, w - w // 2, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def with_alpha(bgr: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, bgr.shape[:2], dtype=np.uint8)
    a[::3] = 0
    return np.dstack([bgr, a])


# ----------------------------- the files -----------------------------

def fixtures():
    """{name: (bytes, what the fixture must show)}: 'transforms' (types in
    stream order), 'colours' (palette size), and counts of the decode."""
    out = {}
    w71 = mf.noisy(71, 53, 3)
    # the three files the card refused before it read VP8L and animation
    # (written as RGB from the BGR array, as the card's refusal fixtures
    # were, so their bytes stay; cv2.imencode's, ../png/refused/ once,
    # comes from ../jpeg/make_fixtures.py)
    rgb = np.ascontiguousarray(w71[..., ::-1])
    out["pillow_71x53"] = (pillow(rgb, lossless=True), {})
    out["animated_lossy_71x53"] = (pillow(rgb, [rgb[::-1]], quality=75),
                                   {"animated": True, "kind": "lossy"})
    with open(os.path.join(OUT, "imencode_45x37.webp"), "rb") as f:
        out["imencode_45x37"] = (f.read(), {"kind": "lossless"})
    for w, h in ((1, 1), (3, 5), (33, 17), (37, 70), (100, 3)):
        out[f"size_{w}x{h}"] = (libwebp_lossless(textured(h, w, w + h)), {})
    tex = textured(96, 130, 1)
    out["modes_m6_q100"] = (libwebp_lossless(tex, 100, 6),
                            {"transforms": [0, 1]})
    out["effort_m0_q0"] = (libwebp_lossless(tex, 0, 0), {"cache_bits": 0})
    out["meta_m5_q90"] = (libwebp_lossless(textured(200, 260, 5), 90, 5),
                          {"meta": True})
    for n in (2, 4, 16, 256):
        out[f"palette_{n}"] = (libwebp_lossless(palette_image(40, 67, n, n)),
                               {"colours": n})
    bgra = with_alpha(w71, 5)
    out["alpha_exact"] = (pillow(bgra, lossless=True, exact=True),
                          {"reads_as": (w71, True)})
    out["alpha_not_exact"] = (pillow(bgra, lossless=True),
                              {"reads_as": (w71, False)})
    out["near_lossless_60"] = (libwebp_lossless(tex, 75, 4,
                                                near_lossless=60),
                               {"reads_as": (tex, False)})
    small = textured(20, 30, 8)
    for k in range(1, 9):
        out[f"exif_{k}"] = (pillow(small, lossless=True,
                                   exif=mf.exif_orientation(k)),
                            {"exif": k})
    out["animated_lossless_30x20"] = (pillow(small, [small[::-1]],
                                             lossless=True),
                                      {"animated": True, "kind": "lossless"})
    out["animated_alpha_30x20"] = (pillow(with_alpha(small, 3),
                                          [with_alpha(small[::-1], 4)],
                                          quality=80),
                                   {"animated": True, "kind": "lossy",
                                    "alph": True})
    out["animated_exif_6"] = (pillow(small, [small[::-1]], lossless=True,
                                     exif=mf.exif_orientation(6)),
                              {"animated": True, "exif": 6})
    # hand-assembled: the first frame at an offset on a larger canvas
    ll = chunk(libwebp_lossless(with_alpha(small, 9)), b"VP8L")
    lossy = dict(mf.chunks(pillow(with_alpha(small, 9), quality=80)))
    lossy_frame = [(b"ALPH", lossy[b"ALPH"]), (b"VP8 ", lossy[b"VP8 "])]
    for flags in range(4):
        out[f"offset_lossless_flags{flags}"] = (
            animated((60, 50), [(4, 8, 30, 20, flags, [(b"VP8L", ll)]),
                                (0, 0, 30, 20, 0, [(b"VP8L", ll)])],
                     (10, 20, 30, 255) if flags & 1 else (0, 0, 0, 0)),
            {"animated": True, "kind": "lossless", "offset": [4, 8]})
    out["offset_lossy_alph"] = (
        animated((64, 40), [(30, 14, 30, 20, 2, lossy_frame)]),
        {"animated": True, "kind": "lossy", "offset": [30, 14],
         "alph": True})
    out["offset_lossy"] = (
        animated((34, 26), [(2, 6, 30, 20, 0, [(b"VP8 ",
                                                lossy[b"VP8 "])])]),
        {"animated": True, "kind": "lossy", "offset": [2, 6]})
    # written by hand: predictor modes 14 and 15 (black, as libwebp reads
    # them) beside 0-13, blocks of 4 on a 16x16 image
    rng = np.random.default_rng(21)
    modes = np.arange(16, dtype=np.uint32) << 8
    res = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    out["hand_modes_0_15"] = (riff([(b"VP8L", vp8l_stream(
        16, 16, [(0, 2, modes)], res))]), {"transforms": [0],
                                           "modes": list(range(16))})
    out["hand_cache_11"] = (riff([(b"VP8L", vp8l_stream(
        5, 7, [(2, None, None)], res[:35], cache_bits=11))]),
        {"cache_bits": 11})
    return out


def refused():
    """{name: (bytes, the host decoder's code or None: refused by the
    container check)}."""
    small = textured(20, 30, 8)
    ll = libwebp_lossless(small)
    frame = chunk(ll, b"VP8L")
    half = frame[:len(frame) // 2]
    res = np.arange(16, dtype=np.uint32) * 0x01020304
    return {
        "frame_past_canvas.webp": (animated(
            (60, 50), [(40, 8, 30, 20, 0, [(b"VP8L", frame)])]), None),
        "animated_no_anmf.webp": (riff([(b"VP8X", mf.vp8x(0x12, 30, 20)),
                                        (b"ANIM", bytes(6))]), None),
        "anmf_before_anim.webp": (riff([
            (b"VP8X", mf.vp8x(0x12, 30, 20)),
            (b"ANMF", anmf(0, 0, 30, 20, 0, [(b"VP8L", frame)])),
            (b"ANIM", bytes(6))]), None),
        "bad_signature.webp": (riff([(b"VP8L", b"\x2e" + frame[1:])]), 5008),
        "bad_version.webp": (riff([(b"VP8L", frame[:4] + bytes(
            [frame[4] | 0x20]) + frame[5:])]), 5008),
        "truncated_vp8l.webp": (riff([(b"VP8L", half)]), 5009),
        "oversubscribed.webp": (riff([(b"VP8L", vp8l_stream(
            4, 4, [], res, green_used=257))]), 5010),
        "incomplete.webp": (riff([(b"VP8L", vp8l_stream(
            4, 4, [], res, green_used=255))]), 5010),
        "repeated_transform.webp": (riff([(b"VP8L", vp8l_stream(
            4, 4, [(2, None, None), (2, None, None)], res))]), 5011),
        "cache_bits_12.webp": (riff([(b"VP8L", vp8l_stream(
            4, 4, [], res, cache_bits=12))]), 5011),
    }


def _has_alph(data: bytes) -> bool:
    """An ALPH chunk beside the frame: at the top level, or in the first
    ANMF."""
    from mpmvs_torch.io import images

    top = images._riff_chunks(data, 12, len(data))
    anmf = [p for f, p in top if f == b"ANMF"][:1]
    inner = images._riff_chunks(anmf[0], 16, len(anmf[0])) if anmf else []
    return any(f == b"ALPH" for f, _ in top + inner)


def describe(data: bytes, lib) -> dict:
    """What the file holds, read back: the container's frame, and for a
    VP8L frame its transforms, palette size and the decode's counts."""
    from mpmvs_torch.io import images

    info = images.webp_container(data)
    d = {"kind": info.kind, "animated": info.animated,
         "canvas": list(info.canvas), "offset": list(info.offset),
         "size": list(info.size), "alph": _has_alph(data),
         "exif": 1 if info.exif is None else
         lib.exif_orientation_tiff(info.exif, len(info.exif))}
    if info.kind == "lossless":
        img = images.vp8l_decode(info.frame, lib)
        d["transforms"] = [t.type for t in img.transforms]
        d["bits"] = [t.bits for t in img.transforms]
        for t in img.transforms:
            if t.type == images.VP8L_PREDICTOR:
                d["modes"] = sorted({int(m >> 8) & 15 for m in t.data})
        d.update(img.stats)
    return d


def hand_fixtures():
    """({name: bytes} read, {name: bytes} refused) of the streams written
    here for what libwebp's encoder never writes."""
    return ({"groups_1200": many_groups()},
            {"backref_before_first_pixel.webp":
             backref_before_first_pixel()})


def write_hand() -> None:
    """Write :func:`hand_fixtures`, adding cv2.imread's arrays of each
    file that cv2 reads to ``cv2_arrays.npz`` and what it holds to
    ``fixtures.json``; the others under ``refused/``, refused by cv2."""
    import cv2

    read, refused_ = hand_fixtures()
    path = os.path.join(OUT, "cv2_arrays.npz")
    arrays = dict(np.load(path))
    with open(os.path.join(OUT, "fixtures.json")) as f:
        manifest = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        lib = check_host_webp.build(tmp)
        for name, data in read.items():
            file = os.path.join(OUT, f"{name}.webp")
            with open(file, "wb") as f:
                f.write(data)
            g = cv2.imread(file, cv2.IMREAD_GRAYSCALE)
            c = cv2.imread(file, cv2.IMREAD_COLOR)
            if g is None or c is None:
                raise AssertionError(f"cv2 does not read {name}")
            arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = g, c
            manifest[name] = describe(data, lib)
    for name, data in refused_.items():
        file = os.path.join(OUT, "refused", name)
        with open(file, "wb") as f:
            f.write(data)
        if cv2.imread(file, cv2.IMREAD_COLOR) is not None:
            raise AssertionError(f"cv2 reads refused/{name}")
    np.savez_compressed(path, **arrays)
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def main() -> int:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "hand"), default="all")
    if ap.parse_args().part == "hand":
        write_hand()
        return 0
    os.makedirs(os.path.join(OUT, "refused"), exist_ok=True)
    arrays, manifest = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = check_host_webp.build(tmp)
        for name, (data, want) in fixtures().items():
            d = describe(data, lib)
            buf = np.frombuffer(data, np.uint8)
            g = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
            c = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            if g is None or c is None:
                raise AssertionError(f"cv2 does not read {name}")
            bad = {}
            for k, v in want.items():
                if k == "reads_as":  # exact / not, near-lossless
                    got = bool(np.array_equal(c, v[0]))
                    v = v[1]
                else:
                    got = d.get("meta_bits", 0) > 0 if k == "meta" else \
                        d.get(k)
                if got != v:
                    bad[k] = (got, v)
            if bad:
                raise AssertionError(f"{name}: the file does not hold {bad}")
            arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = g, c
            manifest[name] = d
            with open(os.path.join(OUT, f"{name}.webp"), "wb") as f:
                f.write(data)
        for name, (data, code) in refused().items():
            if cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR) is not None:
                raise AssertionError(f"cv2 reads refused/{name}")
            with open(os.path.join(OUT, "refused", name), "wb") as f:
                f.write(data)
    np.savez_compressed(os.path.join(OUT, "cv2_arrays.npz"), **arrays)
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(manifest)} fixtures, {len(refused())} refused")
    write_hand()
    return 0


if __name__ == "__main__":
    sys.exit(main())
