"""Write the JPEG 2000 fixtures of tests/test_torch_jp2.py and
chip_smoke.py.

    python tests/data/jp2/make_fixtures.py [--part small|conversion|all]

Every ``<name>.jp2`` (a JP2 file) or ``<name>.j2k`` (a raw codestream) here
is an image of at most 97x61 made from a seed, written by
``cv2.imwrite`` (``cv2_*``: OpenJPEG 2.5.3 as OpenCV sets it, the 5/3
wavelet, or at ``IMWRITE_JPEG2000_COMPRESSION_X1000`` below 1000 the 9/7
one at a rate, and no colour transform either way) or by Pillow
(``pil_*``, OpenJPEG 2.5.4; ``mct=1`` for the RCT after the 5/3 wavelet
and the ICT after the 9/7 one, Pillow's default none): the 5/3 and the
9/7 wavelets with the RCT, the ICT or no colour transform; grey, grey
and alpha, RGB and RGBA; 8 and 16 bits, and 9, 10, 12 and 13 bits
(``*_prec*``: a 16-bit file whose SIZ precision is rewritten, a file cv2
reads as such); tiles of odd sizes down to 1x1 and past 2^31 (one tile);
the five progression orders with precincts, tiles and layers; precincts
smaller than a code-block; 2 to 4 quality layers at low rates, so that
code-blocks stop above bit-plane 0; code-blocks of 4x4 to 64x64 and
16x64; one resolution and the most a size allows; images of 1x1 to 17x17;
PLT markers; raw codestreams; a JP2 file without a colr box (read as a
raw codestream is), with a colr box of an ICC profile (ignored) and of
an enumerated space OpenCV does not know; a SOT marker after the last
tile; a quantization style of 3, an unknown marker, fewer step sizes
than bands, a code-block of more than 109 passes and one of more zero
bit-planes than its band has, which OpenJPEG reads. ``fixtures.json`` records each file's
writer and options. ``cv2_arrays.npz`` holds ``cv2.imread``'s grey
(``gray_<name>``) and BGR (``bgr_<name>``) arrays of each file.

``refused/``: what the card refuses, each for the cause its code names
(``refused.json``: the code, and whether cv2 reads the file in grey and in
colour, with its arrays in ``cv2_arrays.npz`` where it does): signed
samples, an image offset, 4-bit samples (cv2 refuses all three), a raw
one-component codestream (cv2 reads its grey only), a colr box of sYCC
(which cv2 converts; the card does not read it) and of CMYK, a code-block
style of 1 (bypass, which cv2 reads; OpenJPEG's encoders here write only
style 0), a JP2 file whose codestream box holds no codestream, whose
ftyp or ihdr box is missing or whose ihdr width is not the codestream's,
a one-component JP2 without a colr box or with an ICC profile (cv2 reads
its grey only), files cut before the first tile-part, inside one and
before the EOC, a tile followed by a COM marker where its next tile's
SOT was, components of unequal precision (cv2 reads them), a tile-part
out of order and a COD with bytes left over.

``cuts.json``: a sweep of two files (``pil_prog_rpcl.jp2``, four tiles,
and ``pil_rgb_53.j2k``) cut to every length short of the whole, with the
lengths ``cv2.imread`` reads (``cuts_arrays.npz``: its arrays of each,
``gray_<name>_<length>``, ``bgr_<name>_<length>``): OpenJPEG's strict
mode, cv2's setting, refuses a codestream cut anywhere but right after the
SOT marker of a tile other than the first, where it ends the codestream,
decodes the tiles before and leaves the rest 0 (``pil_stops_after_sot.jp2``
is one such file).

``--part conversion``: ``conversion/``, chip_smoke.py's phase 8g sources,
phase 8b's 3200x2130 source as cv2 reads it
(``tests/data/webp/conversion/plane_3200x2130.webp``) written as a
lossless 5/3 JP2 by ``cv2.imwrite`` (no colour transform:
``plane_3200x2130_lossless.jp2``) and as a 9/7 ICT JP2 by Pillow with
1024x1024 tiles, RPCL order, 128x128 precincts and three rate layers
(``plane_3200x2130_97_rpcl.jp2``), and as a 5/3 RCT JP2 by Pillow, one
tile, LRCP order and three rate layers (``plane_3200x2130_53_rct.jp2``:
the reversible colour transform at full size; a lossless RCT file would
take about as many bytes as cv2's lossless one, over the folder's room);
``conversion/cv2.json`` holds the sha-256 of each file, of cv2's grey and
BGR arrays of it and of the JAX converter's workspace image of it
(``cv2.imwrite(dst.jpg, cv2.imread(src))``).

Needs OpenCV and Pillow.
"""

import argparse
import hashlib
import json
import os
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REFUSED = os.path.join(HERE, "refused")
CONVERSION = os.path.join(HERE, "conversion")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
WEBP_SOURCE = os.path.join(REPO, "tests", "data", "webp", "conversion",
                           "plane_3200x2130.webp")
SEED = 22


def pattern(h: int, w: int, channels: int, seed: int, bits: int = 8):
    """Smooth gradients and edges with noise, uint8 or uint16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    planes = []
    for c in range(channels):
        base = (np.sin(xx / (3.0 + c) + seed) * 70 +
                np.cos(yy / (4.0 + 2 * c)) * 50 + 128 +
                np.where((xx + 2 * yy) % 23 < 9, 40, -20))
        planes.append(base + rng.normal(0, 12, (h, w)))
    img = np.stack(planes, -1)
    top = 255 if bits == 8 else 65535
    img = np.clip(img * (top / 255.0), 0, top)
    img = img.astype(np.uint8 if bits == 8 else np.uint16)
    return img[..., 0] if channels == 1 else img


def _pil_save(path: str, arr, mode=None, **kw) -> bool:
    """Pillow's write in a child process: OpenJPEG's encoder aborts on some
    tiny 9/7 images. True where the file was written."""
    from PIL import Image

    pid = os.fork()
    if pid == 0:
        try:
            Image.fromarray(arr, mode).save(path, **kw)
            os._exit(0)
        except Exception:
            os._exit(1)
    _, status = os.waitpid(pid, 0)
    if status != 0 and os.path.exists(path):
        os.remove(path)
    return status == 0


def _siz(data: bytes) -> int:
    return data.index(b"\xff\x51")


def set_precision(data: bytes, prec: int) -> bytes:
    """The file with every component's SIZ precision set to ``prec``."""
    d = bytearray(data)
    at = _siz(data)
    nc = struct.unpack(">H", d[at + 38:at + 40])[0]
    for c in range(nc):
        d[at + 40 + 3 * c] = (d[at + 40 + 3 * c] & 0x80) | (prec - 1)
    return bytes(d)


def set_code_block_style(data: bytes, style: int) -> bytes:
    d = bytearray(data)
    at = data.index(b"\xff\x52")
    d[at + 12] = style  # Lcod(2) Scod SGcod(4) levels xcb ycb style
    return bytes(d)


def set_bytes(data: bytes, marker: bytes, offset: int, value: bytes,
              nth: int = 0) -> bytes:
    """The file with ``value`` written ``offset`` bytes after the start of
    the ``nth`` (from 0) ``marker``."""
    at = -1
    for _ in range(nth + 1):
        at = data.index(marker, at + 1)
    return data[:at + offset] + value + data[at + offset + len(value):]


def set_colr_method(data: bytes, meth: int) -> bytes:
    d = bytearray(data)
    d[data.index(b"colr") + 4] = meth
    return bytes(d)


def set_enumcs(data: bytes, enumcs: int) -> bytes:
    d = bytearray(data)
    at = data.index(b"colr")
    d[at + 7:at + 11] = struct.pack(">I", enumcs)
    return bytes(d)


def small_fixtures():
    """{name: (writer, options)} of the files written here."""
    import cv2

    out = {}
    rgb = pattern(47, 61, 3, SEED)
    grey = pattern(47, 61, 1, SEED + 1)
    rgb16 = pattern(37, 45, 3, SEED + 2, 16)
    grey16 = pattern(37, 45, 1, SEED + 3, 16)

    def cv2_write(name, img, params=()):
        path = os.path.join(HERE, name)
        if not cv2.imwrite(path, img, list(params)):
            raise AssertionError(f"cv2 did not write {name}")
        out[name] = ("cv2.imwrite", {"params": list(params)})

    x1000 = cv2.IMWRITE_JPEG2000_COMPRESSION_X1000
    cv2_write("cv2_lossless_rgb.jp2", rgb[..., ::-1])
    cv2_write("cv2_x100_rgb.jp2", rgb[..., ::-1], (x1000, 100))
    cv2_write("cv2_x25_rgb.jp2", rgb[..., ::-1], (x1000, 25))
    cv2_write("cv2_grey.jp2", grey)
    cv2_write("cv2_grey_x200.jp2", grey, (x1000, 200))
    cv2_write("cv2_rgb16.jp2", rgb16[..., ::-1])
    cv2_write("cv2_grey16.jp2", grey16)

    def pil(name, arr, mode=None, **kw):
        if _pil_save(os.path.join(HERE, name), arr, mode, **kw):
            out[name] = ("Pillow", {k: (list(v) if isinstance(v, tuple)
                                        else v) for k, v in kw.items()})
            return True
        return False

    layers = dict(quality_mode="rates", quality_layers=[60, 25, 10])
    # mct=1: the RCT after the 5/3 wavelet, the ICT after the 9/7 one
    # (Pillow's default is none)
    pil("pil_rgb_53.jp2", rgb, mct=1)
    pil("pil_rgb_97.jp2", rgb, irreversible=True, mct=1)
    pil("pil_rgb_53_nomct.jp2", rgb, mct=0)
    pil("pil_rgb_97_nomct.jp2", rgb, irreversible=True, mct=0)
    pil("pil_grey_53.jp2", grey)
    pil("pil_grey_97.jp2", grey, irreversible=True)
    pil("pil_grey16_53.jp2", grey16)
    pil("pil_grey16_97_layers.jp2", grey16, irreversible=True, **layers)
    pil("pil_la_53.jp2", np.dstack([grey, grey[::-1]]), "LA")
    pil("pil_rgba_97.jp2", np.dstack([rgb, grey]), irreversible=True, mct=1)
    pil("pil_tiles_17x13_97.jp2", rgb, irreversible=True, mct=1,
        tile_size=(17, 13))
    pil("pil_tiles_16x16_53.jp2", rgb, mct=1, tile_size=(16, 16))
    pil("pil_tiles_5x3_97.jp2", rgb[:20, :23], irreversible=True, mct=1,
        tile_size=(5, 3))
    pil("pil_tiles_1x1_53.jp2", rgb[:5, :7], mct=1, tile_size=(1, 1))
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        pil(f"pil_prog_{prog.lower()}.jp2", rgb, irreversible=True, mct=1,
            progression=prog, precinct_size=(16, 16), tile_size=(32, 24),
            num_resolutions=4, **layers)
    pil("pil_prog_cprl_53.jp2", rgb, progression="CPRL", mct=1,
        precinct_size=(8, 16), num_resolutions=5, **layers)
    pil("pil_precinct_8_cb32.jp2", rgb, precinct_size=(8, 8), mct=1,
        codeblock_size=(32, 32))
    pil("pil_precinct_4x2_97.jp2", rgb, irreversible=True, mct=1,
        precinct_size=(4, 2), codeblock_size=(16, 16), num_resolutions=3)
    pil("pil_layers_97.jp2", rgb, irreversible=True, mct=1,
        quality_mode="rates", quality_layers=[80, 40, 20, 12])
    pil("pil_layers_53.jp2", rgb, mct=1, quality_mode="rates",
        quality_layers=[40, 15, 6])
    pil("pil_layers_97_nomct.jp2", rgb, irreversible=True,
        quality_mode="rates", quality_layers=[50, 20])
    pil("pil_layers_db.jp2", rgb, irreversible=True, mct=1,
        quality_mode="dB", quality_layers=[24, 30, 38])
    pil("pil_cb_32x32.jp2", rgb, mct=1, codeblock_size=(32, 32))
    pil("pil_cb_16x64_97.jp2", rgb, irreversible=True, mct=1,
        codeblock_size=(16, 64))
    pil("pil_cb_64x16.jp2", rgb, codeblock_size=(64, 16))
    pil("pil_cb_4x4_97.jp2", rgb, irreversible=True, mct=1,
        codeblock_size=(4, 4))
    pil("pil_res_1.jp2", rgb, mct=1, num_resolutions=1)
    pil("pil_res_6_97.jp2", rgb, irreversible=True, mct=1,
        num_resolutions=6)
    for h, w in ((1, 1), (1, 17), (17, 1), (2, 2), (3, 5), (7, 3),
                 (13, 11), (16, 16), (17, 17)):
        res = 1
        while min(h, w) >> res:
            res += 1
        pil(f"pil_size_{w}x{h}_53.jp2", rgb[:h, :w], mct=1,
            num_resolutions=min(res, 6))
        pil(f"pil_size_{w}x{h}_97.jp2", rgb[:h, :w], irreversible=True,
            mct=1, num_resolutions=min(res, 6))
    pil("pil_plt_tiles.jp2", rgb, mct=1, tile_size=(32, 32), plt=True)
    pil("pil_rgb_53.j2k", rgb, no_jp2=True, mct=1)
    pil("pil_rgb_97_layers.j2k", rgb, no_jp2=True, irreversible=True,
        mct=1, **layers)
    # a JP2 file without a colr box, which OpenJPEG reads as a raw
    # codestream is (cv2: sRGB)
    with open(os.path.join(HERE, "pil_rgb_53.jp2"), "rb") as f:
        data = f.read()
    at = data.index(b"colr")
    with open(os.path.join(HERE, "pil_rgb_53_no_colr.jp2"), "wb") as f:
        f.write(data[:at] + b"xolr" + data[at + 4:])
    out["pil_rgb_53_no_colr.jp2"] = ("Pillow, colr box renamed xolr", {
        "from": "pil_rgb_53.jp2"})
    # a codestream that stops right after the SOT marker of its third
    # tile: OpenJPEG decodes the two tiles before it and leaves the rest 0
    with open(os.path.join(HERE, "pil_prog_rpcl.jp2"), "rb") as f:
        data = f.read()
    sots = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\x90"]
    with open(os.path.join(HERE, "pil_stops_after_sot.jp2"), "wb") as f:
        f.write(data[:sots[2] + 2])
    out["pil_stops_after_sot.jp2"] = ("Pillow, cut after a SOT marker", {
        "from": "pil_prog_rpcl.jp2", "length": sots[2] + 2})
    for prec in (9, 10, 12, 13):
        src = os.path.join(HERE, "pil_grey16_53.jp2")
        with open(src, "rb") as f:
            data = set_precision(f.read(), prec)
        name = f"pil_grey16_53_prec{prec}.jp2"
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        out[name] = ("Pillow, SIZ precision rewritten",
                     {"from": "pil_grey16_53.jp2", "precision": prec})
    with open(os.path.join(HERE, "pil_rgb_97.jp2"), "rb") as f:
        data = set_precision(f.read(), 12)
    with open(os.path.join(HERE, "pil_rgb_97_prec12.jp2"), "wb") as f:
        f.write(data)
    out["pil_rgb_97_prec12.jp2"] = ("Pillow, SIZ precision rewritten",
                                    {"from": "pil_rgb_97.jp2",
                                     "precision": 12})

    def rewrite(name, src, how, fn):
        with open(os.path.join(HERE, src), "rb") as f:
            data = fn(f.read())
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        out[name] = (how, {"from": src})

    # colr boxes that OpenJPEG ignores (method 2, an ICC profile: here the
    # four bytes that followed) or whose space OpenCV does not know (14,
    # CIELab): cv2 takes the image by its number of components
    rewrite("pil_rgb_53_icc.jp2", "pil_rgb_53.jp2",
            "Pillow, colr method rewritten to 2 (ICC profile)",
            lambda d: set_colr_method(d, 2))
    rewrite("pil_rgb_97_space14.jp2", "pil_rgb_97.jp2",
            "Pillow, colr rewritten to CIELab (14)",
            lambda d: set_enumcs(d, 14))
    # a SOT marker and two zero bytes where the EOC was: OpenJPEG stops
    # after the last tile
    rewrite("pil_tiles_5x3_97_sot_after.jp2", "pil_tiles_5x3_97.jp2",
            "Pillow, the EOC replaced by a SOT marker and two zero bytes",
            lambda d: d[:-2] + b"\xff\x90\x00\x00")
    # marker segments as OpenJPEG reads them: tile sizes past 2^31 (one
    # tile), a quantization style of 3 (read as expounded), an unknown
    # marker (skipped two bytes at a time to the next known one), fewer
    # step sizes than bands (the rest 0)
    rewrite("pil_rgb_53_big_tiles.jp2", "pil_rgb_53.jp2",
            "Pillow, SIZ tile width and height rewritten to 2^32 - 1",
            lambda d: set_bytes(d, b"\xff\x51", 22, b"\xff" * 8))
    rewrite("pil_rgb_97_qcd_style3.jp2", "pil_rgb_97.jp2",
            "Pillow, QCD style rewritten to 3",
            lambda d: set_bytes(d, b"\xff\x5c", 4, bytes(
                [d[d.index(b"\xff\x5c") + 4] | 3])))
    def unknown_marker(d):
        at = _siz(d) + 2 + struct.unpack(">H", d[_siz(d) + 2:_siz(d) + 4])[0]
        return d[:at] + b"\xff\x65\x00\x04\x00\x00" + d[at:]

    rewrite("pil_rgb_53_unknown_marker.j2k", "pil_rgb_53.j2k",
            "Pillow, an unknown marker segment (FF65, 6 bytes) inserted "
            "after SIZ", unknown_marker)
    # a packet header byte changed so that a code-block's passes run past
    # 109, OpenJPEG's passes a segment: a second segment with a length of
    # its own, whose passes are never decoded
    rewrite("pil_size_17x17_53_passes.jp2", "pil_size_17x17_53.jp2",
            "Pillow, byte 441 (a packet header) rewritten from 32 to 81",
            lambda d: d[:441] + b"\x51" + d[442:])
    # packet bytes changed so that a code-block's zero bit-planes count
    # past its band's (OpenJPEG leaves it 0; the tag tree's 999 ends the
    # count)
    def planes(d):
        b = bytearray(d)
        for at, v in ((322, 161), (370, 123), (537, 77), (565, 222)):
            b[at] = v
        return bytes(b)

    rewrite("pil_stops_after_sot_planes.jp2", "pil_stops_after_sot.jp2",
            "Pillow, packet bytes 322, 370, 537, 565 rewritten", planes)
    rewrite("pil_size_11x13_53_levels4.jp2", "pil_size_11x13_53.jp2",
            "Pillow, COD levels rewritten from 3 to 4 (QCD gives 10 of "
            "the 13 bands)", lambda d: set_bytes(d, b"\xff\x52", 9,
                                                 b"\x04"))
    return out


def refused_fixtures():
    """{name: (code, how it was made)} of refused/."""
    os.makedirs(REFUSED, exist_ok=True)
    rgb = pattern(29, 33, 3, SEED + 5)
    grey = pattern(29, 33, 1, SEED + 6)
    out = {}

    def put(name, data, code, how):
        with open(os.path.join(REFUSED, name), "wb") as f:
            f.write(data)
        out[name] = (code, how)

    tmp = tempfile.mkdtemp()

    def pil_bytes(arr, **kw):
        path = os.path.join(tmp, "x.j2k" if kw.get("no_jp2") else "x.jp2")
        if not _pil_save(path, arr, **kw):
            raise AssertionError(f"Pillow did not write {kw}")
        with open(path, "rb") as f:
            return f.read()

    put("signed_8.jp2", pil_bytes(grey, signed=True), 6009,
        "Pillow, signed=True")
    put("offset_3x5.jp2", pil_bytes(rgb, offset=(3, 5),
                                    tile_offset=(2, 4),
                                    tile_size=(16, 16)), 6008,
        "Pillow, offset (3, 5), tile_offset (2, 4)")
    plain = pil_bytes(rgb)
    plain_grey = pil_bytes(grey)
    put("prec4.jp2", set_precision(pil_bytes(grey // 16), 4), 6009,
        "Pillow, SIZ precision rewritten to 4")
    put("grey.j2k", pil_bytes(grey, no_jp2=True), 6013,
        "Pillow, no_jp2=True, one component")
    put("sycc.jp2", set_enumcs(plain, 18), 6006,
        "Pillow, colr rewritten to sYCC (18)")
    put("cmyk.jp2", set_enumcs(plain, 12), 6006,
        "Pillow, colr rewritten to CMYK (12)")
    put("bypass.jp2", set_code_block_style(plain, 1), 6003,
        "Pillow, COD code-block style rewritten to 1 (bypass)")
    at = plain.index(b"jp2c")
    put("no_codestream.jp2", plain[:at + 4] + b"\x00" * 16, 6002,
        "Pillow, the jp2c box's contents replaced by zeros")
    for box in (b"ftyp", b"ihdr"):
        i = plain.index(box)
        put(f"no_{box.decode()}.jp2", plain[:i] + b"x" + box[1:] +
            plain[i + 4:], 6002, f"Pillow, the {box.decode()} box renamed")
    i = plain.index(b"ihdr") + 4
    put("unequal_precision.jp2", set_bytes(plain, b"\xff\x51", 43,
                                           b"\x08"), 6014,
        "Pillow, SIZ precision of component 1 rewritten to 9")
    put("tile_part_index.jp2", set_bytes(plain, b"\xff\x90", 10, b"\x01"),
        6002, "Pillow, the first SOT's tile-part index rewritten to 1")
    precincts = pil_bytes(rgb, precinct_size=(16, 16))
    put("cod_precinct_bytes_left.jp2", set_bytes(
        precincts, b"\xff\x52", 4, b"\x00"), 6002,
        "Pillow, precincts, Scod rewritten to 0: the sizes left over")
    put("ihdr_width.jp2", plain[:i + 7] + bytes([plain[i + 7] + 1]) +
        plain[i + 8:], 6002, "Pillow, the ihdr box's width rewritten to "
        "one more than the codestream's")
    i = plain_grey.index(b"colr")
    put("grey_no_colr.jp2", plain_grey[:i] + b"xolr" + plain_grey[i + 4:],
        6013, "Pillow, one component, the colr box renamed")
    put("grey_icc.jp2", set_colr_method(plain_grey, 2), 6013,
        "Pillow, one component, colr method rewritten to 2 (ICC profile)")
    tiled = pil_bytes(rgb, tile_size=(16, 16))
    sot = tiled.index(b"\xff\x90", tiled.index(b"\xff\x90") + 2)
    put("com_after_tile.jp2", tiled[:sot] + b"\xff\x64" + tiled[sot + 2:],
        6001, "Pillow, 16x16 tiles, the second tile's SOT marker "
        "rewritten to COM")
    sot = plain.index(b"\xff\x90")
    put("cut_before_tile.jp2", plain[:sot], 6001,
        "Pillow, cut before the first SOT")
    put("cut_in_tile.jp2", plain[:(sot + len(plain)) // 2], 6001,
        "Pillow, cut inside the tile-part")
    put("cut_eoc.jp2", plain[:-2], 6001, "Pillow, the EOC marker cut")
    return out


def _arrays(path: str):
    import cv2

    return (cv2.imread(path, cv2.IMREAD_GRAYSCALE),
            cv2.imread(path, cv2.IMREAD_COLOR))


def write_small():
    import cv2

    for folder in (HERE, REFUSED):
        if os.path.isdir(folder):
            for f in os.listdir(folder):
                if f.endswith((".jp2", ".j2k")):
                    os.remove(os.path.join(folder, f))
    made = small_fixtures()
    refused = refused_fixtures()
    arrays = {}
    for name in sorted(made):
        grey, bgr = _arrays(os.path.join(HERE, name))
        if grey is None or bgr is None:
            raise AssertionError(f"cv2 does not read {name}")
        arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = grey, bgr
    np.savez_compressed(os.path.join(HERE, "cv2_arrays.npz"), **arrays)
    record = {}
    ref_arrays = {}
    for name, (code, how) in sorted(refused.items()):
        grey, bgr = _arrays(os.path.join(REFUSED, name))
        record[name] = {"code": code, "made": how,
                        "cv2_reads_grey": grey is not None,
                        "cv2_reads_colour": bgr is not None}
        if grey is not None:
            ref_arrays[f"gray_{name}"] = grey
        if bgr is not None:
            ref_arrays[f"bgr_{name}"] = bgr
    with open(os.path.join(REFUSED, "refused.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(REFUSED, "cv2_arrays.npz"),
                        **ref_arrays)
    with open(os.path.join(HERE, "fixtures.json"), "w") as f:
        json.dump({k: {"writer": w, "options": o}
                   for k, (w, o) in sorted(made.items())}, f, indent=1,
                  sort_keys=True)
    cuts, cut_arrays = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("pil_prog_rpcl.jp2", "pil_rgb_53.j2k"):
            with open(os.path.join(HERE, name), "rb") as f:
                data = f.read()
            path = os.path.join(tmp, "cut" + os.path.splitext(name)[1])
            reads = []
            for n in range(len(data)):
                with open(path, "wb") as f:
                    f.write(data[:n])
                grey, bgr = _arrays(path)
                if grey is not None or bgr is not None:
                    reads.append(n)
                    cut_arrays[f"gray_{name}_{n}"] = grey
                    cut_arrays[f"bgr_{name}_{n}"] = bgr
            cuts[name] = {"length": len(data), "cv2_reads": reads}
    with open(os.path.join(HERE, "cuts.json"), "w") as f:
        json.dump(cuts, f, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(HERE, "cuts_arrays.npz"), **cut_arrays)
    print(f"{len(made)} fixtures, {len(refused)} refused, cut sweeps "
          f"{ {k: v['length'] for k, v in cuts.items()} }")


def _hashes(path: str) -> dict:
    import cv2

    sha = lambda b: hashlib.sha256(b).hexdigest()
    with open(path, "rb") as f:
        data = f.read()
    grey, bgr = _arrays(path)
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "00000000.jpg")
        cv2.imwrite(dst, cv2.imread(path))
        with open(dst, "rb") as f:
            workspace = f.read()
    return {"source_sha256": sha(data), "gray_sha256": sha(grey.tobytes()),
            "bgr_sha256": sha(bgr.tobytes()),
            "workspace_sha256": sha(workspace), "shape": list(bgr.shape),
            "bytes": len(data)}


def write_conversion():
    import cv2

    os.makedirs(CONVERSION, exist_ok=True)
    bgr = cv2.imread(WEBP_SOURCE)
    lossless = os.path.join(CONVERSION, "plane_3200x2130_lossless.jp2")
    if not cv2.imwrite(lossless, bgr):
        raise AssertionError("cv2 did not write the lossless source")
    lossy = os.path.join(CONVERSION, "plane_3200x2130_97_rpcl.jp2")
    options = dict(irreversible=True, mct=1, tile_size=(1024, 1024),
                   progression="RPCL", precinct_size=(128, 128),
                   quality_mode="rates", quality_layers=[40, 20, 10])
    if not _pil_save(lossy, np.ascontiguousarray(bgr[..., ::-1]),
                     **options):
        raise AssertionError("Pillow did not write the 9/7 source")
    rct = os.path.join(CONVERSION, "plane_3200x2130_53_rct.jp2")
    rct_options = dict(irreversible=False, mct=1, quality_mode="rates",
                       quality_layers=[100, 50, 25])
    if not _pil_save(rct, np.ascontiguousarray(bgr[..., ::-1]),
                     **rct_options):
        raise AssertionError("Pillow did not write the 5/3 RCT source")
    listed = lambda o: {k: list(v) if isinstance(v, tuple) else v
                        for k, v in o.items()}
    record = {"lossless": dict(_hashes(lossless), writer="cv2.imwrite"),
              "97_rpcl": dict(_hashes(lossy), writer="Pillow",
                              options=listed(options)),
              "53_rct": dict(_hashes(rct), writer="Pillow",
                             options=listed(rct_options))}
    if record["lossless"]["bgr_sha256"] != \
            hashlib.sha256(bgr.tobytes()).hexdigest():
        raise AssertionError("the lossless source does not read back to "
                             "phase 8b's pixels")
    with open(os.path.join(CONVERSION, "cv2.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    print({k: v["bytes"] for k, v in record.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("small", "conversion", "all"),
                    default="all")
    args = ap.parse_args(argv)
    if args.part in ("small", "all"):
        write_small()
    if args.part in ("conversion", "all"):
        write_conversion()
    return 0


if __name__ == "__main__":
    sys.exit(main())
