"""Write the BMP and PNM fixtures of tests/test_torch_bmp_pnm.py and
chip_smoke.py.

    python tests/data/bmp/make_fixtures.py

BMPs (``tests/data/bmp``) are assembled field by field by :func:`bmp_bytes`
(OpenCV's encoder writes only 8-bit grey and 24-bit files), PNMs
(``tests/data/pnm``) by :func:`pnm_bytes`; ``cv2_arrays.npz`` beside each
holds ``cv2.imread``'s grey (``gray_<name>``, IMREAD_GRAYSCALE) and BGR
(``bgr_<name>``, IMREAD_COLOR) arrays, the target of the card's reads.
Each option is checked in the bytes written (:func:`bmp_fields`,
:func:`pnm_header`).

The BMP cases: 1, 4 and 8 bits with a palette (a short palette by
biClrUsed, a grey one), RLE8 and RLE4 with runs, absolute runs, ends of
line, deltas and an end of bitmap (and the quirks of OpenCV's expansion:
an end of line right after a run that filled its row, an RLE4 delta across
a row's end), 16 bits as 5-5-5 and as 5-6-5 and 5-5-5 by BI_BITFIELDS, 24
bits (``image``: cv2.imencode's, once ``png/refused/image.bmp``), 32 bits
with and without masks (alpha dropped, masks ignored), top-down rows, the
OS/2 12-byte header at 8 and 24 bits, and a 124-byte (V5) header.
``refused/`` holds what cv2 refuses too: 2 bits, 4-4-4 bit fields, a run
past its row, run-length data that ends early, and a truncated file.

The PNM cases: P1 to P6, ASCII and binary, comments in the header, maxval
below 255 (binary samples stay as stored, ASCII ones are rescaled by
OpenCV's palette), 16-bit samples binary and ASCII, ASCII values above
maxval (clamped), P4 of an odd width, and binary data one character after
maxval. ``refused/`` holds what cv2 refuses (a truncated file, maxval 0, a
letter among ASCII samples) and a PAM (P7), which cv2 reads and the card
does not.
"""

import os
import struct
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PNM_DIR = os.path.join(os.path.dirname(HERE), "pnm")


def _pad(row: bytes) -> bytes:
    return row + b"\0" * (-len(row) % 4)


def bmp_rows(pixels: np.ndarray, bits: int, top_down: bool = False) -> bytes:
    """Image data of ``pixels`` (H, W) indices or 16-bit words, (H, W, 3|4)
    B, G, R (A) bytes: rows padded to 4 bytes, bottom row first unless
    ``top_down``."""
    rows = []
    for row in pixels:
        if bits < 8:
            per = 8 // bits
            v = np.concatenate([row, np.zeros(-len(row) % per, row.dtype)])
            v = v.astype(np.int64).reshape(-1, per) << (
                np.arange(per - 1, -1, -1) * bits)
            rows.append(_pad(v.sum(-1).astype(np.uint8).tobytes()))
        elif bits == 16:
            rows.append(_pad(row.astype("<u2").tobytes()))
        else:
            rows.append(_pad(row.astype(np.uint8).tobytes()))
    return b"".join(rows if top_down else rows[::-1])


def bmp_bytes(data: bytes, width: int, height: int, bits: int,
              palette=None, compression: int = 0, masks=None,
              header: int = 40, used: int = None) -> bytes:
    """A BMP of image ``data`` (as :func:`bmp_rows` or an RLE stream gives
    it): a ``header``-byte info header (12: OS/2, 3-byte palette entries;
    40, 108 or 124), ``height`` negative for top-down rows, ``palette``
    (n, 3) R, G, B, ``masks`` (red, green, blue) after the header,
    biClrUsed ``used`` (default: the palette's length)."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0")
                       for r, g, b in np.asarray(palette).tolist())
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        n = len(palette) if palette is not None else 0
        info = struct.pack("<IiiHHIIiiII", header, width, height, 1, bits,
                           compression, len(data), 2835, 2835,
                           n if used is None else used, 0)
        info += b"\0" * (header - 40)
    extra = struct.pack("<3I", *masks) if masks else b""
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + info + extra + pal + data)


def bmp_fields(data: bytes) -> dict:
    """What a BMP's headers say (the check of each option written)."""
    offset, size = struct.unpack("<II", data[10:18])
    if size == 12:
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        return dict(offset=offset, header=12, width=w, height=h, bits=bits,
                    compression=0)
    w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    return dict(offset=offset, header=size, width=w, height=h, bits=bits,
                compression=comp, used=struct.unpack("<I", data[46:50])[0])


def rle8(ops) -> bytes:
    """An RLE8 stream of ops: ("run", n, index), ("abs", [indices]),
    ("eol",), ("delta", dx, dy), ("eob",)."""
    out = bytearray()
    for op in ops:
        if op[0] == "run":
            out += bytes([op[1], op[2]])
        elif op[0] == "abs":
            v = bytes(op[1])
            out += bytes([0, len(v)]) + v + b"\0" * (len(v) & 1)
        elif op[0] == "eol":
            out += b"\0\0"
        elif op[0] == "delta":
            out += bytes([0, 2, op[1], op[2]])
        else:
            out += b"\0\1"
    return bytes(out)


def rle4(ops) -> bytes:
    """An RLE4 stream: ("run", n, (i, j)) alternates indices i and j,
    ("abs", [indices]) packs two a byte, padded to 16 bits; the rest as
    :func:`rle8`."""
    out = bytearray()
    for op in ops:
        if op[0] == "run":
            out += bytes([op[1], op[2][0] << 4 | op[2][1]])
        elif op[0] == "abs":
            v = list(op[1]) + [0] * (len(op[1]) & 1)
            b = bytes(v[k] << 4 | v[k + 1] for k in range(0, len(v), 2))
            out += bytes([0, len(op[1])]) + b + b"\0" * (len(b) & 1)
        else:
            out += rle8([op])
    return bytes(out)


def random_rle(rng, width: int, height: int, bits: int) -> bytes:
    """A run-length stream of random ops that keeps every run inside its
    row (OpenCV refuses the rest), ending with an end of bitmap: what
    tests/test_torch_bmp_pnm.py holds the host expansion to cv2 on."""
    ops, x, y, top = [], 0, 0, (1 << bits) - 1
    while y < height:
        room = width - x
        kind = rng.integers(0, 6)
        if kind <= 1 and room > 0:
            n = int(rng.integers(1, min(room, 255) + 1))
            idx = int(rng.integers(0, top + 1)) if bits == 8 else (
                int(rng.integers(0, 16)), int(rng.integers(0, 16)))
            ops.append(("run", n, idx))
            x += n
        elif kind == 2 and room >= 3:
            n = int(rng.integers(3, min(room, 255) + 1))
            ops.append(("abs", rng.integers(0, top + 1, n).tolist()))
            x += n
        elif kind == 3:
            ops.append(("eol",))
            x, y = 0, y + 1
        elif kind == 4 and room > 0:
            dx = int(rng.integers(0, room))
            ops.append(("delta", dx, 0))
            x += dx
        elif rng.integers(0, 8) == 0:
            break
        if x >= width:
            ops.append(("eol",))
            x, y = 0, y + 1
    ops.append(("eob",))
    return (rle8 if bits == 8 else rle4)(ops)


def picture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth B, G, R fields with faint noise."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3)).astype(
        np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img.astype(np.int64) + rng.integers(-3, 4, img.shape),
                   0, 255).astype(np.uint8)


def image_bmp() -> bytes:
    """cv2.imencode's 24-bit BMP of a 45x37 picture, written here by
    tests/data/jpeg/make_fixtures.py (once ../png/refused/image.bmp)."""
    with open(os.path.join(HERE, "image.bmp"), "rb") as fh:
        data = fh.read()
    assert bmp_fields(data)["bits"] == 24
    return data


def bmp_fixtures():
    rng = np.random.default_rng(11)
    H, W = 21, 27
    bgr = picture(H, W, 1)
    pal = rng.integers(0, 256, (256, 3))
    grey_pal = np.repeat(np.arange(0, 256, 17)[:, None], 3, 1)
    idx8 = rng.integers(0, 256, (H, W))
    idx4, idx1 = idx8 % 16, idx8 % 2
    words = rng.integers(0, 65536, (H, W))
    bgra = np.concatenate([bgr, rng.integers(0, 256, (H, W, 1))], -1)
    small = picture(37, 45, 5)[..., 1]
    f = {
        "image": image_bmp(),
        "grey8_imencode": cv2.imencode(".bmp", small)[1].tobytes(),
        "pal1": bmp_bytes(bmp_rows(idx1, 1), W, H, 1, pal[:2]),
        "pal4": bmp_bytes(bmp_rows(idx4, 4), W, H, 4, pal[:16]),
        "pal4_grey": bmp_bytes(bmp_rows(idx4, 4), W, H, 4, grey_pal),
        "pal8": bmp_bytes(bmp_rows(idx8, 8), W, H, 8, pal),
        "pal8_used40": bmp_bytes(bmp_rows(idx8 % 60, 8), W, H, 8, pal[:40]),
        "pal8_topdown": bmp_bytes(bmp_rows(idx8, 8, True), W, -H, 8, pal),
        "rgb555": bmp_bytes(bmp_rows(words, 16), W, H, 16),
        "rgb555_bitfields": bmp_bytes(bmp_rows(words, 16), W, H, 16,
                                      compression=3,
                                      masks=(0x7C00, 0x3E0, 0x1F)),
        "rgb565_bitfields": bmp_bytes(bmp_rows(words, 16), W, H, 16,
                                      compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F)),
        "bgr24_topdown": bmp_bytes(bmp_rows(bgr, 24, True), W, -H, 24),
        "bgra32": bmp_bytes(bmp_rows(bgra, 32), W, H, 32),
        "bgra32_bitfields_swapped": bmp_bytes(
            bmp_rows(bgra, 32), W, H, 32, compression=3,
            masks=(0xFF, 0xFF00, 0xFF0000)),
        "os2_pal8": bmp_bytes(bmp_rows(idx8, 8), W, H, 8, pal, header=12),
        "os2_bgr24": bmp_bytes(bmp_rows(bgr, 24), W, H, 24, header=12),
        "v5_bgr24": bmp_bytes(bmp_rows(bgr, 24), W, H, 24, header=124),
        # runs, absolute runs, an end of line, a delta, an end of bitmap
        "rle8": bmp_bytes(rle8([
            ("run", 5, 7), ("abs", list(range(10, 19))), ("eol",),
            ("run", W, 3), ("eol",),  # passed over: the run ended its row
            ("run", 4, 9), ("delta", 6, 2), ("abs", [1, 2, 3, 4, 5]),
            ("run", 3, 250), ("eol",), ("eol",), ("run", 27, 1),
            ("abs", list(range(40, 67))), ("eob",)]), W, H, 8, pal,
            compression=1),
        "rle4": bmp_bytes(rle4([
            ("run", 7, (3, 12)), ("abs", [1, 2, 3, 4, 5, 6, 7]), ("eol",),
            ("run", 4, (9, 9)), ("delta", 30, 0),  # across the row's end
            ("abs", [15, 14, 13]), ("eol",), ("run", 27, (1, 2)),
            ("eol",)] + [op for k in range(16) for op in (
                ("run", 27, (k, 15 - k)), ("eol",))] + [("eol",)] * 2),
            W, H, 4, pal[:16], compression=2),
        "rle8_random": bmp_bytes(random_rle(rng, W, H, 8), W, H, 8, pal,
                                 compression=1),
        "rle4_random": bmp_bytes(random_rle(rng, W, H, 4), W, H, 4,
                                 pal[:16], compression=2),
    }
    return f


def bmp_refused():
    rng = np.random.default_rng(12)
    H, W = 9, 11
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 4, (H, W))
    bgr = picture(H, W, 2)
    full = bmp_bytes(bmp_rows(bgr, 24), W, H, 24)
    return {
        "bits2": bmp_bytes(bmp_rows(idx, 2), W, H, 2, pal[:4]),
        "bitfields444": bmp_bytes(bmp_rows(rng.integers(0, 4096, (H, W)),
                                           16), W, H, 16, compression=3,
                                  masks=(0xF00, 0xF0, 0xF)),
        "rle8_past_row": bmp_bytes(rle8([("run", 6, 1), ("run", 6, 2),
                                         ("eob",)]), W, H, 8, pal,
                                   compression=1),
        "rle8_ends_early": bmp_bytes(rle8([("run", 11, 1), ("eol",)]), W, H,
                                     8, pal, compression=1),
        "truncated": full[:-20],
    }


def pnm_bytes(magic: str, width: int, height: int, maxval, body: bytes,
              comment: bytes = b"") -> bytes:
    """A netpbm file: the magic, an optional comment line, the size, maxval
    (None for P1 and P4), then ``body`` (ASCII or binary samples)."""
    head = magic.encode() + b"\n" + comment + b"%d %d\n" % (width, height)
    if maxval is not None:
        head += b"%d\n" % maxval
    return head + body


def ascii_body(values: np.ndarray, per_line: int = 12) -> bytes:
    v = [str(int(x)).encode() for x in values.reshape(-1)]
    return b"\n".join(b" ".join(v[k:k + per_line])
                      for k in range(0, len(v), per_line)) + b"\n"


def pnm_header(data: bytes):
    """(magic, width, height, maxval) of a netpbm file's header (the check
    of each option written; comments skipped)."""
    tokens, pos = [], 2
    while len(tokens) < (2 if data[1:2] in b"14" else 3):
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while data[end:end + 1].isdigit():
            end += 1
        tokens.append(int(data[pos:end]))
        pos = end
    return (data[:2].decode(), *tokens) + ((None,) if len(tokens) == 2
                                             else ())


def pnm_fixtures():
    rng = np.random.default_rng(13)
    H, W = 13, 19
    rgb = picture(H, W, 3)[..., ::-1]
    grey = rgb[..., 1]
    bits = rng.integers(0, 2, (H, W))
    v16 = rng.integers(0, 65536, (H, W, 3))
    c = b"# written for the card's PNM reader\n"
    packed = np.packbits(bits.astype(np.uint8), axis=1).tobytes()
    return {
        "p1.pbm": pnm_bytes("P1", W, H, None, ascii_body(bits, 19), c),
        "p1_packed_digits.pbm": pnm_bytes("P1", W, H, None, b"".join(
            str(int(v)).encode() for v in bits.reshape(-1)) + b"\n"),
        "p4_odd_width.pbm": pnm_bytes("P4", W, H, None, packed, c),
        "p2_maxval100_above.pgm": pnm_bytes(
            "P2", W, H, 100, ascii_body(rng.integers(0, 130, (H, W))), c),
        "p2_16.pgm": pnm_bytes("P2", W, H, 1000,
                           ascii_body(rng.integers(0, 1200, (H, W)))),
        "p5.pgm": pnm_bytes("P5", W, H, 255, grey.tobytes(), c),
        "p5_maxval100.pgm": pnm_bytes("P5", W, H, 100,
                                  (grey % 101).astype(np.uint8).tobytes()),
        "p5_16.pgm": pnm_bytes("P5", W, H, 65535,
                           v16[..., 0].astype(">u2").tobytes()),
        "p5_16_maxval1000.pgm": pnm_bytes(
            "P5", W, H, 1000, (v16[..., 0] % 1001).astype(">u2").tobytes()),
        "p3.ppm": pnm_bytes("P3", W, H, 255, ascii_body(rgb), c),
        "p6.ppm": pnm_bytes("P6", W, H, 255, rgb.tobytes(), c),
        "p6_16.ppm": pnm_bytes("P6", W, H, 65535, v16.astype(">u2").tobytes()),
        # the data begins one character after maxval: here "\r", then "\n"
        "p5_crlf.pgm": b"P5 %d %d 255\r\n" % (W, H) + grey.tobytes()[:-1],
    }


def pnm_refused():
    rng = np.random.default_rng(14)
    H, W = 5, 7
    grey = rng.integers(0, 256, (H, W)).astype(np.uint8)
    return {
        "truncated.pgm": pnm_bytes("P5", W, H, 255, grey.tobytes()[:-3]),
        "maxval0.pgm": pnm_bytes("P5", W, H, 0, grey.tobytes()),
        "letter.pgm": pnm_bytes("P2", W, H, 255, b"1 2 x 4\n"),
        "image.pam": cv2.imencode(".pam", np.dstack([grey] * 3))[1].tobytes(),
    }


def cv2_pair(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    return (cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE),
            cv2.imdecode(buf, cv2.IMREAD_COLOR))


def write(folder: str, files: dict, ext: str, refused: dict) -> None:
    arrays = {}
    os.makedirs(os.path.join(folder, "refused"), exist_ok=True)
    for name, data in files.items():
        path = os.path.join(folder, name if "." in name else name + ext)
        with open(path, "wb") as fh:
            fh.write(data)
        g, c = cv2_pair(data)
        assert g is not None and c is not None, name
        stem = os.path.basename(path).rsplit(".", 1)[0]
        arrays[f"gray_{stem}"], arrays[f"bgr_{stem}"] = g, c
    np.savez_compressed(os.path.join(folder, "cv2_arrays.npz"), **arrays)
    for name, data in refused.items():
        with open(os.path.join(folder, "refused",
                               name if "." in name else name + ext),
                  "wb") as fh:
            fh.write(data)


def main() -> None:
    bmps, pnms = bmp_fixtures(), pnm_fixtures()
    # each option is in the bytes written
    f = {k: bmp_fields(v) for k, v in bmps.items()}
    assert [f[k]["bits"] for k in ("pal1", "pal4", "pal8", "rgb555",
                                   "bgr24_topdown", "bgra32")] == \
        [1, 4, 8, 16, 24, 32]
    assert (f["rle8"]["compression"], f["rle4"]["compression"]) == (1, 2)
    assert f["rgb565_bitfields"]["compression"] == 3
    assert f["pal8_topdown"]["height"] < 0 and f["pal8_used40"]["used"] == 40
    assert f["os2_pal8"]["header"] == 12 and f["v5_bgr24"]["header"] == 124
    assert struct.unpack("<3I", bmps["rgb565_bitfields"][54:66]) == (
        0xF800, 0x7E0, 0x1F)
    h = {k.split(".")[0]: pnm_header(v) for k, v in pnms.items()}
    assert [h[k][0] for k in ("p1", "p2_16", "p3", "p4_odd_width", "p5",
                              "p6")] == ["P1", "P2", "P3", "P4", "P5", "P6"]
    assert h["p2_16"][3] == 1000 and h["p5_maxval100"][3] == 100
    assert h["p6_16"][3] == 65535 and pnms["p5.pgm"].startswith(b"P5\n#")
    write(HERE, bmps, ".bmp", bmp_refused())
    write(PNM_DIR, pnms, "", pnm_refused())
    for folder, refused in ((HERE, bmp_refused()), (PNM_DIR, pnm_refused())):
        for name, data in refused.items():
            g, c = cv2_pair(data)
            if name.endswith(".pam"):  # cv2 reads a PAM; the card does not
                assert c is not None
            else:
                assert g is None and c is None, name


if __name__ == "__main__":
    sys.exit(main())
