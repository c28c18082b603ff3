"""Write JPEG files of layouts that cv2.imencode and PIL cannot write: four
components (YCCK, CMYK without an Adobe marker), any sampling factors from
1 to 4, non-interleaved scans and restart intervals.

    from jpeg_file import baseline_jpeg
    data = baseline_jpeg(planes, factors, (H, W), pre=adobe_app14(2))

``planes`` are uint8 arrays, one a component, each at its sampled size
ceil(H v / vmax) x ceil(W h / hmax) for its factors (h, v). The encoder is
baseline sequential Huffman: the forward DCT in floating point, the
standard luminance quantization table (Annex K) for every component and the
standard luminance Huffman tables; it is slow (a bit at a time) and meant
for images of a few thousand pixels. :func:`scans_jpeg` assembles a large
image of non-interleaved scans from one-component JPEGs instead.
"""

import struct

import numpy as np
from scipy.fft import dctn

DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_VALS = bytes(range(12))
AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d)
AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])


def _codes(bits, vals):
    """symbol -> (code, length) of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


DC, AC = _codes(DC_BITS, DC_VALS), _codes(AC_BITS, AC_VALS)


class _Bits:
    """Entropy-coded bytes, most significant bit first, 0xFF stuffed."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):  # pad with 1 bits to a byte
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _put_value(bits: _Bits, v: int):
    """A coefficient's magnitude category's bits (F.1.2.1)."""
    s = abs(v).bit_length()
    if s:
        bits.put(v if v >= 0 else v + (1 << s) - 1, s)


def _block(bits: _Bits, blk: np.ndarray, pred: int) -> int:
    """One block's zig-zag coefficients; returns its DC value."""
    diff = int(blk[0]) - pred
    bits.put(*DC[abs(diff).bit_length()])
    _put_value(bits, diff)
    run = 0
    for k in range(1, 64):
        v = int(blk[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*AC[0xF0])
            run -= 16
        bits.put(*AC[(run << 4) | abs(v).bit_length()])
        _put_value(bits, v)
        run = 0
    if run:
        bits.put(*AC[0x00])
    return int(blk[0])


def segment(marker: int, body: bytes) -> bytes:
    return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body


def adobe_app14(transform: int) -> bytes:
    """An Adobe APP14 segment of ``transform`` (0: RGB or CMYK, 1: YCbCr,
    2: YCCK)."""
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                transform))


def jfif_app0() -> bytes:
    return segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _coefficients(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(bh, bw, 64) quantized zig-zag coefficients of a plane, padded by
    edge replication to (8 bh, 8 bw)."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64), ((0, 8 * bh - h), (0, 8 * bw - w)),
               mode="edge")
    b = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
    f = dctn(b, axes=(2, 3), norm="ortho").reshape(bh, bw, 64)
    return np.round(f / QUANT).astype(np.int64)[..., ZIGZAG]


def _header(size, factors, ids, pre: bytes, tables: bytes) -> bytes:
    H, W = size
    sof = struct.pack(">BHHB", 8, H, W, len(factors))
    for i, (h, v) in zip(ids, factors):
        sof += bytes([i, (h << 4) | v, 0])
    return b"\xff\xd8" + pre + tables + segment(0xC0, sof)


def _tables() -> bytes:
    return (segment(0xDB, bytes([0]) + bytes(QUANT[ZIGZAG].astype(
        np.uint8))) + segment(0xC4, bytes([0x00]) + bytes(DC_BITS) + DC_VALS)
        + segment(0xC4, bytes([0x10]) + bytes(AC_BITS) + AC_VALS))


def baseline_jpeg(planes, factors, size, ids=None, pre: bytes = b"",
                  restart: int = 0, interleave: bool = True) -> bytes:
    """A baseline JPEG of ``planes`` at sampling ``factors`` ((h, v) each)
    and image ``size`` (H, W): ``ids`` the component ids (1, 2, ...),
    ``pre`` segments after SOI (APP0, APP1, APP14), ``restart`` MCUs a
    restart interval, ``interleave`` one scan of every component (else a
    scan a component)."""
    H, W = size
    n = len(planes)
    ids = list(ids or range(1, n + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for p, (h, v) in zip(planes, factors):
        if p.shape != (-(-H * v // vmax), -(-W * h // hmax)):
            raise ValueError(f"plane {p.shape} at factors {(h, v)} of "
                             f"{size}")
    out = bytearray(_header(size, factors, ids, pre, _tables()))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    coef = [_coefficients(p, my * v, mx * h)
            for p, (h, v) in zip(planes, factors)]
    scans = [list(range(n))] if interleave and n > 1 else [[c] for c in
                                                            range(n)]
    for comps in scans:
        out += segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], 0x00]) for c in comps) + bytes([0, 63, 0]))
        if len(comps) == 1:  # the blocks that cover the component's samples
            c = comps[0]
            ph, pw = planes[c].shape
            units = [[(c, by, bx)] for by in range(-(-ph // 8))
                     for bx in range(-(-pw // 8))]
        else:
            units = [[(c, y * factors[c][1] + j, x * factors[c][0] + i)
                      for c in comps for j in range(factors[c][1])
                      for i in range(factors[c][0])]
                     for y in range(my) for x in range(mx)]
        bits, preds = _Bits(), [0] * n
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                bits.flush()
                bits.out += bytes((0xFF, 0xD0 + (u // restart - 1) % 8))
                preds = [0] * n
            for c, by, bx in unit:
                preds[c] = _block(bits, coef[c][by, bx], preds[c])
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


def _segments(data: bytes):
    """(marker, body, entropy-coded bytes after it) of a JPEG's segments."""
    pos, out = 2, []
    while pos < len(data) and data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body, pos = data[pos + 4:pos + 2 + n], pos + 2 + n
        scan = b""
        if marker == 0xDA:
            end = pos
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(
                    0xD0, 0xD8))):
                end += 1
            scan, pos = data[pos:end], end
        out.append((marker, body, scan))
    return out


def scans_jpeg(grey_jpegs, factors, size, pre: bytes = b"") -> bytes:
    """One JPEG of non-interleaved scans, a component each, assembled from
    one-component baseline JPEGs of the components' planes (one quality, so
    one quantization table, and one set of Huffman tables, as
    cv2.imencode writes a grey image): their tables and entropy-coded
    scans under one frame of ``factors`` and ``size``. A non-interleaved
    scan codes the blocks that cover its component's samples, which is
    what a one-component JPEG of that plane codes."""
    parts = [_segments(d) for d in grey_jpegs]
    tables = b"".join(segment(m, b) for m, b, _ in parts[0]
                      if m in (0xDB, 0xC4))
    for p in parts[1:]:
        if b"".join(segment(m, b) for m, b, _ in p if m in (0xDB, 0xC4)) \
                != tables:
            raise ValueError("the one-component JPEGs' tables differ")
    ids = list(range(1, len(parts) + 1))
    out = bytearray(_header(size, factors, ids, pre, tables))
    for i, p in zip(ids, parts):
        _, body, scan = next(s for s in p if s[0] == 0xDA)
        out += segment(0xDA, bytes([1, i]) + body[2:]) + scan
    return bytes(out + b"\xff\xd9")
