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


# ------------------------------ lossless ------------------------------

def _optimal_bits(freq):
    """jcdctmgr/jchuff.c jpeg_gen_optimal_table: (BITS[1..16], HUFFVAL) of a
    code for symbols 0..len(freq)-1 of counts ``freq``, no code longer than
    16 bits and none all ones (a reserved symbol of count 1)."""
    n = len(freq)
    f = [int(v) for v in freq] + [1]  # the reserved code point
    codesize, others = [0] * (n + 1), [-1] * (n + 1)
    while True:
        live = [i for i in range(n + 1) if f[i] > 0]
        if len(live) < 2:
            break
        c1 = min(live, key=lambda i: (f[i], -i))
        c2 = min((i for i in live if i != c1), key=lambda i: (f[i], -i))
        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(n + 1):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):  # limit the lengths to 16 bits
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved code point
    vals = [s for size in range(1, 33) for s in range(n)
            if codesize[s] == size]
    return bits[1:17], bytes(vals)


def _code_table(bits, vals):
    """(code, length) arrays indexed by symbol."""
    codes = _codes(bits, vals)
    top = max(vals) + 1
    code, length = np.zeros(top, np.int64), np.zeros(top, np.int64)
    for s, (c, n) in codes.items():
        code[s], length[s] = c, n
    return code, length


def predict(x: np.ndarray, predictor: int, first: np.ndarray,
            initial: int) -> np.ndarray:
    """T.81 H.1.2.1's prediction of every sample of a component's plane of
    (point-transformed) samples ``x`` (int64): predictor 1..7 from Ra (left),
    Rb (above) and Rc (above left); on a row where ``first`` is set (the
    scan's first, and the first after each restart) predictor 1, with
    ``initial`` for its first sample; in column 0 of the other rows Rb."""
    H, W = x.shape
    ra = np.zeros_like(x)
    rb = np.zeros_like(x)
    rc = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb[1:] = x[:-1]
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    pred[first, 1:] = ra[first, 1:]
    pred[first, 0] = initial
    return pred


def first_rows(height: int, v: int, restart_rows: int) -> np.ndarray:
    """The rows of a component of ``height`` rows at vertical factor ``v``
    in an interleaved scan that predict as a first row: row 0 and the first
    row of each restart interval of ``restart_rows`` MCU rows."""
    r = np.arange(height)
    if not restart_rows:
        return r == 0
    return (r % v == 0) & ((r // v) % restart_rows == 0)


def _pack(words: np.ndarray, lengths: np.ndarray) -> bytes:
    """The entropy-coded bytes of codes ``words`` of ``lengths`` bits
    (at most 32 each), most significant bit first, the last byte padded
    with 1 bits, 0xFF bytes stuffed with 0x00."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    if total == 0:
        return b""
    off = np.cumsum(lengths) - lengths
    w, b = off >> 5, off & 31
    v = words.astype(np.uint64) << (64 - b - lengths).astype(np.uint64)
    nwords = (total + 31) // 32 + 1
    hi = np.bincount(w, (v >> np.uint64(32)).astype(np.float64), nwords)
    lo = np.bincount(w + 1, (v & np.uint64(0xFFFFFFFF)).astype(np.float64),
                     nwords)
    out = (hi + lo).astype(np.uint64).astype(">u4").view(np.uint8)
    out = out[:(total + 7) // 8].copy()
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1
    ff = out == 0xFF
    stuffed = np.zeros(len(out) + int(ff.sum()), np.uint8)
    stuffed[np.arange(len(out)) + np.cumsum(ff) - ff] = out
    return stuffed.tobytes()


def lossless_jpeg(planes, precision: int = 8, predictor: int = 1,
                  pt: int = 0, ids=None, factors=None,
                  restart_rows: int = 0, pre: bytes = b"",
                  size=None, interleave: bool = True) -> bytes:
    """A lossless JPEG (SOF3, Huffman; T.81 Annex H) of ``planes`` (integer
    arrays, a component each, at their sampled sizes for ``factors``; the
    first plane's size at the largest factors is the image's) of
    ``precision`` bits, ``predictor`` 1..7 and point transform ``pt`` (or,
    with a scan a component, a point transform a component): one
    interleaved scan (``interleave`` False: a scan a component, its MCU
    a sample), a restart every ``restart_rows`` MCU rows (T.81 H.1.2.1:
    the first row after each is predicted as a first row), ``pre`` the
    segments after SOI; ``size`` (H, W) the image's, by default the first
    plane's (at the largest factors). Vectorised: the predictions of the shifted
    samples, the differences mod 2^16, their categories and codes from one
    optimal table (jchuff.c's) and the bits packed in one pass."""
    n = len(planes)
    factors = list(factors or [(1, 1)] * n)
    ids = list(ids or range(1, n + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    H, W = size or np.shape(planes[0])
    for p, (h, v) in zip(planes, factors):
        if np.shape(p) != (-(-H * v // vmax), -(-W * h // hmax)):
            raise ValueError(f"plane {np.shape(p)} at factors {(h, v)} of "
                             f"{(H, W)}")
    mx, my = -(-W // hmax), -(-H // vmax)
    pts = list(pt) if np.ndim(pt) else [pt] * n
    if interleave and len(set(pts)) > 1:
        raise ValueError("one interleaved scan has one point transform")
    units = []  # (my, mx, samples of the MCU) of each component
    for p, (h, v), t in zip(planes, factors, pts):
        x = np.asarray(p).astype(np.int64) >> t
        first = first_rows(len(x), v if interleave else 1, restart_rows)
        initial = 1 << (precision - t - 1)
        diff = (x - predict(x, predictor, first, initial)) & 0xFFFF
        if not interleave:  # an MCU row is a row of the component
            units.append(diff[:, :, None])
            continue
        pad = np.zeros((my * v, mx * h), np.int64)
        pad[:x.shape[0], :x.shape[1]] = diff
        units.append(pad.reshape(my, v, mx, h).transpose(0, 2, 1, 3)
                     .reshape(my, mx, v * h))
    scans = [np.concatenate(units, axis=2)] if interleave else units
    if not interleave and restart_rows and \
            len({u.shape[1] for u in units}) > 1:
        raise ValueError("restarts of a scan a component need one width")
    mx = scans[0].shape[1]
    diffs = np.concatenate([u.reshape(-1) for u in scans])
    d = np.where(diffs >= 32768, diffs - 65536, diffs)
    ssss = np.where(diffs == 32768, 16, _bit_length(np.abs(d)))
    bits, vals = _optimal_bits(np.bincount(ssss.ravel(), minlength=17))
    code, length = _code_table(bits, vals)
    extra_n = np.where(ssss == 16, 0, ssss)
    extra = (d - (d < 0)) & ((1 << extra_n) - 1)
    words = (code[ssss] << extra_n) | extra
    lengths = length[ssss] + extra_n
    at = np.cumsum([0] + [u.size for u in scans])
    sof = struct.pack(">BHHB", precision, H, W, n) + b"".join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, factors))
    out = bytearray(b"\xff\xd8" + pre + segment(0xC3, sof) + segment(
        0xC4, bytes([0x00]) + bytes(bits) + vals))
    if restart_rows:
        out += segment(0xDD, struct.pack(">H", restart_rows * mx))
    for j, scan in enumerate(scans):
        comps = range(n) if interleave else [j]
        out += segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], 0x00]) for c in comps) + bytes([predictor, 0,
                                                            pts[j]]))
        rows, per_row = scan.shape[0], scan[0].size
        step = restart_rows or rows
        for k, r0 in enumerate(range(0, rows, step)):
            if k:
                out += bytes((0xFF, 0xD0 + (k - 1) % 8))
            span = slice(at[j] + r0 * per_row,
                         at[j] + min(r0 + step, rows) * per_row)
            out += _pack(words[span], lengths[span])
    return bytes(out + b"\xff\xd9")


def _bit_length(a: np.ndarray) -> np.ndarray:
    """The bits of each non-negative integer below 2^16 (0 for 0)."""
    n = np.zeros(a.shape, np.int64)
    for s in range(16):
        n += (a >> s) > 0
    return n



# -------------------------- arithmetic coding --------------------------

# T.81 Table D.2 (libjpeg's jaricom.c): Qe, Next_Index_LPS, Next_Index_MPS,
# Switch_MPS of each state; state 113 is the fixed estimate of 0.5
# (T.851), for the signs and DC refinement bits.
QE_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
_QE = [q for q, _, _, _ in QE_TABLE]
_NL = [(s << 7) | lps for _, lps, _, s in QE_TABLE]
_NM = [mps for _, _, mps, _ in QE_TABLE]
FIXED = 113  # the fixed-estimate state
DC_BINS, AC_BINS = 64, 256


class _QM:
    """libjpeg-turbo's QM encoder (jcarith.c arith_encode, emit_restart,
    finish_pass): the C and A registers, the stacked 0xFF and pending 0x00
    counts and the byte buffer; statistics bins are bytearrays whose entry
    is (MPS << 7) | state."""

    def __init__(self):
        self.out = bytearray()
        self.start()

    def start(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, v: int):
        self.out.append(v)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _byte_out(self, temp: int):
        if temp > 0xFF:  # carry over the stacked 0xFF bytes
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st, i: int, val: int):
        sv = st[i]
        qe = _QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ _NL[sv & 0x7F]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ _NM[sv & 0x7F]
        while True:  # renormalization and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:  # the final bytes, only if not 0x00
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)


class _ArithScan:
    """One scan's statistics and predictions (jcarith.c): DC and AC bins a
    table, each component's last DC value and conditioning context."""

    def __init__(self, qm: _QM, comps, tables, dac, progressive, ss, se, ah,
                 al):
        self.qm, self.comps, self.tables, self.dac = qm, comps, tables, dac
        self.progressive, self.ss, self.se, self.ah, self.al = \
            progressive, ss, se, ah, al
        self.fixed = bytearray([FIXED])
        self.reset()

    def reset(self):
        n = len(self.comps)
        self.dc = {t: bytearray(DC_BINS) for t, _ in self.tables}
        self.ac = {t: bytearray(AC_BINS) for _, t in self.tables}
        self.last_dc, self.context = [0] * n, [0] * n

    def dc_first(self, ci: int, value: int):
        """F.1.4.1 (a sequential block's DC, or a progressive DC first
        scan's point-transformed one)."""
        tbl = self.tables[ci][0]
        st = self.dc[tbl]
        at = self.context[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            self.qm.encode(st, at, 0)
            self.context[ci] = 0
            return
        self.last_dc[ci] = value
        self.qm.encode(st, at, 1)
        if v > 0:
            self.qm.encode(st, at + 1, 0)
            at += 2
            self.context[ci] = 4
        else:
            v = -v
            self.qm.encode(st, at + 1, 1)
            at += 3
            self.context[ci] = 8
        L, U = self.dac.get(("dc", tbl), (0, 1))
        m = self._dc_magnitude(st, at, v)
        if m < (1 << L) >> 1:
            self.context[ci] = 0
        elif m > (1 << U) >> 1:
            self.context[ci] += 8

    def _dc_magnitude(self, st, at, v):
        qm = self.qm
        m = 0
        v -= 1
        if v:
            qm.encode(st, at, 1)
            m = 1
            v2 = v
            at = 20
            v2 >>= 1
            while v2:
                qm.encode(st, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
        qm.encode(st, at, 0)
        at += 14
        mm = m >> 1
        while mm:
            qm.encode(st, at, 1 if mm & v else 0)
            mm >>= 1
        return m

    def _ac_magnitude(self, st, at, v, k, tbl):
        qm = self.qm
        m = 0
        v -= 1
        if v:
            qm.encode(st, at, 1)
            m = 1
            v2 = v >> 1
            if v2:
                qm.encode(st, at, 1)
                m <<= 1
                at = 189 if k <= self.dac.get(("ac", tbl), 5) else 217
                v2 >>= 1
                while v2:
                    qm.encode(st, at, 1)
                    m <<= 1
                    at += 1
                    v2 >>= 1
        qm.encode(st, at, 0)
        at += 14
        m >>= 1
        while m:
            qm.encode(st, at, 1 if m & v else 0)
            m >>= 1

    def ac_first(self, ci: int, zz):
        """F.1.4.2 / G.1.3.2: the coefficients ss..se of a block in zig-zag
        order ``zz`` (point-transformed by al, magnitudes rounded toward
        0)."""
        tbl = self.tables[ci][1]
        st = self.ac[tbl]
        qm = self.qm
        al = self.al
        pt = [(abs(int(v)) >> al) * (1 if v >= 0 else -1) for v in zz]
        ke = self.se
        while ke > 0 and pt[ke] == 0:
            ke -= 1
        k = self.ss
        while k <= ke:
            at = 3 * (k - 1)
            qm.encode(st, at, 0)  # not EOB
            while pt[k] == 0:
                qm.encode(st, at + 1, 0)
                at += 3
                k += 1
            qm.encode(st, at + 1, 1)
            v = pt[k]
            qm.encode(self.fixed, 0, 0 if v > 0 else 1)
            self._ac_magnitude(st, at + 2, abs(v), k, tbl)
            k += 1
        if k <= self.se:
            qm.encode(st, 3 * (k - 1), 1)  # EOB

    def dc_refine(self, value: int):
        self.qm.encode(self.fixed, 0, (value >> self.al) & 1)

    def ac_refine(self, ci: int, zz):
        """G.1.3.3: the next bit (al) of coefficients ss..se whose
        magnitudes were coded to bit ah."""
        tbl = self.tables[ci][1]
        st = self.ac[tbl]
        qm = self.qm
        mag = [abs(int(v)) for v in zz]
        ke = self.se
        while ke > 0 and mag[ke] >> self.al == 0:
            ke -= 1
        kex = ke
        while kex > 0 and mag[kex] >> self.ah == 0:
            kex -= 1
        k = self.ss
        while k <= ke:
            at = 3 * (k - 1)
            if k > kex:
                qm.encode(st, at, 0)
            while True:
                v = mag[k] >> self.al
                if v:
                    if v >> 1:  # nonzero before this scan
                        qm.encode(st, at + 2, v & 1)
                    else:
                        qm.encode(st, at + 1, 1)
                        qm.encode(self.fixed, 0, 0 if zz[k] > 0 else 1)
                    break
                qm.encode(st, at + 1, 0)
                at += 3
                k += 1
            k += 1
        if k <= self.se:
            qm.encode(st, 3 * (k - 1), 1)


def simple_progression(n: int):
    """libjpeg's jpeg_simple_progression scans, (components, Ss, Se, Ah,
    Al): for three components the YCbCr script, else its generic one."""
    if n == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    every = tuple(range(n))
    scans = [(every, 0, 0, 0, 1)] if n <= 4 else [((c,), 0, 0, 0, 1)
                                                   for c in every]
    scans += [((c,), 1, 5, 0, 2) for c in every]
    scans += [((c,), 6, 63, 0, 2) for c in every]
    scans += [((c,), 1, 63, 2, 1) for c in every]
    scans += [(every, 0, 0, 1, 0)] if n <= 4 else [((c,), 0, 0, 1, 0)
                                                    for c in every]
    scans += [((c,), 1, 63, 1, 0) for c in every]
    return scans


def dac_segment(dac: dict) -> bytes:
    """A DAC segment of ``dac``: {("dc", table): (L, U), ("ac", table): K}."""
    body = b""
    for (kind, tbl), val in sorted(dac.items()):
        if kind == "dc":
            body += bytes([tbl, (val[1] << 4) | val[0]])
        else:
            body += bytes([0x10 | tbl, val])
    return segment(0xCC, body)


def arithmetic_jpeg(coefs, factors, size, tables: bytes, tq=None, ids=None,
                    pre: bytes = b"", restart: int = 0,
                    progressive: bool = False, dac: dict = None,
                    scans=None, interleave: bool = True) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with ``progressive``;
    libjpeg-turbo's jcarith.c, T.81 Annex D and F.1.4) of quantized
    coefficients: ``coefs`` a component's (blocks down, blocks across, 64)
    array in natural order, padded to whole MCUs (as a decoder's
    coefficient buffer holds them, so a Huffman file is transcoded
    losslessly, as ``jpegtran -arithmetic`` does), at ``factors`` and image
    ``size`` (H, W); ``tables`` the DQT segments, ``tq`` each component's
    table, ``ids`` its id, ``pre`` the segments after SOI, ``restart`` MCUs
    a restart interval, ``dac`` the conditioning (:func:`dac_segment`;
    tables 0 for DC and AC), ``scans`` a progressive script
    (:func:`simple_progression` by default) and ``interleave`` False for a
    sequential scan a component."""
    H, W = size
    n = len(coefs)
    ids = list(ids or range(1, n + 1))
    tq = list(tq or [0] * n)
    dac = dict(dac or {})
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    zz = [np.asarray(c, np.int64)[..., ZIGZAG] for c in coefs]
    sof = struct.pack(">BHHB", 8, H, W, n) + b"".join(
        bytes([i, (h << 4) | v, t]) for i, (h, v), t in zip(ids, factors, tq))
    out = bytearray(b"\xff\xd8" + pre + tables)
    if dac:
        out += dac_segment(dac)
    out += segment(0xCA if progressive else 0xC9, sof)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    if not progressive:
        scans = [(tuple(range(n)), 0, 63, 0, 0)] if interleave else [
            ((c,), 0, 63, 0, 0) for c in range(n)]
    elif scans is None:
        scans = simple_progression(n)
    for comps, ss, se, ah, al in scans:
        out += segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], 0x00]) for c in comps) + bytes([ss, se,
                                                            (ah << 4) | al]))
        qm = _QM()
        scan = _ArithScan(qm, comps, [(0, 0)] * len(comps), dac, progressive,
                          ss if progressive else 1, se, ah, al)
        if len(comps) == 1:
            c = comps[0]
            h, v = factors[c]
            bh, bw = -(-(-(-H * v // vmax)) // 8), -(-(-(-W * h // hmax)) // 8)
            units = [[(0, c, by, bx)] for by in range(bh) for bx in range(bw)]
        else:
            units = [[(j, c, y * factors[c][1] + b, x * factors[c][0] + a)
                      for j, c in enumerate(comps)
                      for b in range(factors[c][1])
                      for a in range(factors[c][0])]
                     for y in range(my) for x in range(mx)]
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                qm.finish()
                qm.out += bytes((0xFF, 0xD0 + (u // restart - 1) % 8))
                qm.start()
                scan.reset()
            for j, c, by, bx in unit:
                blk = zz[c][by, bx]
                if not progressive:
                    scan.dc_first(j, int(blk[0]))
                    scan.ac_first(j, blk)
                elif ss == 0 and ah == 0:
                    scan.dc_first(j, int(blk[0]) >> al)
                elif ss == 0:
                    scan.dc_refine(int(blk[0]))
                elif ah == 0:
                    scan.ac_first(j, blk)
                else:
                    scan.ac_refine(j, blk)
        qm.finish()
        out += qm.out
    return bytes(out + b"\xff\xd9")


def sof11_constant(h: int, w: int, precision: int = 8) -> bytes:
    """A true arithmetic-coded lossless JPEG (SOF11, predictor 1) of an
    (h, w) grey image whose every sample is the first prediction,
    2^(precision - 1): every difference is 0, so every sample codes one
    decision 0 in the one statistics bin its zero neighbours select (T.81
    H.1.4.3), whichever bin that is."""
    qm = _QM()
    st = bytearray(1)
    for _ in range(h * w):
        qm.encode(st, 0, 0)
    qm.finish()
    sof = struct.pack(">BHHB", precision, h, w, 1) + bytes([1, 0x11, 0])
    return (b"\xff\xd8" + segment(0xCB, sof)
            + segment(0xDA, bytes([1, 1, 0x00, 1, 0, 0])) + bytes(qm.out)
            + b"\xff\xd9")


def hierarchical_jpeg(h: int, w: int) -> bytes:
    """A hierarchical JPEG (T.81 Annex J) of an (h, w) mid-grey image: DHP,
    a first frame coded sequential with arithmetic coding (SOF9, all
    coefficients 0), EXP (no expansion) and a differential frame (SOF13)
    adding zero differences to it."""
    blocks = np.zeros((-(-h // 8), -(-w // 8), 64), np.int64)
    tables = segment(0xDB, bytes([0]) + bytes(QUANT[ZIGZAG].astype(np.uint8)))
    frame = _segments(arithmetic_jpeg([blocks], [(1, 1)], (h, w), tables))
    sof = next(b for m, b, _ in frame if m == 0xC9)
    _, sos, scan = next(s for s in frame if s[0] == 0xDA)
    return (b"\xff\xd8" + tables + segment(0xDE, sof) + segment(0xC9, sof)
            + segment(0xDA, sos) + scan + segment(0xDF, bytes([0x00]))
            + segment(0xCD, sof) + segment(0xDA, sos) + scan + b"\xff\xd9")
