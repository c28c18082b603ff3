"""Write TIFF files field by field, for test sources that cv2.imencode and
PIL cannot write: tiles, BigTIFF, planar configuration 2, min-is-white,
16-bit colour maps, predictor 2 on 16-bit samples, either byte order.

    from tiff_file import tiff_bytes
    data = tiff_bytes(samples, photometric=2, compression=5, predictor=2)

``samples`` is (H, W, C) uint8 or uint16 (or (H, W), one sample), each
sample below 2 ** ``bits``. Compressions: 1 (none), 5 (LZW, by
``lzw_encode.c`` beside this file, built with the C compiler at first use),
8 and 32946 (Deflate), 32773 (PackBits); any other value is written as its
tag over the data as given (a file a reader must refuse by its tag, or,
with ``chunks``, the strips or tiles of another codec: JPEG streams for
Compression 7, with their ``JPEGTables`` in ``extra_tags``).
"""

import atexit
import ctypes
import functools
import os
import shutil
import struct
import subprocess
import tempfile
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BYTE, SHORT, LONG, RATIONAL, UNDEFINED, LONG8 = 1, 3, 4, 5, 7, 16


@functools.lru_cache(maxsize=None)
def _lzw_library():
    cc = shutil.which("gcc") or shutil.which("cc") or shutil.which("g++")
    if cc is None:
        raise RuntimeError("LZW test sources need a C compiler")
    folder = tempfile.mkdtemp(prefix="tiff_lzw_")
    atexit.register(shutil.rmtree, folder, True)
    out = os.path.join(folder, "lzw.so")
    subprocess.run([cc, "-O2", "-shared", "-fPIC", "-x", "c",
                    os.path.join(HERE, "lzw_encode.c"), "-o", out],
                   check=True)
    lib = ctypes.CDLL(out)
    lib.lzw_encode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_void_p, ctypes.c_int]
    lib.lzw_encode.restype = ctypes.c_size_t
    return lib


def lzw(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW (``compat``: the pre-1991 bit-reversed form)."""
    out = np.empty(2 * len(data) + 16, np.uint8)
    n = _lzw_library().lzw_encode(data, len(data), out.ctypes.data,
                                  int(compat))
    return out[:n].tobytes()


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as (1 - n, byte), the rest as
    literal runs of up to 128 bytes (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes([len(lit) - 1]) + lit
                lit = bytearray()
            out += bytes([(257 - (j - i)) & 255, data[i]])
            i = j
            continue
        lit.append(data[i])
        i += 1
        if len(lit) == 128:
            out += bytes([127]) + lit
            lit = bytearray()
    if lit:
        out += bytes([len(lit) - 1]) + lit
    return bytes(out)


def compress(data: bytes, compression: int, old_lzw: bool = False) -> bytes:
    if compression == 5:
        return lzw(data, old_lzw)
    if compression in (8, 32946):
        return zlib.compress(data, 6)
    if compression == 32773:
        return packbits(data)
    return data


def pack_rows(s: np.ndarray, bits: int, big: bool) -> np.ndarray:
    """(rows, n) samples -> (rows, rowbytes) uint8: MSB first below 8 bits,
    rows padded to a byte; 16-bit samples in the file's byte order."""
    if bits == 16:
        return s.astype(">u2" if big else "<u2").view(np.uint8).reshape(
            s.shape[0], -1)
    if bits == 8:
        return s.astype(np.uint8)
    per = 8 // bits
    n = s.shape[1]
    pad = -n % per
    s = np.concatenate([s, np.zeros((s.shape[0], pad), s.dtype)], 1)
    s = s.astype(np.uint16).reshape(s.shape[0], -1, per)
    shifts = np.arange(per - 1, -1, -1) * bits
    return (s << shifts).sum(-1).astype(np.uint8)


def predict(s: np.ndarray, channels: int) -> np.ndarray:
    """Predictor 2: each sample less the same channel's sample to its left,
    modulo its width (s: (rows, W * channels))."""
    d = s.astype(np.int64)
    d[:, channels:] -= s[:, :-channels].astype(np.int64)
    return (d % (1 << (8 * s.itemsize))).astype(s.dtype)


def tiff_bytes(samples: np.ndarray, bits: int = None, photometric: int = 2,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               big: bool = False, bigtiff: bool = False,
               rows_per_strip: int = None, tile: tuple = None,
               colormap: np.ndarray = None, extra_samples: tuple = None,
               orientation: int = None, sample_format: int = None,
               extra_tags: dict = None, pad: int = 0,
               old_lzw: bool = False, fill_order: int = 1,
               chunks: list = None) -> bytes:
    """A TIFF of one image. ``tile`` (tile width, tile length) writes tiles
    (the edge tiles' overhang filled with ``pad``), else strips of
    ``rows_per_strip`` rows (the whole image by default). ``colormap``
    (3, 2 ** bits) uint16; ``extra_samples`` the ExtraSamples values of the
    channels past the colour ones; ``extra_tags`` {tag: (type, values)};
    ``old_lzw`` codes LZW in the pre-1991 bit-reversed form; ``fill_order``
    2 reverses the bits of every byte of image data (FillOrder 2).
    ``chunks``: the strips' or tiles' bytes as they are before compression
    (``samples`` then gives the image's shape only), for data the rows of
    ``samples`` cannot hold: JPEG streams, YCbCr data units. RATIONAL
    values in ``extra_tags`` are (numerator, denominator) pairs, flat;
    BYTE and UNDEFINED values are bytes."""
    s = samples if samples.ndim == 3 else samples[..., None]
    H, W, C = s.shape
    if bits is None:
        bits = 8 * s.dtype.itemsize
    e = ">" if big else "<"
    planes = [s] if planar == 1 else [s[..., c:c + 1] for c in range(C)]
    given, chunks = chunks, []
    if given is not None:
        pass
    elif tile:
        tw, th = tile
        across, down = -(-W // tw), -(-H // th)
        for p in planes:
            full = np.full((down * th, across * tw, p.shape[2]), pad, s.dtype)
            full[:H, :W] = p
            for ty in range(down):
                for tx in range(across):
                    t = full[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                    chunks.append(t.reshape(th, -1))
    else:
        rps = rows_per_strip or H
        for p in planes:
            for y0 in range(0, H, rps):
                chunks.append(p[y0:y0 + rps].reshape(-1, W * p.shape[2]))
    per_pixel = C if planar == 1 else 1
    blobs = []
    for ch in given if given is not None else chunks:
        if given is None:
            if predictor == 2:
                ch = predict(ch, per_pixel)
            ch = pack_rows(ch, bits, big).tobytes()
        blob = compress(ch, compression, old_lzw)
        if fill_order == 2:
            blob = np.unpackbits(np.frombuffer(blob, np.uint8)).reshape(
                -1, 8)[:, ::-1].copy()
            blob = np.packbits(blob.reshape(-1)).tobytes()
        blobs.append(blob)
    tags = {256: (LONG, [W]), 257: (LONG, [H]), 258: (SHORT, [bits] * C),
            259: (SHORT, [compression]), 262: (SHORT, [photometric]),
            277: (SHORT, [C]), 284: (SHORT, [planar])}
    if predictor != 1:
        tags[317] = (SHORT, [predictor])
    if colormap is not None:
        tags[320] = (SHORT, [int(v) for v in colormap.reshape(-1)])
    if extra_samples is not None:
        tags[338] = (SHORT, list(extra_samples))
    if orientation is not None:
        tags[274] = (SHORT, [orientation])
    if sample_format is not None:
        tags[339] = (SHORT, [sample_format] * C)
    if fill_order != 1:
        tags[266] = (SHORT, [fill_order])
    tags.update(extra_tags or {})
    off_type = LONG8 if bigtiff else LONG
    if tile:
        tags[322], tags[323] = (LONG, [tile[0]]), (LONG, [tile[1]])
        offs_tag, counts_tag = 324, 325
    else:
        tags[278] = (LONG, [rows_per_strip or H])
        offs_tag, counts_tag = 273, 279
    tags[counts_tag] = (off_type, [len(b) for b in blobs])
    tags[offs_tag] = (off_type, [0] * len(blobs))  # set below

    size = {BYTE: 1, UNDEFINED: 1, SHORT: 2, LONG: 4, RATIONAL: 4, LONG8: 8}
    code = {BYTE: "B", UNDEFINED: "B", SHORT: "H", LONG: "I", RATIONAL: "I",
            LONG8: "Q"}
    head = 16 if bigtiff else 8
    entry, inline = (20, 8) if bigtiff else (12, 4)
    count_fmt = "Q" if bigtiff else "I"
    ifd_len = (8 if bigtiff else 2) + entry * len(tags) + (8 if bigtiff
                                                           else 4)
    data_at = head + ifd_len
    # values that do not fit an entry follow the IFD, then the image data
    extern = sum(size[t] * len(v) for t, v in tags.values()
                 if size[t] * len(v) > inline)
    pos = data_at + extern
    offsets = []
    for b in blobs:
        offsets.append(pos)
        pos += len(b)
    tags[offs_tag] = (off_type, offsets)
    out = bytearray()
    if bigtiff:
        out += (b"MM" if big else b"II") + struct.pack(e + "HHHQ", 43, 8, 0,
                                                       head)
        out += struct.pack(e + "Q", len(tags))
    else:
        out += (b"MM" if big else b"II") + struct.pack(e + "HI", 42, head)
        out += struct.pack(e + "H", len(tags))
    ext = bytearray()
    for tag in sorted(tags):
        t, vals = tags[tag]
        body = struct.pack(e + code[t] * len(vals), *vals)
        count = len(vals) // 2 if t == RATIONAL else len(vals)
        out += struct.pack(e + "HH" + count_fmt, tag, t, count)
        if len(body) <= inline:
            out += body + b"\0" * (inline - len(body))
        else:
            out += struct.pack(e + count_fmt, data_at + len(ext))
            ext += body
    out += struct.pack(e + count_fmt, 0)
    assert len(out) == data_at and len(ext) == extern
    return bytes(out + ext + b"".join(blobs))


def tags_of(data: bytes) -> dict:
    """{tag: values} of a classic TIFF's first IFD (either byte order;
    RATIONAL values as (numerator, denominator) pairs, flat): the check
    that a fixture holds the options it was written with."""
    e = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", data[4:8])[0]
    n = struct.unpack(e + "H", data[ifd:ifd + 2])[0]
    out = {}
    for at in range(ifd + 2, ifd + 2 + 12 * n, 12):
        tag, typ, count = struct.unpack(e + "HHI", data[at:at + 8])
        fmt = {BYTE: "B", UNDEFINED: "B", SHORT: "H", LONG: "I",
               RATIONAL: "I"}[typ]
        count *= 2 if typ == RATIONAL else 1
        size = struct.calcsize(fmt) * count
        pos = at + 8 if size <= 4 else struct.unpack(
            e + "I", data[at + 8:at + 12])[0]
        out[tag] = struct.unpack(f"{e}{count}{fmt}", data[pos:pos + size])
    return out


def cut_chunk(data: bytes, index: int, keep: int) -> bytes:
    """A classic TIFF whose strip or tile ``index`` holds only its first
    ``keep`` bytes: its byte count is set to ``keep``, and where its data
    ends the file, the file ends there too (a file cut short)."""
    e = "<" if data[:2] == b"II" else ">"
    t = tags_of(data)
    counts_tag = 325 if 325 in t else 279
    offs = t[324 if counts_tag == 325 else 273]
    out = bytearray(data)
    ifd = struct.unpack(e + "I", data[4:8])[0]
    for at in range(ifd + 2, ifd + 2 + 12 * struct.unpack(
            e + "H", data[ifd:ifd + 2])[0], 12):
        tag, typ, count = struct.unpack(e + "HHI", data[at:at + 8])
        if tag != counts_tag:
            continue
        fmt = {SHORT: "H", LONG: "I"}[typ]
        size = struct.calcsize(fmt)
        pos = at + 8 if size * count <= 4 else struct.unpack(
            e + "I", data[at + 8:at + 12])[0]
        out[pos + size * index:pos + size * (index + 1)] = struct.pack(
            e + fmt, keep)
    end = offs[index] + t[counts_tag][index]
    return bytes(out[:offs[index] + keep] if end == len(data) else out)


def cielab_samples(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 CIELab samples made from a BGR image in integers:
    L* its luma, a* and b* half the red-green and green-blue differences
    (signed bytes' bits): a CIELab TIFF's data at the image's size."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    lum = (2126 * r + 7152 * g + 722 * b + 5000) // 10000
    a = np.clip((r - g) // 2, -128, 127)
    bb = np.clip((g - b) // 2, -128, 127)
    return np.stack([lum, a & 255, bb & 255], -1).astype(np.uint8)


def rare_conversion_sources(bgr: np.ndarray) -> dict:
    """chip_smoke.py phase 8f's run-time TIFFs of a BGR image (the lossy
    WebP conversion source as cv2 reads it): its CIELab samples
    (:func:`cielab_samples`, LZW with predictor 2, 16-row strips) and its
    RGB in old-style LZW (16-row strips). LZW comes from ``lzw_encode.c``,
    so the bytes do not hang on a zlib's; ``conversion/cv2.json`` holds
    their sha-256 and cv2's hashes of them."""
    return {"lab_3200x2130.tif": tiff_bytes(
        cielab_samples(bgr), photometric=8, compression=5, predictor=2,
        rows_per_strip=16),
        "old_lzw_3200x2130.tif": tiff_bytes(
            np.ascontiguousarray(bgr[..., ::-1]), compression=5,
            old_lzw=True, rows_per_strip=16)}
