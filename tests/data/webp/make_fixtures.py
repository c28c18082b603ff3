"""Write the lossy WebP fixtures of the card's WebP reads and cv2's arrays
of them.

    python tests/data/webp/make_fixtures.py

Needs OpenCV and Pillow (whose bundled libwebp encodes). The files are
libwebp's: Pillow's ``save`` for the extended format (``ALPH``, ``ICCP``,
``EXIF``, animation), and libwebp's own ``WebPEncode`` through ``ctypes``
for the encoder options Pillow does not expose (filter type, sharpness and
strength, segments, token partitions). Each option is checked in the frame
header the encoder wrote (:func:`vp8_header`), and ``fixtures.json``
records those header fields per file.

Written here:

* ``*.webp``: sizes 1x1, 15x17, 16x16, 17x33 and 8x300 (W x H; 19 MB rows
  for the wavefront), qualities 5 (skipped MBs, DC-only blocks) and 100,
  noisy images (sub-block modes) and flat ones (16x16 modes), the simple
  and the normal loop filter, sharpness 0-7, filter strength 0 (no
  filter), 1-4 segments, 1/2/4/8 token partitions, lossy with ``ALPH``,
  with ``ICCP``, with ``EXIF`` orientations 1-8 (also with the chunk's
  ``Exif`` prefix, which cv2 does not read as EXIF), and
  ``lf_deltas.webp``: a frame whose header carries the loop filter's
  reference and mode deltas, which libwebp's encoder never writes
  (:func:`with_lf_deltas`; ``--part deltas`` writes it alone, its arrays
  cv2.imread's of the file);
* ``cv2_arrays.npz``: cv2.imdecode's grey and BGR arrays of each
  (``gray_<name>``, ``bgr_<name>``);
* ``refused/``: what cv2 refuses too (a truncated RIFF, a RIFF that is
  not WEBP, a VP8X canvas that differs from the frame);
* ``conversion/``: see ``make_conversion.py``; lossless and animated
  files: ``make_lossless.py``.
"""

import argparse
import ctypes
import glob
import io
import json
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


# ----------------------------- libwebp's encoder -----------------------------

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_ABI = 0x020f  # WEBP_ENCODER_ABI_VERSION of libwebp 1.6


class _Config(ctypes.Structure):  # WebPConfig, with room to spare
    _fields_ = [(n, _I) for n in ("lossless",)] + [("quality", _F)] + [
        (n, _I) for n in ("method", "image_hint", "target_size")] + [
        ("target_PSNR", _F)] + [(n, _I) for n in (
            "segments", "sns_strength", "filter_strength", "filter_sharpness",
            "filter_type", "autofilter", "alpha_compression",
            "alpha_filtering", "alpha_quality", "pass_", "show_compressed",
            "preprocessing", "partitions", "partition_limit",
            "emulate_jpeg_size", "thread_level", "low_memory",
            "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv",
            "qmin", "qmax")] + [("pad", ctypes.c_uint32 * 64)]


class _Writer(ctypes.Structure):  # WebPMemoryWriter
    _fields_ = [("mem", _P), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 8)]


class _Picture(ctypes.Structure):  # WebPPicture, with room to spare
    _fields_ = [("use_argb", _I), ("colorspace", _I), ("width", _I),
                ("height", _I), ("y", _P), ("u", _P), ("v", _P),
                ("y_stride", _I), ("uv_stride", _I), ("a", _P),
                ("a_stride", _I), ("pad1", ctypes.c_uint32 * 2),
                ("argb", _P), ("argb_stride", _I),
                ("pad2", ctypes.c_uint32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", _I),
                ("extra_info", _P), ("stats", _P), ("error_code", _I),
                ("progress_hook", _P), ("user_data", _P),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", _P),
                ("memory_argb_", _P), ("pad7", _P * 2),
                ("spare", ctypes.c_uint8 * 512)]


def _libwebp():
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                        "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0],
                mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])


def encode(bgr: np.ndarray, quality: float = 75, **options) -> bytes:
    """A simple-format lossy WebP of a uint8 (H, W, 3) BGR image by
    libwebp's WebPEncode, with WebPConfig fields set from ``options``."""
    lib = _libwebp()
    cfg = _Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, _F(quality), _ABI):
        raise RuntimeError("WebPConfigInit")
    for k, v in options.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses {options}")
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI):
        raise RuntimeError("WebPPictureInit")
    H, W = bgr.shape[:2]
    pic.width, pic.height = W, H
    a = np.ascontiguousarray(bgr, np.uint8)
    wr = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    try:
        if not lib.WebPPictureImportBGR(ctypes.byref(pic),
                                        a.ctypes.data_as(_P), 3 * W):
            raise RuntimeError("WebPPictureImportBGR")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
        pic.custom_ptr = ctypes.addressof(wr)
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode: error {pic.error_code}")
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(wr))


def pillow_webp(bgr: np.ndarray, quality: float = 75, alpha=None,
                **save) -> bytes:
    """Pillow's lossy WebP of a BGR image (with an alpha plane if given),
    extended format where ``save`` asks for chunks."""
    from PIL import Image

    rgb = np.ascontiguousarray(bgr[..., ::-1])
    im = Image.fromarray(rgb) if alpha is None else Image.fromarray(
        np.dstack([rgb, alpha]), "RGBA")
    f = io.BytesIO()
    im.save(f, "WEBP", quality=quality, **save)
    return f.getvalue()


# ----------------------------- the frame header -----------------------------

def chunks(data: bytes):
    """(fourcc, payload) of each chunk of a RIFF/WEBP file."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


class _Bool:
    """RFC 6386 section 7.3's boolean decoder (a header's bits only)."""

    def __init__(self, data: bytes):
        self.d, self.i = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.count = 255, 0

    def get(self, prob: int = 128) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            bit, self.range, self.value = 1, self.range - split, \
                self.value - (split << 8)
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value, self.range = self.value << 1, self.range << 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.d[self.i] if self.i < len(self.d) else 0
                self.i += 1
        return bit

    def lit(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get()
        return v

    def signed(self, n: int) -> int:
        v = self.lit(n)
        return -v if self.get() else v


def vp8_header(data: bytes) -> dict:
    """The fields of a WebP's VP8 frame header (RFC 6386 section 9) the
    fixtures vary: size, segmentation, filter, partitions, base quantizer."""
    vp8 = dict(chunks(data))[b"VP8 "]
    width = struct.unpack("<H", vp8[6:8])[0] & 0x3fff
    height = struct.unpack("<H", vp8[8:10])[0] & 0x3fff
    br = _Bool(vp8[10:])
    br.get(), br.get()  # colour space, clamping
    seg = {"use_segment": br.get(), "update_map": 0, "segments_used": 1}
    if seg["use_segment"]:
        seg["update_map"] = br.get()
        if br.get():
            br.get()
            q = [br.signed(7) if br.get() else 0 for _ in range(4)]
            [br.signed(6) if br.get() else 0 for _ in range(4)]
            seg["segment_quantizers"] = q
        if seg["update_map"]:
            [br.lit(8) if br.get() else 255 for _ in range(3)]
    simple, level, sharpness = br.get(), br.lit(6), br.lit(3)
    deltas = {}
    if br.get() and br.get():
        deltas = {"lf_deltas": [br.signed(6) if br.get() else 0
                                for _ in range(8)]}
    partitions = 1 << br.lit(2)
    return dict(width=width, height=height, simple=simple, level=level,
                sharpness=sharpness, partitions=partitions,
                base_q=br.lit(7), **seg, **deltas)


# ------------------------- the loop filter's deltas -------------------------

# The host decoder (csrc/webp_decode.h) with every read of the first
# partition recorded, (probability << 1 | bit), built for the host.
_TRACE_SHIM = r'''
#include <stdint.h>
#include <vector>
static std::vector<uint16_t> g_trace;
static const void* g_first = nullptr;
#include "webp_decode_traced.h"
extern "C" int first_partition_trace(const unsigned char* data, size_t n,
                                     int* records, short* coefs,
                                     int* params, uint16_t* out, int cap) {
  g_trace.clear();
  int err = webp_host_decode(data, n, records, coefs, params);
  if (err) return -err;
  for (size_t i = 0; i < g_trace.size() && (int)i < cap; i++)
    out[i] = g_trace[i];
  return (int)g_trace.size();
}
'''


def _first_partition(data: bytes):
    """[(probability, bit)] of every read the decoder makes of a lossy
    WebP's first partition: its header and every macroblock's modes."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        HERE))), "mpmvs_torch", "csrc")
    with open(os.path.join(csrc, "webp_decode.h")) as f:
        src = f.read()
    for old, new in (
            ("    return bit;\n  }\n  int literal(",
             "    if (this == g_first) g_trace.push_back((uint16_t)(prob << 1 "
             "| bit));\n    return bit;\n  }\n  int literal("),
            ("  BoolDecoder& br = f->br;\n  br.init(d, first_len);",
             "  BoolDecoder& br = f->br;\n  g_first = &br;\n"
             "  br.init(d, first_len);")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "webp_decode_traced.h"), "w") as f:
            f.write(src)
        with open(os.path.join(tmp, "trace.cpp"), "w") as f:
            f.write(_TRACE_SHIM)
        so = os.path.join(tmp, "trace.so")
        subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-I", tmp, "-I",
                        csrc, "-o", so, os.path.join(tmp, "trace.cpp")],
                       check=True)
        lib = ctypes.CDLL(so)
        head = vp8_header(data)
        mbs = ((head["width"] + 15) // 16) * ((head["height"] + 15) // 16)
        records = np.zeros(4 * mbs, np.int32)
        coefs = np.zeros(mbs * 25 * 16, np.int16)
        params = np.zeros(49, np.int32)
        out = np.zeros(1 << 22, np.uint16)
        n = lib.first_partition_trace(
            data, ctypes.c_size_t(len(data)), records.ctypes.data_as(_P),
            coefs.ctypes.data_as(_P), params.ctypes.data_as(_P),
            out.ctypes.data_as(_P), ctypes.c_int(len(out)))
    assert 0 < n <= len(out), n
    return [(int(v) >> 1, int(v) & 1) for v in out[:n]]


def _bool_encode(symbols) -> bytes:
    """RFC 6386 section 7.3's boolean encoder of [(probability, bit)]."""
    out = bytearray()
    rng, bottom, count = 255, 0, 24

    def carry():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, bit in symbols:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if not count:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                count = 8
    c, v = count, bottom
    if v & (1 << (32 - c)):
        carry()
    v = (v << (c & 7)) & 0xFFFFFFFF
    for _ in range(c >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def with_lf_deltas(data: bytes, ref, mode) -> bytes:
    """A simple-format lossy WebP of ``data``'s frame (one segment) with
    the loop filter's reference deltas ``ref`` and mode deltas ``mode``
    (4 each) in its header: the first partition's reads re-coded with the
    deltas' bits where libwebp wrote use_lf_delta 0."""
    syms = _first_partition(data)
    head = vp8_header(data)
    assert not head["use_segment"] and "lf_deltas" not in head
    at = 2 + 1 + 1 + 6 + 3  # colour space, clamping, segmentation, filter
    assert syms[at] == (128, 0)
    bits = [(128, 1), (128, 1)]  # use_lf_delta, update
    for d in list(ref) + list(mode):
        bits.append((128, 1))
        bits += [(128, (abs(d) >> i) & 1) for i in reversed(range(6))]
        bits.append((128, int(d < 0)))
    part = _bool_encode(syms[:at] + bits + syms[at + 1:])
    vp8 = dict(chunks(data))[b"VP8 "]
    tag = int.from_bytes(vp8[:3], "little")
    frame = ((tag & 0x1F) | (len(part) << 5)).to_bytes(3, "little") + \
        vp8[3:10] + part + vp8[10 + (tag >> 5):]
    return riff([(b"VP8 ", frame)])


def delta_fixtures():
    """{name: (bytes, header fields)} of the frames with loop filter
    deltas: a key frame's filter level moves by the reference delta of
    intra frames, and by the mode delta of sub-block (B_PRED) MBs."""
    base = encode(noisy(48, 64, 4), 10, filter_type=1, filter_strength=50,
                  filter_sharpness=2)  # level 24
    out = {}
    # the levels 31 and 19; then 74 clipped to 63, and 11
    for name, ref, mode in (("lf_deltas", (7, -3, 2, 0), (-12, 4, 0, -1)),
                            ("lf_deltas_clipped", (50, 0, 0, 0),
                             (-63, 0, 0, 0))):
        out[name] = (with_lf_deltas(base, ref, mode),
                     {"lf_deltas": list(ref + mode), "simple": 0,
                      "sharpness": 2, "level": 24})
    return out


def write_deltas() -> None:
    """Add :func:`delta_fixtures` with cv2.imread's arrays of each file to
    ``cv2_arrays.npz`` and their header fields to ``fixtures.json``."""
    import cv2

    path = os.path.join(HERE, "cv2_arrays.npz")
    arrays = dict(np.load(path))
    with open(os.path.join(HERE, "fixtures.json")) as f:
        manifest = json.load(f)
    for name, (data, want) in delta_fixtures().items():
        head = vp8_header(data)
        bad = {k: (head[k], v) for k, v in want.items() if head[k] != v}
        if bad:
            raise AssertionError(f"{name}: the frame does not hold {bad}")
        file = os.path.join(HERE, f"{name}.webp")
        with open(file, "wb") as f:
            f.write(data)
        g = cv2.imread(file, cv2.IMREAD_GRAYSCALE)
        c = cv2.imread(file, cv2.IMREAD_COLOR)
        if g is None or c is None:
            raise AssertionError(f"cv2 does not read {name}")
        arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = g, c
        manifest[name] = head
    np.savez_compressed(path, **arrays)
    with open(os.path.join(HERE, "fixtures.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


# ----------------------------- the images -----------------------------

def noisy(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Gradients, edges and noise: every kind of MB (BGR uint8)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / 7 + c) * np.cos(y / 11 - c)
                     for c in range(3)], -1)
    base[(x + 2 * y).astype(int) % 23 < 5] = (250, 30, 90)
    base += rng.normal(0, 40, base.shape)
    base[: h // 3, : w // 2] = rng.integers(0, 256, (h // 3, w // 2, 3))
    return np.clip(base, 0, 255).astype(np.uint8)


def flat(h: int, w: int) -> np.ndarray:
    """A smooth gradient: 16x16 modes."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.clip(np.stack([40 + x * 2, 90 + y, 200 - x - y], -1), 0,
                   255).astype(np.uint8)


def segmented(h: int, w: int) -> np.ndarray:
    """Flat and busy regions side by side, so libwebp's segments differ."""
    img = flat(h, w)
    img[:, w // 2:] = noisy(h, w - w // 2, 5)
    img[h // 2:, : w // 4] = noisy(h - h // 2, w // 4, 6)
    return img


def exif_orientation(k: int, prefix: bool = False) -> bytes:
    """A big-endian TIFF-structured EXIF holding Orientation = k (with
    ``Exif\\0\\0`` before it if ``prefix``)."""
    tiff = (b"MM\x00*" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, k, 0) + b"\x00" * 4)
    return (b"Exif\x00\x00" if prefix else b"") + tiff


def riff(chunk_list) -> bytes:
    body = b"WEBP" + b"".join(
        fourcc + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
        for fourcc, p in chunk_list)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (
        h - 1).to_bytes(3, "little")


def fixtures():
    """{name: (bytes, the header fields the fixture must show)}."""
    out = {}
    n = noisy(48, 64)
    for w, h in ((1, 1), (15, 17), (16, 16), (17, 33), (8, 300)):
        out[f"size_{w}x{h}"] = (encode(noisy(h, w, w + h), 75), {})
    out["q5_noisy"] = (encode(n, 5), {})
    out["q100_noisy"] = (encode(n, 100), {})
    out["flat_q75"] = (encode(flat(48, 64), 75), {})
    out["flat_q100"] = (encode(flat(48, 64), 100), {})
    out["filter_simple"] = (encode(n, 50, filter_type=0, filter_strength=60),
                            {"simple": 1})
    out["filter_normal"] = (encode(n, 50, filter_type=1, filter_strength=80),
                            {"simple": 0})
    for s in range(8):
        out[f"sharpness_{s}"] = (encode(n, 40, filter_type=1,
                                        filter_strength=70,
                                        filter_sharpness=s),
                                 {"sharpness": s, "simple": 0})
    out["filter_simple_sharp5"] = (encode(n, 30, filter_type=0,
                                          filter_strength=90,
                                          filter_sharpness=5),
                                   {"sharpness": 5, "simple": 1})
    # level 40 and above: the high-edge-variance threshold 2
    out["filter_strong"] = (encode(n, 8, filter_type=1, filter_strength=100),
                            {"simple": 0, "level": 52})
    out["nofilter"] = (encode(n, 75, filter_strength=0), {"level": 0})
    seg = segmented(96, 128)
    for s in range(1, 5):
        out[f"segments_{s}"] = (encode(seg, 60, segments=s, sns_strength=90),
                                {"use_segment": int(s > 1)})
    tall = noisy(160, 48, 9)
    for p in range(4):
        # libwebp writes token partitions at methods 0-2 only
        out[f"partitions_{1 << p}"] = (encode(tall, 80, partitions=p,
                                              method=2),
                                       {"partitions": 1 << p})
    w71 = noisy(71, 53, 3)
    rng = np.random.default_rng(11)
    out["alpha"] = (pillow_webp(w71, 75, alpha=rng.integers(
        0, 256, (71, 53), dtype=np.uint8)), {})
    out["iccp"] = (pillow_webp(w71, 75, icc_profile=b"\x00" * 128), {})
    for k in range(1, 9):
        out[f"exif_{k}"] = (pillow_webp(w71, 75, exif=exif_orientation(k)),
                            {})
    # the chunk as some writers leave it, with the JPEG APP1's prefix
    frame = dict(chunks(encode(w71, 75)))[b"VP8 "]
    out["exif_prefixed_6"] = (riff([(b"VP8X", vp8x(8, 53, 71)),
                                    (b"VP8 ", frame),
                                    (b"EXIF", exif_orientation(6, True))]),
                              {})
    return out


def refused():
    """{name: bytes} of the files under refused/."""
    w71 = noisy(71, 53, 3)
    good = encode(w71, 75)
    frame = dict(chunks(good))[b"VP8 "]
    return {
        "truncated.webp": good[:len(good) // 2],
        "not_webp.webp": b"RIFF" + struct.pack("<I", 36) + b"WAVEfmt "
                         + b"\x00" * 28,
        "canvas.webp": riff([(b"VP8X", vp8x(0, 60, 71)), (b"VP8 ", frame)]),
    }


def main() -> int:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "deltas"), default="all")
    if ap.parse_args().part == "deltas":
        write_deltas()
        return 0
    arrays, manifest = {}, {}
    for name, (data, want) in fixtures().items():
        head = vp8_header(data)
        bad = {k: (head[k], v) for k, v in want.items() if head[k] != v}
        if bad:
            raise AssertionError(f"{name}: the encoder did not write {bad}")
        buf = np.frombuffer(data, np.uint8)
        g = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        c = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if g is None or c is None:
            raise AssertionError(f"cv2 does not read {name}")
        arrays[f"gray_{name}"], arrays[f"bgr_{name}"] = g, c
        manifest[name] = head
        with open(os.path.join(HERE, f"{name}.webp"), "wb") as f:
            f.write(data)
    parts = sorted({m["partitions"] for m in manifest.values()})
    sharp = sorted({m["sharpness"] for m in manifest.values()
                    if m["level"]})
    if parts != [1, 2, 4, 8] or sharp != list(range(8)):
        raise AssertionError(f"partitions {parts}, sharpness {sharp}")
    np.savez_compressed(os.path.join(HERE, "cv2_arrays.npz"), **arrays)
    with open(os.path.join(HERE, "fixtures.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    os.makedirs(os.path.join(HERE, "refused"), exist_ok=True)
    for name, data in refused().items():
        if cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is not None:
            raise AssertionError(f"cv2 reads refused/{name}")
        with open(os.path.join(HERE, "refused", name), "wb") as f:
            f.write(data)
    print(f"{len(manifest)} fixtures, {len(refused())} refused")
    write_deltas()
    return 0


if __name__ == "__main__":
    sys.exit(main())
