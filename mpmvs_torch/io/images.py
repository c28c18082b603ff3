"""Image files of a workspace: JPEG reads and writes, PNG writes.

The JAX package reads and writes images with OpenCV. Here the device picks
the codec:

  * on a CUDA device, JPEGs go through ``csrc/jpeg_codec.cu``: the host
    entropy-decodes the file to DCT coefficients (``csrc/jpeg_entropy.h``),
    and the card runs libjpeg's integer inverse DCT (``idct_islow_kernel``)
    and libjpeg-turbo's chroma upsampling and YCbCr -> BGR
    (``ycc_to_bgr_kernel``): what ``cv2.imread`` returns, bit for bit. The
    grey image is the Y plane, as ``cv2.imread(IMREAD_GRAYSCALE)`` gives
    it. Encoding is nvJPEG's (the CUDA toolkit's library). A codec that
    fails to build, load, decode or encode raises; nothing falls back to
    OpenCV or to the CPU. A file that is not a JPEG raises there, naming its
    format, and so does a JPEG that OpenCV would read as another image than
    its planes: one with an EXIF orientation other than 1, or with RGB
    components.
  * on the CPU, through OpenCV, imported only there: the CPU tests hold the
    port's reads against the JAX package's OpenCV reads.

PNG files (``triangulation.png``) are written on the host with the
standard library's ``zlib``, on every device.

``COUNTS`` counts launches of the colour kernel and ``IDCT_COUNTS`` of the
IDCT kernel (and calls of their plain versions, :func:`ycc_to_bgr_plain`,
:func:`idct_islow_plain`); ``CODEC_COUNTS`` counts host decodes
(``forms["decode"]``) and nvJPEG encodes (``forms["encode"]``).
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import Tuple

import numpy as np
import torch

from mpmvs_torch.ops import nvcc

Tensor = torch.Tensor

SOURCE = "jpeg_codec.cu"
NVCC_FLAGS = ("-lnvjpeg",)
PREVIEW_QUALITY = 95  # cv2.imwrite's default JPEG quality (and 4:2:0)

COUNTS = nvcc.LaunchCounts()
IDCT_COUNTS = nvcc.LaunchCounts()
CODEC_COUNTS = nvcc.LaunchCounts()
_DECODE_ERRORS = {2001: "truncated", 2002: "unsupported (arithmetic coding, "
                  "lossless, 12-bit, or more than 3 components)",
                  2003: "malformed",
                  2004: "unsupported (an EXIF orientation other than 1, "
                  "which OpenCV would apply)",
                  2005: "unsupported (RGB components, by the Adobe marker's "
                  "transform 0 or the ids 'R', 'G', 'B')"}

_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"\x89PNG\r\n\x1a\n", "PNG"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"BM", "BMP"),
          (b"GIF8", "GIF"), (b"RIFF", "RIFF (WebP)"), (b"P5", "PGM"),
          (b"P6", "PPM"))


def image_format(data: bytes) -> str:
    """The format a file's first bytes name ("JPEG", "PNG", ...), or
    "unknown"."""
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(nvcc.build(SOURCE, NVCC_FLAGS))
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    szp = ctypes.POINTER(ctypes.c_size_t)
    lib.jpeg_codec_create.argtypes = [ctypes.POINTER(vp)]
    lib.jpeg_host_decode.argtypes = [ctypes.c_char_p, sz,
                                     ctypes.POINTER(vp), ip]
    lib.jpeg_host_upload.argtypes = [vp, i, vp, vp, vp]
    lib.jpeg_host_free.argtypes = [vp]
    lib.jpeg_host_free.restype = None
    lib.idct_islow_launch.argtypes = [vp, vp, i, i, i, vp, i, i, vp]
    lib.ycc_to_bgr_launch.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp, vp]
    lib.jpeg_codec_encode.argtypes = [vp, vp, i, i, i, i, vp, szp]
    lib.jpeg_codec_retrieve.argtypes = [vp, ctypes.c_char_p, szp, vp]
    for fn in ("jpeg_codec_create", "jpeg_host_decode", "jpeg_host_upload",
               "idct_islow_launch", "ycc_to_bgr_launch", "jpeg_codec_encode",
               "jpeg_codec_retrieve"):
        getattr(lib, fn).restype = i
    return lib


def _check(err: int, what: str):
    if err in _DECODE_ERRORS:
        raise ValueError(f"{what}: {_DECODE_ERRORS[err]} JPEG")
    if err != 0:
        kind = (f"CUDA error {err - 1000}" if err >= 1000
                else f"nvJPEG status {err}")
        raise RuntimeError(f"{what} failed: {kind}")


@functools.lru_cache(maxsize=None)
def _codec(device: torch.device) -> int:
    """The nvJPEG encoder's handle and states of ``device`` (made once)."""
    handle = ctypes.c_void_p()
    with torch.cuda.device(device):
        _check(_library().jpeg_codec_create(ctypes.byref(handle)),
               "nvJPEG codec creation")
    return handle.value


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# ----------------------------- decoding -----------------------------

def _factor(full: int, sampled: int, what: str) -> int:
    if sampled == full:
        return 1
    if sampled == (full + 1) // 2:
        return 2
    raise ValueError(f"JPEG chroma {what} {sampled} of {full}: only 1x and "
                     f"2x chroma sampling per axis are supported")


def ycc_to_bgr_plain(y: Tensor, cb: Tensor = None, cr: Tensor = None,
                     hs: int = 1, vs: int = 1) -> Tensor:
    """The plain version of ``ycc_to_bgr_kernel``: (H, W, 3) uint8 BGR from
    uint8 planes Y (H, W) and Cb, Cr at their sampled size, by
    libjpeg-turbo's fancy upsampling (factors ``hs``, ``vs``) and
    fixed-point YCbCr -> RGB; without chroma, B = G = R = Y."""
    COUNTS.plain += 1
    Y = y.to(torch.int64)
    if cb is None:
        return torch.stack([Y, Y, Y], -1).to(torch.uint8)
    H, W = Y.shape
    Hc, Wc = cb.shape
    dev = y.device
    r = torch.arange(H, device=dev)[:, None]
    c = torch.arange(W, device=dev)[None, :]

    odd_r, odd_c = (r & 1) == 1, (c & 1) == 1
    i = r >> 1 if vs == 2 else r
    j = c >> 1 if hs == 2 else c
    i2 = torch.where(odd_r, torch.clamp(i + 1, max=Hc - 1),
                     torch.clamp(i - 1, min=0))
    jn = torch.where(odd_c, torch.clamp(j + 1, max=Wc - 1),
                     torch.clamp(j - 1, min=0))

    def up(p: Tensor) -> Tensor:
        p = p.to(torch.int64)
        if hs == 1 and vs == 1:
            return p[i, j]
        if hs == 2 and vs == 2:
            cs = 3 * p[i, j] + p[i2, j]
            cn = 3 * p[i, jn] + p[i2, jn]
            return (3 * cs + cn + torch.where(odd_c, 7, 8)) >> 4
        if hs == 2:
            return (3 * p[i, j] + p[i, jn] + torch.where(odd_c, 2, 1)) >> 2
        return (3 * p[i, j] + p[i2, j] + torch.where(odd_r, 2, 1)) >> 2

    xb, xr = up(cb) - 128, up(cr) - 128
    red = (91881 * xr + 32768) >> 16
    green = (-22554 * xb + 32768 - 46802 * xr) >> 16
    blue = (116130 * xb + 32768) >> 16
    return torch.clamp(torch.stack([Y + blue, Y + green, Y + red], -1),
                       0, 255).to(torch.uint8)


def _idct_1d(v):
    """jidctint's 1-D pass over eight int64 tensors: (even part tmp10,
    tmp11, tmp12, tmp13; odd part tmp0..tmp3)."""
    z1 = (v[2] + v[6]) * 4433
    tmp2 = z1 + v[6] * -15137
    tmp3 = z1 + v[2] * 6270
    tmp0 = (v[0] + v[4]) * 8192
    tmp1 = (v[0] - v[4]) * 8192
    ev = (tmp0 + tmp3, tmp1 + tmp2, tmp1 - tmp2, tmp0 - tmp3)
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z5 = (t0 + t2 + t1 + t3) * 9633
    z1, z2 = (t0 + t3) * -7373, (t1 + t2) * -20995
    z3, z4 = (t0 + t2) * -16069 + z5, (t1 + t3) * -3196 + z5
    od = (t0 * 2446 + z1 + z3, t1 * 16819 + z2 + z4, t2 * 25172 + z2 + z3,
          t3 * 12299 + z1 + z4)
    return ev, od


def _idct_outputs(ev, od, n):
    """The eight outputs of a pass, descaled by n bits, in order 0..7."""
    d = lambda x: (x + (1 << (n - 1))) >> n
    return [d(ev[0] + od[3]), d(ev[1] + od[2]), d(ev[2] + od[1]),
            d(ev[3] + od[0]), d(ev[3] - od[0]), d(ev[2] - od[1]),
            d(ev[1] - od[2]), d(ev[0] - od[3])]


def idct_islow_plain(coef: Tensor, qt: Tensor, plane_h: int,
                     plane_w: int) -> Tensor:
    """The plain version of ``idct_islow_kernel``: the (plane_h, plane_w)
    uint8 samples of a component from its quantized coefficients
    ``coef`` (blocks_h, blocks_w, 64) int16 and quantization table ``qt``
    (64,) (int16 holding uint16 bits), both in natural order: libjpeg's
    jidctint (CONST_BITS 13, PASS1_BITS 2) and its range limit."""
    IDCT_COUNTS.plain += 1
    bh, bw = coef.shape[:2]
    x = coef.to(torch.int64) * (qt.to(torch.int64) & 0xFFFF)
    x = x.reshape(bh, bw, 8, 8)  # [..., row k, column c]
    ev, od = _idct_1d([x[..., k, :] for k in range(8)])
    ws = _idct_outputs(ev, od, 13 - 2)           # 8 x (bh, bw, 8 columns)
    ws = torch.stack(ws, -2)                     # (bh, bw, 8 rows, 8 cols)
    ev, od = _idct_1d([ws[..., c] for c in range(8)])
    out = torch.stack(_idct_outputs(ev, od, 13 + 2 + 3), -1)
    i = out & 1023  # libjpeg's IDCT_range_limit table, indexed by x & 1023
    out = torch.where(i < 128, i + 128, torch.where(
        i < 512, 255, torch.where(i < 896, 0, i - 896)))
    plane = out.permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)
    return plane[:plane_h, :plane_w].to(torch.uint8)


def idct_islow_kernel(coef: Tensor, qt: Tensor, plane_h: int,
                      plane_w: int) -> Tensor:
    """Launch ``idct_islow_kernel`` on CUDA tensors: as
    :func:`idct_islow_plain`."""
    if coef.device.type != "cuda" or coef.dtype != torch.int16 or \
            qt.dtype != torch.int16 or qt.numel() != 64 or coef.ndim != 3 \
            or coef.shape[2] != 64:
        raise ValueError(f"the IDCT kernel takes int16 CUDA coefficients "
                         f"(bh, bw, 64) and a 64-entry table, got "
                         f"{coef.dtype} {tuple(coef.shape)} on {coef.device}")
    bh, bw = coef.shape[:2]
    if plane_h > 8 * bh or plane_w > 8 * bw:
        raise ValueError(f"plane {(plane_h, plane_w)} exceeds the "
                         f"coefficients' {(8 * bh, 8 * bw)}")
    coef, qt = coef.contiguous(), qt.to(coef.device).contiguous()
    plane = torch.empty((plane_h, plane_w), dtype=torch.uint8,
                        device=coef.device)
    err = _library().idct_islow_launch(
        coef.data_ptr(), qt.data_ptr(), bw, -(-plane_w // 8),
        -(-plane_h // 8), plane.data_ptr(), plane_w, plane_h,
        torch.cuda.current_stream(coef.device).cuda_stream)
    _check(err, "idct_islow_kernel launch")
    IDCT_COUNTS.launched()
    return plane


def decode_coefficients(data: bytes, device):
    """Entropy-decode a JPEG on the host and copy its coefficients to a
    CUDA ``device``: per component (coefficients (bh, bw, 64) int16,
    quantization table (64,), plane height, plane width), and the image's
    (height, width)."""
    if image_format(data) != "JPEG":
        raise ValueError(f"not a JPEG ({image_format(data)}): the card's "
                         f"codec decodes only JPEG")
    dev = _cuda_device(device)
    lib = _library()
    handle = ctypes.c_void_p()
    info = (ctypes.c_int * 21)()
    _check(lib.jpeg_host_decode(data, len(data), ctypes.byref(handle),
                                info), "JPEG decode")
    try:
        comps = []
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c in range(info[0]):
            pw, ph, bw, bh = info[3 + 6 * c:7 + 6 * c]
            coef = torch.empty((bh, bw, 64), dtype=torch.int16, device=dev)
            qt = torch.empty(64, dtype=torch.int16, device=dev)
            with torch.cuda.device(dev):
                _check(lib.jpeg_host_upload(handle, c, coef.data_ptr(),
                                            qt.data_ptr(), stream),
                       "JPEG coefficient upload")
            comps.append((coef, qt, ph, pw))
    finally:
        lib.jpeg_host_free(handle)
    CODEC_COUNTS.launched("decode")
    return comps, (info[2], info[1])


def decode_planes(data: bytes, device):
    """A JPEG's component planes on a CUDA ``device``: the Y plane (H, W)
    and, for a colour JPEG, the Cb and Cr planes at their sampled size
    (None for a grey one), uint8, from the IDCT kernel, and the chroma
    factors (hs, vs)."""
    comps, (H, W) = decode_coefficients(data, device)
    planes = [idct_islow_kernel(*c) for c in comps]
    if len(planes) == 1:
        return planes[0], None, None, (1, 1)
    y, cb, cr = planes
    if cb.shape != cr.shape or y.shape != (H, W):
        raise ValueError("JPEG whose planes do not fit its size")
    return y, cb, cr, (_factor(W, cb.shape[1], "width"),
                       _factor(H, cb.shape[0], "height"))


def ycc_to_bgr_kernel(y: Tensor, cb: Tensor = None, cr: Tensor = None,
                      hs: int = 1, vs: int = 1) -> Tensor:
    """Launch ``ycc_to_bgr_kernel`` on CUDA planes: (H, W, 3) uint8 BGR."""
    if y.device.type != "cuda" or y.dtype != torch.uint8:
        raise ValueError(f"the colour kernel takes uint8 CUDA planes, got "
                         f"{y.dtype} on {y.device}")
    H, W = y.shape
    y = y.contiguous()
    Hc = Wc = 0
    if cb is not None:
        cb, cr = cb.contiguous(), cr.contiguous()
        Hc, Wc = cb.shape
        if cb.dtype != torch.uint8 or cr.shape != cb.shape or \
                Hc != -(-H // vs) or Wc != -(-W // hs):
            raise ValueError(f"chroma planes {tuple(cb.shape)}, "
                             f"{tuple(cr.shape)} do not fit Y {(H, W)} at "
                             f"factors {(hs, vs)}")
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=y.device)
    err = _library().ycc_to_bgr_launch(
        y.data_ptr(), None if cb is None else cb.data_ptr(),
        None if cr is None else cr.data_ptr(), H, W, Hc, Wc, hs, vs,
        out.data_ptr(), torch.cuda.current_stream(y.device).cuda_stream)
    _check(err, "ycc_to_bgr_kernel launch")
    COUNTS.launched()
    return out


def decode(data: bytes, device) -> Tuple[Tensor, Tensor]:
    """(grey (H, W), BGR (H, W, 3)) uint8 tensors on ``device`` from a
    file's bytes: what ``cv2.imread`` gives with ``IMREAD_GRAYSCALE`` and
    ``IMREAD_COLOR``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        import cv2

        buf = np.frombuffer(data, np.uint8)
        gray = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if gray is None or bgr is None:
            raise ValueError(f"OpenCV cannot decode this {image_format(data)}"
                             f" file")
        return torch.from_numpy(gray), torch.from_numpy(bgr)
    if dev.type != "cuda":
        raise ValueError(f"no image codec for device {dev}")
    y, cb, cr, (hs, vs) = decode_planes(data, dev)
    return y, ycc_to_bgr_kernel(y, cb, cr, hs, vs)


def read_image(path: str, device) -> Tuple[Tensor, Tensor]:
    """:func:`decode` of the file at ``path``."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    try:
        return decode(data, device)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# ----------------------------- encoding -----------------------------

def _u8(img, device) -> Tensor:
    t = torch.as_tensor(img)
    if t.dtype != torch.uint8:
        raise TypeError(f"images are written from uint8 arrays, got "
                        f"{t.dtype}")
    if not (t.ndim == 2 or (t.ndim == 3 and t.shape[2] == 3)):
        raise ValueError(f"an image is (H, W) grey or (H, W, 3) BGR, got "
                         f"{tuple(t.shape)}")
    return t.to(device).contiguous()


def encode_jpeg(img, device, quality: int = PREVIEW_QUALITY) -> bytes:
    """JPEG bytes of a uint8 (H, W) grey or (H, W, 3) BGR image (colour at
    4:2:0, cv2's default), encoded on ``device``: nvJPEG on a CUDA device,
    OpenCV on the CPU."""
    dev = torch.device(device)
    t = _u8(img, "cpu" if dev.type == "cpu" else _cuda_device(dev))
    if dev.type == "cpu":
        import cv2

        ok, buf = cv2.imencode(".jpg", t.numpy(),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError("OpenCV JPEG encode failed")
        return buf.tobytes()
    if dev.type != "cuda":
        raise ValueError(f"no image codec for device {dev}")
    lib, codec = _library(), _codec(t.device)
    H, W = t.shape[:2]
    channels = 1 if t.ndim == 2 else 3
    stream = torch.cuda.current_stream(t.device).cuda_stream
    length = ctypes.c_size_t()
    with torch.cuda.device(t.device):
        _check(lib.jpeg_codec_encode(codec, t.data_ptr(), H, W, channels,
                                     quality, stream, ctypes.byref(length)),
               "nvJPEG encode")
        out = ctypes.create_string_buffer(length.value)
        _check(lib.jpeg_codec_retrieve(codec, out, ctypes.byref(length),
                                       stream), "nvJPEG bitstream retrieval")
    CODEC_COUNTS.launched("encode")
    return out.raw[:length.value]


def write_jpeg(path: str, img, device, quality: int = PREVIEW_QUALITY) -> None:
    """Write :func:`encode_jpeg`'s bytes to ``path``."""
    data = encode_jpeg(img, device, quality)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img) -> bytes:
    """PNG bytes (8-bit grey or RGB, no filter, zlib level 1 as
    ``cv2.imwrite``'s default) of a uint8 (H, W) grey or (H, W, 3) BGR
    image."""
    a = _u8(img, "cpu").numpy()
    H, W = a.shape[:2]
    colour_type = 0 if a.ndim == 2 else 2
    rows = a.reshape(H, W) if a.ndim == 2 else a[..., ::-1].reshape(H, 3 * W)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    """Write :func:`encode_png`'s bytes to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
