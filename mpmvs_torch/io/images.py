"""Image files of a workspace: JPEG, PNG and TIFF reads, JPEG and PNG
writes.

The JAX package reads and writes images with OpenCV. Here the device picks
the codec:

  * on a CUDA device, through ``csrc/jpeg_codec.cu``, with what ``cv2``
    gives, bit for bit, and no OpenCV:
      - JPEG reads of one, three or four components at every sampling
        layout libjpeg takes: the host entropy-decodes the file to DCT
        coefficients (``csrc/jpeg_entropy.h``), the card runs libjpeg's
        integer inverse DCT (``idct_islow_kernel``) and libjpeg-turbo's
        upsampling of each component and colour conversion with OpenCV's
        after it (``ycc_to_bgr_kernel``: YCbCr, or RGB components;
        ``cmyk_to_bgr_kernel``: CMYK or YCCK; libjpeg guesses the space from
        the markers and ids), and applies the EXIF orientation as OpenCV's
        ``ApplyExifOrientation`` does (:func:`orient`). The grey image is the
        Y plane of a YCbCr JPEG, as ``cv2.imread(IMREAD_GRAYSCALE)`` gives
        it, libjpeg-turbo's ``rgb_gray_convert`` of an RGB one and OpenCV's
        ``icvCvt_CMYK2Gray_8u_C4C1R`` of a CMYK or YCCK one;
      - PNG reads of every colour type at every bit depth, Adam7 included
        (:func:`png_rows`: the chunks are parsed and inflated here with
        ``zlib``, the rows unfiltered and de-interlaced on the host,
        ``csrc/png_unfilter.h``), and TIFF reads (:func:`tiff_rows`: classic
        and BigTIFF, strips and tiles, chunky and planar, uncompressed, LZW,
        Deflate and PackBits, predictor 2, grey, RGB, palette and 8-bit
        CMYK, 1 to 16 bits; parsed and decompressed on the host,
        ``csrc/tiff_decode.h``): the samples are copied to the card, where
        ``raster_to_bgr_kernel`` makes cv2's BGR and grey images of them
        (sub-8-bit grey expanded, palette looked up, 16 bits narrowed as
        libpng or libtiff narrows, alpha dropped or premultiplied, CMYK by
        libtiff's RGBA rule, the grey of colour by libpng's or OpenCV's
        arithmetic), and the eXIf or Orientation tag is applied;
      - JPEG writes: cv2.imencode's bytes (4:2:0 colour or grey, standard
        Huffman tables) from the card's colour conversion and downsampling
        (``bgr_to_ycc_kernel``) and forward DCT and quantization
        (``fdct_islow_quant_kernel``), Huffman-coded on the host
        (``csrc/jpeg_encode.h``).
    A kernel that fails to build or launch raises, and so does a file the card
    cannot read, naming why (12-bit, arithmetic-coded and lossless JPEGs;
    JPEG-compressed, YCbCr, CIELab, signed, float and old-style LZW TIFFs;
    other formats; and what cv2 does not read either). Nothing falls back to
    OpenCV or to the CPU.
  * on the CPU, through OpenCV, imported only there: the CPU tests hold the
    port's reads and writes against the JAX package's OpenCV calls.

PNG files (``triangulation.png``) are written on the host with the
standard library's ``zlib``, on every device.

Each kernel has a plain PyTorch version beside it, for the tests
(:func:`colour_plain`, with :func:`ycc_to_bgr_plain` and
:func:`cmyk_to_bgr_plain`;
:func:`idct_islow_plain`, :func:`bgr_to_ycc_plain`,
:func:`fdct_islow_plain`, :func:`raster_to_bgr_plain`). ``COUNTS`` counts
launches of the colour kernels (form ``"rgb"`` for RGB components,
``"cmyk"`` and ``"ycck"`` for ``cmyk_to_bgr_kernel``) and their plain calls
(the four-component ones by form in ``plain_forms``), ``IDCT_COUNTS``,
``YCC_COUNTS``, ``FDCT_COUNTS`` and ``RASTER_COUNTS`` those of the IDCT,
encoder colour, forward DCT and raster kernels; ``CODEC_COUNTS`` counts
host decodes (``forms["decode"]``), PNG and TIFF reads (``forms["png"]``,
``forms["tiff"]``) and encodes (``forms["encode"]``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import zlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mpmvs_torch.ops import nvcc

Tensor = torch.Tensor

SOURCE = "jpeg_codec.cu"
NVCC_FLAGS = ()
PREVIEW_QUALITY = 95  # cv2.imwrite's default JPEG quality (and 4:2:0)

COUNTS = nvcc.LaunchCounts()
IDCT_COUNTS = nvcc.LaunchCounts()
YCC_COUNTS = nvcc.LaunchCounts()
FDCT_COUNTS = nvcc.LaunchCounts()
CODEC_COUNTS = nvcc.LaunchCounts()
RASTER_COUNTS = nvcc.LaunchCounts()
# what the host codes of csrc/ name (a JPEG's or PNG's cause of refusal)
_CODE_ERRORS = {
    2001: "a truncated JPEG",
    2002: "a JPEG of an unsupported layout (2 or more than 4 components, "
          "or more than 2^28 pixels)",
    2003: "a malformed JPEG",
    2006: "a JPEG of 12-bit (not 8-bit) samples",
    2007: "an arithmetic-coded JPEG",
    2008: "a lossless or hierarchical JPEG",
    2010: "coefficients that do not fit the image's size",
    2011: "a JPEG of a sampling layout libjpeg refuses too (a factor "
          "outside 1-4, a factor that does not divide the largest of its "
          "axis, or more than 10 blocks in an interleaved MCU)",
    3001: "a PNG whose image data is shorter than its header implies",
    3002: "a PNG with a row filter type above 4",
    4001: "a truncated TIFF",
    4002: "a malformed TIFF (a required tag missing or out of range)",
    4003: "a TIFF of JPEG-compressed data (Compression 6 or 7), which "
          "OpenCV reads through libtiff's JPEG codec; the card does not",
    4004: "a TIFF of a compression the card does not read (it reads none, "
          "LZW, Deflate and PackBits)",
    4005: "a TIFF of old-style LZW (the pre-1991 bit-reversed form)",
    4006: "a TIFF whose LZW data is corrupt",
    4007: "a TIFF whose strip or tile holds fewer bytes than its rows",
    4008: "a TIFF of signed or float samples (SampleFormat 2 or 3)",
    4009: "a TIFF of the floating-point predictor (Predictor 3)",
    4010: "a TIFF of horizontal differencing on samples other than 8- or "
          "16-bit, which libtiff refuses too",
    4011: "a TIFF of separated samples of another InkSet than CMYK, which "
          "cv2 (libtiff's RGBA reader) does not read either",
    4012: "a TIFF of YCbCr samples, which OpenCV converts through libtiff's "
          "RGBA reader; the card does not",
    4013: "a TIFF of CIELab samples, which the card does not convert",
    4014: "a TIFF of a photometric the card does not read (it reads "
          "min-is-white, min-is-black, RGB, palette and CMYK)",
    4015: "a TIFF of more than 16 bits a sample",
    4016: "a TIFF of a bit depth OpenCV does not read into an 8-bit image "
          "either (grey takes 1, 8, 16; RGB 8, 16; a palette 1, 4, 8; "
          "CMYK 8)",
    4017: "a TIFF of a sample count its photometric does not take",
    4018: "a CMYK TIFF with an extra sample: five channels, which cv2 "
          "does not read either"}

_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"\x89PNG\r\n\x1a\n", "PNG"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"),
          (b"MM\x00+", "TIFF"), (b"BM", "BMP"),
          (b"GIF8", "GIF"), (b"RIFF", "RIFF (WebP)"), (b"P5", "PGM"),
          (b"P6", "PPM"))


def image_format(data: bytes) -> str:
    """The format a file's first bytes name ("JPEG", "PNG", ...), or
    "unknown"."""
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


def bind_host(lib):
    """Set the ctypes signatures of the codec's host functions (no CUDA:
    the encoder's entropy coding, the PNG unfilter and de-interlace, the
    TIFF reader, the EXIF reader) on a library that has them, the card's or
    a host build of the headers."""
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.jpeg_quality_tables.argtypes = [i, vp]
    lib.jpeg_quality_tables.restype = None
    lib.jpeg_host_encode.argtypes = [vp, i, i, vp, vp, i, i, i, i, i, i,
                                     ctypes.POINTER(vp), ctypes.POINTER(vp),
                                     ctypes.POINTER(sz)]
    lib.jpeg_host_encode.restype = i
    lib.jpeg_host_encode_free.argtypes = [vp]
    lib.jpeg_host_encode_free.restype = None
    lib.png_unfilter_rows.argtypes = [vp, sz, vp, i, sz, i]
    lib.png_unfilter_rows.restype = i
    lib.png_adam7_rows.argtypes = [vp, sz, vp, i, i, i]
    lib.png_adam7_rows.restype = i
    lib.tiff_host_info.argtypes = [ctypes.c_char_p, sz, vp]
    lib.tiff_host_layout.argtypes = [ctypes.c_char_p, sz, vp, vp, vp]
    lib.tiff_host_decode.argtypes = [ctypes.c_char_p, sz, vp, vp, vp]
    for fn in ("tiff_host_info", "tiff_host_layout", "tiff_host_decode"):
        getattr(lib, fn).restype = i
    lib.exif_orientation_tiff.argtypes = [ctypes.c_char_p, i]
    lib.exif_orientation_tiff.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    lib = bind_host(ctypes.CDLL(nvcc.build(SOURCE, NVCC_FLAGS)))
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_host_decode.argtypes = [ctypes.c_char_p, sz,
                                     ctypes.POINTER(vp), ip]
    lib.jpeg_host_upload.argtypes = [vp, i, vp, vp, vp]
    lib.jpeg_host_free.argtypes = [vp]
    lib.jpeg_host_free.restype = None
    lib.idct_islow_launch.argtypes = [vp, vp, i, i, i, vp, i, i, vp]
    lib.ycc_to_bgr_launch.argtypes = [vp, vp, i, i, i, i, vp, vp, vp]
    lib.cmyk_to_bgr_launch.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.bgr_to_ycc_launch.argtypes = [vp, i, i, i, vp, i, i, vp, vp, i, i,
                                      vp]
    lib.fdct_islow_launch.argtypes = [vp, i, i, vp, vp, vp]
    lib.raster_to_bgr_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp]
    for fn in ("jpeg_host_decode", "jpeg_host_upload", "idct_islow_launch",
               "ycc_to_bgr_launch", "cmyk_to_bgr_launch", "bgr_to_ycc_launch",
               "fdct_islow_launch", "raster_to_bgr_launch"):
        getattr(lib, fn).restype = i
    return lib


def _check(err: int, what: str):
    if err in _CODE_ERRORS:
        raise ValueError(f"{what}: {_CODE_ERRORS[err]}")
    if err != 0:
        kind = (f"CUDA error {err - 1000}" if 1000 <= err < 2000
                else f"error {err}")
        raise RuntimeError(f"{what} failed: {kind}")


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _stream(t: Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------- decoding -----------------------------

# jpeg_entropy::Space: the colour space libjpeg takes the components for
SPACE_YCC, SPACE_RGB, SPACE_CMYK, SPACE_YCCK = 0, 1, 2, 3


def _fancy(w: int, rh: int, rv: int) -> bool:
    """Whether libjpeg-turbo's jinit_upsampler (jdsample.c) gives a
    component of ``w`` samples across at ratios ``rh``, ``rv`` (largest
    factor / its factor) fancy upsampling: h2v1 and h2v2 where it is more
    than 2 samples wide, h1v2 at any width; else it replicates."""
    return (rh, rv) == (1, 2) or ((rh, rv) in ((2, 1), (2, 2)) and w > 2)


def _upsample(p: Tensor, H: int, W: int, rh: int, rv: int) -> Tensor:
    """libjpeg-turbo's upsampling (jdsample.c) of a component's plane to
    (H, W), int64, at ratios ``rh``, ``rv``: as it is at 1 x 1, fancy
    (:func:`_fancy`) or each sample replicated ``rh`` x ``rv`` times."""
    Hc, Wc = p.shape
    dev = p.device
    r = torch.arange(H, device=dev)[:, None]
    c = torch.arange(W, device=dev)[None, :]
    p = p.to(torch.int64)
    if rh == 1 and rv == 1:
        return p[:H, :W]
    if not _fancy(Wc, rh, rv):
        return p[r // rv, c // rh]
    odd_r, odd_c = (r & 1) == 1, (c & 1) == 1
    i, j = r // rv, c // rh
    i2 = torch.where(odd_r, torch.clamp(i + 1, max=Hc - 1),
                     torch.clamp(i - 1, min=0))
    jn = torch.where(odd_c, torch.clamp(j + 1, max=Wc - 1),
                     torch.clamp(j - 1, min=0))
    if rh == 2 and rv == 2:
        cs = 3 * p[i, j] + p[i2, j]
        cn = 3 * p[i, jn] + p[i2, jn]
        return (3 * cs + cn + torch.where(odd_c, 7, 8)) >> 4
    if rh == 2:
        return (3 * p[i, j] + p[i, jn] + torch.where(odd_c, 2, 1)) >> 2
    return (3 * p[i, j] + p[i2, j] + torch.where(odd_r, 2, 1)) >> 2


def _ycc_rgb(y: Tensor, cb: Tensor, cr: Tensor):
    """jdcolor.c's fixed-point YCbCr -> (R, G, B) of int64 samples,
    clamped."""
    xb, xr = cb - 128, cr - 128
    red = (91881 * xr + 32768) >> 16
    green = (-22554 * xb + 32768 - 46802 * xr) >> 16
    blue = (116130 * xb + 32768) >> 16
    return [torch.clamp(y + d, 0, 255) for d in (red, green, blue)]


def ycck_to_cmy_plain(y: Tensor, cb: Tensor, cr: Tensor):
    """jdcolor.c's ycck_cmyk_convert of int64 samples: (C, M, Y) = 255 -
    the clamped (R, G, B) of Y, Cb, Cr."""
    return [255 - v for v in _ycc_rgb(y, cb, cr)]


def cmyk_bgr_plain(c: Tensor, m: Tensor, y: Tensor, k: Tensor):
    """OpenCV's icvCvt_CMYK2Gray_8u_C4C1R and icvCvt_CMYK2BGR_8u_C4C3R of
    int64 C, M, Y, K samples: (grey, B, G, R), int64."""
    red, green, blue = [k - ((255 - x) * k >> 8) for x in (c, m, y)]
    return (blue * 1868 + green * 9617 + red * 4899 + 8192) >> 14, \
        blue, green, red


def _check_planes(planes, factors, size):
    H, W = size
    if len(planes) != len(factors) or len(planes) not in (1, 3, 4):
        raise ValueError(f"{len(planes)} planes with {len(factors)} factors")
    for p, (rh, rv) in zip(planes, factors):
        if p.dtype != torch.uint8 or tuple(p.shape) != (-(-H // rv),
                                                        -(-W // rh)):
            raise ValueError(f"a plane {p.dtype} {tuple(p.shape)} does not "
                             f"fit {size} at ratios {(rh, rv)}")


def colour_plain(planes, factors, size, space: int) -> Tuple[Tensor, Tensor]:
    """The plain version of the colour kernels: (grey (H, W), BGR (H, W, 3))
    uint8, cv2.imread's, from a JPEG's component planes (uint8, each at its
    sampled size), their ratios ``factors`` ((hmax / h, vmax / v) each) and
    the image's ``size`` (H, W), in colour ``space`` (``SPACE_*``;
    csrc/jpeg_colour.h says what each computes). Four components go through
    :func:`cmyk_to_bgr_plain`."""
    if space in (SPACE_CMYK, SPACE_YCCK):
        return cmyk_to_bgr_plain(planes, factors, space == SPACE_YCCK, size)
    _check_planes(planes, factors, size)
    COUNTS.plain += 1
    H, W = size
    up = [_upsample(p, H, W, *f) for p, f in zip(planes, factors)]
    Y = up[0]
    if len(up) == 1:
        grey, bgr = Y, torch.stack([Y, Y, Y], -1)
    elif space == SPACE_RGB:
        R, G, B = up
        grey = (19595 * R + 38470 * G + 7471 * B + 32768) >> 16
        bgr = torch.stack([B, G, R], -1)
    else:
        red, green, blue = _ycc_rgb(*up)
        grey, bgr = Y, torch.stack([blue, green, red], -1)
    return grey.to(torch.uint8), bgr.to(torch.uint8)


def cmyk_to_bgr_plain(planes, factors, ycck: bool,
                      size=None) -> Tuple[Tensor, Tensor]:
    """The plain version of ``cmyk_to_bgr_kernel``: (grey (H, W), BGR
    (H, W, 3)) uint8, cv2.imread's, from the four planes of a CMYK or (with
    ``ycck``) YCCK JPEG at their sampled sizes and ratios ``factors``, each
    upsampled by its own rule; ``size`` (H, W) defaults to the size of a
    plane at 1 x 1."""
    if size is None:
        size = next(tuple(p.shape) for p, f in zip(planes, factors)
                    if f == (1, 1))
    _check_planes(planes, factors, size)
    if len(planes) != 4:
        raise ValueError(f"a CMYK or YCCK image has 4 planes, not "
                         f"{len(planes)}")
    COUNTS.plain += 1
    COUNTS.plain_forms["ycck" if ycck else "cmyk"] = \
        COUNTS.plain_forms.get("ycck" if ycck else "cmyk", 0) + 1
    H, W = size
    c, m, y, k = [_upsample(p, H, W, *f) for p, f in zip(planes, factors)]
    if ycck:
        c, m, y = ycck_to_cmy_plain(c, m, y)
    grey, b, g, r = cmyk_bgr_plain(c, m, y, k)
    return grey.to(torch.uint8), torch.stack([b, g, r], -1).to(torch.uint8)


def _chroma(hs: int, vs: int, y: Tensor, cb: Tensor):
    """The planes' ratios of a Y plane at full size with chroma sampled
    by ``hs``, ``vs``."""
    return [(1, 1)] + [(hs, vs)] * (0 if cb is None else 2), tuple(y.shape)


def ycc_to_bgr_plain(y: Tensor, cb: Tensor = None, cr: Tensor = None,
                     hs: int = 1, vs: int = 1) -> Tensor:
    """:func:`colour_plain`'s BGR (H, W, 3) of a YCbCr JPEG whose Y plane is
    at full size and Cb, Cr are sampled by ``hs``, ``vs`` (without chroma,
    B = G = R = Y)."""
    factors, size = _chroma(hs, vs, y, cb)
    planes = [y] if cb is None else [y, cb, cr]
    return colour_plain(planes, factors, size, SPACE_YCC)[1]


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


class Layout(NamedTuple):
    """What a JPEG's markers say of the image cv2.imread makes of its
    planes: the EXIF orientation (1..8), the colour space libjpeg takes its
    components for (``SPACE_*``) and each component's ratios (hmax / h,
    vmax / v), by which it is upsampled."""
    orientation: int
    space: int
    factors: Tuple[Tuple[int, int], ...]

    @property
    def rgb(self) -> bool:
        return self.space == SPACE_RGB


def host_decode(data: bytes):
    """Parse and entropy-decode a JPEG on the host (``jpeg_host_decode``):
    the decoder's handle, which holds the coefficients until
    :func:`upload_coefficients` frees it, and its ``info`` (39 ints,
    csrc/jpeg_codec.cu says which)."""
    if image_format(data) != "JPEG":
        raise ValueError(f"not a JPEG ({image_format(data)})")
    handle = ctypes.c_void_p()
    info = (ctypes.c_int * 39)()
    _check(_library().jpeg_host_decode(data, len(data), ctypes.byref(handle),
                                       info), "JPEG decode")
    return handle, info


def upload_coefficients(handle, info, device):
    """Copy a :func:`host_decode`'s coefficients to a CUDA ``device`` and
    free its handle: per component (coefficients (bh, bw, 64) int16,
    quantization table (64,), plane height, plane width), the image's
    (height, width) and its :class:`Layout`."""
    dev = _cuda_device(device)
    lib = _library()
    try:
        comps, factors = [], []
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c in range(info[0]):
            pw, ph, bw, bh, _, _, h, v = info[7 + 8 * c:15 + 8 * c]
            coef = torch.empty((bh, bw, 64), dtype=torch.int16, device=dev)
            qt = torch.empty(64, dtype=torch.int16, device=dev)
            with torch.cuda.device(dev):
                _check(lib.jpeg_host_upload(handle, c, coef.data_ptr(),
                                            qt.data_ptr(), stream),
                       "JPEG coefficient upload")
            comps.append((coef, qt, ph, pw))
            factors.append((info[5] // h, info[6] // v))
    finally:
        lib.jpeg_host_free(handle)
    return comps, (info[2], info[1]), Layout(info[3], info[4],
                                             tuple(factors))


def decode_coefficients(data: bytes, device):
    """Entropy-decode a JPEG on the host and copy its coefficients to a
    CUDA ``device``: :func:`upload_coefficients` of :func:`host_decode`."""
    out = upload_coefficients(*host_decode(data), device)
    CODEC_COUNTS.launched("decode")
    return out


def _planes(comps):
    """The IDCT kernel's plane of each component's decoded coefficients, at
    its sampled size."""
    return [idct_islow_kernel(*c) for c in comps]


def decode_planes(data: bytes, device):
    """A JPEG's component planes on a CUDA ``device`` (uint8, each at its
    sampled size, from the IDCT kernel), the image's (height, width) and its
    :class:`Layout`: what :func:`colour_kernel` takes."""
    comps, size, layout = decode_coefficients(data, device)
    return _planes(comps), size, layout


def _plane_args(planes, factors):
    """The launches' plane pointers and n x 5 ints (h, w, rh, rv, fancy:
    jpeg_colour::Plane)."""
    ptrs = (ctypes.c_void_p * 4)(*[p.data_ptr() for p in planes])
    geo = (ctypes.c_int * 20)(*[v for p, (rh, rv) in zip(planes, factors)
                                for v in (p.shape[0], p.shape[1], rh, rv,
                                          int(_fancy(p.shape[1], rh, rv)))])
    return ptrs, geo


def colour_kernel(planes, factors, size, space: int) -> Tuple[Tensor, Tensor]:
    """Launch the colour kernel of ``space`` on a JPEG's CUDA planes:
    (grey, BGR), as :func:`colour_plain`. One or three components launch
    ``ycc_to_bgr_kernel`` (form ``"rgb"`` for RGB components), four
    ``cmyk_to_bgr_kernel`` (:func:`cmyk_to_bgr_kernel`). The grey of a
    YCbCr or grey JPEG whose first plane is at full size is that plane."""
    if space in (SPACE_CMYK, SPACE_YCCK):
        return cmyk_to_bgr_kernel(planes, factors, space == SPACE_YCCK, size)
    if any(p.device.type != "cuda" for p in planes):
        raise ValueError("the colour kernel takes CUDA planes")
    _check_planes(planes, factors, size)
    planes = [p.contiguous() for p in planes]
    H, W = size
    dev = planes[0].device
    bgr = torch.empty((H, W, 3), dtype=torch.uint8, device=dev)
    rgb = space == SPACE_RGB and len(planes) == 3
    gray = None if factors[0] == (1, 1) and not rgb else torch.empty(
        (H, W), dtype=torch.uint8, device=dev)
    ptrs, geo = _plane_args(planes, factors)
    err = _library().ycc_to_bgr_launch(
        ptrs, geo, len(planes), int(rgb), H, W, bgr.data_ptr(),
        None if gray is None else gray.data_ptr(), _stream(planes[0]))
    _check(err, "ycc_to_bgr_kernel launch")
    COUNTS.launched("rgb" if rgb else None)
    return (planes[0] if gray is None else gray), bgr


def cmyk_to_bgr_kernel(planes, factors, ycck: bool,
                       size=None) -> Tuple[Tensor, Tensor]:
    """Launch ``cmyk_to_bgr_kernel`` on the four CUDA planes of a CMYK or
    (with ``ycck``) YCCK JPEG: (grey, BGR), both from the one launch, as
    :func:`cmyk_to_bgr_plain` (form ``"cmyk"`` or ``"ycck"``)."""
    if size is None:
        size = next(tuple(p.shape) for p, f in zip(planes, factors)
                    if f == (1, 1))
    if any(p.device.type != "cuda" for p in planes):
        raise ValueError("the CMYK colour kernel takes CUDA planes")
    _check_planes(planes, factors, size)
    if len(planes) != 4:
        raise ValueError(f"a CMYK or YCCK image has 4 planes, not "
                         f"{len(planes)}")
    planes = [p.contiguous() for p in planes]
    H, W = size
    dev = planes[0].device
    bgr = torch.empty((H, W, 3), dtype=torch.uint8, device=dev)
    gray = torch.empty((H, W), dtype=torch.uint8, device=dev)
    ptrs, geo = _plane_args(planes, factors)
    err = _library().cmyk_to_bgr_launch(ptrs, geo, int(ycck), H, W,
                                        bgr.data_ptr(), gray.data_ptr(),
                                        _stream(planes[0]))
    _check(err, "cmyk_to_bgr_kernel launch")
    COUNTS.launched("ycck" if ycck else "cmyk")
    return gray, bgr


def ycc_to_bgr_kernel(y: Tensor, cb: Tensor = None, cr: Tensor = None,
                      hs: int = 1, vs: int = 1) -> Tensor:
    """Launch ``ycc_to_bgr_kernel`` on CUDA planes: (H, W, 3) uint8 BGR, as
    :func:`ycc_to_bgr_plain`."""
    factors, size = _chroma(hs, vs, y, cb)
    planes = [y] if cb is None else [y, cb, cr]
    return colour_kernel(planes, factors, size, SPACE_YCC)[1]


def orient(img: Tensor, orientation: int) -> Tensor:
    """OpenCV's ``ApplyExifOrientation`` of an (H, W) or (H, W, 3) image:
    2 mirrors it left-right, 3 turns it 180 degrees, 4 mirrors it top-down,
    5 transposes it, 6 turns it 90 degrees clockwise, 7 transposes it
    across the other diagonal, 8 turns it 90 degrees anticlockwise; 1 and
    any other value leave it."""
    if not 2 <= orientation <= 8:
        return img
    if orientation >= 5:
        img = img.transpose(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1),
            8: (0,)}[orientation]
    return (torch.flip(img, flip) if flip else img).contiguous()


def _decode_jpeg(data: bytes, dev) -> Tuple[Tensor, Tensor]:
    planes, size, layout = decode_planes(data, dev)
    gray, bgr = colour_kernel(planes, layout.factors, size, layout.space)
    return orient(gray, layout.orientation), orient(bgr, layout.orientation)


class RasterForm(NamedTuple):
    """What a PNG's or a TIFF's samples are and which of OpenCV's
    conversions applies to them: the fields of ``raster_bgr::Form``
    (csrc/raster_bgr.h), in its order."""
    kind: int          # RASTER_GREY, RASTER_RGB, RASTER_PALETTE or
                       # RASTER_CMYK
    bits: int          # 1, 2, 4, 8 or 16
    channels: int      # samples a pixel, alpha included
    planar: int        # 1: a plane a channel
    little: int        # 16-bit samples little-endian
    min_is_white: int  # grey inverted
    narrow: int        # 16-bit colour: NARROW_SHIFT or NARROW_ROUND257
    premultiply: int   # channel 3 is unassociated alpha
    grey_rule: int     # GREY_LIBPNG, GREY_LIBPNG_GAMMA or GREY_OPENCV
    width: int
    height: int
    rowbytes: int      # bytes a row of a plane
    plane_bytes: int   # bytes a plane


RASTER_GREY, RASTER_RGB, RASTER_PALETTE, RASTER_CMYK = 0, 1, 2, 3
GREY_LIBPNG, GREY_LIBPNG_GAMMA, GREY_OPENCV = 0, 1, 2
NARROW_SHIFT, NARROW_ROUND257 = 0, 1
# raster_bgr.h: the palette (256 x RGB), libpng's 8-bit gamma tables, then
# its 16-bit ones (2048 big-endian entries each)
TO_ONE_AT, FROM_ONE_AT = 768, 1024
TO_ONE16_AT, FROM_ONE16_AT, GREY16_AT = 1280, 1280 + 4096, 1280 + 8192
TABLES_LEN = 1280 + 12288
# libpng's png_set_rgb_to_gray coefficients for OpenCV's 0.299, 0.587
LIBPNG_RC, LIBPNG_GC = 9797, 19234
LIBPNG_BC = 32768 - LIBPNG_RC - LIBPNG_GC


class Raster(NamedTuple):
    """A PNG's or a TIFF's samples as the host leaves them (unfiltered,
    decompressed, de-interlaced) and what the card makes of them."""
    samples: np.ndarray      # (planes * height, rowbytes) uint8
    form: RasterForm
    tables: np.ndarray       # (TABLES_LEN,) uint8: palette, gamma tables
    orientation: int         # applied after the conversion (orient)


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_GAMMA_SRGB = 45455  # libpng's gamma of an sRGB chunk (1 / 2.2, x 100000)


def _significant(gamma: int) -> bool:
    """libpng's png_gamma_significant (PNG_GAMMA_THRESHOLD_FIXED 5000)."""
    return not 95000 <= gamma <= 105000


def _reciprocal(gamma: int) -> int:
    """libpng's png_reciprocal of a 100000-scaled value."""
    return int(math.floor(1e10 / gamma + .5))


def _gamma_table8(gamma: int) -> np.ndarray:
    """libpng's png_build_8bit_table: floor(255 (v / 255) ^ (gamma / 1e5)
    + .5), the identity where the exponent is not significant."""
    if not _significant(gamma):
        return np.arange(256, dtype=np.uint8)
    return np.array([math.floor(255 * math.pow(v / 255., gamma * .00001)
                                + .5) if 0 < v < 255 else v
                     for v in range(256)], np.uint8)


def _gamma_correct16(v: int, gamma: int) -> int:
    """libpng's png_gamma_16bit_correct."""
    if 0 < v < 65535:
        return int(math.floor(65535 * math.pow(v / 65535., gamma * .00001)
                              + .5))
    return v


def _gamma_table16(gamma: int) -> np.ndarray:
    """libpng's png_build_16bit_table at gamma_shift 5 (png_set_strip_16),
    flat: entry ig for the samples whose top 11 bits are ig."""
    if not _significant(gamma):
        return (np.arange(2048) * 65535 + 1024) // 2047
    return np.array([math.floor(65535. * math.pow(ig / 2047, gamma * .00001)
                                + .5) for ig in range(2048)], np.int64)


def _grey_table16(gamma: int) -> np.ndarray:
    """libpng's png_build_16to8_table at gamma_shift 5, flat: the 16-bit
    value (an 8-bit one times 257) of a grey pixel by its top 11 bits."""
    table = np.full(2048, 65535, np.int64)
    last = 0
    for i in range(255):
        bound = (_gamma_correct16(i * 257 + 128, gamma) * 2047 + 32768) \
            // 65535 + 1
        table[last:bound] = i * 257
        last = max(last, bound)
    return table


def png_rows(data: bytes, lib) -> Raster:
    """Parse a PNG's chunks (IHDR, PLTE, gAMA, sRGB, eXIf, IDAT; tRNS and
    the rest are read past: OpenCV drops alpha), check the critical ones'
    CRCs, inflate the image data with ``zlib`` and unfilter (and
    de-interlace) its rows with ``lib``'s ``png_unfilter_rows`` /
    ``png_adam7_rows`` (the card's library, or a host build of
    ``csrc/png_unfilter.h``). Every colour type at every bit depth the
    format allows is read; a gAMA or sRGB chunk takes the grey image of a
    colour PNG through libpng's gamma tables, as ``cv2.imread`` does.
    Raises ValueError, naming the cause, for a malformed file."""
    if image_format(data) != "PNG":
        raise ValueError(f"not a PNG ({image_format(data)})")
    pos, header, palette, exif, idat = 8, None, None, None, []
    gamma = srgb = None
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n or pos + 12 + n > len(data):
            raise ValueError("a truncated PNG")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if kind[0] < 0x61 and zlib.crc32(kind + body) != crc:
            raise ValueError(f"a PNG whose {kind.decode('latin-1')} chunk "
                             f"fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3]
        elif kind == b"gAMA" and not idat and n == 4:
            gamma = struct.unpack(">I", body)[0]
        elif kind == b"sRGB" and not idat:
            srgb = True
        elif kind == b"eXIf" and exif is None and not idat:
            exif = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("a malformed PNG (no IHDR or no IDAT chunk)")
    width, height, depth, colour_type, _, _, interlace = header
    if colour_type not in _PNG_CHANNELS or width < 1 or height < 1 or \
            depth not in _PNG_DEPTHS[colour_type] or interlace > 1:
        raise ValueError(f"a malformed PNG (colour type {colour_type}, "
                         f"{depth}-bit, interlace {interlace}, "
                         f"{width}x{height})")
    if colour_type == 3 and palette is None:
        raise ValueError("a malformed PNG (a palette image without PLTE)")
    if width * height > 1 << 30:
        raise ValueError(f"a PNG of {width}x{height}: more than 2^30 pixels")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"a malformed PNG (its image data: {e})") from None
    channels = _PNG_CHANNELS[colour_type]
    pixel_bits = channels * depth
    rowbytes = (width * pixel_bits + 7) // 8
    rows = np.empty((height, rowbytes), np.uint8)
    if interlace:
        err = lib.png_adam7_rows(raw, len(raw), rows.ctypes.data, width,
                                 height, pixel_bits)
    else:
        err = lib.png_unfilter_rows(raw, len(raw), rows.ctypes.data, height,
                                    rowbytes, max(1, pixel_bits // 8))
    _check(err, "PNG unfilter")
    tables = np.zeros(TABLES_LEN, np.uint8)
    if palette is not None:
        tables[:min(len(palette), 768)] = palette[:768]
    # libpng's rgb_to_gray goes through gamma tables where the file's gamma
    # (sRGB: 45455) or its reciprocal, the screen's, is significant
    file_gamma = _GAMMA_SRGB if srgb else gamma if gamma else None
    grey_rule = GREY_LIBPNG
    if colour_type in (2, 3, 6) and file_gamma and (
            _significant(file_gamma)
            or _significant(_reciprocal(file_gamma))):
        grey_rule = GREY_LIBPNG_GAMMA
        screen = _reciprocal(file_gamma)
        if depth == 16:
            for at, t in ((TO_ONE16_AT, _gamma_table16(screen)),
                          (FROM_ONE16_AT, _gamma_table16(
                              _reciprocal(screen))),
                          (GREY16_AT, _grey_table16(int(math.floor(
                              1e15 / file_gamma / screen + .5))))):
                tables[at:at + 4096] = t.astype(">u2").view(np.uint8)
        else:
            tables[TO_ONE_AT:TO_ONE_AT + 256] = _gamma_table8(screen)
            tables[FROM_ONE_AT:FROM_ONE_AT + 256] = _gamma_table8(
                _reciprocal(screen))
    kind = {0: RASTER_GREY, 4: RASTER_GREY, 3: RASTER_PALETTE}.get(
        colour_type, RASTER_RGB)
    form = RasterForm(kind, depth, channels, 0, 0, 0, NARROW_SHIFT, 0,
                      grey_rule, width, height, rowbytes, rowbytes * height)
    orientation = 1 if exif is None else lib.exif_orientation_tiff(
        exif, len(exif))
    return Raster(rows, form, tables, orientation)


def tiff_rows(data: bytes, lib) -> Raster:
    """Parse a TIFF's first IFD and decode its strips or tiles on the host
    with ``lib``'s ``tiff_host_*`` functions (the card's library, or a host
    build of ``csrc/tiff_decode.h``), Deflate chunks inflated here with
    ``zlib``: the samples ``cv2.imread`` converts, and how it converts them
    (libtiff's 16-bit narrowing and colour-map rule, OpenCV's grey).
    Raises ValueError, naming the cause, for what the card does not read."""
    if image_format(data) != "TIFF":
        raise ValueError(f"not a TIFF ({image_format(data)})")
    info = (ctypes.c_longlong * 18)()
    _check(lib.tiff_host_info(data, len(data), info), "TIFF read")
    (W, H, bits, spp, pm, planar, comp, _, orientation, _, _, _, chunks,
     alpha, little, n_map, _, _) = list(info)
    offsets = np.zeros(chunks, np.uint64)
    counts = np.zeros(chunks, np.uint64)
    cmap = np.zeros(3 * max(n_map, 1), np.uint16)
    _check(lib.tiff_host_layout(data, len(data), offsets.ctypes.data,
                                counts.ctypes.data, cmap.ctypes.data),
           "TIFF read")
    inflated = None
    if comp in (8, 32946):
        keep = []
        for off, cnt in zip(offsets.tolist(), counts.tolist()):
            try:
                keep.append(zlib.decompressobj().decompress(
                    data[off:off + cnt]))
            except zlib.error as e:
                raise ValueError(f"a malformed TIFF (a Deflate chunk: {e})"
                                 ) from None
        inflated = ((ctypes.c_char_p * chunks)(*keep),
                    (ctypes.c_size_t * chunks)(*map(len, keep)))
    planes = spp if planar == 2 else 1
    rowbytes = (W * (1 if planar == 2 else spp) * bits + 7) // 8
    rows = np.empty((planes * H, rowbytes), np.uint8)
    _check(lib.tiff_host_decode(data, len(data),
                                inflated[0] if inflated else None,
                                inflated[1] if inflated else None,
                                rows.ctypes.data), "TIFF read")
    tables = np.zeros(TABLES_LEN, np.uint8)
    if n_map:  # libtiff's checkcmap: a map with an entry >= 256 is 16-bit
        m = cmap.reshape(3, n_map)
        m = m >> 8 if (m >= 256).any() else m
        tables[:3 * n_map] = m.T.reshape(-1).astype(np.uint8)
    kind = {0: RASTER_GREY, 1: RASTER_GREY, 2: RASTER_RGB,
            3: RASTER_PALETTE, 5: RASTER_CMYK}[pm]
    form = RasterForm(kind, bits, spp, int(planar == 2), little,
                      int(pm == 0), NARROW_ROUND257,
                      int(kind == RASTER_RGB and spp == 4 and alpha == 2),
                      GREY_OPENCV, W, H, rowbytes, rowbytes * H)
    return Raster(rows, form, tables, orientation)


def _raster_samples(raster: Tensor, f: RasterForm) -> Tensor:
    """(H, W, channels) int64 samples of a raster's bytes."""
    H, W, C = f.height, f.width, f.channels
    planes, per = (C, 1) if f.planar else (1, C)
    rows = raster.reshape(planes, H, f.rowbytes).to(torch.int64)
    n = W * per
    if f.bits == 16:
        b = rows[..., :2 * n].reshape(planes, H, n, 2)
        hi, lo = (b[..., 1], b[..., 0]) if f.little else (b[..., 0],
                                                           b[..., 1])
        v = hi * 256 + lo
    elif f.bits == 8:
        v = rows[..., :n]
    else:
        shifts = torch.arange(8 - f.bits, -1, -f.bits, device=raster.device)
        v = ((rows[..., None] >> shifts) & ((1 << f.bits) - 1)).reshape(
            planes, H, -1)[..., :n]
    return v.reshape(planes, H, W, per).permute(1, 2, 0, 3).reshape(H, W, C)


def raster_to_bgr_plain(raster: Tensor, form: RasterForm,
                        tables: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of ``raster_to_bgr_kernel``: (grey (H, W), BGR
    (H, W, 3)) uint8, cv2.imread's, from a raster's bytes (uint8, the
    layout :func:`png_rows` and :func:`tiff_rows` leave) and its tables
    (csrc/raster_bgr.h says what each form computes)."""
    RASTER_COUNTS.plain += 1
    f = form
    s = _raster_samples(raster, f)
    t = tables.to(torch.int64)
    if f.kind == RASTER_GREY:
        v = s[..., 0]
        g = v >> 8 if f.bits == 16 else (
            v * 255 // ((1 << f.bits) - 1) if f.bits < 8 else v)
        if f.min_is_white:
            g = 255 - g
        return g.to(torch.uint8), torch.stack([g, g, g], -1).to(torch.uint8)
    g16 = None
    if f.kind == RASTER_PALETTE:
        rgb = t[:768].reshape(256, 3)[s[..., 0]]
        r, g, b = rgb.unbind(-1)
    elif f.kind == RASTER_CMYK:  # libtiff's RGBA reader
        k = 255 - s[..., 3]
        r, g, b = [k * (255 - s[..., i]) // 255 for i in range(3)]
    else:
        r, g, b = s[..., 0], s[..., 1], s[..., 2]
        a = s[..., 3] if f.premultiply else None
        if f.bits == 16:  # libpng converts before it narrows
            same = (r == g) & (r == b)
            if f.grey_rule == GREY_LIBPNG:
                g16 = torch.where(same, r, (
                    LIBPNG_RC * r + LIBPNG_GC * g + LIBPNG_BC * b + 16384)
                    >> 15)
            elif f.grey_rule == GREY_LIBPNG_GAMMA:
                tab = lambda at: t[at:at + 4096].reshape(2048, 2)
                big = lambda at: tab(at)[:, 0] * 256 + tab(at)[:, 1]
                to1, from1 = big(TO_ONE16_AT), big(FROM_ONE16_AT)
                mix = (LIBPNG_RC * to1[r >> 5] + LIBPNG_GC * to1[g >> 5]
                       + LIBPNG_BC * to1[b >> 5] + 16384) >> 15
                g16 = torch.where(same, big(GREY16_AT)[r >> 5],
                                  from1[mix >> 5])
            nar = (lambda x: (x + 128) // 257) if \
                f.narrow == NARROW_ROUND257 else (lambda x: x >> 8)
            r, g, b = nar(r), nar(g), nar(b)
            a = None if a is None else nar(a)
        if a is not None:
            r, g, b = [(x * a + 127) // 255 for x in (r, g, b)]
    if f.grey_rule == GREY_OPENCV:
        grey = (r * 4899 + g * 9617 + b * 1868 + 8192) >> 14
    elif g16 is not None:
        grey = g16 >> 8
    else:
        if f.grey_rule == GREY_LIBPNG_GAMMA:
            to1 = t[TO_ONE_AT:TO_ONE_AT + 256]
            mix = t[FROM_ONE_AT:FROM_ONE_AT + 256][(
                LIBPNG_RC * to1[r] + LIBPNG_GC * to1[g] + LIBPNG_BC * to1[b]
                + 16384) >> 15]
        else:
            mix = (LIBPNG_RC * r + LIBPNG_GC * g + LIBPNG_BC * b) >> 15
        grey = torch.where((r == g) & (r == b), r, mix)
    return grey.to(torch.uint8), torch.stack([b, g, r], -1).to(torch.uint8)


def raster_to_bgr_kernel(raster: Tensor, form: RasterForm,
                         tables: Tensor) -> Tuple[Tensor, Tensor]:
    """Launch ``raster_to_bgr_kernel`` on a CUDA raster: (grey, BGR), as
    :func:`raster_to_bgr_plain`."""
    planes = form.channels if form.planar else 1
    if raster.device.type != "cuda" or raster.dtype != torch.uint8 or \
            raster.numel() != planes * form.plane_bytes or \
            tables.numel() != TABLES_LEN:
        raise ValueError(f"the raster kernel takes the uint8 CUDA bytes of "
                         f"its form ({planes} x {form.plane_bytes}) and "
                         f"{TABLES_LEN} table bytes, got {raster.dtype} "
                         f"{tuple(raster.shape)} on {raster.device}")
    raster = raster.contiguous()
    tables = tables.to(device=raster.device, dtype=torch.uint8).contiguous()
    H, W = form.height, form.width
    bgr = torch.empty((H, W, 3), dtype=torch.uint8, device=raster.device)
    gray = torch.empty((H, W), dtype=torch.uint8, device=raster.device)
    ints = (ctypes.c_int * 11)(*form[:11])
    sizes = (ctypes.c_longlong * 2)(form.rowbytes, form.plane_bytes)
    err = _library().raster_to_bgr_launch(
        raster.data_ptr(), ints, sizes, tables.data_ptr(), bgr.data_ptr(),
        gray.data_ptr(), _stream(raster))
    _check(err, "raster_to_bgr_kernel launch")
    RASTER_COUNTS.launched()
    return gray, bgr


def raster_rows(data: bytes, lib) -> Raster:
    """:func:`png_rows` or :func:`tiff_rows` by the file's first bytes."""
    return (png_rows if image_format(data) == "PNG" else tiff_rows)(data,
                                                                    lib)


def _decode_raster(data: bytes, dev) -> Tuple[Tensor, Tensor]:
    kind = image_format(data)
    r = raster_rows(data, _library())
    samples = torch.from_numpy(r.samples).to(dev)
    tables = torch.from_numpy(r.tables).to(dev)
    gray, bgr = raster_to_bgr_kernel(samples, r.form, tables)
    CODEC_COUNTS.launched(kind.lower())
    return orient(gray, r.orientation), orient(bgr, r.orientation)


def decode(data: bytes, device) -> Tuple[Tensor, Tensor]:
    """(grey (H, W), BGR (H, W, 3)) uint8 tensors on ``device`` from a
    file's bytes: what ``cv2.imread`` gives with ``IMREAD_GRAYSCALE`` and
    ``IMREAD_COLOR``. On a CUDA device, JPEG, PNG and TIFF."""
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
    kind = image_format(data)
    if kind in ("PNG", "TIFF"):
        return _decode_raster(data, _cuda_device(dev))
    if kind != "JPEG":
        raise ValueError(f"not a JPEG, PNG or TIFF ({kind}): the card's "
                         f"codec reads those only")
    return _decode_jpeg(data, dev)


def decode_colour(data: bytes, device) -> Tensor:
    """BGR (H, W, 3) uint8 on ``device`` from a file's bytes: what
    ``cv2.imread`` gives with ``IMREAD_COLOR``. On a CUDA device, JPEG, PNG
    and TIFF."""
    dev = torch.device(device)
    if dev.type == "cuda" and image_format(data) in ("PNG", "TIFF"):
        return _decode_raster(data, _cuda_device(dev))[1]
    if dev.type == "cpu":
        import cv2

        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError(f"OpenCV cannot decode this {image_format(data)}"
                             f" file")
        return torch.from_numpy(bgr)
    return decode(data, dev)[1]


def _read(path: str, fn, device):
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    try:
        return fn(data, device)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def read_image(path: str, device) -> Tuple[Tensor, Tensor]:
    """:func:`decode` of the file at ``path``."""
    return _read(path, decode, device)


def read_colour(path: str, device) -> Tensor:
    """:func:`decode_colour` of the file at ``path``."""
    return _read(path, decode_colour, device)


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


def _ycc_of(r, g, b):
    """jccolor.c's fixed-point Y, Cb, Cr of int64 samples."""
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
    return y, cb, cr


def _encoder_shapes(H: int, W: int):
    """The encoder's Y plane (the blocks that hold samples) and chroma
    plane sizes of an (H, W) image."""
    return (8 * -(-H // 8), 8 * -(-W // 8)), (8 * -(-H // 16), 8 * -(-W // 16))


def bgr_to_ycc_plain(img: Tensor):
    """The plain version of ``bgr_to_ycc_kernel``: the encoder's planes of
    a uint8 (H, W, 3) BGR or (H, W) grey image, as libjpeg-turbo makes them
    for cv2.imencode: Y at 8 * ceil(H / 8) x 8 * ceil(W / 8) with the last
    row and column replicated, and for colour Cb and Cr at 8 * ceil(H / 16)
    x 8 * ceil(W / 16), 2x2 means with bias 1, 2, 1, 2, ... along a row
    (rows past ceil(H / 2) repeat the last). Returns (y, cb, cr), cb and cr
    None for grey."""
    YCC_COUNTS.plain += 1
    H, W = img.shape[:2]
    (yh, yw), (ch, cw) = _encoder_shapes(H, W)
    dev = img.device
    rows = torch.clamp(torch.arange(yh, device=dev), max=H - 1)
    cols = torch.clamp(torch.arange(yw, device=dev), max=W - 1)
    x = img.to(torch.int64)
    if img.ndim == 2:
        return x[rows][:, cols].to(torch.uint8), None, None
    b, g, r = x.unbind(-1)
    y, cb, cr = _ycc_of(r, g, b)
    i = torch.clamp(torch.arange(ch, device=dev), max=(H + 1) // 2 - 1)
    j = torch.arange(cw, device=dev)
    r0, r1 = torch.clamp(2 * i, max=H - 1), torch.clamp(2 * i + 1, max=H - 1)
    c0, c1 = torch.clamp(2 * j, max=W - 1), torch.clamp(2 * j + 1, max=W - 1)

    def down(p):
        s = (p[r0][:, c0] + p[r0][:, c1] + p[r1][:, c0] + p[r1][:, c1]
             + 1 + (j & 1))
        return (s >> 2).to(torch.uint8)

    return y[rows][:, cols].to(torch.uint8), down(cb), down(cr)


def bgr_to_ycc_kernel(img: Tensor):
    """Launch ``bgr_to_ycc_kernel`` on a CUDA image: as
    :func:`bgr_to_ycc_plain`."""
    if img.device.type != "cuda" or img.dtype != torch.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"the encoder's colour kernel takes a uint8 CUDA "
                         f"(H, W) or (H, W, 3) image, got {img.dtype} "
                         f"{tuple(img.shape)} on {img.device}")
    img = img.contiguous()
    H, W = img.shape[:2]
    (yh, yw), (ch, cw) = _encoder_shapes(H, W)
    new = lambda h, w: torch.empty((h, w), dtype=torch.uint8,
                                   device=img.device)
    y = new(yh, yw)
    cb = cr = None
    if img.ndim == 3:
        cb, cr = new(ch, cw), new(ch, cw)
        gh, gw = ch, cw
    else:
        gh, gw = yh // 2, yw // 2
    err = _library().bgr_to_ycc_launch(
        img.data_ptr(), H, W, 1 if img.ndim == 2 else 3, y.data_ptr(), yh,
        yw, None if cb is None else cb.data_ptr(),
        None if cr is None else cr.data_ptr(), gh, gw, _stream(img))
    _check(err, "bgr_to_ycc_kernel launch")
    YCC_COUNTS.launched()
    return y, cb, cr


def _divisors(qt: Tensor):
    """jcdctmgr.c compute_reciprocal of each divisor 8 * q of a table:
    (recip, corr, shift) int64 tensors."""
    out = []
    for q in (qt.to(torch.int64) & 0xFFFF).tolist():
        d = 8 * q
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr, c = (1 << r) // d, (1 << r) % d, d // 2
        if fr == 0:
            fq, r = fq >> 1, r - 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        out.append((fq, c, r))
    return [torch.tensor(v, dtype=torch.int64, device=qt.device)
            for v in zip(*out)]


def _fdct_1d(v, even_up, even_down, odd_down):
    """jfdctint's 1-D pass over eight int64 tensors, outputs in order."""
    d = lambda x, n: (x + (1 << (n - 1))) >> n
    tmp0, tmp7 = v[0] + v[7], v[0] - v[7]
    tmp1, tmp6 = v[1] + v[6], v[1] - v[6]
    tmp2, tmp5 = v[2] + v[5], v[2] - v[5]
    tmp3, tmp4 = v[3] + v[4], v[3] - v[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if even_up:
        o0, o4 = (tmp10 + tmp11) << even_up, (tmp10 - tmp11) << even_up
    else:
        o0, o4 = d(tmp10 + tmp11, even_down), d(tmp10 - tmp11, even_down)
    z1 = (tmp12 + tmp13) * 4433
    o2, o6 = d(z1 + tmp13 * 6270, odd_down), d(z1 - tmp12 * 15137, odd_down)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, \
        tmp7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    return [o0, d(tmp7 + z1 + z4, odd_down), o2, d(tmp6 + z2 + z3, odd_down),
            o4, d(tmp5 + z2 + z4, odd_down), o6, d(tmp4 + z1 + z3, odd_down)]


def fdct_islow_plain(plane: Tensor, qt: Tensor) -> Tensor:
    """The plain version of ``fdct_islow_quant_kernel``: the quantized
    coefficients (bh, bw, 64) int16, natural order, of a uint8 (8 bh, 8 bw)
    plane by table ``qt`` (64,) (natural order, int16 holding uint16 bits):
    level shift, jfdctint (CONST_BITS 13, PASS1_BITS 2), libjpeg-turbo's
    reciprocal quantization (|x| / 8q rounded half up, sign kept)."""
    FDCT_COUNTS.plain += 1
    H, W = plane.shape
    bh, bw = H // 8, W // 8
    x = plane.to(torch.int64).reshape(bh, 8, bw, 8).permute(0, 2, 1, 3) - 128
    rows = _fdct_1d([x[..., c] for c in range(8)], 2, 0, 11)
    x = torch.stack(rows, -1)                    # (bh, bw, 8 rows, 8 cols)
    cols = _fdct_1d([x[..., k, :] for k in range(8)], 0, 2, 15)
    x = torch.stack(cols, -2).reshape(bh, bw, 64)
    recip, corr, shift = _divisors(qt)
    q = ((x.abs() + corr) * recip) >> shift
    return torch.where(x < 0, -q, q).to(torch.int16)


def fdct_islow_kernel(plane: Tensor, qt: Tensor) -> Tensor:
    """Launch ``fdct_islow_quant_kernel`` on a CUDA plane: as
    :func:`fdct_islow_plain`."""
    H, W = plane.shape
    if plane.device.type != "cuda" or plane.dtype != torch.uint8 or \
            H % 8 or W % 8 or qt.numel() != 64:
        raise ValueError(f"the forward DCT kernel takes a uint8 CUDA plane "
                         f"of whole blocks and a 64-entry table, got "
                         f"{plane.dtype} {(H, W)} on {plane.device}")
    plane = plane.contiguous()
    qt = qt.to(device=plane.device, dtype=torch.int16).contiguous()
    coef = torch.empty((H // 8, W // 8, 64), dtype=torch.int16,
                       device=plane.device)
    err = _library().fdct_islow_launch(plane.data_ptr(), W // 8, H // 8,
                                       qt.data_ptr(), coef.data_ptr(),
                                       _stream(plane))
    _check(err, "fdct_islow_quant_kernel launch")
    FDCT_COUNTS.launched()
    return coef


def quality_tables(quality: int, lib) -> Tensor:
    """The luminance and chrominance quantization tables (2, 64) of a
    quality, natural order, as int16 holding uint16 bits: jcparam.c's, from
    ``lib`` (the card's library or a host build of csrc/jpeg_encode.h)."""
    out = np.zeros(128, np.uint16)
    lib.jpeg_quality_tables(int(quality), out.ctypes.data)
    return torch.from_numpy(out.view(np.int16).reshape(2, 64).copy())


def encode_coefficients(coefs, width: int, height: int, quality: int,
                        lib) -> bytes:
    """The JPEG file of quantized coefficients, Huffman-coded on the host by
    ``lib``'s ``jpeg_host_encode``: ``coefs`` are Y's (and Cb's and Cr's)
    (bh, bw, 64) int16 blocks that hold samples, on the CPU."""
    arrs = [np.ascontiguousarray(c.numpy() if isinstance(c, Tensor) else c,
                                 np.int16) for c in coefs]
    ptr = lambda k: arrs[k].ctypes.data if len(arrs) > k else None
    cb_shape = arrs[1].shape if len(arrs) == 3 else (0, 0)
    handle, data = ctypes.c_void_p(), ctypes.c_void_p()
    length = ctypes.c_size_t()
    _check(lib.jpeg_host_encode(
        ptr(0), arrs[0].shape[1], arrs[0].shape[0], ptr(1), ptr(2),
        cb_shape[1], cb_shape[0], len(arrs), width, height, int(quality),
        ctypes.byref(handle), ctypes.byref(data), ctypes.byref(length)),
        "JPEG entropy coding")
    try:
        return ctypes.string_at(data.value, length.value)
    finally:
        lib.jpeg_host_encode_free(handle)


def encode_jpeg(img, device, quality: int = PREVIEW_QUALITY) -> bytes:
    """JPEG bytes of a uint8 (H, W) grey or (H, W, 3) BGR image (colour at
    4:2:0, cv2's default), encoded on ``device``: ``cv2.imencode``'s bytes
    at ``quality``, by the card's kernels and the host's entropy coding on a
    CUDA device, by OpenCV on the CPU."""
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
    lib = _library()
    qt = quality_tables(quality, lib).to(t.device)
    y, cb, cr = bgr_to_ycc_kernel(t)
    coefs = [fdct_islow_kernel(y, qt[0])]
    if cb is not None:
        coefs += [fdct_islow_kernel(cb, qt[1]), fdct_islow_kernel(cr, qt[1])]
    H, W = t.shape[:2]
    out = encode_coefficients([c.cpu() for c in coefs], W, H, quality, lib)
    CODEC_COUNTS.launched("encode")
    return out


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
