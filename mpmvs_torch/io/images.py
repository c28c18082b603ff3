"""Image files of a workspace: JPEG, PNG, TIFF, WebP, BMP and PNM reads,
JPEG and PNG writes.

The JAX package reads and writes images with OpenCV. Here the device picks
the codec:

  * on a CUDA device, through ``csrc/jpeg_codec.cu``, with what ``cv2``
    gives, bit for bit, and no OpenCV:
      - JPEG reads of one, three or four components at every sampling
        layout libjpeg takes, Huffman or arithmetic-coded, sequential or
        progressive: the host entropy-decodes the file to DCT
        coefficients (``csrc/jpeg_entropy.h``; arithmetic coding by
        ``csrc/jpeg_arith.h``, libjpeg's QM decoder), the card runs libjpeg's
        integer inverse DCT (``idct_islow_kernel``) and libjpeg-turbo's
        upsampling of each component and colour conversion with OpenCV's
        after it (``ycc_to_bgr_kernel``: YCbCr, or RGB components;
        ``cmyk_to_bgr_kernel``: CMYK or YCCK; libjpeg guesses the space from
        the markers and ids), and applies the EXIF orientation as OpenCV's
        ``ApplyExifOrientation`` does (:func:`orient`). The grey image is the
        Y plane of a YCbCr JPEG, as ``cv2.imread(IMREAD_GRAYSCALE)`` gives
        it, libjpeg-turbo's ``rgb_gray_convert`` of an RGB one and OpenCV's
        ``icvCvt_CMYK2Gray_8u_C4C1R`` of a CMYK or YCCK one;
      - lossless JPEG reads (SOF3, 2 to 8 bits, predictors 1 to 7, any
        point transform, restarts, any sampling): the host entropy-decodes
        each component's sample differences (``csrc/jpeg_lossless.h``,
        :func:`lossless_image`), the card undifferences them
        (``ljpeg_scan_kernel`` for predictors 1 to 4, prefix sums;
        ``ljpeg_wavefront_kernel`` for 5 to 7, a wavefront; their
        arithmetic in ``csrc/jpeg_lossless_pred.h``) into the planes the
        IDCT would give, and the RGB or CMYK colour form makes the BGR,
        components replicated (no fancy upsampling in lossless mode). As
        cv2 reads them: RGB in colour only (:func:`decode_colour`), CMYK in
        both modes, grey in grey only, which no entry here takes; YCbCr and
        YCCK in neither;
      - PNG reads of every colour type at every bit depth, Adam7 included
        (:func:`png_rows`: the chunks are parsed and inflated here with
        ``zlib``, the rows unfiltered and de-interlaced on the host,
        ``csrc/png_unfilter.h``), TIFF reads (:func:`tiff_rows`: classic
        and BigTIFF, strips and tiles, chunky and planar, uncompressed, LZW
        (old-style too), Deflate and PackBits, a compressed chunk cut short
        read as libtiff reads it, predictor 2, grey, RGB, palette, 8-bit
        CMYK, YCbCr in libtiff's data units and CIELab at 8 and 16 bits, 1
        to 16 bits, signed samples as their bits; parsed and decompressed
        on the host, ``csrc/tiff_decode.h``), BMP reads (:func:`bmp_rows`: 1 to 32 bits,
        RLE4 and RLE8 expanded on the host, OS/2 headers) and PBM, PGM and
        PPM reads (:func:`pnm_rows`, P1 to P6): the samples are copied to
        the card, where ``raster_to_bgr_kernel`` makes cv2's BGR and grey
        images of them (sub-8-bit grey expanded, palette looked up, 16 bits
        narrowed as libpng or libtiff narrows, alpha dropped or
        premultiplied, CMYK by libtiff's RGBA rule, YCbCr by libtiff's
        tables (:func:`ycbcr_tables`), CIELab by libtiff's RGBA reader's
        conversion (:func:`cielab_tables`), a BMP's B, G, R order and 16-bit
        fields, the grey of colour by libpng's or OpenCV's arithmetic), and
        the eXIf or Orientation tag (a bottom-up BMP: a top-down mirror) is
        applied;
      - JPEG-compressed TIFF reads (:func:`tiff_jpeg_coefficients`: each
        strip or tile a JPEG stream of its own, decoded on the host with the
        JPEGTables' tables, ``csrc/tiff_jpeg.h``): one IDCT launch a
        component over every chunk at once, and one launch of
        ``ycc_to_bgr_kernel``'s chunked form, which upsamples each chunk on
        its own and writes libjpeg's BGR (YCbCr converted, RGB as it is) and
        OpenCV's grey of it;
      - lossy WebP reads (VP8 frames, simple or extended files; ALPH and
        ICCP chunks read past, as cv2 drops alpha; the EXIF chunk's
        orientation applied): the RIFF is checked here
        (:func:`webp_container`), the host parses the frame and
        entropy-decodes every macroblock (``csrc/webp_decode.h``), and the
        card rebuilds it (``vp8_reconstruct_kernel``), loop-filters it
        (``vp8_loop_filter_kernel``), both as macroblock-row wavefronts, and
        makes libwebp's fancy-upsampled BGR and OpenCV's grey of it
        (``webp_yuv_to_bgr_kernel``);
      - lossless WebP reads (VP8L frames, simple or VP8X files, the EXIF
        orientation applied) and animated ones (cv2's read: the first ANMF
        frame, lossy or lossless, at its offset (2 X, 2 Y) on a canvas of
        zeros the VP8X's size): the container is walked here
        (:func:`webp_container`), the host entropy-decodes a VP8L frame
        (``csrc/webp_lossless.h``: prefix codes, colour cache, LZ77, the
        transforms' data; :func:`vp8l_decode`), and the card undoes its
        transforms in the file's reverse order, the predictor as a pixel
        wavefront (``vp8l_predictor_kernel``), each run of element-wise
        ones (cross-colour, add green, colour indexing) in one launch
        (``vp8l_colour_kernel``), and makes cv2's BGR (alpha dropped) and
        grey on the canvas (``webp_argb_to_bgr_kernel``); a lossy first
        frame takes the lossy kernels and is placed on the canvas;
      - JPEG writes: cv2.imencode's bytes (4:2:0 colour or grey, standard
        Huffman tables) from the card's colour conversion and downsampling
        (``bgr_to_ycc_kernel``) and forward DCT and quantization
        (``fdct_islow_quant_kernel``), Huffman-coded on the host
        (``csrc/jpeg_encode.h``).
    Files cut short read as ``cv2.imread`` reads them from the path, through
    libjpeg's and libtiff's sources, which feed a fake EOI (FF D9) past the
    end: a JPEG cut inside its entropy-coded data decodes what it holds
    (libjpeg's insufficient-data rule, block smoothing of progressive
    files); one cut inside a marker segment has the segment completed with
    the fake EOI's bytes and parsed by libjpeg's rule for that marker,
    refused where libjpeg errors (a cut before the first scan always is);
    a JPEG-compressed TIFF's stream of fewer rows than its strip or tile
    leaves the rest black; an uncompressed TIFF strip short of its rows
    reads as zeros after libtiff's estimate of the byte counts, and a count
    of 0 or past the end of the file, or a short tile, is refused.
    A kernel that fails to build or launch raises, and so does a file the card
    cannot read, naming why (12-bit, arithmetic-coded lossless and
    hierarchical JPEGs, and the lossless reads cv2 refuses;
    old-style JPEG, ICCLab, ITULab and float TIFFs; PAM, PFM, GIF
    and other formats; and what cv2 does not read either, such as a WebP
    whose first frame runs past its canvas or whose prefix codes libwebp
    rejects, or a BMP run past its row). Nothing falls back to OpenCV or to
    the CPU.
  * on the CPU, through OpenCV, imported only there: :func:`read_image` and
    :func:`read_colour` are ``cv2.imread`` of the path, as the JAX package
    reads a view; :func:`decode` and :func:`decode_colour`, which have no
    path, ``cv2.imdecode`` of the bytes (which refuses a JPEG cut short).
    The CPU tests hold the port's reads and writes against the JAX
    package's OpenCV calls.

PNG files (``triangulation.png``) are written on the host with the
standard library's ``zlib``, on every device.

Each kernel has a plain PyTorch version beside it, for the tests
(:func:`colour_plain`, with :func:`ycc_to_bgr_plain` and
:func:`cmyk_to_bgr_plain`;
:func:`jpeg_smooth_plain`, :func:`idct_islow_plain`,
:func:`bgr_to_ycc_plain`,
:func:`fdct_islow_plain`, :func:`raster_to_bgr_plain`,
:func:`vp8_reconstruct_plain`, :func:`vp8_loop_filter_plain`,
:func:`webp_yuv_to_bgr_plain`, :func:`vp8l_predictor_plain`,
:func:`vp8l_colour_plain`, :func:`webp_argb_to_bgr_plain`,
:func:`ljpeg_undiff_plain`). ``COUNTS`` counts
launches of the colour kernels (form ``"rgb"`` for RGB components,
``"cmyk"`` and ``"ycck"`` for ``cmyk_to_bgr_kernel``) and their plain calls
(the four-component ones by form in ``plain_forms``), ``SMOOTH_COUNTS``,
``IDCT_COUNTS``,
``YCC_COUNTS``, ``FDCT_COUNTS``, ``RASTER_COUNTS``, ``VP8_RECON_COUNTS``,
``VP8_FILTER_COUNTS``, ``WEBP_COLOUR_COUNTS``, ``VP8L_PREDICTOR_COUNTS``,
``VP8L_COLOUR_COUNTS`` (by run, ``forms``), ``WEBP_ARGB_COUNTS`` and
``LJPEG_COUNTS`` (forms ``"scan"``, a launch a pass, and ``"wavefront"``)
those of the smoothing, IDCT, encoder colour, forward DCT, raster, WebP
and lossless JPEG kernels; ``CODEC_COUNTS`` counts host decodes (``forms["decode"]``;
``"jpeg_arith"`` too for an arithmetic-coded JPEG, ``"jpeg_lossless"``
for a lossless one's read), PNG, TIFF, BMP,
PNM and WebP reads (``forms["png"]``, ``forms["tiff"]``,
``forms["tiff_jpeg"]`` for a JPEG-compressed TIFF, ``forms["bmp"]``,
``forms["pnm"]``, ``forms["webp"]`` for a lossy still file,
``"webp_lossless"`` for a lossless one, ``"webp_animated"`` for an
animated one) and encodes (``forms["encode"]``). ``COUNTS`` names the
chunked colour forms ``"chunks"`` and ``"chunks_rgb"``, and
``RASTER_COUNTS`` the raster forms ``"ycbcr"``, ``"bmp16"``, ``"bgr"``
and ``"cielab"``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import re
import struct
import zlib
from typing import NamedTuple, Optional, Tuple

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
SMOOTH_COUNTS = nvcc.LaunchCounts()
RASTER_COUNTS = nvcc.LaunchCounts()
LJPEG_COUNTS = nvcc.LaunchCounts()
# what the host codes of csrc/ name (a JPEG's, PNG's, TIFF's or WebP's
# cause of refusal)
_CODE_ERRORS = {
    2001: "a truncated JPEG, cut inside a marker segment whose "
          "completion libjpeg rejects too: completed with the fake EOI "
          "bytes (FF D9) that libjpeg's source feeds past the end, as "
          "cv2.imread reads a file, its Huffman table counts, table index, "
          "restart-interval length, scan header or progression are not "
          "valid",
    2002: "a JPEG of an unsupported layout (2 or more than 4 components, "
          "or more than 2^28 pixels)",
    2003: "a malformed JPEG (or one with no scan, such as a file cut "
          "before its first)",
    2006: "a JPEG of another sample precision than cv2 reads (12-bit DCT "
          "samples, or a lossless JPEG of more than 8 bits or of 1)",
    2007: "an arithmetic-coded lossless JPEG (SOF11), which libjpeg-turbo "
          "refuses too",
    2008: "a hierarchical JPEG (DHP, SOF5-7, SOF13-15), which libjpeg "
          "refuses too",
    2010: "coefficients that do not fit the image's size",
    2011: "a JPEG of a sampling layout libjpeg refuses too (a factor "
          "outside 1-4, a factor that does not divide the largest of its "
          "axis, or more than 10 blocks in an interleaved MCU)",
    2012: "a lossless JPEG whose scan libjpeg refuses too (a predictor Ss "
          "outside 1-7, Se or Ah not 0, or a point transform not below the "
          "precision)",
    2013: "a lossless JPEG whose restart interval is not whole MCU rows, "
          "which libjpeg-turbo refuses too",
    2014: "a lossless JPEG of YCbCr or YCCK components (a JFIF marker, or "
          "an Adobe transform other than 0), which cv2 reads in neither "
          "mode: libjpeg-turbo converts no colour in lossless mode",
    2015: "a lossless JPEG of one component, which cv2 reads in grey only: "
          "IMREAD_COLOR fails, as libjpeg-turbo makes no BGR of grey in "
          "lossless mode",
    2016: "a lossless RGB JPEG, which cv2 reads in colour only: "
          "IMREAD_GRAYSCALE fails, as libjpeg-turbo makes no grey of RGB "
          "in lossless mode",
    3001: "a PNG whose image data is shorter than its header implies",
    3002: "a PNG with a row filter type above 4",
    4001: "a truncated TIFF",
    4002: "a malformed TIFF (a required tag missing or out of range)",
    4003: "a TIFF of old-style JPEG data (Compression 6), which the card "
          "does not read",
    4004: "a TIFF of a compression the card does not read (it reads none, "
          "LZW, Deflate and PackBits)",
    4005: "a TIFF whose old-style LZW data (the pre-1991 bit-reversed "
          "form) is corrupt",
    4006: "a TIFF whose LZW data is corrupt",
    4007: "a TIFF of uncompressed data that libtiff fails to read, so cv2 "
          "refuses it too: a strip or tile byte count of 0 or past the end "
          "of the file (as libtiff estimates the counts where it replaces "
          "them), or a tile shorter than its rows (a strip shorter than its "
          "rows reads as zeros)",
    4008: "a TIFF of signed or float samples that cv2 does not read into "
          "an 8-bit image either (SampleFormat 3, or SampleFormat 2 above "
          "16 bits)",
    4009: "a TIFF of the floating-point predictor (Predictor 3)",
    4010: "a TIFF of horizontal differencing on samples other than 8- or "
          "16-bit, which libtiff refuses too",
    4011: "a TIFF of separated samples of another InkSet than CMYK, which "
          "cv2 (libtiff's RGBA reader) does not read either",
    4012: "a TIFF of YCbCr samples of a layout libtiff's RGBA reader does "
          "not read either (other than 8 bits and 3 samples, a subsampling "
          "other than (1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), "
          "(1, 2), planar and subsampled, or a predictor), or of subsampled "
          "tiles under an orientation that mirrors them, which the card "
          "does not lay out",
    4013: "a TIFF of ICCLab or ITULab samples (Photometric 9 or 10), "
          "which libtiff's RGBA reader, and so cv2, does not read either",
    4014: "a TIFF of a photometric the card does not read (it reads "
          "min-is-white, min-is-black, RGB, palette, CMYK and YCbCr)",
    4015: "a TIFF of more than 16 bits a sample",
    4016: "a TIFF of a bit depth OpenCV does not read into an 8-bit image "
          "either (grey takes 1, 8, 16; RGB 8, 16; a palette 1, 4, 8; "
          "CMYK 8)",
    4017: "a TIFF of a sample count its photometric does not take",
    4018: "a CMYK TIFF with an extra sample: five channels, which cv2 "
          "does not read either",
    4019: "a JPEG-compressed TIFF whose stream's component count or "
          "sampling factors do not match its tags, which libtiff refuses "
          "too (Improper JPEG sampling factors or component count)",
    4020: "a JPEG-compressed TIFF whose stream is larger than its strip or "
          "tile, which libtiff refuses too, or of another width, which the "
          "card does not read (a stream of fewer rows reads, the rows past "
          "it black, as cv2 reads it)",
    4021: "a JPEG-compressed TIFF of a layout the card does not read "
          "(planar, not grey, RGB or YCbCr of 8 bits, or quantization "
          "tables that differ from one strip or tile to another)",
    4022: "a CIELab TIFF of planar samples (PlanarConfiguration 2), "
          "which libtiff's RGBA reader, and so cv2, does not read either",
    4023: "a CIELab TIFF of other than three samples (an extra sample, or "
          "L* alone), which libtiff's RGBA reader, and so cv2, does not "
          "read either",
    4024: "a CIELab TIFF of other than 8 or 16 bits a sample, which cv2 "
          "does not read either",
    5001: "a truncated WebP (a header or partition ends early)",
    5002: "a malformed WebP (not RIFF/WEBP, or a chunk out of bounds)",
    5003: "a WebP whose frame is lossless (VP8L), handed to the lossy "
          "(VP8) decoder",
    5004: "an animated WebP (ANIM/ANMF chunks), handed whole to the still "
          "lossy (VP8) decoder",
    5005: "a malformed WebP (no VP8 chunk)",
    5006: "a WebP whose VP8 data is not a shown key frame of non-zero size",
    5007: "a corrupt WebP (a VP8 partition read well past its end)",
    5008: "a lossless WebP (VP8L) whose header is not VP8L's (signature "
          "0x2f, version 0, 5 bytes), which libwebp refuses too",
    5009: "a truncated lossless WebP (its VP8L data ends before the image "
          "does), which libwebp refuses too",
    5010: "a lossless WebP (VP8L) with a prefix code libwebp rejects too "
          "(over-subscribed, incomplete or empty)",
    5011: "a malformed lossless WebP (VP8L: a transform repeated, colour "
          "cache bits outside 1-11, or a back-reference outside the "
          "image), which libwebp refuses too"}

_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"\x89PNG\r\n\x1a\n", "PNG"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"),
          (b"MM\x00+", "TIFF"), (b"BM", "BMP"),
          (b"GIF8", "GIF"), (b"PF", "PFM"), (b"Pf", "PFM"))
# the netpbm formats as OpenCV's decoders tell them: P, a digit, whitespace
_PNM = {b"1": "PBM", b"2": "PGM", b"3": "PPM", b"4": "PBM", b"5": "PGM",
        b"6": "PPM", b"7": "PAM"}
_SPACE = b" \t\n\v\f\r"


def image_format(data: bytes) -> str:
    """The format a file's first bytes name ("JPEG", "PNG", "WebP", "BMP",
    "PGM", ...), or "unknown". A netpbm file is named as OpenCV's decoders
    check it: "P", the kind's digit, then whitespace."""
    if data.startswith(b"RIFF"):
        return "WebP" if data[8:12] == b"WEBP" else \
            f"RIFF {data[8:12]!r}, not a WebP"
    if data[:1] == b"P" and data[1:2] in _PNM and data[2:3] and \
            data[2:3] in _SPACE:
        return _PNM[data[1:2]]
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


def bind_host(lib):
    """Set the ctypes signatures of the codec's host functions (no CUDA:
    the encoder's entropy coding, the PNG unfilter and de-interlace, the
    TIFF reader, the EXIF reader, the WebP entropy decode) on a library
    that has them, the card's or a host build of the headers."""
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
    lib.tiff_host_rationals.argtypes = [ctypes.c_char_p, sz, i, vp, i]
    lib.tiff_host_rationals.restype = i
    if hasattr(lib, "tiff_jpeg_host_info"):  # a build with tiff_jpeg.h
        lib.tiff_jpeg_host_info.argtypes = [ctypes.c_char_p, sz, vp, vp]
        lib.tiff_jpeg_host_decode.argtypes = [ctypes.c_char_p, sz, vp, vp,
                                              vp]
        for fn in ("tiff_jpeg_host_info", "tiff_jpeg_host_decode"):
            getattr(lib, fn).restype = i
    if hasattr(lib, "webp_host_header"):  # a build with webp_decode.h
        lib.webp_host_header.argtypes = [ctypes.c_char_p, sz, vp]
        lib.webp_host_decode.argtypes = [ctypes.c_char_p, sz, vp, vp, vp]
        for fn in ("webp_host_header", "webp_host_decode"):
            getattr(lib, fn).restype = i
    if hasattr(lib, "vp8l_host_decode"):  # a build with webp_lossless.h
        lib.vp8l_host_decode.argtypes = [ctypes.c_char_p, sz, vp, vp, vp, vp]
        lib.vp8l_host_decode.restype = i
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
    lib.jpeg_host_lossless.argtypes = [vp, i, vp, vp]
    lib.jpeg_host_smoothing.argtypes = [vp, vp]
    lib.jpeg_smooth_launch.argtypes = [vp, vp, vp, vp]
    lib.ljpeg_scan_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp, i, vp]
    lib.ljpeg_wavefront_launch.argtypes = [vp, vp, vp, vp, i, i, vp, vp]
    lib.idct_islow_launch.argtypes = [vp, vp, i, i, i, vp, i, i, vp]
    lib.ycc_to_bgr_launch.argtypes = [vp, vp, i, i, vp, vp, i, i, vp, vp,
                                      vp]
    lib.cmyk_to_bgr_launch.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.bgr_to_ycc_launch.argtypes = [vp, i, i, i, vp, i, i, vp, vp, i, i,
                                      vp]
    lib.fdct_islow_launch.argtypes = [vp, i, i, vp, vp, vp]
    lib.raster_to_bgr_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp]
    lib.vp8_reconstruct_launch.argtypes = [vp, vp, vp, i, i, vp, vp, vp, vp,
                                           vp]
    lib.vp8_loop_filter_launch.argtypes = [vp, vp, i, i, vp, vp, vp, vp, vp]
    lib.webp_yuv_to_bgr_launch.argtypes = [vp, vp, vp, i, i, i, vp, vp, vp]
    lib.vp8l_predictor_launch.argtypes = [vp, vp, i, i, i, vp, vp, vp]
    lib.vp8l_colour_launch.argtypes = [vp, vp, vp, vp, vp]
    lib.webp_argb_to_bgr_launch.argtypes = [vp, i, i, i, i, i, i, vp, vp, vp]
    for fn in ("jpeg_host_decode", "jpeg_host_upload", "idct_islow_launch",
               "ycc_to_bgr_launch", "cmyk_to_bgr_launch", "bgr_to_ycc_launch",
               "fdct_islow_launch", "raster_to_bgr_launch",
               "vp8_reconstruct_launch", "vp8_loop_filter_launch",
               "webp_yuv_to_bgr_launch", "vp8l_predictor_launch",
               "vp8l_colour_launch", "webp_argb_to_bgr_launch",
               "jpeg_host_lossless", "jpeg_host_smoothing",
               "jpeg_smooth_launch", "ljpeg_scan_launch",
               "ljpeg_wavefront_launch"):
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


def _upsample(p: Tensor, H: int, W: int, rh: int, rv: int,
              fancy: bool = True) -> Tensor:
    """libjpeg-turbo's upsampling (jdsample.c) of a component's plane to
    (H, W), int64, at ratios ``rh``, ``rv``: as it is at 1 x 1, fancy
    (:func:`_fancy`; never without ``fancy``, a lossless JPEG's) or each
    sample replicated ``rh`` x ``rv`` times."""
    Hc, Wc = p.shape
    dev = p.device
    r = torch.arange(H, device=dev)[:, None]
    c = torch.arange(W, device=dev)[None, :]
    p = p.to(torch.int64)
    if rh == 1 and rv == 1:
        return p[:H, :W]
    if not (fancy and _fancy(Wc, rh, rv)):
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


def opencv_grey(b: Tensor, g: Tensor, r: Tensor) -> Tensor:
    """OpenCV's BGR -> grey of int64 samples (14-bit fixed point,
    rounding)."""
    return (b * 1868 + g * 9617 + r * 4899 + 8192) >> 14


def cmyk_bgr_plain(c: Tensor, m: Tensor, y: Tensor, k: Tensor):
    """OpenCV's icvCvt_CMYK2Gray_8u_C4C1R and icvCvt_CMYK2BGR_8u_C4C3R of
    int64 C, M, Y, K samples: (grey, B, G, R), int64."""
    red, green, blue = [k - ((255 - x) * k >> 8) for x in (c, m, y)]
    return opencv_grey(blue, green, red), blue, green, red


def _check_planes(planes, factors, size):
    H, W = size
    if len(planes) != len(factors) or len(planes) not in (1, 3, 4):
        raise ValueError(f"{len(planes)} planes with {len(factors)} factors")
    for p, (rh, rv) in zip(planes, factors):
        if p.dtype != torch.uint8 or tuple(p.shape) != (-(-H // rv),
                                                        -(-W // rh)):
            raise ValueError(f"a plane {p.dtype} {tuple(p.shape)} does not "
                             f"fit {size} at ratios {(rh, rv)}")


class Chunks(NamedTuple):
    """How a JPEG-compressed TIFF's image is cut into strips or tiles, each
    a JPEG stream of its own (``jpeg_colour::Chunks``, in its order)."""
    tiled: int        # 1: tiles, 0: strips
    width: int        # a chunk's pixels across (a strip's: the image's)
    height: int       # its rows (RowsPerStrip, or the tile's)
    across: int       # chunks a row of them (1 for strips)
    count: int        # chunks in all
    mirror: int       # tiles laid out mirrored (an orientation 2, 3, 6, 7)
    image_width: int
    # each chunk's stream's rows: a last strip's may pass the image, the
    # rows past a shorter stream are black
    rows: tuple


def _chunk_planes(planes, factors, size, chunks: Chunks):
    """Check the chunked planes (each (count * stride, pitch) uint8, a
    chunk's samples every ``stride`` rows) and return each plane's
    (h, w, stride): its samples a chunk."""
    H, W = size
    k = chunks
    if len(planes) != len(factors) or len(planes) not in (1, 3):
        raise ValueError(f"{len(planes)} chunked planes with {len(factors)} "
                         f"factors")
    if k.count != (-(-H // k.height)) * (k.across if k.tiled else 1) or (
            k.tiled and k.across != -(-W // k.width)) or (
            not k.tiled and k.width != W):
        raise ValueError(f"chunks {k} do not cut a {size} image")
    out = []
    for p, (rh, rv) in zip(planes, factors):
        h, w = -(-k.height // rv), -(-k.width // rh)
        rows = max(h, -(-max(k.rows) // rv))
        if p.dtype != torch.uint8 or p.ndim != 2 or \
                p.shape[0] % k.count or p.shape[0] // k.count < rows or \
                p.shape[1] < w:
            raise ValueError(f"a chunked plane {p.dtype} {tuple(p.shape)} "
                             f"does not hold {k.count} chunks of {rows} x "
                             f"{w} samples")
        out.append((h, w, p.shape[0] // k.count))
    return out


def _spots(chunks: Chunks, H: int, W: int, dev):
    """jpeg_colour.h spot of every pixel: its chunk, row and column there
    and the rows of the chunk's stream, (H, W) int64 each."""
    k = chunks
    r = torch.arange(H, device=dev)[:, None]
    c = torch.arange(W, device=dev)[None, :]
    if k.mirror:
        c = W - 1 - c
    ty = r // k.height
    tx = c // k.width if k.tiled else torch.zeros_like(c)
    chunk = ty * k.across + tx
    rows = torch.tensor(k.rows, device=dev)[chunk]
    col = c - tx * k.width
    if k.mirror:  # each tile's columns in order at its mirrored place
        col = torch.clamp(W - tx * k.width, max=k.width) - 1 - col
    return chunk, r - ty * k.height, col, rows


def _upsample_chunked(p: Tensor, spots, w: int, stride: int, rh: int,
                      rv: int) -> Tensor:
    """jpeg_colour.h upsampled() of one component at every pixel: each
    chunk's samples upsampled on their own, neighbours clamped to the
    chunk, int64 (H, W)."""
    chunk, r, col, rows = spots
    pitch = p.shape[1]
    flat = p.reshape(-1).to(torch.int64)
    base = chunk * stride * pitch
    at = lambda i, j: flat[base + i * pitch + j]
    if rh == 1 and rv == 1:
        return at(r, col)
    if not _fancy(w, rh, rv):
        return at(r // rv, col // rh)
    h = (rows + rv - 1) // rv
    odd_r, odd_c = (r & 1) == 1, (col & 1) == 1
    i, j = r // rv, col // rh
    i2 = torch.where(odd_r, torch.minimum(i + 1, h - 1),
                     torch.clamp(i - 1, min=0))
    jn = torch.where(odd_c, torch.clamp(j + 1, max=w - 1),
                     torch.clamp(j - 1, min=0))
    if rh == 2 and rv == 2:
        cs = 3 * at(i, j) + at(i2, j)
        cn = 3 * at(i, jn) + at(i2, jn)
        return (3 * cs + cn + torch.where(odd_c, 7, 8)) >> 4
    if rh == 2:
        return (3 * at(i, j) + at(i, jn) + torch.where(odd_c, 2, 1)) >> 2
    return (3 * at(i, j) + at(i2, j) + torch.where(odd_r, 2, 1)) >> 2


def colour_plain(planes, factors, size, space: int,
                 chunks: Chunks = None,
                 fancy: bool = True) -> Tuple[Tensor, Tensor]:
    """The plain version of the colour kernels: (grey (H, W), BGR (H, W, 3))
    uint8, cv2.imread's, from a JPEG's component planes (uint8, each at its
    sampled size), their ratios ``factors`` ((hmax / h, vmax / v) each) and
    the image's ``size`` (H, W), in colour ``space`` (``SPACE_*``;
    csrc/jpeg_colour.h says what each computes). Four components go through
    :func:`cmyk_to_bgr_plain`. With ``chunks`` (a JPEG-compressed TIFF's
    strips or tiles, their planes laid out as :func:`tiff_jpeg_planes`
    gives them) each chunk is upsampled on its own and the grey is OpenCV's
    of the BGR (form ``"chunks"``, ``"chunks_rgb"``). Without ``fancy`` (a
    lossless JPEG's planes) every component is upsampled by
    replication."""
    if space in (SPACE_CMYK, SPACE_YCCK):
        return cmyk_to_bgr_plain(planes, factors, space == SPACE_YCCK, size,
                                 fancy)
    H, W = size
    if chunks is None:
        _check_planes(planes, factors, size)
        up = [_upsample(p, H, W, *f, fancy) for p, f in zip(planes, factors)]
    else:
        geo = _chunk_planes(planes, factors, size, chunks)
        spots = _spots(chunks, H, W, planes[0].device)
        up = [_upsample_chunked(p, spots, w, stride, *f)
              for p, f, (_, w, stride) in zip(planes, factors, geo)]
        form = "chunks_rgb" if space == SPACE_RGB and len(up) == 3 \
            else "chunks"
        COUNTS.plain_forms[form] = COUNTS.plain_forms.get(form, 0) + 1
    COUNTS.plain += 1
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
    if chunks is not None:
        grey = opencv_grey(*bgr.unbind(-1))
        past = spots[1] >= spots[3]  # past a chunk's shorter stream
        grey = torch.where(past, 0, grey)
        bgr = torch.where(past[..., None], 0, bgr)
    return grey.to(torch.uint8), bgr.to(torch.uint8)


def cmyk_to_bgr_plain(planes, factors, ycck: bool, size=None,
                      fancy: bool = True) -> Tuple[Tensor, Tensor]:
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
    c, m, y, k = [_upsample(p, H, W, *f, fancy)
                  for p, f in zip(planes, factors)]
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


def _wrap16(x: Tensor) -> Tensor:
    return ((x + 32768) & 0xFFFF) - 32768


def _wrap32(x: Tensor) -> Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _madd(a, ca: int, b, cb: int) -> Tensor:
    """pmaddwd: a * ca + b * cb in 32 bits."""
    return _wrap32(a * ca + b * cb)


def _idct_1d(v):
    """One pass of libjpeg-turbo's SIMD islow IDCT (``csrc/jpeg_idct.h``
    idct_1d) over eight int64 tensors of 16-bit values: the eight 32-bit
    sums of outputs 0..7 before the descale."""
    tmp3 = _madd(v[2], 4433 + 6270, v[6], 4433)
    tmp2 = _madd(v[2], 4433, v[6], 4433 - 15137)
    tmp0 = _wrap32(_wrap16(v[0] + v[4]) * 8192)
    tmp1 = _wrap32(_wrap16(v[0] - v[4]) * 8192)
    t10, t13 = _wrap32(tmp0 + tmp3), _wrap32(tmp0 - tmp3)
    t11, t12 = _wrap32(tmp1 + tmp2), _wrap32(tmp1 - tmp2)
    z3, z4 = _wrap16(v[7] + v[3]), _wrap16(v[5] + v[1])
    z3s = _madd(z3, 9633 - 16069, z4, 9633)
    z4s = _madd(z3, 9633, z4, 9633 - 3196)
    o0 = _wrap32(_madd(v[7], 2446 - 7373, v[1], -7373) + z3s)
    o3 = _wrap32(_madd(v[7], -7373, v[1], 12299 - 7373) + z4s)
    o1 = _wrap32(_madd(v[5], 16819 - 20995, v[3], -20995) + z4s)
    o2 = _wrap32(_madd(v[5], -20995, v[3], 25172 - 20995) + z3s)
    return [_wrap32(t10 + o3), _wrap32(t11 + o2), _wrap32(t12 + o1),
            _wrap32(t13 + o0), _wrap32(t13 - o0), _wrap32(t12 - o1),
            _wrap32(t11 - o2), _wrap32(t10 - o3)]


def _idct_descale(x: Tensor, n: int) -> Tensor:
    """paddd of the rounding, psrad by n, packssdw."""
    return (_wrap32(x + (1 << (n - 1))) >> n).clamp(-32768, 32767)


def idct_islow_plain(coef: Tensor, qt: Tensor, plane_h: int,
                     plane_w: int) -> Tensor:
    """The plain version of ``idct_islow_kernel``: the (plane_h, plane_w)
    uint8 samples of a component from its quantized coefficients
    ``coef`` (blocks_h, blocks_w, 64) int16 and quantization table ``qt``
    (64,) (int16 holding uint16 bits), both in natural order: libjpeg-
    turbo's SIMD islow IDCT as cv2 runs it (jidctint's sums in 16- and
    32-bit lanes, the DC shortcut of a block whose rows 1 to 7 are zero,
    the samples saturated; csrc/jpeg_idct.h)."""
    IDCT_COUNTS.plain += 1
    bh, bw = coef.shape[:2]
    c64 = coef.to(torch.int64)
    x = _wrap16(c64 * (qt.to(torch.int64) & 0xFFFF))
    x = x.reshape(bh, bw, 8, 8)  # [..., row k, column c]
    ac = (c64[..., 8:] != 0).any(-1)[..., None, None]
    ws = torch.stack([_idct_descale(o, 13 - 2) for o in _idct_1d(
        [x[..., k, :] for k in range(8)])], -2)  # (bh, bw, 8 rows, 8 cols)
    ws = torch.where(ac, ws, _wrap16(x[..., :1, :] * 4).expand_as(ws))
    out = torch.stack([_idct_descale(o, 13 + 2 + 3) for o in _idct_1d(
        [ws[..., c] for c in range(8)])], -1)
    out = out.clamp(-128, 127) + 128  # packsswb, then + CENTERJSAMPLE
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


# ----------------------------- block smoothing -----------------------------

class Smoothing(NamedTuple):
    """What libjpeg-turbo's smoothing_ok latches of a progressive JPEG's
    component (``jpeg_host_smoothing``; ``csrc/jpeg_smooth.h`` Params): its
    coefficient array's blocks across and down, the blocks that cover its
    samples across and down, its v factor, the frame's iMCU rows and the
    one in which the input ran out of data, the progression status
    (libjpeg's coef_bits: -1 unknown, else the scan's Al) of its first ten
    coefficients in zigzag order after the last scan (``bits``) and before
    it (``prev``, for the iMCU rows past ``last_good``), and their
    quantization entries."""
    blocks_w: int
    blocks_h: int
    width_in_blocks: int
    height_in_blocks: int
    v: int
    total_imcu_rows: int
    last_good: int
    bits: Tuple[int, ...]
    prev: Tuple[int, ...]
    q: Tuple[int, ...]

    @classmethod
    def of(cls, ints) -> "Smoothing":
        v = [int(x) for x in ints]
        return cls(*v[:7], tuple(v[7:17]), tuple(v[17:27]), tuple(v[27:37]))

    def ints(self):
        return (ctypes.c_int * SMOOTH_INTS)(*self[:7], *self.bits,
                                            *self.prev, *self.q)


SMOOTH_INTS = 37  # jpeg_entropy::kSmoothInts
JPEG_SMOOTH_LEN = 1 + 4 * SMOOTH_INTS  # jpeg_entropy::kSmoothLen


def smoothing(handle, lib=None) -> tuple:
    """A :func:`host_decode`'s smoothing latch: a :class:`Smoothing` per
    component where libjpeg-turbo smooths the file's blocks (a progressive
    JPEG whose first coefficients are not all exact: cut short, or its scans
    stop before the last bit), else ()."""
    out = (ctypes.c_int * JPEG_SMOOTH_LEN)()
    (lib or _library()).jpeg_host_smoothing(handle, out)
    if not out[0]:
        return ()
    n = sum(1 for c in range(4) if out[1 + SMOOTH_INTS * c + 4])
    return tuple(Smoothing.of(out[1 + SMOOTH_INTS * c:1 + SMOOTH_INTS * (c + 1)])
                 for c in range(n))


# The DC weights of jdcoefct.c decompress_smooth_data, as 5 x 5 arrays over
# the neighbourhood (rows two above to two below, columns two left to two
# right), by zigzag coefficient: _SMOOTH_CHANGE_DC where no AC coefficient of
# the nine is known (libjpeg's change_dc: nine estimates and, at 0, the DC's
# own), _SMOOTH_KEEP_DC otherwise (the first five).
def _weights(terms):
    w = np.zeros((5, 5), np.int64)
    for n, c in terms.items():
        w[(n - 1) // 5, (n - 1) % 5] = c
    return w


_SMOOTH_CHANGE_DC = {
    1: _weights({1: -1, 2: -1, 4: 1, 5: 1, 6: -3, 7: 13, 9: -13, 10: 3,
                 11: -3, 12: 38, 14: -38, 15: 3, 16: -3, 17: 13, 19: -13,
                 20: 3, 21: -1, 22: -1, 24: 1, 25: 1}),
    2: _weights({1: -1, 2: -3, 3: -3, 4: -3, 5: -1, 6: -1, 7: 13, 8: 38,
                 9: 13, 10: -1, 16: 1, 17: -13, 18: -38, 19: -13, 20: 1,
                 21: 1, 22: 3, 23: 3, 24: 3, 25: 1}),
    3: _weights({3: 1, 7: 2, 8: 7, 9: 2, 12: -5, 13: -14, 14: -5, 17: 2,
                 18: 7, 19: 2, 23: 1}),
    4: _weights({1: -1, 5: 1, 7: 9, 9: -9, 17: -9, 19: 9, 21: 1, 25: -1}),
    5: _weights({7: 2, 8: -5, 9: 2, 11: 1, 12: 7, 13: -14, 14: 7, 15: 1,
                 17: 2, 18: -5, 19: 2}),
    6: _weights({7: 1, 9: -1, 12: 2, 14: -2, 17: 1, 19: -1}),
    7: _weights({7: 1, 8: -3, 9: 1, 17: -1, 18: 3, 19: -1}),
    8: _weights({7: 1, 9: -1, 12: -3, 14: 3, 17: 1, 19: -1}),
    9: _weights({7: 1, 8: 2, 9: 1, 17: -1, 18: -2, 19: -1}),
    0: _weights({1: -2, 2: -6, 3: -8, 4: -6, 5: -2, 6: -6, 7: 6, 8: 42,
                 9: 6, 10: -6, 11: -8, 12: 42, 13: 152, 14: 42, 15: -8,
                 16: -6, 17: 6, 18: 42, 19: 6, 20: -6, 21: -2, 22: -6,
                 23: -8, 24: -6, 25: -2})}
_SMOOTH_KEEP_DC = {
    1: _weights({11: -7, 12: 50, 14: -50, 15: 7}),
    2: _weights({3: -7, 8: 50, 18: -50, 23: 7}),
    3: _weights({3: -1, 8: 13, 13: -24, 18: 13, 23: -1}),
    4: _weights({10: 1, 16: 1, 17: -10, 19: 10, 2: -1, 20: -1, 22: 1,
                 24: -1, 4: 1, 6: -1, 7: 10, 9: -10}),
    5: _weights({11: -1, 12: 13, 13: -24, 14: 13, 15: -1})}
_SMOOTH_POS = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)  # jpeg_smooth.h's pos


def _smooth_rows(p: Smoothing) -> np.ndarray:
    """(height_in_blocks, 5) block rows each block row's window reads
    (jpeg_smooth::window_rows)."""
    rows = np.zeros((p.height_in_blocks, 5), np.int64)
    last = p.total_imcu_rows - 1
    for by in range(p.height_in_blocks):
        imcu, br = divmod(by, p.v)
        block_rows = p.v
        if imcu == last:
            block_rows = p.height_in_blocks % p.v or p.v
        n, r = block_rows * p.total_imcu_rows, imcu * block_rows + br
        up = by - 1 if r > 0 else by
        down = by + 1 if r < n - 1 else by
        rows[by] = (by - 2 if r > 1 else up, up, by, down,
                    by + 2 if r < n - 2 else down)
    return rows


def _estimate(num: Tensor, q: int, al: Tensor) -> Tensor:
    """jpeg_smooth::estimate, element-wise: num (int64) with al per row."""
    mag = (q * 128 + num.abs()) // (q * 256)
    cap = (torch.ones_like(al) << al.clamp(min=0)) - 1
    mag = torch.where(al > 0, torch.minimum(mag, cap), mag)
    return torch.where(num >= 0, mag, -mag)


def jpeg_smooth_plain(coef: Tensor, p: Smoothing) -> Tensor:
    """The plain version of ``jpeg_smooth_kernel``: a component's quantized
    coefficients (blocks_h, blocks_w, 64) int16 with libjpeg-turbo's
    inter-block smoothing (``csrc/jpeg_smooth.h``) applied to the blocks of
    its samples, a new array."""
    SMOOTH_COUNTS.plain += 1
    dev = coef.device
    H, W = p.height_in_blocks, p.width_in_blocks
    rows = torch.as_tensor(_smooth_rows(p), device=dev)
    cols = (torch.arange(W, device=dev)[:, None] +
            torch.arange(-2, 3, device=dev)).clamp(0, W - 1)
    dc = coef[..., 0].to(torch.int64)
    win = dc[rows[:, None, :, None], cols[None, :, None, :]]  # (H, W, 5, 5)
    past = torch.arange(H, device=dev) // p.v > p.last_good
    bits = torch.where(past[:, None], torch.tensor(p.prev, device=dev),
                       torch.tensor(p.bits, device=dev))  # (H, 10)
    change_dc = (bits[:, 1:] == -1).all(1)[:, None]          # (H, 1)
    out = coef.clone()
    blk = out[:H, :W].to(torch.int64)
    q00 = p.q[0]
    for k in range(1, 10):
        sums = (win * torch.as_tensor(_SMOOTH_CHANGE_DC[k], device=dev)
                ).sum((2, 3))
        if k in _SMOOTH_KEEP_DC:
            plain = (win * torch.as_tensor(_SMOOTH_KEEP_DC[k], device=dev)
                     ).sum((2, 3))
            sums = torch.where(change_dc, sums, plain)
            use = torch.ones_like(change_dc)
        else:
            use = change_dc
        al = bits[:, k][:, None]
        at = _SMOOTH_POS[k]
        est = _estimate(q00 * sums, p.q[k], al.expand(H, W))
        blk[..., at] = torch.where(use & (al != 0) & (blk[..., at] == 0),
                                   est, blk[..., at])
    sums = (win * torch.as_tensor(_SMOOTH_CHANGE_DC[0], device=dev)
            ).sum((2, 3))
    est = _estimate(q00 * sums, q00, torch.zeros_like(sums))
    blk[..., 0] = torch.where(change_dc, est, blk[..., 0])
    out[:H, :W] = blk.to(torch.int32).to(torch.int16)
    return out


def jpeg_smooth_kernel(coef: Tensor, p: Smoothing) -> Tensor:
    """Launch ``jpeg_smooth_kernel`` on a component's CUDA coefficients:
    as :func:`jpeg_smooth_plain`."""
    if coef.device.type != "cuda" or coef.dtype != torch.int16 or \
            coef.ndim != 3 or coef.shape[2] != 64 or \
            tuple(coef.shape[:2]) != (p.blocks_h, p.blocks_w):
        raise ValueError(f"the smoothing kernel takes int16 CUDA "
                         f"coefficients ({p.blocks_h}, {p.blocks_w}, 64), "
                         f"got {coef.dtype} {tuple(coef.shape)} on "
                         f"{coef.device}")
    coef = coef.contiguous()
    out = torch.empty_like(coef)
    err = _library().jpeg_smooth_launch(coef.data_ptr(), p.ints(),
                                        out.data_ptr(), _stream(coef))
    _check(err, "jpeg_smooth_kernel launch")
    SMOOTH_COUNTS.launched()
    return out


class Layout(NamedTuple):
    """What a JPEG's markers say of the image cv2.imread makes of its
    planes: the EXIF orientation (1..8), the colour space libjpeg takes its
    components for (``SPACE_*``), each component's ratios (hmax / h,
    vmax / v), by which it is upsampled, and, where libjpeg-turbo smooths
    the file's blocks, each component's :class:`Smoothing`."""
    orientation: int
    space: int
    factors: Tuple[Tuple[int, int], ...]
    smooth: Tuple[Smoothing, ...] = ()

    @property
    def rgb(self) -> bool:
        return self.space == SPACE_RGB


JPEG_INFO_LEN = 50  # jpeg_host_decode's info
INFO_LOSSLESS, INFO_PRECISION, INFO_ARITHMETIC = 39, 40, 41


def host_decode(data: bytes):
    """Parse and entropy-decode a JPEG on the host (``jpeg_host_decode``):
    the decoder's handle, which holds the coefficients (a lossless JPEG's
    sample differences) until :func:`upload_coefficients`
    (:func:`lossless_image`) frees it, and its ``info``
    (``JPEG_INFO_LEN`` ints, csrc/jpeg_codec.cu says which)."""
    if image_format(data) != "JPEG":
        raise ValueError(f"not a JPEG ({image_format(data)})")
    handle = ctypes.c_void_p()
    info = (ctypes.c_int * JPEG_INFO_LEN)()
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
    if info[INFO_LOSSLESS]:
        lib.jpeg_host_free(handle)
        raise ValueError("a lossless JPEG holds sample differences, not "
                         "coefficients: lossless_image reads them")
    try:
        comps, factors = [], []
        smooth = smoothing(handle, lib)
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
                                             tuple(factors), smooth)


def decode_coefficients(data: bytes, device, decoded=None):
    """Entropy-decode a JPEG on the host (or take ``decoded``, a
    :func:`host_decode`'s handle and info) and copy its coefficients to a
    CUDA ``device``: :func:`upload_coefficients` of :func:`host_decode`.
    An arithmetic-coded file counts in ``CODEC_COUNTS`` as
    ``"jpeg_arith"`` too."""
    handle, info = decoded or host_decode(data)
    arithmetic = info[INFO_ARITHMETIC]
    out = upload_coefficients(handle, info, device)
    CODEC_COUNTS.launched("decode")
    if arithmetic:
        CODEC_COUNTS.launched("jpeg_arith")
    return out


def _planes(comps, smooth=()):
    """The IDCT kernel's plane of each component's decoded coefficients, at
    its sampled size; with ``smooth`` (a :class:`Layout`'s), each
    component's coefficients smoothed by ``jpeg_smooth_kernel`` first."""
    if smooth:
        comps = [(jpeg_smooth_kernel(c[0], p),) + tuple(c[1:])
                 for c, p in zip(comps, smooth)]
    return [idct_islow_kernel(*c) for c in comps]


def decode_planes(data: bytes, device, decoded=None):
    """A JPEG's component planes on a CUDA ``device`` (uint8, each at its
    sampled size, from the IDCT kernel), the image's (height, width) and its
    :class:`Layout`: what :func:`colour_kernel` takes."""
    comps, size, layout = decode_coefficients(data, device, decoded)
    return _planes(comps, layout.smooth), size, layout


def plane_ints(planes, factors, geo=None, fancy: bool = True):
    """n x 6 ints of jpeg_colour::Plane (w, rh, rv, fancy, pitch, stride);
    ``geo``: each plane's (h, w, stride) a chunk (:func:`_chunk_planes`),
    else the plane is the image's; without ``fancy`` no plane is fancy
    upsampled (a lossless JPEG's)."""
    geo = geo or [(p.shape[0], p.shape[1], p.shape[0]) for p in planes]
    return (ctypes.c_int * 24)(*[
        v for p, (rh, rv), (_, w, stride) in zip(planes, factors, geo)
        for v in (w, rh, rv, int(fancy and _fancy(w, rh, rv)), p.shape[1],
                  stride)])


def _plane_args(planes, factors, geo=None, fancy: bool = True):
    """The launches' plane pointers and :func:`plane_ints`."""
    ptrs = (ctypes.c_void_p * 4)(*[p.data_ptr() for p in planes])
    return ptrs, plane_ints(planes, factors, geo, fancy)


# ycc_to_bgr_kernel's form bits (jpeg_colour::YccForm)
FORM_RGB, FORM_OPENCV_GREY = 1, 2


@functools.lru_cache(maxsize=64)
def _rows_on(rows: tuple, device: torch.device) -> Tensor:
    """A chunk layout's stream rows (``Chunks.rows``) on the card, copied
    once a layout on the stream current then: a read of a layout seen
    before, or the launch captured in a CUDA graph, copies nothing."""
    return torch.tensor(rows, dtype=torch.int32, device=device)


def colour_kernel(planes, factors, size, space: int,
                  chunks: Chunks = None,
                  fancy: bool = True) -> Tuple[Tensor, Tensor]:
    """Launch the colour kernel of ``space`` on a JPEG's CUDA planes:
    (grey, BGR), as :func:`colour_plain`. One or three components launch
    ``ycc_to_bgr_kernel`` (form ``"rgb"`` for RGB components), four
    ``cmyk_to_bgr_kernel`` (:func:`cmyk_to_bgr_kernel`). The grey of a
    YCbCr or grey JPEG whose first plane is at full size is that plane.
    With ``chunks`` (a JPEG-compressed TIFF) the kernel's chunked form
    (``"chunks"``, ``"chunks_rgb"``) writes both images in one launch.
    Without ``fancy`` (a lossless JPEG's planes) every component is
    upsampled by replication."""
    if space in (SPACE_CMYK, SPACE_YCCK):
        return cmyk_to_bgr_kernel(planes, factors, space == SPACE_YCCK, size,
                                  fancy)
    if any(p.device.type != "cuda" for p in planes):
        raise ValueError("the colour kernel takes CUDA planes")
    geo = None
    if chunks is None:
        _check_planes(planes, factors, size)
    else:
        geo = _chunk_planes(planes, factors, size, chunks)
    planes = [p.contiguous() for p in planes]
    H, W = size
    dev = planes[0].device
    bgr = torch.empty((H, W, 3), dtype=torch.uint8, device=dev)
    rgb = space == SPACE_RGB and len(planes) == 3
    gray = None if factors[0] == (1, 1) and not rgb and chunks is None \
        else torch.empty((H, W), dtype=torch.uint8, device=dev)
    ptrs, ints = _plane_args(planes, factors, geo, fancy)
    form = (FORM_RGB if rgb else 0) | (0 if chunks is None
                                       else FORM_OPENCV_GREY)
    rows = None if chunks is None else _rows_on(chunks.rows, dev)
    err = _library().ycc_to_bgr_launch(
        ptrs, ints, len(planes), form,
        None if chunks is None else (ctypes.c_int * 7)(*chunks[:7]),
        None if rows is None else rows.data_ptr(), H, W,
        bgr.data_ptr(), None if gray is None else gray.data_ptr(),
        _stream(planes[0]))
    _check(err, "ycc_to_bgr_kernel launch")
    COUNTS.launched(("chunks_rgb" if rgb else "chunks") if chunks
                    else "rgb" if rgb else None)
    return (planes[0] if gray is None else gray), bgr


def cmyk_to_bgr_kernel(planes, factors, ycck: bool, size=None,
                       fancy: bool = True) -> Tuple[Tensor, Tensor]:
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
    ptrs, geo = _plane_args(planes, factors, None, fancy)
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


def _decode_jpeg(data: bytes, dev, grey: bool = True
                 ) -> Tuple[Tensor, Tensor]:
    """A JPEG's (grey, BGR) on the card; ``grey`` False where the caller
    takes the BGR only (cv2's IMREAD_COLOR), which decides what a lossless
    JPEG's refusal is. What stays refused raises before any copy."""
    decoded = host_decode(data)
    if decoded[1][INFO_LOSSLESS]:
        try:
            lossless_check_modes(decoded[1][0], grey)
        except ValueError:
            _library().jpeg_host_free(decoded[0])
            raise
        img = lossless_image(*decoded)
        gray, bgr = colour_kernel(ljpeg_planes(img, dev), img.factors,
                                  img.size, img.space, fancy=False)
        CODEC_COUNTS.launched("jpeg_lossless")
        orientation = img.orientation
    else:
        planes, size, layout = decode_planes(data, dev, decoded)
        gray, bgr = colour_kernel(planes, layout.factors, size, layout.space)
        orientation = layout.orientation
    return orient(gray, orientation), orient(bgr, orientation)


# ----------------------------- lossless JPEG -----------------------------

class LosslessImage(NamedTuple):
    """A lossless JPEG entropy-decoded on the host (``csrc/jpeg_lossless.h``):
    per component its sample differences (plane height, width) int16, its
    first-row marks (height,) uint8 (the scan's first row and the first
    after each restart), its predictor (1-7) and point transform; the
    precision, the image's (height, width), each component's ratios (hmax /
    h, vmax / v), libjpeg's colour space (``SPACE_*``, lossless-mode
    guess) and the EXIF orientation."""
    diffs: list
    firsts: list
    predictors: list
    pts: list
    precision: int
    size: Tuple[int, int]
    factors: tuple
    space: int
    orientation: int


def lossless_image(handle, info, lib=None) -> LosslessImage:
    """Copy a lossless :func:`host_decode`'s differences out of its handle
    (``lib``'s ``jpeg_host_lossless``: the card's library, or a host build)
    and free it."""
    lib = lib or _library()
    try:
        n = info[0]
        diffs, firsts, factors = [], [], []
        for c in range(n):
            pw, ph, _, _, _, _, h, v = info[7 + 8 * c:15 + 8 * c]
            diff = np.empty((ph, pw), np.int16)
            first = np.empty(ph, np.uint8)
            _check(lib.jpeg_host_lossless(handle, c, diff.ctypes.data,
                                          first.ctypes.data), "JPEG decode")
            diffs.append(diff)
            firsts.append(first)
            factors.append((info[5] // h, info[6] // v))
    finally:
        lib.jpeg_host_free(handle)
    return LosslessImage(diffs, firsts, [info[42 + 2 * c] for c in range(n)],
                         [info[43 + 2 * c] for c in range(n)],
                         info[INFO_PRECISION], (info[2], info[1]),
                         tuple(factors), info[4], info[3])


def lossless_check_modes(n: int, grey: bool = True) -> None:
    """Raise, naming the mode, where cv2 refuses a lossless JPEG of ``n``
    components in a mode the caller reads (its BGR, and with ``grey`` its
    grey too): one component reads in grey only, RGB in colour only, CMYK
    in both (libjpeg-turbo converts no colour in lossless mode; the host
    decode has refused YCbCr and YCCK)."""
    if n == 1:
        _check(2015, "JPEG decode")
    if n == 3 and grey:
        _check(2016, "JPEG decode")


def ljpeg_bands(firsts) -> np.ndarray:
    """The scan kernel's bands of each plane: its first rows, then its
    height, padded with it to the most bands of any plane; (planes, most
    bands + 1) int32."""
    if not all(len(f) and f[0] for f in firsts):
        raise ValueError("a plane's row 0 predicts as a first row")
    starts = [np.append(np.flatnonzero(f), len(f)) for f in firsts]
    most = max(len(b) for b in starts)
    return np.stack([np.pad(b, (0, most - len(b)), constant_values=b[-1])
                     for b in starts]).astype(np.int32)


def ljpeg_undiff_plain(diff: Tensor, first: Tensor, predictor: int,
                       precision: int, pt: int) -> Tensor:
    """The plain version of the lossless kernels: the (h, w) uint8 samples
    of a component from its int16 differences, its first-row marks (h,),
    its predictor (1-7), the precision and its point transform, by
    jdlossls.c's rule for each sample (csrc/jpeg_lossless_pred.h says
    which). A sample needs its left, upper and upper-left neighbours, so
    the plane is rebuilt one anti-diagonal r + c = t at a time, in order,
    each diagonal's samples at once."""
    LJPEG_COUNTS.plain += 1
    H, W = diff.shape
    dev = diff.device
    d = diff.to(torch.int64)
    fr = first.to(torch.bool)
    x = torch.zeros((H, W), dtype=torch.int64, device=dev)
    init = 1 << (precision - pt - 1)
    for t in range(H + W - 1):
        rs = torch.arange(max(0, t - W + 1), min(H - 1, t) + 1, device=dev)
        cs = t - rs
        up, left = (rs - 1).clamp(min=0), (cs - 1).clamp(min=0)
        ra, rb, rc = x[rs, left], x[up, cs], x[up, left]
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                7: (ra + rb) >> 1}[predictor]
        pred = torch.where(cs == 0, rb, pred)
        pred = torch.where(fr[rs], torch.where(cs == 0, init, ra), pred)
        x[rs, cs] = (d[rs, cs] + pred) & 0xFFFF
    return ((x << pt) & 0xFF).to(torch.uint8)


def ljpeg_undiff_kernel(diffs, firsts, bands: Optional[Tensor],
                        predictor: int, precision: int, pts) -> list:
    """Launch the lossless kernels on components of one predictor: their
    (h, w) uint8 samples from their CUDA int16 differences and uint8
    first-row marks, each as :func:`ljpeg_undiff_plain`. Predictors 1-4:
    ``ljpeg_scan_kernel``'s two launches (form ``"scan"``, counted once a
    launch), which take ``bands`` (:func:`ljpeg_bands` on the card);
    5-7: one launch of ``ljpeg_wavefront_kernel`` (form ``"wavefront"``)."""
    n = len(diffs)
    if not 1 <= n <= 4 or len(firsts) != n or len(pts) != n:
        raise ValueError(f"{n} planes with {len(firsts)} marks, {len(pts)} "
                         f"point transforms")
    if not 1 <= predictor <= 7:
        raise ValueError(f"predictor {predictor} is not 1-7")
    for d, f in zip(diffs, firsts):
        if d.device.type != "cuda" or d.dtype != torch.int16 or d.ndim != 2 \
                or not d.is_contiguous() or f.device != d.device or \
                f.dtype != torch.uint8 or tuple(f.shape) != d.shape[:1]:
            raise ValueError(f"the lossless kernels take contiguous int16 "
                             f"CUDA differences (h, w) and uint8 marks (h,), "
                             f"got {d.dtype} {tuple(d.shape)} on {d.device}, "
                             f"{f.dtype} {tuple(f.shape)}")
    outs = [torch.empty(d.shape, dtype=torch.uint8, device=d.device)
            for d in diffs]
    vp = ctypes.c_void_p
    geo = (ctypes.c_int * (4 * n))(*[
        v for d, pt in zip(diffs, pts)
        for v in (d.shape[1], d.shape[0], pt, 1 << (precision - pt - 1))])
    ptrs = lambda ts: (vp * n)(*[t.data_ptr() for t in ts])
    lib, stream = _library(), _stream(diffs[0])
    if predictor <= 4:
        if bands is None or bands.dtype != torch.int32 or \
                bands.ndim != 2 or bands.shape[0] != n or \
                bands.shape[1] < 2 or not bands.is_contiguous() or \
                bands.device != diffs[0].device:
            raise ValueError("the scan form takes each plane's bands, int32 "
                             "on the card (ljpeg_bands)")
        scratch = [torch.empty_like(d) for d in diffs]
        for pass_ in (0, 1):
            _check(lib.ljpeg_scan_launch(
                ptrs(diffs), ptrs(scratch), ptrs(outs), ptrs(firsts), geo, n,
                predictor, pass_, bands.data_ptr(), bands.shape[1] - 1,
                stream), "ljpeg_scan_kernel launch")
            LJPEG_COUNTS.launched("scan")
    else:
        sync = torch.zeros(1 + sum(d.shape[1] for d in diffs),
                           dtype=torch.int64, device=diffs[0].device)
        _check(lib.ljpeg_wavefront_launch(
            ptrs(diffs), ptrs(outs), ptrs(firsts), geo, n, predictor,
            sync.data_ptr(), stream), "ljpeg_wavefront_kernel launch")
        LJPEG_COUNTS.launched("wavefront")
    return outs


def ljpeg_upload(img: LosslessImage, dev):
    """A lossless image's differences, first-row marks and bands
    (:func:`ljpeg_bands`) copied to the card."""
    diffs = [torch.from_numpy(d).to(dev) for d in img.diffs]
    firsts = [torch.from_numpy(f).to(dev) for f in img.firsts]
    return diffs, firsts, torch.from_numpy(ljpeg_bands(img.firsts)).to(dev)


def ljpeg_planes(img: LosslessImage, device) -> list:
    """A lossless image's component planes on a CUDA ``device`` (uint8,
    each at its sampled size): its differences copied there and
    undifferenced by the kernels, a launch (or the scan form's two) for
    each predictor its scans use."""
    diffs, firsts, bands = ljpeg_upload(img, _cuda_device(device))
    planes = [None] * len(diffs)
    for p in sorted(set(img.predictors)):
        at = [c for c, q in enumerate(img.predictors) if q == p]
        outs = ljpeg_undiff_kernel([diffs[c] for c in at],
                                   [firsts[c] for c in at],
                                   bands if len(at) == len(diffs)
                                   else bands[at], p,
                                   img.precision, [img.pts[c] for c in at])
        for c, o in zip(at, outs):
            planes[c] = o
    return planes


class TiffJpeg(NamedTuple):
    """A JPEG-compressed TIFF's strips or tiles entropy-decoded on the host
    (``csrc/tiff_jpeg.h``): per component its coefficients, every chunk's
    after the one before, each padded to the same blocks down, and its
    quantization table; and how the card makes cv2's images of them."""
    coefs: tuple          # (count * blocks down, blocks across, 64) int16
    qt: np.ndarray        # (components, 64) uint16
    factors: tuple        # (hmax / h, vmax / v) of each component
    chunks: Chunks
    size: Tuple[int, int]
    space: int            # SPACE_YCC (YCbCr, or grey) or SPACE_RGB
    orientation: int


TIFF_INFO_LEN = 22        # tiff_decode::kInfoLen
TIFF_JPEG_INFO_LEN = 16   # tiff_jpeg::kInfoLen


def _tiff_info(data: bytes, lib) -> list:
    if image_format(data) != "TIFF":
        raise ValueError(f"not a TIFF ({image_format(data)})")
    info = (ctypes.c_longlong * TIFF_INFO_LEN)()
    _check(lib.tiff_host_info(data, len(data), info), "TIFF read")
    return list(info)


def tiff_compression(data: bytes, lib) -> int:
    """The Compression tag of a TIFF's first IFD, read by ``lib``'s
    ``tiff_host_info`` (which refuses, naming why, what the card does not
    read); 7 is JPEG (:func:`tiff_jpeg_coefficients`)."""
    return _tiff_info(data, lib)[6]


def tiff_jpeg_coefficients(data: bytes, lib, tiff_info=None) -> TiffJpeg:
    """Entropy-decode every strip or tile of a JPEG-compressed TIFF on the
    host with ``lib``'s ``tiff_jpeg_host_*`` functions (the card's library,
    or a host build of ``csrc/tiff_jpeg.h``), each with the JPEGTables'
    tables, each frame checked against the tags as libtiff checks it.
    ``tiff_info``: the file's ``tiff_host_info`` fields where the caller
    has read them. Raises ValueError, naming the cause, for what the card
    does not read."""
    (W, H, _, _, pm, _, comp, _, orientation, tiled, cw, ch, n_chunks, *_
     ) = tiff_info or _tiff_info(data, lib)
    if comp != 7:
        raise ValueError(f"not a JPEG-compressed TIFF (Compression {comp})")
    info = (ctypes.c_longlong * TIFF_JPEG_INFO_LEN)()
    rows = (ctypes.c_int * n_chunks)()
    _check(lib.tiff_jpeg_host_info(data, len(data), info, rows),
           "TIFF read")
    count, n, hmax, vmax = list(info[:4])
    comps = [list(info[4 + 4 * k:8 + 4 * k]) for k in range(n)]
    coefs = [np.empty((count * bh, bw, 64), np.int16)
             for _, _, bw, bh in comps]
    qt = np.empty((n, 64), np.uint16)
    ptrs = (ctypes.c_void_p * 3)(*[c.ctypes.data for c in coefs])
    _check(lib.tiff_jpeg_host_decode(data, len(data), info, ptrs,
                                     qt.ctypes.data), "TIFF read")
    chunks = Chunks(int(tiled), cw, ch, -(-W // cw) if tiled else 1, count,
                    int(bool(tiled) and orientation in (2, 3, 6, 7)), W,
                    tuple(rows))
    return TiffJpeg(tuple(coefs), qt,
                    tuple((hmax // h, vmax // v) for h, v, _, _ in comps),
                    chunks, (H, W), SPACE_RGB if pm == 2 else SPACE_YCC,
                    orientation)


def tiff_jpeg_planes(tj: TiffJpeg, dev) -> list:
    """The card's planes of a :class:`TiffJpeg`: its coefficients copied to
    a CUDA ``dev`` and one IDCT launch a component over every chunk's
    blocks at once: (count * 8 blocks down, 8 blocks across) uint8 each,
    chunk k's samples from row 8 k blocks down."""
    planes = []
    for coef, qt in zip(tj.coefs, tj.qt):
        c = torch.from_numpy(coef).to(dev)
        q = torch.from_numpy(qt.view(np.int16)).to(dev)
        planes.append(idct_islow_kernel(c, q, 8 * coef.shape[0],
                                        8 * coef.shape[1]))
    return planes


def _decode_tiff_jpeg(data: bytes, tiff_info, dev) -> Tuple[Tensor, Tensor]:
    tj = tiff_jpeg_coefficients(data, _library(), tiff_info)
    gray, bgr = colour_kernel(tiff_jpeg_planes(tj, dev), tj.factors,
                              tj.size, tj.space, tj.chunks)
    CODEC_COUNTS.launched("tiff_jpeg")
    return orient(gray, tj.orientation), orient(bgr, tj.orientation)


class RasterForm(NamedTuple):
    """What a PNG's, a TIFF's, a BMP's or a PNM's samples are and which of
    OpenCV's conversions applies to them: the fields of ``raster_bgr::Form``
    (csrc/raster_bgr.h; :func:`form_ints` gives them in its order)."""
    kind: int          # RASTER_GREY, RASTER_RGB, RASTER_PALETTE,
                       # RASTER_CMYK, RASTER_YCBCR, RASTER_BMP16 or
                       # RASTER_CIELAB
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
    rowbytes: int      # bytes a row of a plane (of YCbCr data units)
    plane_bytes: int   # bytes a plane
    bgr: int = 0       # RGB samples in B, G, R order (a BMP's)
    green6: int = 0    # RASTER_BMP16: 5-6-5 (else 5-5-5)
    sub_h: int = 1     # RASTER_YCBCR: YCbCrSubSampling
    sub_v: int = 1


def form_ints(form: RasterForm):
    """The kernel's ints of a form (``raster_bgr::form_of``: its 15 ints;
    rowbytes and plane_bytes go as long longs)."""
    return (ctypes.c_int * 15)(*form[:11], *form[13:])


RASTER_GREY, RASTER_RGB, RASTER_PALETTE, RASTER_CMYK = 0, 1, 2, 3
RASTER_YCBCR, RASTER_BMP16, RASTER_CIELAB = 4, 5, 6
GREY_LIBPNG, GREY_LIBPNG_GAMMA, GREY_OPENCV = 0, 1, 2
NARROW_SHIFT, NARROW_ROUND257 = 0, 1
# raster_bgr.h: the palette (256 x RGB), libpng's 8-bit gamma tables, then
# its 16-bit ones (2048 big-endian entries each)
TO_ONE_AT, FROM_ONE_AT = 768, 1024
TO_ONE16_AT, FROM_ONE16_AT, GREY16_AT = 1280, 1280 + 4096, 1280 + 8192
TABLES_LEN = 1280 + 12288
# a YCbCr TIFF's tables take their place: ycbcr_tables' five, 256
# little-endian int32 entries each; a CIELab TIFF's: cielab_tables' Yr2r
# (LAB_RANGE + 1 float32 entries), then X0, Y0, Z0 and the table's step
LAB_RANGE = 1500
LAB_WHITE_AT = 4 * (LAB_RANGE + 1)
# libpng's png_set_rgb_to_gray coefficients for OpenCV's 0.299, 0.587
LIBPNG_RC, LIBPNG_GC = 9797, 19234
LIBPNG_BC = 32768 - LIBPNG_RC - LIBPNG_GC


class Raster(NamedTuple):
    """A PNG's, a TIFF's, a BMP's or a PNM's samples as the host leaves them
    (unfiltered, decompressed, de-interlaced, run-length expanded, parsed)
    and what the card makes of them."""
    samples: np.ndarray      # (planes * rows, rowbytes) uint8
    form: RasterForm
    tables: np.ndarray       # (TABLES_LEN,) uint8: palette, gamma tables
    orientation: int         # applied after the conversion (orient)


def ycbcr_tables(luma=(0.299, 0.587, 0.114),
                 ref=(0., 255., 128., 255., 128., 255.)) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c) of YCbCrCoefficients
    ``luma`` and ReferenceBlackWhite ``ref`` (float32, as libtiff reads the
    tags): its int32 Y_tab, Cr_r_tab, Cb_b_tab, Cr_g_tab and Cb_g_tab, in
    float32 arithmetic with FIX at 16 bits and the CLAMPw clamps, (5, 256)
    int64 in that order (csrc/raster_bgr.h reads them so)."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    ref = [f32(v) for v in ref]

    def fix(x):  # FIX(CLAMP(x, 0, 2)); the product is float, + 0.5 double
        x = f32(0) if not x >= 0 else f32(2) if x > 2 else x
        return int(float(f32(x * f32(65536))) + .5)

    def code2v(c, rb, rw, cr):
        d = f32(rw - rb)
        return f32(f32(c - int(rb)) * f32(cr)) / (d if d != 0 else f32(1))

    def clampw(v):  # CLAMPw(v, -128 * 32, 128 * 32), then (int32_t)
        return int(-4096 if v < -4096 else 4096 if v > 4096 else v)

    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d2 = fix(f1), -fix(f32(lr * f1) / lg)
    d3, d4 = fix(f3), -fix(f32(lb * f3) / lg)
    out = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127))
        cb = clampw(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127))
        out[:, i] = (clampw(code2v(x + 128, ref[0], ref[1], 255)),
                     (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16,
                     d2 * cr, d4 * cb + 32768)
    return out


def cielab_tables(white=None) -> np.ndarray:
    """libtiff's CIELab state as its RGBA reader builds it
    (initCIELabConversion, TIFFCIELabToRGBInit under display_sRGB) from a
    WhitePoint tag's chromaticities ``white`` (float32 x, y; None: D50, the
    tag's TIFFGetFieldDefaulted): the Yr2r table ((float) pow(i / 1500,
    1 / 2.4) times 255, in float), then the reference white X0, Y0, Z0 and
    the table's step, float32 (LAB_RANGE + 5,) as raster_bgr.h reads
    them. Raises ValueError for a white point of y 0, which libtiff
    rejects."""
    f32 = np.float32
    if white is None:  # D50_X0 / (D50_X0 + D50_Y0 + D50_Z0), in float
        s = f32(f32(f32(96.4250) + f32(100.0)) + f32(82.4680))
        white = (f32(96.4250) / s, f32(100.0) / s)
    x, y = f32(white[0]), f32(white[1])
    if y == 0:
        raise ValueError("a CIELab TIFF whose WhitePoint has a y of 0, which "
                         "libtiff rejects too")
    ref = (f32(x / y * f32(100)), f32(100),
           f32(f32(f32(f32(1) - x) - y) / y * f32(100)))
    i = np.arange(LAB_RANGE + 1)
    yr = f32(255) * np.power(i / LAB_RANGE, 1.0 / float(f32(2.4))).astype(f32)
    step = f32(f32(99) / f32(LAB_RANGE))  # (d_YCR - d_Y0R) / range
    return np.concatenate([yr.astype(f32), np.array([*ref, step], f32)])


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


def tiff_rows(data: bytes, lib, tiff_info=None) -> Raster:
    """Parse a TIFF's first IFD and decode its strips or tiles on the host
    with ``lib``'s ``tiff_host_*`` functions (the card's library, or a host
    build of ``csrc/tiff_decode.h``), Deflate chunks inflated here with
    ``zlib``: the samples ``cv2.imread`` converts, and how it converts them
    (libtiff's 16-bit narrowing and colour-map rule, its YCbCr tables,
    OpenCV's grey); signed samples are read as their bits, as cv2 reads
    them. A JPEG-compressed TIFF is :func:`tiff_jpeg_coefficients`'s.
    ``tiff_info``: the file's ``tiff_host_info`` fields where the caller
    has read them. Raises ValueError, naming the cause, for what the card
    does not read."""
    (W, H, bits, spp, pm, planar, comp, _, orientation, _, _, _, chunks,
     alpha, little, n_map, _, _, sub_h, sub_v, _, _) = \
        tiff_info or _tiff_info(data, lib)
    if comp == 7:
        raise ValueError("a JPEG-compressed TIFF: its strips or tiles are "
                         "JPEG streams (tiff_jpeg_coefficients), not rows")
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
    n_rows = H
    if pm != 6:
        sub_h = sub_v = 1
    elif sub_h * sub_v > 1:  # libtiff's data units: hs vs Y, Cb, Cr
        rowbytes = -(-W // sub_h) * (sub_h * sub_v + 2)
        n_rows = -(-H // sub_v)
    rows = np.empty((planes * n_rows, rowbytes), np.uint8)
    _check(lib.tiff_host_decode(data, len(data),
                                inflated[0] if inflated else None,
                                inflated[1] if inflated else None,
                                rows.ctypes.data), "TIFF read")
    tables = np.zeros(TABLES_LEN, np.uint8)
    if n_map:  # libtiff's checkcmap: a map with an entry >= 256 is 16-bit
        m = cmap.reshape(3, n_map)
        m = m >> 8 if (m >= 256).any() else m
        tables[:3 * n_map] = m.T.reshape(-1).astype(np.uint8)
    if pm == 6:
        luma = _rationals(data, lib, 529, 3) or (0.299, 0.587, 0.114)
        ref = _rationals(data, lib, 532, 6) or (0., 255., 128., 255., 128.,
                                                255.)
        if not (np.isfinite(luma).all() and np.isfinite(ref).all()) or \
                luma[1] == 0:
            raise ValueError("a YCbCr TIFF whose YCbCrCoefficients or "
                             "ReferenceBlackWhite libtiff rejects too (not "
                             "finite, or a zero green)")
        tables[:5 * 1024] = ycbcr_tables(luma, ref).astype("<i4").view(
            np.uint8).reshape(-1)
    if pm == 8:
        lab = cielab_tables(_rationals(data, lib, 318, 2))
        tables[:lab.nbytes] = lab.astype("<f4").view(np.uint8)
    kind = {0: RASTER_GREY, 1: RASTER_GREY, 2: RASTER_RGB,
            3: RASTER_PALETTE, 5: RASTER_CMYK, 6: RASTER_YCBCR,
            8: RASTER_CIELAB}[pm]
    form = RasterForm(kind, bits, spp, int(planar == 2), little,
                      int(pm == 0), NARROW_ROUND257,
                      int(kind == RASTER_RGB and spp == 4 and alpha == 2),
                      GREY_OPENCV, W, H, rowbytes, rowbytes * n_rows,
                      sub_h=sub_h, sub_v=sub_v)
    return Raster(rows, form, tables, orientation)


def _rationals(data: bytes, lib, tag: int, n: int):
    """The n float values of a TIFF tag as libtiff reads them, or None where
    the tag is absent or holds fewer."""
    out = np.zeros(n, np.float32)
    got = lib.tiff_host_rationals(data, len(data), tag, out.ctypes.data, n)
    if got < 0:
        raise ValueError(f"a malformed TIFF (tag {tag} is not rational)")
    return tuple(out.tolist()) if got >= n else None


def _ycbcr_samples(raster: Tensor, f: RasterForm):
    """(Y, Cb, Cr) int64 (H, W) of a YCbCr raster: each pixel's Y and its
    data unit's chroma (a plain pixel at 1 x 1)."""
    if f.sub_h * f.sub_v == 1:
        return _raster_samples(raster, f).unbind(-1)
    H, W, hs, vs = f.height, f.width, f.sub_h, f.sub_v
    unit = hs * vs + 2
    flat = raster.reshape(-1).to(torch.int64)
    y = torch.arange(H, device=raster.device)[:, None]
    x = torch.arange(W, device=raster.device)[None, :]
    base = (y // vs) * f.rowbytes + (x // hs) * unit
    return (flat[base + (y % vs) * hs + x % hs], flat[base + unit - 2],
            flat[base + unit - 1])


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


def _cielab_rgb(s: Tensor, f: RasterForm, tables: Tensor):
    """libtiff's TIFFCIELab16ToXYZ and TIFFXYZToRGB of (H, W, 3) L*, a*, b*
    samples (int64, their bits) with :func:`cielab_tables`' state, in
    float32, an operation at a time: R, G, B int64."""
    lab = tables[:LAB_WHITE_AT + 16].view(torch.float32)  # little-endian
    yr, (X0, Y0, Z0, step) = lab[:LAB_RANGE + 1], lab[LAB_RANGE + 1:]
    l, a, b = s.unbind(-1)
    sign = 1 << (f.bits - 1)
    a, b = (a ^ sign) - sign, (b ^ sign) - sign  # signed char / int16
    if f.bits == 8:  # TIFFCIELabToXYZ: TIFFCIELab16ToXYZ of l 257, a 256
        l, a, b = l * 257, a * 256, b * 256
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=s.device)
    L = l.to(torch.float32) * c(100) / c(65535)
    small = L < c(8.856)
    Ys = L * Y0 / c(903.292)
    cby = torch.where(small, c(7.787) * (Ys / Y0) + c(16) / c(116),
                      (L + c(16)) / c(116))
    Y = torch.where(small, Ys, Y0 * cby * cby * cby)

    def xz(t, w):
        return torch.where(t < c(0.2069), w * (t - c(0.13793)) / c(7.787),
                           w * t * t * t)

    X = xz(a.to(torch.float32) / c(256) / c(500) + cby, X0)
    Z = xz(cby - b.to(torch.float32) / c(256) / c(200), Z0)
    out = []
    for m0, m1, m2 in ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416),
                       (0.0556, -0.2040, 1.0570)):
        lum = c(m0) * X + c(m1) * Y + c(m2) * Z
        lum = torch.clamp(lum, min=1, max=100)
        i = torch.clamp(((lum - c(1)) / step).to(torch.int64), max=LAB_RANGE)
        v = (yr[i].to(torch.float64) + 0.5).to(torch.int64)
        out.append(torch.clamp(v, max=255))
    return out


def raster_to_bgr_plain(raster: Tensor, form: RasterForm,
                        tables: Tensor) -> Tuple[Tensor, Tensor]:
    """The plain version of ``raster_to_bgr_kernel``: (grey (H, W), BGR
    (H, W, 3)) uint8, cv2.imread's, from a raster's bytes (uint8, the
    layout :func:`png_rows` and :func:`tiff_rows` leave) and its tables
    (csrc/raster_bgr.h says what each form computes)."""
    RASTER_COUNTS.plain += 1
    f = form
    s = None if f.kind == RASTER_YCBCR else _raster_samples(raster, f)
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
    elif f.kind == RASTER_YCBCR:  # libtiff's TIFFYCbCrtoRGB
        y0, cb, cr = _ycbcr_samples(raster, f)
        tab = tables[:5 * 1024].reshape(5, 256, 4).to(torch.int64)
        tab = (tab * torch.tensor([1, 256, 65536, 16777216],
                                  device=tab.device)).sum(-1)
        tab = torch.where(tab >= 1 << 31, tab - (1 << 32), tab)
        yv = tab[0][y0]
        r = torch.clamp(yv + tab[1][cr], 0, 255)
        g = torch.clamp(yv + ((tab[4][cb] + tab[3][cr]) >> 16), 0, 255)
        b = torch.clamp(yv + tab[2][cb], 0, 255)
    elif f.kind == RASTER_CIELAB:  # libtiff's RGBA reader
        r, g, b = _cielab_rgb(s, f, tables)
    elif f.kind == RASTER_BMP16:  # OpenCV's BGR555 / BGR565 expansion
        v = s[..., 0]
        b = (v << 3) & 0xF8
        g = (v >> 3) & 0xFC if f.green6 else (v >> 2) & 0xF8
        r = (v >> 8) & 0xF8 if f.green6 else (v >> 7) & 0xF8
    elif f.kind == RASTER_CMYK:  # libtiff's RGBA reader
        k = 255 - s[..., 3]
        r, g, b = [k * (255 - s[..., i]) // 255 for i in range(3)]
    else:
        r, g, b = s[..., 0], s[..., 1], s[..., 2]
        if f.bgr:
            r, b = b, r
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
        grey = opencv_grey(b, g, r)
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
    sizes = (ctypes.c_longlong * 2)(form.rowbytes, form.plane_bytes)
    err = _library().raster_to_bgr_launch(
        raster.data_ptr(), form_ints(form), sizes, tables.data_ptr(),
        bgr.data_ptr(), gray.data_ptr(), _stream(raster))
    _check(err, "raster_to_bgr_kernel launch")
    RASTER_COUNTS.launched(raster_form_name(form))
    return gray, bgr


def raster_form_name(form: RasterForm):
    """The launch counters' name of a raster form that later reads added
    ("ycbcr", "bmp16", "bgr", "cielab"), None for the rest."""
    return {RASTER_YCBCR: "ycbcr", RASTER_BMP16: "bmp16",
            RASTER_CIELAB: "cielab"}.get(form.kind,
                                         "bgr" if form.bgr else None)


# ------------------------------- BMP, PNM -------------------------------

def _bmp_error(why: str):
    return ValueError(f"a BMP {why}, which cv2 does not read either")


def _rle_fill(out, pos, count: int, value: int):
    """OpenCV's FillUniColor: ``count`` pixels of ``value`` from pos (x, y),
    wrapping to the next row at each row's end; the new position."""
    x, y = pos
    H, W = out.shape
    while True:
        n = min(count, W - x)
        out[y, x:x + n] = value
        x += n
        count -= n
        if x >= W:
            x, y = 0, y + 1
            if y >= H:
                break
        if count <= 0:
            break
    return x, y


def bmp_rle(data: bytes, at: int, W: int, H: int, bits: int) -> np.ndarray:
    """A BMP's RLE8 (``bits`` 8) or RLE4 (4) image data from ``at``
    expanded as OpenCV's BmpDecoder expands it: (H, W) palette indices in
    the file's row order (bottom row first), skipped pixels (end of line,
    delta, end of bitmap) index 0, as OpenCV fills them with palette entry
    0. Its quirks are kept: an RLE8 end of line right after a run that
    ended its row is passed over, an RLE4 delta and end of bitmap skip
    pixels along the row (wrapping) without their rows. Raises, as OpenCV
    refuses the file, for a run past its row's end or data that ends
    before the image does."""
    out = np.zeros((H, W), np.uint8)
    x = y = 0
    ended_row = False  # RLE8: the last run wrapped to this row

    def take(n):
        nonlocal at
        if at + n > len(data):
            raise _bmp_error("whose run-length data ends before its image")
        at += n
        return data[at - n:at]

    while True:
        n, code = take(2)
        if n:  # a run
            if x + n > W:
                raise _bmp_error("whose run passes its row's end")
            if bits == 8:
                y0 = y
                x, y = _rle_fill(out, (x, y), n, code)
                ended_row = y != y0
                if y >= H:
                    break
            else:
                out[y, x:x + n] = np.resize([code >> 4, code & 15], n)
                x += n
        elif code > 2:  # absolute: code indices, padded to 16 bits
            if x + code > W:
                raise _bmp_error("whose run passes its row's end")
            if bits == 8:
                out[y, x:x + code] = np.frombuffer(
                    take((code + 1) & ~1), np.uint8)[:code]
            else:
                b = np.frombuffer(take((((code + 1) >> 1) + 1) & ~1),
                                  np.uint8)
                out[y, x:x + code] = np.stack([b >> 4, b & 15],
                                              -1).reshape(-1)[:code]
            x += code
            ended_row = False
        else:  # 0: end of line, 1: end of bitmap, 2: delta
            dx, dy = W - x, H - y
            if bits == 4:
                if code == 2:
                    dx = take(2)[0]
                x, y = _rle_fill(out, (x, y), dx, 0)
                if y >= H:
                    break
                continue
            if code or not ended_row or dx < W:
                if code == 2:
                    dx, dy = take(2)
                if code:
                    dx += dy * W
                if y >= H:
                    break
                x, y = _rle_fill(out, (x, y), dx, 0)
                if y >= H:
                    break
            ended_row = False
            if y >= H:
                break
    return out


def bmp_rows(data: bytes) -> Raster:
    """Parse a BMP as OpenCV's BmpDecoder (grfmt_bmp.cpp) reads it: the
    40-byte (or longer) header and the 12-byte OS/2 one; 1, 4 and 8 bits
    with a palette (RLE8 and RLE4 expanded here, :func:`bmp_rle`), 16 bits
    as 5-5-5 or, by BI_BITFIELDS masks, 5-6-5, 24 and 32 bits (alpha and
    32-bit masks ignored); rows bottom-up (applied as the orientation that
    mirrors the image top-down) or, with a negative height, top-down. The
    samples stay as the file holds them (B, G, R order and 16-bit words
    are forms of the card's kernel). Raises, naming the cause, what cv2
    refuses."""
    if image_format(data) != "BMP" or len(data) < 18:
        raise _bmp_error("without a whole file header")
    offset, size = struct.unpack("<II", data[10:18])
    if size >= 36 and len(data) >= 14 + 36:
        W, H, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
        used = struct.unpack("<I", data[46:50])[0]
        entry, at = 4, 14 + size
        ok = W > 0 and H != 0 and (
            (bits in (1, 4, 8, 24, 32) and comp == 0)
            or (bits in (16, 32) and comp in (0, 3))
            or (bits == 4 and comp == 2) or (bits == 8 and comp == 1))
    elif size == 12 and len(data) >= 26:
        W, H, planes, bits = struct.unpack("<HHHH", data[18:26])
        comp, used, entry, at = 0, 0, 3, 26
        ok = W > 0 and H > 0 and planes == 1 and bits in (1, 4, 8, 24, 32)
    else:
        raise _bmp_error(f"of a header of {size} bytes")
    if not ok:
        raise _bmp_error(f"of {bits} bits, compression {comp}, "
                         f"{W}x{H}")
    if W * abs(H) > 1 << 30:
        raise _bmp_error(f"of {W}x{abs(H)}: more than 2^30 pixels")
    tables = np.zeros(TABLES_LEN, np.uint8)
    green6 = 0
    if bits <= 8:
        n = used or 1 << bits
        if n > 256 or at + n * entry > len(data):
            raise _bmp_error("whose palette is longer than 256 entries or "
                             "than the file")
        pal = np.frombuffer(data[at:at + n * entry], np.uint8).reshape(
            n, entry)
        tables[:3 * n] = pal[:, 2::-1].reshape(-1)  # BGR(A) -> RGB
    elif bits == 16 and comp == 3:
        if at + 12 > len(data):
            raise _bmp_error("whose bit-field masks pass the file's end")
        masks = struct.unpack("<III", data[at:at + 12])
        if masks not in ((0x7C00, 0x3E0, 0x1F), (0xF800, 0x7E0, 0x1F)):
            raise _bmp_error(f"of 16-bit fields other than 5-5-5 and 5-6-5 "
                             f"(masks {tuple(map(hex, masks))})")
        green6 = int(masks[1] == 0x7E0)
    rows = abs(H)
    orientation = 4 if H > 0 else 1  # bottom-up: mirrored top-down
    if comp in (1, 2):
        samples = bmp_rle(data, offset, W, rows, bits)
        bits, rowbytes = 8, W
    else:
        rowbytes = (W * bits + 31) // 32 * 4
        if offset > len(data) or offset + rows * rowbytes > len(data):
            raise _bmp_error("whose image data ends before its image does")
        samples = np.frombuffer(data, np.uint8, rows * rowbytes,
                                offset).reshape(rows, rowbytes).copy()
    kind = RASTER_PALETTE if bits <= 8 else RASTER_BMP16 if bits == 16 \
        else RASTER_RGB
    form = RasterForm(kind, 16 if bits == 16 else min(bits, 8),
                      bits // 8 if bits >= 24 else 1, 0, 1, 0, NARROW_SHIFT,
                      0, GREY_OPENCV, W, rows, rowbytes, rowbytes * rows,
                      bgr=int(bits >= 24), green6=green6)
    return Raster(samples, form, tables, orientation)


# whitespace and comments (to their line's end), then a number
_PNM_NUMBER = re.compile(rb"(?:[ \t\n\v\f\r]+|#[^\r\n]*[\r\n])*(\d)(\d*)")


def _pnm_number(data: bytes, pos: int, one_digit: bool = False):
    """OpenCV's ReadNumber (grfmt_pxm.cpp) from pos: whitespace and
    comments (to the end of their line) skipped, then digits (one with
    ``one_digit``), and the character after them consumed; (value, new
    position). Anything else, or the data's end, raises."""
    m = _PNM_NUMBER.match(data, pos)
    if m is None or m.end(1) > len(data):
        raise ValueError("a PNM whose header or samples hold something "
                         "other than numbers where numbers belong, or end "
                         "early, which cv2 does not read either")
    if one_digit:
        return int(m.group(1)), m.end(1)
    end = m.end(2)
    if end >= len(data):  # the character after the number is read too
        raise ValueError("a PNM that ends inside a number, which cv2 does "
                         "not read either")
    return int(m.group(1) + m.group(2)), end + 1


_PNM_DIGITS_AND_SPACE = b"0123456789 \t\n\v\f\r"


def _pnm_ascii(data: bytes, pos: int, count: int,
               one_digit: bool) -> np.ndarray:
    """``count`` ASCII samples from pos, int64, as that many
    :func:`_pnm_number` calls read them. Where the data from pos holds
    only digits and whitespace, numpy finds the numbers at once (a number
    of up to 18 digits, followed by a character); else, or where that
    falls short, one call a sample, which raises as cv2 refuses."""
    body = data[pos:]
    if not body.translate(None, _PNM_DIGITS_AND_SPACE):
        b = np.frombuffer(body, np.uint8)
        digit = (b >= ord("0")) & (b <= ord("9"))
        if one_digit:  # a digit a sample, nothing consumed after it
            values = b[digit][:count].astype(np.int64) - ord("0")
            if len(values) == count:
                return values
        else:
            edges = np.flatnonzero(np.diff(digit, prepend=False,
                                           append=False))
            starts, ends = edges[0::2][:count], edges[1::2][:count]
            lengths = ends - starts
            if len(starts) == count and ends[-1] < len(b) and \
                    lengths.max() <= 18:
                values = np.zeros(count, np.int64)
                for k in range(int(lengths.max())):
                    m = lengths > k
                    values[m] = values[m] * 10 + b[starts[m] + k] - ord("0")
                return values
    values = np.empty(count, np.int64)
    for i in range(count):
        values[i], pos = _pnm_number(data, pos, one_digit)
    return values


def pnm_rows(data: bytes) -> Raster:
    """Parse a PBM, PGM or PPM (P1 to P6) as OpenCV's PxMDecoder reads it:
    the header's numbers with comments; binary samples as stored (no
    rescaling by maxval; 16-bit big-endian ones narrowed v >> 8 by the
    card's kernel); ASCII samples clamped to maxval and, at 8 bits,
    rescaled v * 255 / maxval by OpenCV's palette (so written here as
    bytes); P1 and P4 with 1 as black. The binary data starts one
    character after maxval's last digit. Raises, naming the cause, what
    cv2 refuses. PAM (P7) and PFM are not read here."""
    kind = image_format(data)
    if kind not in ("PBM", "PGM", "PPM"):
        raise ValueError(f"not a PBM, PGM or PPM ({kind})")
    digit = data[1] - ord("0")
    binary, channels = digit >= 4, 3 if digit in (3, 6) else 1
    pos = 2
    W, pos = _pnm_number(data, pos)
    H, pos = _pnm_number(data, pos)
    maxval = 1
    if digit not in (1, 4):
        maxval, pos = _pnm_number(data, pos)
    if not (0 < W and 0 < H and 0 < maxval < 1 << 16):
        raise ValueError(f"a PNM of {W}x{H}, maxval {maxval}, which cv2 "
                         f"does not read either")
    if W * H > 1 << 30:
        raise ValueError(f"a PNM of {W}x{H}: more than 2^30 pixels")
    bits = 1 if digit in (1, 4) else 8 if maxval < 256 else 16
    n = W * channels
    if binary:
        rowbytes = (n * bits + 7) // 8
        if pos + H * rowbytes > len(data):
            raise ValueError("a PNM whose samples end before its image "
                             "does, which cv2 does not read either")
        samples = np.frombuffer(data, np.uint8, H * rowbytes,
                                pos).reshape(H, rowbytes).copy()
    else:
        values = _pnm_ascii(data, pos, H * n, digit == 1)
        if bits == 1:  # OpenCV's palette: 0 white, anything else black
            values, bits = np.where(values != 0, 0, 255), 8
        elif bits == 8:
            values = np.minimum(values, maxval) * 255 // maxval
        else:
            values = np.minimum(values, maxval)
        samples = values.astype(">u2" if bits == 16 else np.uint8).view(
            np.uint8).reshape(H, -1)
        rowbytes = samples.shape[1]
    form = RasterForm(RASTER_RGB if channels == 3 else RASTER_GREY, bits,
                      channels, 0, 0, int(binary and bits == 1),
                      NARROW_SHIFT, 0, GREY_OPENCV, W, H, rowbytes,
                      rowbytes * H)
    return Raster(samples, form, np.zeros(TABLES_LEN, np.uint8), 1)


def raster_rows(data: bytes, lib) -> Raster:
    """:func:`png_rows`, :func:`tiff_rows`, :func:`bmp_rows` or
    :func:`pnm_rows` by the file's first bytes."""
    kind = image_format(data)
    if kind == "PNG":
        return png_rows(data, lib)
    if kind == "BMP":
        return bmp_rows(data)
    if kind in ("PBM", "PGM", "PPM"):
        return pnm_rows(data)
    if kind != "TIFF":
        raise ValueError(f"not a PNG, TIFF, BMP, PBM, PGM or PPM ({kind})")
    return tiff_rows(data, lib)


_RASTER_FORMATS = {"PNG": "png", "TIFF": "tiff", "BMP": "bmp", "PBM": "pnm",
                   "PGM": "pnm", "PPM": "pnm"}


def _decode_raster(data: bytes, device) -> Tuple[Tensor, Tensor]:
    kind = image_format(data)
    # BMP and PNM are parsed here, before the card's library is built, so
    # what they refuse raises before anything reaches the card
    lib = None if kind in ("BMP", "PBM", "PGM", "PPM") else _library()
    info = _tiff_info(data, lib) if kind == "TIFF" else None
    if info and info[6] == 7:
        return _decode_tiff_jpeg(data, info, _cuda_device(device))
    r = tiff_rows(data, lib, info) if info else raster_rows(data, lib)
    dev = _cuda_device(device)
    samples = torch.from_numpy(r.samples).to(dev)
    tables = torch.from_numpy(r.tables).to(dev)
    gray, bgr = raster_to_bgr_kernel(samples, r.form, tables)
    CODEC_COUNTS.launched(_RASTER_FORMATS[kind])
    return orient(gray, r.orientation), orient(bgr, r.orientation)


# ----------------------------- lossy WebP -----------------------------

VP8_RECON_COUNTS = nvcc.LaunchCounts()
VP8_FILTER_COUNTS = nvcc.LaunchCounts()
WEBP_COLOUR_COUNTS = nvcc.LaunchCounts()
VP8_PARAM_INTS = 49   # vp8_recon.h Params: dq (4 x 6), filter (4 x 2 x 3), type
VP8_HEADER_FIELDS = ("width", "height", "mb_w", "mb_h", "filter_type",
                     "level", "sharpness", "partitions", "use_segment",
                     "update_map", "absolute_delta", "use_skip_proba",
                     "base_q", "colorspace", "clamp_type", "simple")
# vp8_recon.h Record word 0 and the intra modes' numbering (libwebp's)
VP8_INNER = 1 << 7
VP8_DC, VP8_TM, VP8_VE, VP8_HE = 0, 1, 2, 3


class VP8Frame(NamedTuple):
    """What the host's entropy decode (``csrc/webp_decode.h``) leaves of a
    lossy WebP's VP8 frame, for the card's kernels: per MB (raster order) a
    record (vp8_recon.h Record) and its 25 blocks' quantized coefficients
    (Y2, 16 Y, 4 U, 4 V; natural order); the dequantization factors and
    loop filter limits per segment and the filter type (``params``)."""
    records: np.ndarray   # (mb_h * mb_w, 4) int32
    coefs: np.ndarray     # (mb_h * mb_w, 25, 16) int16
    params: np.ndarray    # (VP8_PARAM_INTS,) int32
    header: dict          # VP8_HEADER_FIELDS: the frame header's values

    @property
    def size(self) -> Tuple[int, int]:
        return self.header["height"], self.header["width"]

    @property
    def mbs(self) -> Tuple[int, int]:
        return self.header["mb_h"], self.header["mb_w"]


class WebPFile(NamedTuple):
    """What a WebP's RIFF chunks say (:func:`webp_container`): the frame
    cv2.imread reads (a still file's, or an animated file's first) with
    its kind ("lossy": VP8, "lossless": VP8L) and its chunk's payload, the
    EXIF chunk's payload (None without one), the canvas, the frame's
    offset on it and its size, each (x, y) or (width, height)."""
    kind: str
    frame: bytes
    exif: Optional[bytes]
    canvas: Tuple[int, int]
    offset: Tuple[int, int]
    size: Tuple[int, int]
    animated: bool


def _le24(b: bytes) -> int:
    return int.from_bytes(b[:3], "little")


def _riff_chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload) of the chunks of data[pos:end]; a chunk that ends
    past ``end`` raises."""
    out = []
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        n = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if n > end - pos - 8:
            raise ValueError(f"a truncated WebP (its {fourcc!r} chunk "
                             f"ends past the file)")
        out.append((fourcc, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def vp8l_header(payload: bytes) -> Tuple[int, int]:
    """(width, height) of a VP8L chunk's payload; raises, as libwebp
    refuses them, on a wrong signature, a version other than 0 or fewer
    than 5 bytes (webp_lossless.h read_header, code 5008)."""
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise ValueError(_CODE_ERRORS[5008])
    bits = struct.unpack("<I", payload[1:5])[0]
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _frame_size(fourcc: bytes, payload: bytes) -> Tuple[int, int]:
    if fourcc == b"VP8L":
        return vp8l_header(payload)
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("a malformed WebP (no VP8 key frame)")
    return tuple(v & 0x3FFF for v in struct.unpack("<HH", payload[6:10]))


def webp_container(data: bytes) -> WebPFile:
    """Walk a WebP's RIFF chunks as libwebp (and its demuxer, for an
    animated file) does and find the frame cv2.imread reads: a still
    file's first VP8 or VP8L chunk (simple or VP8X format), or an animated
    file's (VP8X with the animation flag) first ANMF frame, placed at its
    offset (2 X, 2 Y) on the VP8X canvas. Refuses, naming the cause, what
    libwebp refuses: a RIFF that is not WEBP or is shorter than its size,
    a chunk past the end, no frame, a VP8L header that is not VP8L's, a
    still file whose VP8X canvas is not its frame's size, an animated file
    without an ANMF or whose ANIM comes after it, a first frame that runs
    past the canvas."""
    kind = image_format(data)
    if kind != "WebP":
        raise ValueError(f"not a WebP ({kind})")
    size = struct.unpack("<I", data[4:8])[0] if len(data) >= 12 else 0
    if len(data) < 12 or size < 12 or size > len(data) - 8:
        raise ValueError(f"a truncated WebP (its RIFF header says {size + 8}"
                         f" bytes, the file holds {len(data)})")
    chunks = _riff_chunks(data, 12, 8 + size)
    first = {}
    for fourcc, payload in chunks:
        first.setdefault(fourcc, payload)
    exif, x = first.get(b"EXIF"), first.get(b"VP8X")
    canvas = None
    if x is not None and len(x) >= 10:
        canvas = 1 + _le24(x[4:7]), 1 + _le24(x[7:10])
    frames = (b"VP8 ", b"VP8L")
    if canvas is not None and x[0] & 0x02:  # the animation flag
        names = [f for f, _ in chunks]
        if b"ANMF" not in names:
            raise ValueError("an animated WebP without a frame (no ANMF "
                             "chunk), which libwebp refuses too")
        if b"ANIM" not in names[:names.index(b"ANMF")]:
            raise ValueError("an animated WebP whose first ANMF frame comes "
                             "before its ANIM chunk, which libwebp refuses "
                             "too")
        anmf = first[b"ANMF"]
        if len(anmf) < 16:
            raise ValueError("a truncated WebP (an ANMF chunk shorter than "
                             "its header)")
        inner = [c for c in _riff_chunks(anmf, 16, len(anmf))
                 if c[0] in frames]
        if not inner:
            raise ValueError("an animated WebP whose first frame holds no "
                             "VP8 or VP8L bitstream")
        fourcc, frame = inner[0]
        offset = 2 * _le24(anmf[0:3]), 2 * _le24(anmf[3:6])
        w, h = _frame_size(fourcc, frame)
        if offset[0] + w > canvas[0] or offset[1] + h > canvas[1]:
            raise ValueError(f"an animated WebP whose first frame ({w}x{h} "
                             f"at {offset}) runs past its canvas "
                             f"({canvas[0]}x{canvas[1]}), which libwebp "
                             f"refuses too")
        return WebPFile("lossless" if fourcc == b"VP8L" else "lossy", frame,
                        exif, canvas, offset, (w, h), True)
    still = [c for c in chunks if c[0] in frames]
    if not still:
        raise ValueError("a malformed WebP (no VP8 or VP8L frame)")
    fourcc, frame = still[0]
    w, h = _frame_size(fourcc, frame)
    if canvas is not None and canvas != (w, h):
        raise ValueError(f"a WebP whose VP8X canvas ({canvas[0]}x"
                         f"{canvas[1]}) differs from its frame ({w}x{h}), "
                         f"which libwebp refuses too")
    return WebPFile("lossless" if fourcc == b"VP8L" else "lossy", frame, exif,
                    (w, h), (0, 0), (w, h), False)


def _riff(chunks) -> bytes:
    """A RIFF/WEBP file of (fourcc, payload) chunks."""
    body = b"WEBP" + b"".join(
        f + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
        for f, p in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_orientation(info: WebPFile, lib) -> int:
    """The EXIF chunk's orientation (1 without one): cv2 applies it to
    lossy, lossless and animated files alike."""
    return 1 if info.exif is None else lib.exif_orientation_tiff(
        info.exif, len(info.exif))


def webp_frame(data: bytes, lib) -> Tuple[VP8Frame, int]:
    """Check a WebP's container (:func:`webp_container`) and decode its
    lossy (VP8) frame, a still file's or an animated file's first, on the
    host with ``lib``'s ``webp_host_header`` and ``webp_host_decode`` (the
    card's library, or a host build of ``csrc/webp_decode.h``): the
    :class:`VP8Frame` and the EXIF chunk's orientation (1 without one; cv2
    applies it)."""
    info = webp_container(data)
    if info.kind != "lossy":
        raise ValueError("a lossless WebP (VP8L): vp8l_frame decodes it")
    if info.animated:  # the frame's VP8 chunk, as a still file
        data = _riff([(b"VP8 ", info.frame)])
    header_info = (ctypes.c_int * len(VP8_HEADER_FIELDS))()
    _check(lib.webp_host_header(data, len(data), header_info), "WebP decode")
    header = dict(zip(VP8_HEADER_FIELDS, header_info))
    n = header["mb_w"] * header["mb_h"]
    records = np.zeros((n, 4), np.int32)
    coefs = np.zeros((n, 25, 16), np.int16)
    params = np.zeros(VP8_PARAM_INTS, np.int32)
    _check(lib.webp_host_decode(data, len(data), records.ctypes.data,
                                coefs.ctypes.data, params.ctypes.data),
           "WebP decode")
    return VP8Frame(records, coefs, params, header), webp_orientation(info,
                                                                      lib)


def _wrap16(x: Tensor) -> Tensor:
    """x stored into an int16 (two's complement), as int64."""
    return ((x + 32768) & 0xFFFF) - 32768


def _vp8_fields(records: Tensor):
    """Per MB: (sub-block modes?, 16x16 mode, chroma mode, segment, inner
    edges?) as int64 tensors, and the 16 sub-block modes (n, 16)."""
    r = records.to(torch.int64)
    f = r[:, 0]
    n = torch.arange(16, device=r.device)
    word = torch.where(n < 8, r[:, 1:2], r[:, 2:3])
    sub = (word >> (4 * (n & 7))) & 15
    return ((f & 1) == 1, (f >> 1) & 3, (f >> 3) & 3, (f >> 5) & 3,
            (f & VP8_INNER) != 0), sub


def _vp8_residuals(coefs: Tensor, i4x4: Tensor, seg: Tensor,
                   dq: Tensor) -> Tensor:
    """(n, 24, 4, 4) int64: the inverse DCT's ((x + 4) >> 3 terms) of each
    MB's 16 luma and 8 chroma blocks, dequantized as libwebp does (int16
    products; a 16x16 MB's luma DCs from the WHT of its Y2)."""
    c = coefs.to(torch.int64)
    f = dq.to(torch.int64)[seg]                          # (n, 6)
    pos0 = torch.arange(16, device=c.device) == 0
    factor = lambda dc, ac: torch.where(pos0, f[:, dc:dc + 1],
                                        f[:, ac:ac + 1])[:, None, :]
    y2 = _wrap16(c[:, :1] * factor(2, 3))[:, 0]           # (n, 16)
    y = _wrap16(c[:, 1:17] * factor(0, 1))
    uv = _wrap16(c[:, 17:] * factor(4, 5))
    # libwebp's TransformWHT_C
    a0, a1 = y2[:, 0:4] + y2[:, 12:16], y2[:, 4:8] + y2[:, 8:12]
    a2, a3 = y2[:, 4:8] - y2[:, 8:12], y2[:, 0:4] - y2[:, 12:16]
    t = torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)   # (n, 4 r, 4 i)
    dc0 = t[:, :, 0] + 3
    b0, b1 = dc0 + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    b2, b3 = t[:, :, 1] - t[:, :, 2], dc0 - t[:, :, 3]
    wht = _wrap16(torch.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], 2) >> 3)
    y = y.clone()
    y[:, :, 0] = torch.where(i4x4[:, None], y[:, :, 0], wht.reshape(-1, 16))
    x = torch.cat([y, uv], 1).reshape(-1, 24, 4, 4)       # [.., row, col]
    m1 = lambda a: ((a * 20091) >> 16) + a
    m2 = lambda a: (a * 35468) >> 16
    # vertical pass (per column), then horizontal (per row)
    a, b = x[:, :, 0] + x[:, :, 2], x[:, :, 0] - x[:, :, 2]
    cc = m2(x[:, :, 1]) - m1(x[:, :, 3])
    d = m1(x[:, :, 1]) + m2(x[:, :, 3])
    v = torch.stack([a + d, b + cc, b - cc, a - d], 2)     # (n, 24, 4 k, 4 col)
    dc = v[..., 0] + 4
    a, b = dc + v[..., 2], dc - v[..., 2]
    cc = m2(v[..., 1]) - m1(v[..., 3])
    d = m1(v[..., 1]) + m2(v[..., 3])
    return torch.stack([a + d, b + cc, b - cc, a - d], 3) >> 3


def _diagonals(mb_w: int, mb_h: int, device):
    """The MBs of each anti-diagonal d = x + 2 y in order: (xs, ys)."""
    for d in range(mb_w + 2 * (mb_h - 1)):
        ys = torch.arange(max(0, (d - mb_w + 2) // 2), min(mb_h, d // 2 + 1),
                          device=device)
        yield d - 2 * ys, ys


def _pred4_table():
    """Each 4x4 mode's sample (x, y) as an index into _pred4's values:
    avg3 centred on edge sample i (0-12: L K J I X A B C D E F G H, the
    ends repeated), then avg2 of edge samples i, i + 1 (13-24), the edge
    samples themselves (25-37), the DC (38); TM is computed apart. libwebp's
    VE4_C ... HU4_C (dsp/dec.c) rewritten on that edge."""
    a3, a2, e, dc = (lambda i: i), (lambda i: 13 + i), (lambda i: 25 + i), 38
    vr = {(0, 0): a2(4), (1, 2): a2(4), (1, 0): a2(5), (2, 2): a2(5),
          (2, 0): a2(6), (3, 2): a2(6), (3, 0): a2(7), (0, 3): a3(2),
          (0, 2): a3(3), (0, 1): a3(4), (1, 3): a3(4), (1, 1): a3(5),
          (2, 3): a3(5), (2, 1): a3(6), (3, 3): a3(6), (3, 1): a3(7)}
    vl = {(0, 0): a2(5), (1, 0): a2(6), (0, 2): a2(6), (2, 0): a2(7),
          (1, 2): a2(7), (3, 0): a2(8), (2, 2): a2(8), (0, 1): a3(6),
          (1, 1): a3(7), (0, 3): a3(7), (2, 1): a3(8), (1, 3): a3(8),
          (3, 1): a3(9), (2, 3): a3(9), (3, 2): a3(10), (3, 3): a3(11)}
    hd = {(0, 0): a2(3), (2, 1): a2(3), (0, 1): a2(2), (2, 2): a2(2),
          (0, 2): a2(1), (2, 3): a2(1), (0, 3): a2(0), (3, 0): a3(6),
          (2, 0): a3(5), (1, 0): a3(4), (3, 1): a3(4), (1, 1): a3(3),
          (3, 2): a3(3), (1, 2): a3(2), (3, 3): a3(2), (1, 3): a3(1)}
    hu = {(0, 0): a2(2), (2, 0): a2(1), (0, 1): a2(1), (2, 1): a2(0),
          (0, 2): a2(0), (1, 0): a3(2), (3, 0): a3(1), (1, 1): a3(1),
          (3, 1): a3(0), (1, 2): a3(0)}
    modes = {VP8_DC: lambda x, y: dc, VP8_TM: lambda x, y: 0,
             VP8_VE: lambda x, y: a3(5 + x), VP8_HE: lambda x, y: a3(3 - y),
             4: lambda x, y: a3(4 + x - y),           # RD
             5: lambda x, y: vr[x, y], 6: lambda x, y: a3(6 + x + y),  # LD
             7: lambda x, y: vl[x, y], 8: lambda x, y: hd[x, y],
             9: lambda x, y: hu.get((x, y), e(0))}
    return torch.tensor([[modes[m](x, y) for y in range(4) for x in range(4)]
                         for m in range(10)])


_PRED4 = _pred4_table()


def _pred4(mode: Tensor, t: Tensor, left: Tensor) -> Tensor:
    """libwebp's 4x4 predictors (dsp/dec.c) of m sub-blocks, each in its
    mode (m,): t (m, 9) the row above from the top-left (X, A..H), left
    (m, 4) (I..L); (m, 4, 4) [row, col]."""
    edge = torch.cat([left.flip(1), t], 1)                # L K J I X A .. H
    pad = torch.cat([edge[:, :1], edge, edge[:, -1:]], 1)
    a3 = (pad[:, :-2] + 2 * pad[:, 1:-1] + pad[:, 2:] + 2) >> 2
    a2 = (edge[:, :-1] + edge[:, 1:] + 1) >> 1
    dc = (4 + t[:, 1:5].sum(1) + left.sum(1)) >> 3
    vals = torch.cat([a3, a2, edge, dc[:, None]], 1)
    out = torch.gather(vals, 1, _PRED4.to(mode.device)[mode])
    tm = torch.clamp(t[:, None, 1:5] + left[:, :, None] - t[:, :1, None],
                     0, 255).reshape(-1, 16)
    return torch.where((mode == VP8_TM)[:, None], tm, out).reshape(-1, 4, 4)


def _pred_block(mode, buf: Tensor, n: int, xs, ys) -> Tensor:
    """A 16x16 (n 16) or chroma (n 8) mode's prediction (m, n, n) from the
    buffers (m, n + 1, >= n + 1) [1 + row, 1 + col] of MBs at (xs, ys):
    libwebp's DC (inside the frame only), V, H and TM forms."""
    top, left, tl = buf[:, 0, 1:n + 1], buf[:, 1:n + 1, 0], buf[:, 0, 0]
    shift = 4 if n == 16 else 3
    st, sl = top.sum(1), left.sum(1)
    has_t, has_l = ys > 0, xs > 0
    dc = torch.where(has_t & has_l, (st + sl + n) >> (shift + 1),
                     torch.where(has_t, (st + n // 2) >> shift,
                                 torch.where(has_l, (sl + n // 2) >> shift,
                                             torch.full_like(st, 128))))
    mode = mode[:, None, None]
    return torch.where(
        mode == VP8_DC, dc[:, None, None], torch.where(
            mode == VP8_VE, top[:, None, :], torch.where(
                mode == VP8_HE, left[:, :, None], torch.clamp(
                    top[:, None, :] + left[:, :, None] - tl[:, None, None],
                    0, 255))))


def _mb_border(plane: Tensor, n: int, xs, ys, mb_w: int, extra: int = 0):
    """The buffers (m, n + 1, n + 1 + extra) of MBs at (xs, ys) with their
    border from the unfiltered ``plane`` (n 16: Y, 8: U or V) filled in as
    vp8_recon.h's border_sample does: row 0 the row above (127 in the top
    row; col 0 its top-left, 129 at the left edge below the top row;
    ``extra`` above-right samples, the last of the row above repeated in
    the rightmost column), col 0 the column to the left (129 at the frame's
    left)."""
    m = xs.shape[0]
    dev = plane.device
    buf = torch.zeros((m, n + 1, n + 1 + extra), dtype=torch.int64,
                      device=dev)
    c = torch.arange(-1, n + extra, device=dev)
    cols = n * xs[:, None] + c
    cols = torch.where((c >= n) & (xs[:, None] == mb_w - 1),
                       n * xs[:, None] + n - 1, cols)
    row = torch.clamp(n * ys - 1, min=0)
    above = plane[row[:, None], torch.clamp(cols, min=0)].to(torch.int64)
    above = torch.where((c == -1) & (xs[:, None] == 0), 129, above)
    buf[:, 0] = torch.where(ys[:, None] == 0, 127, above)
    r = torch.arange(n, device=dev)
    lft = plane[n * ys[:, None] + r, torch.clamp(n * xs - 1, min=0)[:, None]]
    buf[:, 1:, 0] = torch.where(xs[:, None] == 0, 129, lft.to(torch.int64))
    return buf


def vp8_reconstruct_plain(records: Tensor, coefs: Tensor, params: Tensor,
                          mb_w: int, mb_h: int):
    """The plain version of ``vp8_reconstruct_kernel``: the unfiltered
    (Y (16 mb_h, 16 mb_w), U, V (8 mb_h, 8 mb_w)) uint8 planes of a lossy
    WebP's VP8 frame from its :class:`VP8Frame` arrays as tensors
    (csrc/vp8_recon.h says what it computes). Int64 tensor code over each
    anti-diagonal's MBs at once (x + 2 y: an MB's neighbours to the left,
    above and above right come on earlier ones), the 16 sub-blocks of the
    sub-block modes in order."""
    VP8_RECON_COUNTS.plain += 1
    dev = records.device
    (i4x4, ymode, uvmode, seg, _), sub = _vp8_fields(records)
    dq = params.to(torch.int64)[:24].reshape(4, 6).to(dev)
    res = _vp8_residuals(coefs.to(dev), i4x4, seg, dq)
    Y = torch.zeros((16 * mb_h, 16 * mb_w), dtype=torch.uint8, device=dev)
    U = torch.zeros((8 * mb_h, 8 * mb_w), dtype=torch.uint8, device=dev)
    V = torch.zeros_like(U)
    r16, r8 = torch.arange(16, device=dev), torch.arange(8, device=dev)
    for xs, ys in _diagonals(mb_w, mb_h, dev):
        i = ys * mb_w + xs
        yb = _mb_border(Y, 16, xs, ys, mb_w, 4)          # (m, 17, 21)
        for k in (3, 7, 11):  # the above-right samples for sub-block rows
            yb[:, 1 + k, 17:21] = yb[:, 0, 17:21]
        luma = res[i, :16].reshape(-1, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)
        luma = luma.reshape(-1, 16, 16)
        pred = _pred_block(ymode[i], yb, 16, xs, ys)
        yb[:, 1:17, 1:17] = torch.where(i4x4[i, None, None],
                                        yb[:, 1:17, 1:17],
                                        torch.clamp(pred + luma, 0, 255))
        s = torch.nonzero(i4x4[i])[:, 0]
        if s.numel():
            b = yb[s]
            for n in range(16):
                r, c = 4 * (n >> 2), 4 * (n & 3)
                p = _pred4(sub[i[s], n], b[:, r, c:c + 9],
                           b[:, 1 + r:5 + r, c])
                b[:, 1 + r:5 + r, 1 + c:5 + c] = torch.clamp(
                    p + res[i[s], n], 0, 255)
            yb[s] = b
        Y[16 * ys[:, None, None] + r16[:, None],
          16 * xs[:, None, None] + r16] = yb[:, 1:17, 1:17].to(torch.uint8)
        for k, P in enumerate((U, V)):
            cb = _mb_border(P, 8, xs, ys, mb_w)
            blocks = res[i, 16 + 4 * k:20 + 4 * k].reshape(-1, 2, 2, 4, 4)
            blocks = blocks.permute(0, 1, 3, 2, 4).reshape(-1, 8, 8)
            out = torch.clamp(_pred_block(uvmode[i], cb, 8, xs, ys) + blocks,
                              0, 255)
            P[8 * ys[:, None, None] + r8[:, None],
              8 * xs[:, None, None] + r8] = out.to(torch.uint8)
    return Y, U, V


def _filter_lines(v: Tensor, kind: int, thresh: Tensor, ithresh: Tensor,
                  hev: Tensor, on: Tensor) -> Tensor:
    """vp8_filter.h filter_line on lines v (m, L, 8) [p3..q3] int64: kind 0
    simple, 1 normal MB edge, 2 normal inner edge; per-MB thresh, ithresh,
    hev (m,) and whether the MB's edge is filtered (m,)."""
    s1 = lambda x: torch.clamp(x, -128, 127)
    s2 = lambda x: torch.clamp(x, -16, 15)
    c8 = lambda x: torch.clamp(x, 0, 255)
    p3, p2, p1, p0, q0, q1, q2, q3 = v.unbind(-1)
    t, it, ht = thresh[:, None], ithresh[:, None], hev[:, None]
    go = on[:, None] & (4 * (p0 - q0).abs() + (p1 - q1).abs() <= 2 * t + 1)
    # DoFilter2
    a = 3 * (q0 - p0) + s1(p1 - q1)
    f2 = (c8(p0 + s2((a + 3) >> 3)), c8(q0 - s2((a + 4) >> 3)))
    out = v.clone()
    if kind == 0:
        out[..., 3] = torch.where(go, f2[0], p0)
        out[..., 4] = torch.where(go, f2[1], q0)
        return out
    interior = ((p3 - p2).abs() <= it) & ((p2 - p1).abs() <= it) & (
        (p1 - p0).abs() <= it) & ((q3 - q2).abs() <= it) & (
        (q2 - q1).abs() <= it) & ((q1 - q0).abs() <= it)
    go = go & interior
    high = ((p1 - p0).abs() > ht) | ((q1 - q0).abs() > ht)
    if kind == 1:  # DoFilter6
        w = s1(3 * (q0 - p0) + s1(p1 - q1))
        a1, a2, a3 = [(k * w + 63) >> 7 for k in (27, 18, 9)]
        new = [c8(p2 + a3), c8(p1 + a2), c8(p0 + a1), c8(q0 - a1),
               c8(q1 - a2), c8(q2 - a3)]
        idx = range(1, 7)
    else:  # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = s2((a + 4) >> 3), s2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        new = [c8(p1 + a3), c8(p0 + a2), c8(q0 - a1), c8(q1 - a3)]
        idx = range(2, 6)
    for k, val in zip(idx, new):
        if k == 3:
            val = torch.where(high, f2[0], val)
        elif k == 4:
            val = torch.where(high, f2[1], val)
        else:
            val = torch.where(high, v[..., k], val)
        out[..., k] = torch.where(go, val, v[..., k])
    return out


def vp8_loop_filter_plain(Y: Tensor, U: Tensor, V: Tensor, records: Tensor,
                          params: Tensor, mb_w: int, mb_h: int):
    """The plain version of ``vp8_loop_filter_kernel``: the loop-filtered
    copies of a VP8 frame's reconstructed planes (csrc/vp8_filter.h says
    what it computes). Int64 tensor code over each anti-diagonal's MBs at
    once (x + 2 y, which keeps each MB after the three it depends on), edge
    by edge in libwebp's order."""
    VP8_FILTER_COUNTS.plain += 1
    dev = Y.device
    prm = params.to(torch.int64).to(dev)
    ftype = int(prm[48])
    if ftype == 0:
        return Y.clone(), U.clone(), V.clone()
    # luma alone, then U and V together (they share every MB's limits);
    # the simple filter leaves chroma
    groups = [Y.to(torch.int64)[None], torch.stack([U, V]).to(torch.int64)]
    (i4x4, _, _, seg, inner), _ = _vp8_fields(records.to(dev))
    lim = prm[24:48].reshape(4, 2, 3)[seg, i4x4.to(torch.int64)]  # (n, 3)
    k = torch.arange(-4, 4, device=dev)
    for xs, ys in _diagonals(mb_w, mb_h, dev):
        i = ys * mb_w + xs
        limit, ilevel, hev = lim[i].unbind(1)
        on = limit > 0
        for n, P in zip((16, 8), groups if ftype == 2 else groups[:1]):
            j = torch.arange(n, device=dev)
            pl = torch.arange(P.shape[0], device=dev)[:, None, None, None]
            for vertical in (True, False):  # vertical edges, then horizontal
                for e in range(0, n, 4):
                    if e == 0:  # the MB's left or top edge, not the frame's
                        kind, t = (0 if ftype == 1 else 1), limit + 4
                        go = on & ((xs > 0) if vertical else (ys > 0))
                    else:
                        kind, t, go = (0 if ftype == 1 else 2), limit, \
                            on & inner[i]
                    # lines j along the edge, samples k across it
                    along = lambda o: (n * o)[:, None, None] + j[:, None]
                    across = lambda o: (n * o + e)[:, None, None] + k
                    rr, cc = (along(ys), across(xs)) if vertical else (
                        across(ys), along(xs))
                    at = torch.broadcast_tensors(pl, rr.clamp(min=0),
                                                 cc.clamp(min=0))
                    P[at] = _filter_lines(P[at], kind, t, ilevel, hev, go)
    return (groups[0][0].to(torch.uint8), groups[1][0].to(torch.uint8),
            groups[1][1].to(torch.uint8))


def webp_yuv_to_bgr_plain(Y: Tensor, U: Tensor, V: Tensor, width: int,
                          height: int) -> Tuple[Tensor, Tensor]:
    """The plain version of ``webp_yuv_to_bgr_kernel``: (grey (H, W), BGR
    (H, W, 3)) uint8, cv2.imread's, of a lossy WebP's filtered planes
    (csrc/webp_colour.h says what it computes: libwebp's fancy upsampling
    and YUV -> RGB, OpenCV's BGR -> grey)."""
    WEBP_COLOUR_COUNTS.plain += 1
    H, W = height, width
    dev = Y.device
    r = torch.arange(H, device=dev)[:, None]
    c = torch.arange(W, device=dev)[None, :]
    ch = (H + 1) >> 1
    nr = r >> 1
    fr = torch.where(r == 0, 0, torch.where((r & 1) == 1, (r + 1) >> 1,
                                            (r >> 1) - 1)).clamp(max=ch - 1)
    nc = c >> 1
    edge = (c == 0) | ((c == W - 1) & (W % 2 == 0))
    fc = torch.where((c & 1) == 1, nc + 1, nc - 1).clamp(0, (W - 1) >> 1)

    def up(P):
        P = P.to(torch.int64)
        nn, nf, fn, ff = P[nr, nc], P[nr, fc], P[fr, nc], P[fr, fc]
        avg = nn + nf + fn + ff + 8
        return torch.where(edge, (3 * nn + fn + 2) >> 2,
                           (((avg + 2 * (nf + fn)) >> 3) + nn) >> 1)

    u, v = up(U), up(V)
    y = Y[:H, :W].to(torch.int64)
    mh = lambda a, k: (a * k) >> 8
    clip = lambda x: torch.where((x & ~16383) == 0, x >> 6,
                                 torch.where(x < 0, 0, 255))
    red = clip(mh(y, 19077) + mh(v, 26149) - 14234)
    green = clip(mh(y, 19077) - mh(u, 6419) - mh(v, 13320) + 8708)
    blue = clip(mh(y, 19077) + mh(u, 33050) - 17685)
    grey = (red * 9798 + green * 19235 + blue * 3735 + 16384) >> 15
    return grey.to(torch.uint8), torch.stack([blue, green, red],
                                             -1).to(torch.uint8)


def _vp8_planes_args(Y, U, V, mb_w, mb_h):
    dev = Y.device
    if any(P.device.type != "cuda" or P.dtype != torch.uint8 or
           not P.is_contiguous() for P in (Y, U, V)) or \
            tuple(Y.shape) != (16 * mb_h, 16 * mb_w) or \
            tuple(U.shape) != (8 * mb_h, 8 * mb_w) or U.shape != V.shape:
        raise ValueError(f"the VP8 kernels take contiguous uint8 CUDA planes "
                         f"Y {(16 * mb_h, 16 * mb_w)}, U and V "
                         f"{(8 * mb_h, 8 * mb_w)}, got {tuple(Y.shape)}, "
                         f"{tuple(U.shape)}, {tuple(V.shape)} on {dev}")
    return Y.data_ptr(), U.data_ptr(), V.data_ptr()


def _vp8_launch_args(records: Tensor, params, mb_w: int, mb_h: int):
    if records.device.type != "cuda" or records.dtype != torch.int32 or \
            tuple(records.shape) != (mb_w * mb_h, 4):
        raise ValueError(f"the VP8 kernels take int32 CUDA records "
                         f"({mb_w * mb_h}, 4), got {records.dtype} "
                         f"{tuple(records.shape)} on {records.device}")
    p = torch.as_tensor(params).to(torch.int32).cpu().reshape(-1)
    if p.numel() != VP8_PARAM_INTS:
        raise ValueError(f"{p.numel()} VP8 params, not {VP8_PARAM_INTS}")
    sync = torch.zeros(mb_h + 1, dtype=torch.int32, device=records.device)
    return (ctypes.c_int * VP8_PARAM_INTS)(*p.tolist()), sync


def vp8_reconstruct_kernel(records: Tensor, coefs: Tensor, params,
                           mb_w: int, mb_h: int):
    """Launch ``vp8_reconstruct_kernel`` on a VP8 frame's CUDA records and
    coefficients: the unfiltered (Y, U, V), as
    :func:`vp8_reconstruct_plain`. One launch: a warp a row of MBs, rows
    claimed in order, each MB after the row above has finished the MB
    above right of it."""
    prm, sync = _vp8_launch_args(records, params, mb_w, mb_h)
    if coefs.device != records.device or coefs.dtype != torch.int16 or \
            tuple(coefs.shape) != (mb_w * mb_h, 25, 16):
        raise ValueError(f"the VP8 reconstruction takes int16 CUDA "
                         f"coefficients ({mb_w * mb_h}, 25, 16), got "
                         f"{coefs.dtype} {tuple(coefs.shape)} on "
                         f"{coefs.device}")
    dev = records.device
    Y = torch.empty((16 * mb_h, 16 * mb_w), dtype=torch.uint8, device=dev)
    U = torch.empty((8 * mb_h, 8 * mb_w), dtype=torch.uint8, device=dev)
    V = torch.empty_like(U)
    err = _library().vp8_reconstruct_launch(
        records.contiguous().data_ptr(), coefs.contiguous().data_ptr(), prm,
        mb_w, mb_h, Y.data_ptr(), U.data_ptr(), V.data_ptr(),
        sync.data_ptr(), _stream(records))
    _check(err, "vp8_reconstruct_kernel launch")
    VP8_RECON_COUNTS.launched()
    return Y, U, V


def vp8_loop_filter_kernel(Y: Tensor, U: Tensor, V: Tensor, records: Tensor,
                           params, mb_w: int, mb_h: int):
    """Launch ``vp8_loop_filter_kernel``: filter a VP8 frame's CUDA planes
    in place, as :func:`vp8_loop_filter_plain` filters copies of them, and
    return them. One launch, MB rows claimed in order as in the
    reconstruction. A frame whose filter is off (level 0) launches
    nothing."""
    prm, sync = _vp8_launch_args(records, params, mb_w, mb_h)
    ptrs = _vp8_planes_args(Y, U, V, mb_w, mb_h)
    if prm[48] == 0:
        return Y, U, V
    err = _library().vp8_loop_filter_launch(
        records.contiguous().data_ptr(), prm, mb_w, mb_h, *ptrs,
        sync.data_ptr(), _stream(records))
    _check(err, "vp8_loop_filter_kernel launch")
    VP8_FILTER_COUNTS.launched()
    return Y, U, V


def webp_yuv_to_bgr_kernel(Y: Tensor, U: Tensor, V: Tensor, width: int,
                           height: int) -> Tuple[Tensor, Tensor]:
    """Launch ``webp_yuv_to_bgr_kernel`` on a VP8 frame's filtered CUDA
    planes: (grey, BGR), both from the one launch, as
    :func:`webp_yuv_to_bgr_plain`."""
    mb_h, mb_w = Y.shape[0] // 16, Y.shape[1] // 16
    ptrs = _vp8_planes_args(Y, U, V, mb_w, mb_h)
    if not (0 < height <= 16 * mb_h and 0 < width <= 16 * mb_w):
        raise ValueError(f"{width}x{height} does not fit planes of "
                         f"{mb_w}x{mb_h} MBs")
    bgr = torch.empty((height, width, 3), dtype=torch.uint8, device=Y.device)
    gray = torch.empty((height, width), dtype=torch.uint8, device=Y.device)
    err = _library().webp_yuv_to_bgr_launch(*ptrs, mb_w, width, height,
                                            bgr.data_ptr(), gray.data_ptr(),
                                            _stream(Y))
    _check(err, "webp_yuv_to_bgr_kernel launch")
    WEBP_COLOUR_COUNTS.launched()
    return gray, bgr


# ----------------------- lossless and animated WebP -----------------------

VP8L_PREDICTOR_COUNTS = nvcc.LaunchCounts()
VP8L_COLOUR_COUNTS = nvcc.LaunchCounts()
WEBP_ARGB_COUNTS = nvcc.LaunchCounts()
# VP8L's transform types (webp_lossless.h, vp8l_transform.h)
VP8L_PREDICTOR, VP8L_CROSS_COLOUR, VP8L_SUBTRACT_GREEN, VP8L_COLOUR_INDEXING \
    = 0, 1, 2, 3
VP8L_TRANSFORM_NAMES = ("predictor", "cross_colour", "subtract_green",
                        "colour_indexing")
# webp_lossless.h Stat: what the host decode met, in this order
VP8L_STATS = ("cache_bits", "meta_bits", "groups", "simple_codes",
              "single_codes", "normal_codes", "back_refs", "plane_refs",
              "cache_hits", "literals", "colours")


class VP8LTransform(NamedTuple):
    """One of a VP8L image's transforms: its type, bits (block size of the
    predictor and cross-colour transforms, bundling of colour indexing),
    the width it outputs and its data (the sub-image of modes or
    multipliers, subsampled by 2^bits; the palette, decoded and padded
    with zeros to the 2^(8 >> bits) entries an index can reach; nothing
    for subtract green), uint32 ARGB words on the host or int32 on a
    device."""
    type: int
    bits: int
    xsize: int
    data: object


class VP8LImage(NamedTuple):
    """What the host's entropy decode (``csrc/webp_lossless.h``) leaves of
    a VP8L bitstream: its size, its transforms in stream order (they are
    undone in reverse), the coded image (height, coded_width) of uint32
    ARGB, and what the decode met (VP8L_STATS)."""
    width: int
    height: int
    coded_width: int
    transforms: list
    argb: np.ndarray
    stats: dict


def vp8l_decode(payload: bytes, lib) -> VP8LImage:
    """Entropy-decode a VP8L chunk's payload on the host with ``lib``'s
    ``vp8l_host_decode`` (the card's library, or a host build of
    ``csrc/webp_lossless.h``)."""
    w, h = vp8l_header(payload)
    info = (ctypes.c_int * 21)()
    argb = np.empty(w * h, np.uint32)
    data = np.empty(2 * ((w + 3) // 4) * ((h + 3) // 4) + 256, np.uint32)
    stats = (ctypes.c_int * len(VP8L_STATS))()
    _check(lib.vp8l_host_decode(payload, len(payload), info,
                                argb.ctypes.data, data.ctypes.data, stats),
           "WebP decode")
    width, height, _, coded_w, n = info[:5]
    transforms, at = [], 0
    for k in range(n):
        kind, bits, xsize, words = info[5 + 4 * k:9 + 4 * k]
        transforms.append(VP8LTransform(kind, bits, xsize,
                                        data[at:at + words].copy()))
        at += words
    return VP8LImage(width, height, coded_w, transforms,
                     argb[:coded_w * height].reshape(height, coded_w),
                     dict(zip(VP8L_STATS, stats)))


def vp8l_frame(data: bytes, lib) -> Tuple[VP8LImage, WebPFile, int]:
    """Check a WebP's container (:func:`webp_container`) and entropy-decode
    its lossless (VP8L) frame, a still file's or an animated file's first,
    on the host: the :class:`VP8LImage`, the container's
    :class:`WebPFile` and the EXIF orientation (1 without one)."""
    info = webp_container(data)
    if info.kind != "lossless":
        raise ValueError("a lossy WebP (VP8): webp_frame decodes it")
    return vp8l_decode(info.frame, lib), info, webp_orientation(info, lib)


def vp8l_runs(transforms) -> list:
    """A VP8L image's transforms in the order they are undone (the
    stream's reverse), grouped into launches: a predictor alone, each run
    of consecutive element-wise ones (cross-colour, subtract green, colour
    indexing) together."""
    runs = []
    for t in reversed(transforms):
        if t.type == VP8L_PREDICTOR or not runs or \
                runs[-1][0].type == VP8L_PREDICTOR:
            runs.append([t])
        else:
            runs[-1].append(t)
    return runs


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _channels(argb: Tensor) -> Tensor:
    """(..., 4) int64 channels (B, G, R, A) of int32 ARGB words."""
    v = argb.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(v >> s) & 255 for s in (0, 8, 16, 24)], -1)


def _words(ch: Tensor) -> Tensor:
    """int32 ARGB words of (..., 4) channels."""
    v = ch[..., 0] | (ch[..., 1] << 8) | (ch[..., 2] << 16) | (ch[..., 3]
                                                              << 24)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def vp8l_predictor_plain(residuals: Tensor, modes: Tensor,
                         bits: int) -> Tensor:
    """The plain version of ``vp8l_predictor_kernel``: the inverse
    predictor transform (csrc/vp8l_transform.h says what it computes) of
    an (H, W) int32 ARGB image of residuals, whose modes are the green
    bytes of ``modes`` (the sub-image, subsampled by 2^bits). Pixel (x, y)
    needs its left, top-left, top and top-right neighbours rebuilt, so the
    image is rebuilt one anti-diagonal t = x + 2 y at a time, on which
    every neighbour lies on an earlier one."""
    VP8L_PREDICTOR_COUNTS.plain += 1
    H, W = residuals.shape
    dev = residuals.device
    res = _channels(residuals)
    out = torch.zeros_like(res)
    tiles = _subsample(W, bits)
    mode_of = ((modes.to(torch.int64).reshape(-1) >> 8) & 15).reshape(
        -1, tiles)
    black = torch.tensor([0, 0, 0, 255], device=dev)
    avg = lambda a, b: (a + b) >> 1
    for t in range(W + 2 * (H - 1)):
        ys = torch.arange(max(0, (t - W + 2) // 2), min(H - 1, t // 2) + 1,
                          device=dev)
        xs = t - 2 * ys
        up, left = (ys - 1).clamp(min=0), (xs - 1).clamp(min=0)
        L, T, TL = out[ys, left], out[up, xs], out[up, left]
        TR = torch.where((xs == W - 1)[:, None], out[ys, 0],
                         out[up, (xs + 1).clamp(max=W - 1)])
        sel = ((L - TL).abs() - (T - TL).abs()).sum(1, keepdim=True) <= 0
        a = avg(L, T)
        preds = torch.stack([
            black.expand_as(L), L, T, TR, TL, avg(avg(L, TR), T), avg(L, TL),
            a, avg(TL, T), avg(T, TR), avg(avg(L, TL), avg(T, TR)),
            torch.where(sel, T, L), (L + T - TL).clamp(0, 255),
            (a + torch.div(a - TL, 2, rounding_mode="trunc")).clamp(0, 255),
            black.expand_as(L), black.expand_as(L)])
        mode = torch.where(ys == 0, torch.where(xs == 0, 0, 1),
                           torch.where(xs == 0, 2,
                                       mode_of[ys >> bits, xs >> bits]))
        pred = preds[mode, torch.arange(len(ys), device=dev)]
        out[ys, xs] = (res[ys, xs] + pred) & 255
    return _words(out)


def vp8l_colour_plain(argb: Tensor, run) -> Tensor:
    """The plain version of ``vp8l_colour_kernel``: a run of element-wise
    inverse transforms (VP8LTransform, in the order they are undone:
    cross-colour, add green, colour indexing; csrc/vp8l_transform.h) on an
    (H, W) int32 ARGB image; (H, the last transform's width) int32."""
    VP8L_COLOUR_COUNTS.plain += 1
    H = argb.shape[0]
    dev = argb.device
    out_w = run[-1].xsize
    x = torch.arange(out_w, device=dev)[None, :].expand(H, out_w)
    y = torch.arange(H, device=dev)[:, None].expand(H, out_w)
    cols = []  # each transform's output column of every output pixel
    cx = x
    for t in reversed(run):
        cols.append(cx)
        if t.type == VP8L_COLOUR_INDEXING:
            cx = cx >> t.bits
    cols.reverse()
    ch = _channels(argb)[y, cx]
    for t, xs in zip(run, cols):
        if t.type == VP8L_SUBTRACT_GREEN:
            ch = torch.stack([(ch[..., 0] + ch[..., 1]) & 255, ch[..., 1],
                              (ch[..., 2] + ch[..., 1]) & 255, ch[..., 3]],
                             -1)
        elif t.type == VP8L_CROSS_COLOUR:
            tiles = _subsample(t.xsize, t.bits)
            m = t.data.to(torch.int64).reshape(-1) & 0xFFFFFFFF
            m = m[(y >> t.bits) * tiles + (xs >> t.bits)]
            s8 = lambda v: ((v & 255) ^ 128) - 128  # a byte as int8
            delta = lambda k, c: (s8(k) * s8(c)) >> 5
            g = ch[..., 1]
            red = (ch[..., 2] + delta(m, g)) & 255
            blue = (ch[..., 0] + delta(m >> 8, g) + delta(m >> 16, red)) & 255
            ch = torch.stack([blue, g, red, ch[..., 3]], -1)
        elif t.type == VP8L_COLOUR_INDEXING:
            bpp = 8 >> t.bits
            sub = xs & ((1 << t.bits) - 1)
            index = (ch[..., 1] >> (sub * bpp)) & ((1 << bpp) - 1)
            ch = _channels(t.data.reshape(-1))[index]
        else:
            raise ValueError(f"transform type {t.type} is not element-wise")
    return _words(ch)


def webp_argb_to_bgr_plain(argb: Tensor, canvas: Tuple[int, int] = None,
                           offset: Tuple[int, int] = (0, 0)
                           ) -> Tuple[Tensor, Tensor]:
    """The plain version of ``webp_argb_to_bgr_kernel``: cv2.imread's (grey
    (ch, cw), BGR (ch, cw, 3)) uint8 of an (h, w) int32 ARGB frame at
    ``offset`` (x, y) on a canvas (cw, ch) of zeros (the frame's own size
    if None): alpha dropped, the grey OpenCV 5's cvtColor of the BGR."""
    WEBP_ARGB_COUNTS.plain += 1
    h, w = argb.shape
    cw, ch = canvas or (w, h)
    ox, oy = offset
    c = torch.zeros((ch, cw, 4), dtype=torch.int64, device=argb.device)
    c[oy:oy + h, ox:ox + w] = _channels(argb)
    b, g, r = c[..., 0], c[..., 1], c[..., 2]
    grey = (r * 9798 + g * 19235 + b * 3735 + 16384) >> 15
    return grey.to(torch.uint8), c[..., :3].to(torch.uint8)


def _argb_arg(t: Tensor, what: str):
    if t.device.type != "cuda" or t.dtype != torch.int32 or \
            not t.is_contiguous():
        raise ValueError(f"{what} takes contiguous int32 CUDA ARGB, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def vp8l_predictor_kernel(residuals: Tensor, modes: Tensor,
                          bits: int) -> Tensor:
    """Launch ``vp8l_predictor_kernel`` on an (H, W) int32 CUDA image of
    residuals and its CUDA sub-image of modes: the rebuilt image, as
    :func:`vp8l_predictor_plain`. One launch: a warp a band of 32 rows,
    bands claimed in order, each lane a row of the band, skewed two
    columns behind the lane above; ``sync`` holds the ticket and the
    tagged last row of the band above."""
    ptr = _argb_arg(residuals, "vp8l_predictor_kernel")
    H, W = residuals.shape
    if modes.numel() != _subsample(W, bits) * _subsample(H, bits):
        raise ValueError(f"{modes.numel()} modes for a {W}x{H} image of "
                         f"blocks of 2^{bits}")
    mptr = _argb_arg(modes, "vp8l_predictor_kernel")
    out = torch.empty_like(residuals)
    sync = torch.zeros(W + 1, dtype=torch.int64, device=residuals.device)
    _check(_library().vp8l_predictor_launch(ptr, mptr, bits, W, H,
                                            out.data_ptr(), sync.data_ptr(),
                                            _stream(residuals)),
           "vp8l_predictor_kernel launch")
    VP8L_PREDICTOR_COUNTS.launched()
    return out


def vp8l_colour_kernel(argb: Tensor, run) -> Tensor:
    """Launch ``vp8l_colour_kernel`` on an (H, W) int32 CUDA image: a run
    of element-wise inverse transforms (VP8LTransform with CUDA data, in
    the order they are undone), as :func:`vp8l_colour_plain`. One launch,
    a thread an output pixel."""
    ptr = _argb_arg(argb, "vp8l_colour_kernel")
    if not 1 <= len(run) <= 3 or any(t.type == VP8L_PREDICTOR for t in run):
        raise ValueError(f"a colour run is 1-3 element-wise transforms, got "
                         f"{[t.type for t in run]}")
    H, W = argb.shape
    desc = [len(run), W, run[-1].xsize, H]
    data = (ctypes.c_void_p * 3)()
    for j, t in enumerate(run):
        desc += [t.type, t.bits, t.xsize]
        if t.type != VP8L_SUBTRACT_GREEN:
            words = (_subsample(t.xsize, t.bits) * _subsample(H, t.bits)
                     if t.type == VP8L_CROSS_COLOUR else 1 << (8 >> t.bits))
            if t.data.numel() != words:
                raise ValueError(f"transform {t.type} of bits {t.bits} takes "
                                 f"{words} words, got {t.data.numel()}")
            data[j] = _argb_arg(t.data, "vp8l_colour_kernel")
    out = torch.empty((H, run[-1].xsize), dtype=torch.int32,
                      device=argb.device)
    _check(_library().vp8l_colour_launch(
        ptr, (ctypes.c_int * len(desc))(*desc), data, out.data_ptr(),
        _stream(argb)), "vp8l_colour_kernel launch")
    VP8L_COLOUR_COUNTS.launched(
        "+".join(VP8L_TRANSFORM_NAMES[t.type] for t in run))
    return out


def webp_argb_to_bgr_kernel(argb: Tensor, canvas: Tuple[int, int] = None,
                            offset: Tuple[int, int] = (0, 0)
                            ) -> Tuple[Tensor, Tensor]:
    """Launch ``webp_argb_to_bgr_kernel`` on an (h, w) int32 CUDA ARGB
    frame: (grey, BGR) on the canvas, both from the one launch, as
    :func:`webp_argb_to_bgr_plain`."""
    ptr = _argb_arg(argb, "webp_argb_to_bgr_kernel")
    h, w = argb.shape
    cw, ch = canvas or (w, h)
    ox, oy = offset
    if not (0 <= ox and ox + w <= cw and 0 <= oy and oy + h <= ch):
        raise ValueError(f"a {w}x{h} frame at {offset} is not on a {cw}x{ch}"
                         f" canvas")
    bgr = torch.empty((ch, cw, 3), dtype=torch.uint8, device=argb.device)
    gray = torch.empty((ch, cw), dtype=torch.uint8, device=argb.device)
    _check(_library().webp_argb_to_bgr_launch(
        ptr, w, h, ox, oy, cw, ch, bgr.data_ptr(), gray.data_ptr(),
        _stream(argb)), "webp_argb_to_bgr_kernel launch")
    WEBP_ARGB_COUNTS.launched()
    return gray, bgr


def vp8l_upload(img: VP8LImage, dev):
    """A decoded VP8L image on the card: its coded image and its
    transforms with their data (one copy of each)."""
    argb = torch.from_numpy(img.argb.view(np.int32)).to(dev)
    words = np.concatenate([t.data for t in img.transforms] +
                           [np.zeros(0, np.uint32)]).view(np.int32)
    data = torch.from_numpy(words).to(dev)
    transforms, at = [], 0
    for t in img.transforms:
        transforms.append(t._replace(data=data[at:at + len(t.data)]))
        at += len(t.data)
    return argb, transforms


def vp8l_inverse(argb: Tensor, transforms) -> Tensor:
    """Undo a VP8L image's transforms (stream order given) on its coded
    CUDA image with the kernels, a launch a run of :func:`vp8l_runs`: the
    (height, width) ARGB."""
    for run in vp8l_runs(transforms):
        if run[0].type == VP8L_PREDICTOR:
            argb = vp8l_predictor_kernel(argb, run[0].data, run[0].bits)
        else:
            argb = vp8l_colour_kernel(argb, run)
    return argb


def _on_canvas(img: Tensor, info: WebPFile) -> Tensor:
    """A lossy animated file's first frame, read, placed on its canvas of
    zeros (cv2's read of an animated file)."""
    (cw, ch), (ox, oy) = info.canvas, info.offset
    out = img.new_zeros((ch, cw) + tuple(img.shape[2:]))
    out[oy:oy + img.shape[0], ox:ox + img.shape[1]] = img
    return out


def _decode_webp(data: bytes, device) -> Tuple[Tensor, Tensor]:
    info = webp_container(data)  # what stays refused raises before the card
    lib = _library()
    if info.kind == "lossy":
        frame, orientation = webp_frame(data, lib)
        dev = _cuda_device(device)
        (H, W), (mb_h, mb_w) = frame.size, frame.mbs
        records = torch.from_numpy(frame.records).to(dev)
        coefs = torch.from_numpy(frame.coefs).to(dev)
        planes = vp8_reconstruct_kernel(records, coefs, frame.params, mb_w,
                                        mb_h)
        vp8_loop_filter_kernel(*planes, records, frame.params, mb_w, mb_h)
        gray, bgr = webp_yuv_to_bgr_kernel(*planes, W, H)
        if info.animated:
            gray, bgr = _on_canvas(gray, info), _on_canvas(bgr, info)
    else:
        img, _, orientation = vp8l_frame(data, lib)
        argb = vp8l_inverse(*vp8l_upload(img, _cuda_device(device)))
        gray, bgr = webp_argb_to_bgr_kernel(argb, info.canvas, info.offset)
    CODEC_COUNTS.launched("webp_animated" if info.animated else
                          "webp_lossless" if info.kind == "lossless" else
                          "webp")
    return orient(gray, orientation), orient(bgr, orientation)


def decode(data: bytes, device) -> Tuple[Tensor, Tensor]:
    """(grey (H, W), BGR (H, W, 3)) uint8 tensors on ``device`` from a
    file's bytes: what ``cv2.imread`` gives with ``IMREAD_GRAYSCALE`` and
    ``IMREAD_COLOR``. On a CUDA device: JPEG (Huffman or arithmetic-coded,
    sequential or progressive; lossless CMYK, the only lossless layout cv2
    reads in both modes: grey and RGB lossless files raise, naming the mode
    cv2 refuses); PNG; TIFF (uncompressed, LZW, Deflate, PackBits and
    JPEG-compressed; grey, RGB, palette, CMYK and YCbCr; signed samples as
    their bits); WebP (lossy, lossless, and the first frame of an animated
    file on its canvas); BMP; and PBM, PGM and PPM (P1 to P6). A file cut
    short reads as ``cv2.imread`` reads it from a file (see the module's
    doc): a JPEG cut inside a marker segment by libjpeg's rule for the
    segment completed with the fake EOI's bytes, a JPEG TIFF's stream of
    fewer rows than its chunk with the rest black, an uncompressed TIFF
    strip short of its rows as zeros. On the CPU: ``cv2.imdecode`` of the
    bytes, which refuses a JPEG cut short (:func:`read_image` reads the
    path with ``cv2.imread``)."""
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
    if kind in _RASTER_FORMATS:
        return _decode_raster(data, dev)
    if kind == "WebP":
        return _decode_webp(data, dev)
    if kind != "JPEG":
        raise ValueError(f"not a JPEG, PNG, TIFF, WebP, BMP, PBM, PGM or PPM "
                         f"({kind}): the card's codec reads those only")
    return _decode_jpeg(data, dev)


def decode_colour(data: bytes, device) -> Tensor:
    """BGR (H, W, 3) uint8 on ``device`` from a file's bytes: what
    ``cv2.imread`` gives with ``IMREAD_COLOR``. On a CUDA device, the
    formats :func:`decode` reads, and lossless RGB JPEGs (three components
    without a JFIF marker or an Adobe transform other than 0), which cv2
    reads in colour only. On the CPU: ``cv2.imdecode`` of the bytes."""
    dev = torch.device(device)
    if dev.type == "cuda" and image_format(data) == "JPEG":
        return _decode_jpeg(data, dev, grey=False)[1]
    if dev.type == "cuda" and image_format(data) in _RASTER_FORMATS:
        return _decode_raster(data, dev)[1]
    if dev.type == "cuda" and image_format(data) == "WebP":
        return _decode_webp(data, dev)[1]
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


def _imread(path: str, modes):
    """``cv2.imread`` of ``path`` in each of ``modes``, as the JAX package
    reads a view: libjpeg's file source feeds a cut JPEG a fake EOI, which
    ``cv2.imdecode`` of the bytes refuses. Raises where cv2 returns None."""
    import cv2

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    out = []
    for mode in modes:
        img = cv2.imread(path, mode)
        if img is None:
            with open(path, "rb") as f:
                kind = image_format(f.read(16))
            raise ValueError(f"{path}: OpenCV cannot read this {kind} file")
        out.append(torch.from_numpy(img))
    return out


def read_image(path: str, device) -> Tuple[Tensor, Tensor]:
    """:func:`decode` of the file at ``path`` on a CUDA device; on the CPU
    ``cv2.imread`` of the path with ``IMREAD_GRAYSCALE`` and
    ``IMREAD_COLOR``."""
    if torch.device(device).type == "cpu":
        import cv2

        return tuple(_imread(path, (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR)))
    return _read(path, decode, device)


def read_colour(path: str, device) -> Tensor:
    """:func:`decode_colour` of the file at ``path`` on a CUDA device; on
    the CPU ``cv2.imread`` of the path with ``IMREAD_COLOR``."""
    if torch.device(device).type == "cpu":
        import cv2

        return _imread(path, (cv2.IMREAD_COLOR,))[0]
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
