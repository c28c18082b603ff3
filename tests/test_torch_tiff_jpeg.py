"""The card's JPEG-compressed, YCbCr and signed TIFF reads, held against
cv2.imread on the CPU, without the card.

The JAX package reads every image with OpenCV; the port reads a
JPEG-compressed TIFF (Compression 7) on the card: the host decodes each
strip's or tile's JPEG stream with the JPEGTables' tables
(``csrc/tiff_jpeg.h``, built here with g++ and skipped without it), one
IDCT launch a component decodes every chunk (``images.idct_islow_plain``
here), and ``ycc_to_bgr_kernel``'s chunked form (``csrc/jpeg_colour.h``;
its plain twin ``images.colour_plain`` with ``chunks``) upsamples each
chunk on its own and writes libjpeg's BGR and OpenCV's grey. A YCbCr TIFF's
data units and a signed TIFF's samples go through ``raster_to_bgr_kernel``
(``csrc/raster_bgr.h``; ``images.raster_to_bgr_plain``); every fixture is
held to cv2's arrays in tests/test_torch_raster.py.

* The coefficients of every chunk lie one after another, each chunk's
  padded to the same blocks down, and the IDCT of the whole equals, chunk
  by chunk, the IDCT of each strip's stream decoded alone as a JPEG.
* The chunked colour form equals, strip by strip, the colour of each
  strip's stream read alone as a JPEG (the fancy upsampling stops at each
  strip's edge), with OpenCV's grey of the BGR.
* The chunked form's arithmetic, built for the host, equals the plain twin
  on every JPEG-compressed TIFF fixture.
* The grey and BGR of every (Y, Cb, Cr) triple (one 4096x4096
  subsampling-(1, 1) YCbCr TIFF made here): libtiff's TIFFYCbCrtoRGB
  tables (``images.ycbcr_tables``), the kernel's arithmetic on every one,
  the plain twin on every 8th row, 0 entries differ from cv2.
* What libtiff refuses (an RGB JPEG TIFF of 4:2:0 streams, a stream taller
  than its strip, a 12-bit stream, YCbCr layouts its RGBA reader has no
  routine for) is refused, naming the cause, and cv2 refuses it too.
* On the card (``cuda``, skipped without one): every JPEG-compressed TIFF
  fixture reads to cv2's arrays with one IDCT launch a component and one
  chunked colour launch, no plain call; the chunked form equals its twin
  on each and at 3200x2130 (chip_smoke.py's phase 8d source); the raster
  kernel's YCbCr form equals its twin at 3200x2130.

OpenCV is imported inside the CPU tests, so the ``cuda`` tests run where
it is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_tiff_jpeg.py
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from mpmvs_torch.io import images

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TIFF_DIR = os.path.join(DATA, "tiff")
JPEG_NAMES = sorted(f[:-4] for f in os.listdir(TIFF_DIR)
                    if f.endswith(".tif") and (f.startswith("jpeg_")
                                               or f == "pil_jpeg.tif"))
YCBCR_NAMES = sorted(f[:-4] for f in os.listdir(TIFF_DIR)
                     if f.endswith(".tif") and "ycbcr" in f
                     and not f.startswith("jpeg_"))
CONVERSION = os.path.join(TIFF_DIR, "conversion", "plane_3200x2130_jpeg.tif")
# what libtiff refuses of these layouts, and the cause the card names
REFUSED = {"jpeg_rgb420": "sampling factors",
           "jpeg_strip_taller": "larger than its strip",
           "jpeg12": "12-bit", "ycbcr24": "YCbCr samples of a layout",
           "ycbcr22_planar2": "YCbCr samples of a layout",
           "ycbcr11_alpha": "YCbCr samples of a layout",
           "old_jpeg": "old-style JPEG",
           "jpeg_short_whole_strip1_cut_in_dht": "no scan"}


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _module(os.path.join(TIFF_DIR, "check_host_raster.py"),
               "check_host_raster")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tiff(name):
    return _bytes(os.path.join(TIFF_DIR, f"{name}.tif"))


def _cv2_arrays(name):
    """cv2's (grey, BGR): imdecode's of the bytes, imread's of the file
    but for the orientations 5 to 8 (``jpeg_ycbcr22_orient6``,
    ``jpeg_ycbcr22_tiles_orient7``), on which cv2 5.0.0's imread fails, so
    imdecode is their oracle (tests/test_torch_cpu_read.py)."""
    want = np.load(os.path.join(TIFF_DIR, "cv2_arrays.npz"))
    return want[f"gray_{name}"], want[f"bgr_{name}"]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host TIFF and JPEG readers")
    tmp = str(tmp_path_factory.mktemp("host_tiff_jpeg"))
    decoder = _module(os.path.join(DATA, "jpeg", "check_host_decoder.py"),
                      "check_host_decoder")
    return TOOL.build(tmp), decoder, decoder.build(tmp)


def _strip_stream(data: bytes, k: int) -> bytes:
    """Strip k of a JPEG-compressed TIFF as a JPEG file of its own: the
    JPEGTables' tables put in front of its abbreviated stream."""
    import struct

    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    tags = {}
    for e in range(ifd + 2, ifd + 2 + 12 * n, 12):
        tag, typ, count = struct.unpack("<HHI", data[e:e + 8])
        size = {1: 1, 3: 2, 4: 4, 7: 1}[typ] * count
        at = e + 8 if size <= 4 else struct.unpack("<I", data[e + 8:e + 12])[0]
        fmt = {1: "B", 3: "H", 4: "I", 7: "B"}[typ]
        tags[tag] = struct.unpack(f"<{count}{fmt}", data[at:at + size])
    off, cnt = tags[273][k], tags[279][k]
    stream = data[off:off + cnt]
    if 347 not in tags:
        return stream
    tables = bytes(tags[347])
    return tables[:-2] + stream[2:]  # SOI, tables, then the frame and scans


def test_tiff_jpeg_layout(host):
    """What tiff_jpeg_coefficients reads of a 45x37 YCbCr TIFF of 16-row
    strips: 3 chunks, the last one's stream 5 rows, 2x2 blocks of Y a
    chunk's MCU row, chroma at ratios (2, 2), one table a component."""
    lib = host[0]
    tj = images.tiff_jpeg_coefficients(_tiff("jpeg_ycbcr22_strips16_tables"),
                                       lib)
    assert tj.chunks == images.Chunks(0, 45, 16, 1, 3, 0, 45, (16, 16, 5))
    assert tj.size == (37, 45) and tj.space == images.SPACE_YCC
    assert tj.factors == ((1, 1), (2, 2), (2, 2))
    assert [c.shape for c in tj.coefs] == [(6, 6, 64), (3, 3, 64),
                                           (3, 3, 64)]
    assert tj.qt.shape == (3, 64) and tj.orientation == 1
    tiles = images.tiff_jpeg_coefficients(
        _tiff("jpeg_ycbcr22_tiles_orient2"), lib)
    assert tiles.chunks == images.Chunks(1, 32, 16, 2, 6, 1, 45, (16,) * 6)
    grey = images.tiff_jpeg_coefficients(_tiff("jpeg_grey_tiles32x16"), lib)
    assert len(grey.coefs) == 1 and grey.factors == ((1, 1),)
    rgb = images.tiff_jpeg_coefficients(_tiff("jpeg_rgb_strips16_tables"),
                                        lib)
    assert rgb.space == images.SPACE_RGB


@pytest.mark.parametrize("name", ["jpeg_ycbcr22_strips16_tables",
                                  "jpeg_ycbcr22_strips8_whole",
                                  "jpeg_ycbcr22_width2",
                                  "jpeg_ycbcr22_last_strip_tall"])
def test_every_strip_is_a_jpeg_of_its_own(host, name):
    """The IDCT of every chunk's coefficients at once, and the chunked
    colour form, equal strip by strip the planes and the BGR of each
    strip's stream read alone as a JPEG (the host JPEG decoder and the
    JPEG colour twin); the grey is OpenCV's of that BGR."""
    lib, decoder, dlib = host
    data = _tiff(name)
    tj, planes = TOOL.tiff_jpeg_planes(lib, data)
    grey, bgr = images.colour_plain(planes, tj.factors, tj.size, tj.space,
                                    tj.chunks)
    k = tj.chunks
    for s in range(k.count):
        stream = _strip_stream(data, s)
        alone, factors, size, space, _ = decoder.planes(dlib, stream)
        for p, q, (rh, rv) in zip(planes, alone, tj.factors):
            stride = p.shape[0] // k.count
            got = p[s * stride:s * stride + q.shape[0], :q.shape[1]]
            np.testing.assert_array_equal(got.numpy(), q)
        _, want = images.colour_plain([torch.as_tensor(q) for q in alone],
                                      factors, size, space)
        rows = slice(s * k.height, min((s + 1) * k.height, tj.size[0]))
        n = rows.stop - rows.start
        np.testing.assert_array_equal(bgr[rows].numpy(), want[:n].numpy())
    b, g, r = bgr.to(torch.int64).unbind(-1)
    np.testing.assert_array_equal(grey.numpy(),
                                  images.opencv_grey(b, g, r).numpy())


@pytest.mark.parametrize("name", JPEG_NAMES)
def test_chunked_colour_arithmetic_equals_plain(host, name):
    """ycc_to_bgr_kernel's chunked form (csrc/jpeg_colour.h, built for the
    host) equals the plain twin, every entry, grey and BGR."""
    assert TOOL.kernel_mismatches(host[0], _tiff(name)) == 0


def _samples_read(tj) -> int:
    """The distinct plane samples that the plain twin's chunked upsampling
    (images._upsample_chunked) indexes over every pixel of a TIFF."""
    H, W = tj.size
    k = tj.chunks
    chunk, r, col, rows = images._spots(k, H, W, "cpu")
    total = 0
    for (rh, rv), coef in zip(tj.factors, tj.coefs):
        w, stride = -(-k.width // rh), 8 * coef.shape[0] // k.count
        i, j = [r // rv], [col // rh]
        if images._fancy(w, rh, rv):
            h = (rows + rv - 1) // rv
            if rv == 2:
                i.append(torch.where((r & 1) == 1,
                                     torch.minimum(i[0] + 1, h - 1),
                                     torch.clamp(i[0] - 1, min=0)))
            if rh == 2:
                j.append(torch.where((col & 1) == 1,
                                     torch.clamp(j[0] + 1, max=w - 1),
                                     torch.clamp(j[0] - 1, min=0)))
        pitch = 8 * coef.shape[1]
        total += torch.cat([((chunk * stride + a) * pitch + b).reshape(-1)
                            for a in i for b in j]).unique().numel()
    return total


@pytest.mark.parametrize("name", JPEG_NAMES)
def test_chunked_bound_counts_the_samples_read(host, name):
    """utils.roofline's chunked colour bound counts exactly the samples
    that the chunked form reads: not the IDCT's padding, a tile's
    overhang or the last strip's rows past the image."""
    from mpmvs_torch.utils import roofline

    tj = images.tiff_jpeg_coefficients(_tiff(name), host[0])
    H, W = tj.size
    assert roofline.chunk_samples_read(tj.chunks, tj.factors, H, W) == \
        _samples_read(tj)


def test_stream_of_fewer_rows_leaves_them_black(host):
    """A strip whose JPEG frame holds 10 of its 16 rows: libtiff decodes
    the frame's rows into cv2's zeroed buffer, so the rest are black; the
    colour kernel takes each chunk's frame rows."""
    tj = images.tiff_jpeg_coefficients(_tiff("jpeg_short_strip1_frame10"),
                                       host[0])
    assert tj.chunks.rows == (16, 10, 8)
    g, bgr = _cv2_arrays("jpeg_short_strip1_frame10")
    assert not bgr[26:32].any() and not g[26:32].any()
    assert bgr[16:26].all(axis=-1).any(axis=-1).all()
    full = images.tiff_jpeg_coefficients(_tiff("jpeg_ycbcr22_strips16_tables"),
                                         host[0])
    assert full.chunks.rows == (16, 16, 5)


@pytest.mark.parametrize("name", JPEG_NAMES + YCBCR_NAMES)
def test_read_counts_the_forms(host, name):
    """The plain twins count their calls under the new forms' names:
    ``chunks`` / ``chunks_rgb`` (COUNTS) for a JPEG-compressed TIFF, one
    call a read; ``ycbcr`` is the raster kernel's form of a YCbCr TIFF."""
    data = _tiff(name)
    before = dict(images.COUNTS.plain_forms)
    want_g, want_bgr = _cv2_arrays(name)
    g, bgr = TOOL.read(host[0], data)
    np.testing.assert_array_equal(bgr, want_bgr)
    np.testing.assert_array_equal(g, want_g)
    if name in JPEG_NAMES:
        form = "chunks_rgb" if name.startswith("jpeg_rgb") or \
            name == "pil_jpeg" else "chunks"
        assert images.COUNTS.plain_forms[form] == before.get(form, 0) + 1
    else:
        r = images.raster_rows(data, host[0])
        assert images.raster_form_name(r.form) == "ycbcr"


def test_every_ycbcr_triple_is_cv2(host):
    """The grey and BGR of all 2^24 (Y, Cb, Cr) triples: libtiff's tables
    through the raster kernel's arithmetic on every one and the plain twin
    on every 8th row, 0 entries differ from cv2."""
    assert TOOL.dense_mismatches(host[0], TOOL.every_triple_ycbcr(),
                                 slice(None, None, 8), colour=True) == (0, 0)


def test_ycbcr_tables_are_libtiffs():
    """ycbcr_tables at the default coefficients and ReferenceBlackWhite:
    Y_tab the identity, and the chroma tables libtiff's fixed-point
    products of FIX(1.402), FIX(1.772), -FIX(0.71414) and -FIX(0.34414)
    as float32 gives them (the last 22553, where libjpeg's table has
    22554) with Code2V's chroma, which is x at the default reference; a
    reference of its own moves them."""
    t = images.ycbcr_tables()
    x = np.arange(256) - 128
    assert (t[0] == np.arange(256)).all()
    assert (t[1] == (91881 * x + 32768) >> 16).all()
    assert (t[2] == (116130 * x + 32768) >> 16).all()
    assert (t[3] == -46802 * x).all() and (t[4] == -22553 * x + 32768).all()
    other = images.ycbcr_tables(ref=(16., 235., 128., 240., 128., 240.))
    assert (other[0, :16] < 0).all() and other[0, 235] == 255


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_as_cv2_refuses(host, name):
    """What the card refuses raises in the host's parse (before any copy to
    a card), naming why, and cv2 refuses the same file."""
    import cv2

    data = _bytes(os.path.join(TIFF_DIR, "refused", f"{name}.tif"))
    with pytest.raises(ValueError, match=REFUSED[name]):
        TOOL.read(host[0], data)
    buf = np.frombuffer(data, np.uint8)
    assert cv2.imdecode(buf, cv2.IMREAD_COLOR) is None
    assert cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE) is None


def test_signed_samples_read_as_their_bits(host):
    """A signed TIFF (SampleFormat 2) reads as the unsigned TIFF of the
    same bits: the same form and samples."""
    lib = host[0]
    data = _tiff("signed16_grey_packbits_mm")
    r = images.tiff_rows(data, lib)
    assert (r.form.kind, r.form.bits, r.form.little) == (
        images.RASTER_GREY, 16, 0)
    unsigned = data.replace(b"\x01\x53\x00\x03\x00\x00\x00\x01\x00\x02",
                            b"\x01\x53\x00\x03\x00\x00\x00\x01\x00\x01")
    assert unsigned != data
    np.testing.assert_array_equal(images.tiff_rows(unsigned, lib).samples,
                                  r.samples)


def test_conversion_source_is_the_phase_8d_layout(host):
    """chip_smoke.py's phase 8d source: 3200x2130 YCbCr at (2, 2), 134
    strips of 16 rows, one JPEGTables tag; its headers only."""
    info = (images.ctypes.c_longlong * images.TIFF_JPEG_INFO_LEN)()
    rows = (images.ctypes.c_int * 134)()
    data = _bytes(CONVERSION)
    assert host[0].tiff_jpeg_host_info(data, len(data), info, rows) == 0
    assert list(info[:4]) == [134, 3, 2, 2]
    assert list(rows) == [16] * 133 + [2130 - 133 * 16]
    fields = images._tiff_info(data, host[0])
    assert (fields[0], fields[1], fields[4], fields[6], fields[11]) == (
        3200, 2130, 6, 7, 16)
    assert fields[images.TIFF_INFO_LEN - 1] > 0  # JPEGTables


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", JPEG_NAMES)
def test_card_tiff_jpeg_read_is_cv2(dev, name):
    want_g, want_bgr = _cv2_arrays(name)
    path = os.path.join(TIFF_DIR, f"{name}.tif")
    n = len(images.tiff_jpeg_coefficients(_tiff(name),
                                          images._library()).coefs)
    i0, c0 = images.IDCT_COUNTS.kernel, images.COUNTS.kernel
    p0 = images.IDCT_COUNTS.plain + images.COUNTS.plain
    r0 = images.CODEC_COUNTS.forms.get("tiff_jpeg", 0)
    g, bgr = images.read_image(path, dev)
    assert bgr.device.type == "cuda"
    assert torch.equal(g.cpu(), torch.as_tensor(want_g))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want_bgr))
    assert torch.equal(images.read_colour(path, dev).cpu(),
                       torch.as_tensor(want_bgr))
    assert images.IDCT_COUNTS.kernel == i0 + 2 * n
    assert images.COUNTS.kernel == c0 + 2
    assert images.IDCT_COUNTS.plain + images.COUNTS.plain == p0
    assert images.CODEC_COUNTS.forms["tiff_jpeg"] == r0 + 2


def _chunked_equal(dev, data):
    tj = images.tiff_jpeg_coefficients(data, images._library())
    planes = images.tiff_jpeg_planes(tj, dev)
    got = images.colour_kernel(planes, tj.factors, tj.size, tj.space,
                               tj.chunks)
    want = images.colour_plain(planes, tj.factors, tj.size, tj.space,
                               tj.chunks)
    torch.cuda.synchronize()
    return [int((a != b).sum()) for a, b in zip(got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", JPEG_NAMES)
def test_card_chunked_colour_equals_plain(dev, name):
    assert _chunked_equal(dev, _tiff(name)) == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jpeg_ycbcr22_strips16_tables",
                                  "jpeg_short_strip1_frame10"])
def test_card_chunked_colour_captures_in_a_graph(dev, name):
    """After a read of its layout the chunked launch copies nothing to the
    card, so a CUDA graph captures it (phase 8d times it so), and the
    graph's replay writes what the launch wrote."""
    tj = images.tiff_jpeg_coefficients(_tiff(name), images._library())
    planes = images.tiff_jpeg_planes(tj, dev)
    args = (planes, tj.factors, tj.size, tj.space, tj.chunks)
    want = images.colour_kernel(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = images.colour_kernel(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert [int((a != b).sum()) for a, b in zip(got, want)] == [0, 0]


@pytest.mark.cuda
def test_card_chunked_colour_equals_plain_full_size(dev):
    """At 3200x2130, 134 strips: the phase 8d source."""
    assert _chunked_equal(dev, _bytes(CONVERSION)) == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [(1, 1), (2, 2), (4, 2)])
def test_card_ycbcr_form_equals_plain_full_size(dev, sub):
    """The raster kernel's YCbCr form on 3200x2130 random data units, with
    a ReferenceBlackWhite of its own."""
    hs, vs = sub
    rng = np.random.default_rng(hs * 10 + vs)
    H, W = 2130, 3200
    rowbytes = -(-W // hs) * (hs * vs + 2)
    rows = rng.integers(0, 256, (-(-H // vs), rowbytes)).astype(np.uint8)
    form = images.RasterForm(images.RASTER_YCBCR, 8, 3, 0, 0, 0,
                             images.NARROW_ROUND257, 0, images.GREY_OPENCV,
                             W, H, rowbytes, rows.size, sub_h=hs, sub_v=vs)
    tables = np.zeros(images.TABLES_LEN, np.uint8)
    tables[:5 * 1024] = images.ycbcr_tables(
        ref=(16., 235., 128., 240., 128., 240.)).astype("<i4").view(
        np.uint8).reshape(-1)
    samples = torch.from_numpy(rows).to(dev)
    t = torch.from_numpy(tables).to(dev)
    k0 = images.RASTER_COUNTS.forms.get("ycbcr", 0)
    got = images.raster_to_bgr_kernel(samples, form, t)
    want = images.raster_to_bgr_plain(samples, form, t)
    assert images.RASTER_COUNTS.forms["ycbcr"] == k0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REFUSED))
def test_card_refuses(dev, name):
    with pytest.raises(ValueError, match=REFUSED[name]):
        images.read_image(os.path.join(TIFF_DIR, "refused", f"{name}.tif"),
                          dev)
