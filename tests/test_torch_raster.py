"""The card's TIFF reads and every PNG layout, held against cv2.imread on
the CPU, without the card.

The JAX package reads every image with OpenCV; the port reads PNG and TIFF
on the card: the host parses, decompresses, unfilters and de-interlaces
(``csrc/png_unfilter.h``, ``csrc/tiff_decode.h``, built here with g++ and
skipped without it), and ``raster_to_bgr_kernel`` converts the samples
(``csrc/raster_bgr.h``; its plain twin ``images.raster_to_bgr_plain``).

* Every TIFF fixture (``tests/data/tiff``: strips and tiles, planar 1 and 2,
  compressions 1, 5, 8, 32946 and 32773, predictor 2 at 8 and 16 bits,
  min-is-white, palettes with 8- and 16-bit colour maps, alpha, 8-bit CMYK
  contiguous and planar, both byte orders, BigTIFF, orientations) read
  through ``images.tiff_rows`` and the
  plain twin gives cv2's grey and BGR arrays, 0 entries differing (the PNG
  fixtures are held the same way in tests/test_torch_images.py). The
  TIFFs' arrays are ``cv2.imdecode``'s of the bytes, which are
  ``cv2.imread``'s of the file but for the 14 TIFFs of orientations 5 to 8
  (``orient5_lzw`` ... ``lab16_mm_deflate_pred2_orient6``), on which cv2
  5.0.0's imread fails in both modes: for those imdecode is the oracle,
  and the port's CPU read, which is imread, raises
  (tests/test_torch_cpu_read.py); the ``short_none_*`` TIFFs hold imread's
  arrays of the file.
* The kernel's arithmetic, built for the host, equals the plain twin entry
  for entry on every PNG and TIFF fixture.
* The grey of every 8-bit RGB triple (a 4096x4096 image made here) as a PNG
  (libpng's rgb_to_gray, with and without a gAMA chunk) and as a TIFF
  (OpenCV's own conversion) is cv2's, and so is that of every 16-bit value
  in each channel of a PNG with a gAMA chunk (libpng's 16-bit tables).
* What stays refused raises, naming its cause: the TIFFs under
  ``tests/data/tiff/refused``.
* ``mpmvs_tpu.pipeline._load_view`` against the port's read of the same
  workspace image, a 16-bit PNG, an LZW TIFF, a planar CMYK TIFF, a YCbCr
  JPEG TIFF, a (2, 2) YCbCr TIFF, an RLE8 BMP or a PPM under the name
  ``images/00000000.jpg``, through the host builds and the plain twins.
* On the card (``cuda``, skipped without one): the fixtures read to cv2's
  arrays, the kernel equals its plain twin (also at 3200x2130), and
  ``RASTER_COUNTS`` counts the launches, no plain call.

OpenCV and the JAX package are imported inside the CPU tests, so the
``cuda`` tests run where neither is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_raster.py
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from mpmvs_torch import pipeline as tpipeline
from mpmvs_torch.io import images
from mpmvs_torch.io.cams import write_cam_txt
from mpmvs_torch.utils.synthetic import make_plane_scene

from torch_parity import CAMERA_FIELDS, n

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TIFF_DIR = os.path.join(DATA, "tiff")
PNG_DIR = os.path.join(DATA, "png")
TIFF_NAMES = sorted(f[:-4] for f in os.listdir(TIFF_DIR)
                    if f.endswith(".tif"))
# the JPEG-compressed TIFFs go through the IDCT and colour kernels, not the
# raster kernel (tests/test_torch_tiff_jpeg.py)
JPEG_TIFF_NAMES = [n for n in TIFF_NAMES
                   if n.startswith("jpeg_") or n == "pil_jpeg"]
RASTER_FILES = ([f"png/{f}" for f in sorted(os.listdir(PNG_DIR))
                 if f.endswith(".png")]
                + [f"tiff/{f}.tif" for f in TIFF_NAMES
                   if f not in JPEG_TIFF_NAMES])


def _tool():
    spec = importlib.util.spec_from_file_location(
        "check_host_raster", os.path.join(TIFF_DIR, "check_host_raster.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
# the refusals tests/test_torch_images.py does not hold
TIFF_REFUSED = {k: v for k, v in TOOL.REFUSED.items()
                if k.startswith("tiff/") and k not in (
                    "tiff/refused/old_jpeg.tif", "tiff/refused/float.tif",
                    "tiff/refused/old_lzw_corrupt.tif")}


def _bytes(rel):
    with open(os.path.join(DATA, rel), "rb") as f:
        return f.read()


def _cv2_arrays(rel):
    """cv2's (grey, BGR) of a fixture, from the npz beside it: imread's
    of the file, for the oriented TIFFs imdecode's (see the module's
    doc)."""
    folder, name = os.path.split(rel)
    want = np.load(os.path.join(DATA, folder, "cv2_arrays.npz"))
    return want[f"gray_{name[:-4]}"], want[f"bgr_{name[:-4]}"]


@pytest.fixture(scope="module")
def host_raster(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host PNG and TIFF readers")
    return TOOL.build(str(tmp_path_factory.mktemp("host_raster")))


@pytest.mark.parametrize("name", TIFF_NAMES)
def test_host_tiff_read_is_cv2(host_raster, name):
    want_g, want_bgr = _cv2_arrays(f"tiff/{name}.tif")
    g, bgr = TOOL.read(host_raster, _bytes(f"tiff/{name}.tif"))
    np.testing.assert_array_equal(bgr, want_bgr)
    np.testing.assert_array_equal(g, want_g)


@pytest.mark.parametrize("rel", RASTER_FILES)
def test_raster_kernel_arithmetic_equals_plain(host_raster, rel):
    """raster_to_bgr_kernel's arithmetic (csrc/raster_bgr.h, built for the
    host) equals the plain twin on every PNG and TIFF fixture."""
    assert TOOL.kernel_mismatches(host_raster, _bytes(rel)) == 0


@pytest.mark.parametrize("case", ["png rgb8", "png rgb8 gAMA 45455",
                                  "tiff rgb8", "png rgb16 gAMA 45455",
                                  "png rgb16 gAMA 200000"])
def test_every_rgb_triple_grey_is_cv2(host_raster, case):
    """The grey of all 2^24 8-bit RGB triples (and of every 16-bit value in
    each channel of a 16-bit PNG with gamma, libpng's 16-bit tables): the
    kernel's arithmetic on every one, the plain twin on every 8th row, 0
    entries differ from cv2."""
    data = dict(TOOL.dense_cases())[case]
    assert TOOL.dense_mismatches(host_raster, data,
                                 slice(None, None, 8)) == (0, 0)


@pytest.mark.parametrize("rel", sorted(TIFF_REFUSED))
def test_host_tiff_read_refuses(host_raster, rel):
    with pytest.raises(ValueError, match=TIFF_REFUSED[rel]):
        TOOL.read(host_raster, _bytes(rel))


@pytest.mark.parametrize("rel", sorted(k for k, v in TOOL.REFUSED.items()
                                 if v == "bit depth"))
def test_cv2_refuses_what_is_refused_for_its_bit_depth(rel):
    """The TIFFs refused for their bit depth (code 4016: OpenCV does not
    read them into an 8-bit image either) are refused by cv2 too, in grey
    and colour; the 16-bit palette carries its full colour map (65,536
    entries a colour), so that cv2 refuses its depth and not a malformed
    map."""
    import cv2
    import struct

    data = _bytes(rel)
    buf = np.frombuffer(data, np.uint8)
    assert cv2.imdecode(buf, cv2.IMREAD_COLOR) is None
    assert cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE) is None
    if rel.endswith("palette16.tif"):
        assert data[:4] == b"II*\x00"
        ifd = struct.unpack("<I", data[4:8])[0]
        tags = {struct.unpack("<HHI", data[e:e + 8])[0]:
                struct.unpack("<HHI", data[e:e + 8])[2]
                for e in range(ifd + 2, ifd + 2 + 12 * struct.unpack(
                    "<H", data[ifd:ifd + 2])[0], 12)}
        assert tags[320] == 3 * 65536


def test_png_gamma_tables(host_raster):
    """A gAMA or sRGB chunk takes a colour PNG's grey through libpng's
    gamma tables (the 8-bit ones, or at 16 bits the 2048-entry ones), an
    insignificant gamma does not, and a grey PNG's grey never does."""
    rule = lambda name: images.png_rows(_bytes(f"png/{name}.png"),
                                        host_raster).form.grey_rule
    assert [rule(n) for n in ("gama_rgb8", "srgb_palette8", "gama_rgba16",
                              "gama_rgb8_100000", "gama_grey16")] == [
        images.GREY_LIBPNG_GAMMA] * 3 + [images.GREY_LIBPNG] * 2
    t = images.png_rows(_bytes("png/gama_rgba16.png"), host_raster).tables
    grey16 = t[images.GREY16_AT:images.GREY16_AT + 4096].view(">u2")
    assert (np.diff(grey16.astype(int)) >= 0).all() and grey16[-1] == 65535
    assert set((grey16[:-1] % 257).tolist()) == {0}


def test_tiff_info_fields(host_raster):
    """What tiff_rows reads of a tiled, planar, big-endian 16-bit BigTIFF."""
    r = images.tiff_rows(_bytes("tiff/rgb16_all_mm_planar2_deflate_pred2.tif"),
                         host_raster)
    f = r.form
    assert (f.kind, f.bits, f.channels, f.planar, f.little, f.width,
            f.height) == (images.RASTER_RGB, 16, 3, 1, 0, 256, 256)
    assert f.narrow == images.NARROW_ROUND257 and \
        f.grey_rule == images.GREY_OPENCV
    assert r.samples.shape == (3 * 256, 512) and r.orientation == 1


@pytest.mark.parametrize("source", [
    "png/rgb16_all.png", "tiff/rgb8_lzw_pred2_strips5_mm.tif",
    "tiff/cmyk8_planar2_lzw.tif", "tiff/jpeg_ycbcr22_strips16_tables.tif",
    "tiff/ycbcr22_deflate.tif", "bmp/rle8.bmp", "pnm/p6.ppm"])
def test_load_view_of_raster_matches_jax(tmp_path, monkeypatch,
                                         host_raster, source):
    """The JAX package's _load_view (cv2.imread) and the port's, reading
    the same workspace image (a 16-bit PNG, an LZW TIFF, a planar CMYK
    TIFF, a YCbCr JPEG TIFF, a (2, 2) YCbCr TIFF, an RLE8 BMP and a PPM,
    named 00000000.jpg) through the host builds and the plain twins: the
    same grey and BGR arrays and camera."""
    from mpmvs_tpu import pipeline as jpipeline

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    shutil.copyfile(os.path.join(DATA, source),
                    os.path.join(ws, "images", "00000000.jpg"))
    g, _ = _cv2_arrays(source)
    scene = make_plane_scene(num_views=1, height=g.shape[0], width=g.shape[1],
                             seed=4)
    write_cam_txt(os.path.join(ws, "cams", "00000000_cam.txt"),
                  scene.cameras.view(0))

    def host_read(path, device):
        with open(path, "rb") as f:
            return tuple(torch.from_numpy(a)
                         for a in TOOL.read(host_raster, f.read()))

    monkeypatch.setattr(tpipeline.image_io, "read_image", host_read)
    got = tpipeline._load_view(ws, 0, 3200, "cpu")
    want = jpipeline._load_view(ws, 0, 3200)
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.color, np.asarray(want.color))
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(n(getattr(got.camera, f)),
                                      np.asarray(getattr(want.camera, f)))


def test_card_reads_raise_before_the_card_for_what_stays_refused():
    """On a CUDA device a refused file raises its cause before any copy to
    the card (so also here, where there is none), and a format the card
    does not read is named."""
    with pytest.raises(ValueError, match="GIF"):
        images.decode(_bytes("png/refused/image.gif"), "cuda")
    with pytest.raises(ValueError, match="WebP"):
        images.decode_colour(_bytes(
            "webp/lossless/refused/frame_past_canvas.webp"), "cuda")


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rel", RASTER_FILES)
def test_card_raster_read_is_cv2(dev, rel):
    want_g, want_bgr = _cv2_arrays(rel)
    kind = "png" if rel.startswith("png") else "tiff"
    before = images.CODEC_COUNTS.forms.get(kind, 0)
    k0, p0 = images.RASTER_COUNTS.kernel, images.RASTER_COUNTS.plain
    bgr = images.read_colour(os.path.join(DATA, rel), dev)
    assert bgr.device.type == "cuda"
    assert torch.equal(bgr.cpu(), torch.as_tensor(want_bgr))
    g, bgr2 = images.read_image(os.path.join(DATA, rel), dev)
    assert torch.equal(g.cpu(), torch.as_tensor(want_g))
    assert torch.equal(bgr2.cpu(), torch.as_tensor(want_bgr))
    assert images.CODEC_COUNTS.forms[kind] == before + 2
    assert (images.RASTER_COUNTS.kernel, images.RASTER_COUNTS.plain) == (
        k0 + 2, p0)


@pytest.mark.cuda
@pytest.mark.parametrize("rel", sorted(TOOL.REFUSED))
def test_card_raster_read_refuses(dev, rel):
    with pytest.raises(ValueError, match=TOOL.REFUSED[rel]):
        images.read_image(os.path.join(DATA, rel), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("rel", RASTER_FILES)
def test_raster_kernel_equals_plain(dev, rel):
    r = images.raster_rows(_bytes(rel), images._library())
    samples = torch.from_numpy(r.samples).to(dev)
    tables = torch.from_numpy(r.tables).to(dev)
    before = images.RASTER_COUNTS.kernel
    got = images.raster_to_bgr_kernel(samples, r.form, tables)
    want = images.raster_to_bgr_plain(samples, r.form, tables)
    torch.cuda.synchronize()
    assert images.RASTER_COUNTS.kernel == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["png16", "tiff8"])
def test_raster_kernel_equals_plain_full_size(dev, kind):
    """At 3200x2130: a 16-bit RGB PNG's samples and an LZW TIFF's."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 65536 if kind == "png16" else 256, (2130, 3200, 3))
    if kind == "png16":
        rows = img.astype(">u2").view(np.uint8).reshape(2130, -1)
        form = images.RasterForm(images.RASTER_RGB, 16, 3, 0, 0, 0,
                                 images.NARROW_SHIFT, 0, images.GREY_LIBPNG,
                                 3200, 2130, 19200, 19200 * 2130)
    else:
        rows = TOOL.tiff_bytes(img.astype(np.uint8), compression=5,
                               predictor=2, rows_per_strip=64)
        r = images.tiff_rows(rows, images._library())
        rows, form = r.samples, r.form
    samples = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    tables = torch.zeros(images.TABLES_LEN, dtype=torch.uint8, device=dev)
    got = images.raster_to_bgr_kernel(samples, form, tables)
    want = images.raster_to_bgr_plain(samples, form, tables)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
