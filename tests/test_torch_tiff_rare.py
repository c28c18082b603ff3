"""The rarer TIFFs on the card, held against cv2 and the JAX package on the
CPU: CIELab, old-style LZW, and compressed strips and tiles cut short.

* Every such fixture under ``tests/data/tiff`` (``pil_lab``, ``lab*``,
  ``old_lzw*``, ``short_*``) reads through the host reader
  (``csrc/tiff_decode.h``) and the raster kernel's plain twin as
  ``cv2.imread`` reads it, and the kernel's arithmetic built for the host
  equals the twin (tests/test_torch_raster.py holds every TIFF fixture so
  too); what stays refused (ICCLab, ITULab, the CIELab layouts libtiff's
  RGBA reader does not read, corrupt old-style LZW, uncompressed data
  cut short) raises with its cause.
* CIELab: libtiff's state (``images.cielab_tables``) and the conversion of
  every 8-bit (L*, a*, b*) triple and of 2^20 seeded 16-bit ones, against
  cv2.
* Old-style LZW decodes the bytes the new form decodes; a chunk cut short
  is zero-filled past its data with its predictor and byte swap skipped,
  as libtiff's decoders leave it; libtiff ignores the Predictor tag of
  uncompressed and PackBits data; 16-bit grey tiles clipped at the image's
  edge are read with libtiff's put16bitbwtile row skew.
* Uncompressed strips and tiles cut short among several (``short_none_*``,
  their arrays cv2.imread's of the file): libtiff estimates every byte
  count where the first two differ (and a single strip's where it is short
  of the image), a strip short of its rows reads as zeros, and a count of 0
  or past the end of the file, or a tile short of its rows, fails the read.
  cv2's array is a function of the file's bytes: the same in fresh
  processes, after other reads, and equal to cv2's read of the file with
  that strip's bytes zeroed (or its count whole, where estimated).
* ``mpmvs_tpu.pipeline._load_view`` and the port's read the same grey, BGR
  and camera from a CIELab and from a cut-short workspace image.
* On the card (``cuda``): the CIELab form against its twin on every
  fixture and at 3200x2130, and the reads with their launches.

    python -m pytest --noconftest -m cuda tests/test_torch_tiff_rare.py
"""

import functools
import importlib.util
import os
import re
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
RARE = sorted(f[:-4] for f in os.listdir(TIFF_DIR) if f.endswith(".tif")
              and f.startswith(("pil_lab", "lab", "old_lzw", "short_")))
LAB = [k for k in RARE if "lab" in k]
RARE_REFUSED = {"icclab": (4013, "ICCLab"), "itulab": (4013, "ITULab"),
                "lab_planar2": (4022, "CIELab TIFF of planar"),
                "lab_alpha": (4023, "CIELab TIFF of other than three"),
                "lab_l_only": (4023, "CIELab TIFF of other than three"),
                "lab4": (4024, "CIELab TIFF of other than 8 or 16"),
                "old_lzw_corrupt": (4005, "old-style LZW"),
                "short_none": (4007, "uncompressed data"),
                "short_none_tile3": (4007, "uncompressed data"),
                "short_none_strip2_count0": (4007, "uncompressed data"),
                "short_none_strip3_past_end": (4007, "uncompressed data"),
                "short_none_rows7_estimate_past_end": (4007,
                                                       "uncompressed data")}


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TIFF_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _module("check_host_raster")
TF = _module("tiff_file")


def _bytes(name, folder=TIFF_DIR):
    with open(os.path.join(folder, f"{name}.tif"), "rb") as f:
        return f.read()


def _cv2(name):
    """cv2's (grey, BGR): imdecode's of the bytes (for
    ``lab16_mm_deflate_pred2_orient6``, on which cv2 5.0.0's imread fails,
    imdecode is the oracle), imread's of the file for ``short_none_*``."""
    want = np.load(os.path.join(TIFF_DIR, "cv2_arrays.npz"))
    return want[f"gray_{name}"], want[f"bgr_{name}"]


def _cv2_of(data: bytes, tmp_path):
    import cv2

    path = str(tmp_path / "f.tif")
    with open(path, "wb") as f:
        f.write(data)
    return (cv2.imread(path, cv2.IMREAD_GRAYSCALE),
            cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host TIFF reader")
    return TOOL.build(str(tmp_path_factory.mktemp("host_rare")))


@pytest.mark.parametrize("name", RARE)
def test_host_read_is_cv2(host, name):
    gray, bgr = TOOL.read(host, _bytes(name))
    want = _cv2(name)
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])
    assert TOOL.kernel_mismatches(host, _bytes(name)) == 0


@pytest.mark.parametrize("name", LAB)
def test_cielab_fixtures_take_the_cielab_form(host, name):
    r = images.raster_rows(_bytes(name), host)
    assert r.form.kind == images.RASTER_CIELAB
    assert images.raster_form_name(r.form) == "cielab"


@pytest.mark.parametrize("name", sorted(RARE_REFUSED))
def test_refused_with_its_code(host, name):
    data = _bytes(name, os.path.join(TIFF_DIR, "refused"))
    info = np.zeros(images.TIFF_INFO_LEN, np.int64)
    code = host.tiff_host_info(data, len(data), info.ctypes.data)
    if code == 0:  # found in the strips: a decode's code
        with pytest.raises(ValueError, match=RARE_REFUSED[name][1]):
            TOOL.read(host, data)
        return
    assert code == RARE_REFUSED[name][0]
    with pytest.raises(ValueError, match=RARE_REFUSED[name][1]):
        TOOL.read(host, data)


@pytest.mark.parametrize("case", ["8-bit", "16-bit"])
def test_cielab_of_every_triple_is_cv2(host, case):
    """All 2^24 8-bit (L*, a*, b*) triples, and 2^20 seeded 16-bit ones:
    the kernel's arithmetic on every one, the plain twin on every 8th row,
    0 grey or BGR entries differ from cv2."""
    data = (TOOL.every_triple_cielab() if case == "8-bit"
            else TOOL.cielab16_sample())
    assert TOOL.dense_mismatches(host, data, slice(None, None, 8),
                                 colour=True) == (0, 0)


def test_cielab_tables_are_libtiffs():
    """D50 by default (libtiff's TIFFGetFieldDefaulted of WhitePoint), the
    table's step 99 / 1500 and its ends; a white point of y 0 refused, as
    libtiff refuses it."""
    t = images.cielab_tables()
    assert t.dtype == np.float32 and t.shape == (images.LAB_RANGE + 5,)
    x0, y0, z0, step = t[-4:]
    assert y0 == 100 and abs(x0 - 96.425) < 1e-3 and abs(z0 - 82.468) < 1e-3
    assert step == np.float32(np.float32(99) / np.float32(1500))
    assert t[0] == 0 and t[images.LAB_RANGE] == 255
    d65 = images.cielab_tables((np.float32(0.3127), np.float32(0.329)))
    assert abs(d65[-4] - 95.05) < 0.01 and abs(d65[-2] - 108.9) < 0.1
    with pytest.raises(ValueError, match="WhitePoint"):
        images.cielab_tables((0.3, 0.0))


def test_old_style_lzw_decodes_what_the_new_form_does(host):
    rgb = np.random.default_rng(3).integers(0, 256, (64, 96, 3)).astype(
        np.uint8)
    old = images.tiff_rows(TF.tiff_bytes(rgb, compression=5, old_lzw=True,
                                         rows_per_strip=20), host)
    new = images.tiff_rows(TF.tiff_bytes(rgb, compression=5,
                                         rows_per_strip=20), host)
    np.testing.assert_array_equal(old.samples, new.samples)
    np.testing.assert_array_equal(old.samples.reshape(64, 96, 3), rgb)


@pytest.mark.parametrize("compression", [5, 8, 32773])
def test_short_chunk_zero_filled_without_its_predictor(host, compression):
    """A chunk whose data ends early: what the data holds, then zeros; its
    predictor not undone (libtiff's decode returned an error); the chunks
    after it whole."""
    rgb = np.random.default_rng(compression).integers(
        0, 256, (40, 30, 3)).astype(np.uint8)
    pred = 1 if compression == 32773 else 2
    data = TF.tiff_bytes(rgb, compression=compression, predictor=pred,
                         rows_per_strip=10)
    counts = TF.tags_of(data)[279]
    cut = TF.cut_chunk(data, 1, counts[1] // 2)
    rows = images.tiff_rows(cut, host).samples.reshape(40, 30, 3)
    np.testing.assert_array_equal(rows[:10], rgb[:10])
    np.testing.assert_array_equal(rows[20:], rgb[20:])
    assert not rows[19].any()
    if pred == 2:  # the differences as they are, where the data holds
        np.testing.assert_array_equal(rows[10, 1:].astype(np.uint8),
                                      (rgb[10, 1:].astype(np.int64) -
                                       rgb[10, :-1]).astype(np.uint8))


@pytest.mark.parametrize("compression", [1, 32773])
def test_predictor_ignored_where_libtiff_ignores_it(host, tmp_path,
                                                    compression):
    """libtiff runs the predictor for LZW and Deflate only: uncompressed
    and PackBits data with Predictor 2 read as their differences."""
    rgb = np.random.default_rng(9).integers(0, 256, (12, 17, 3)).astype(
        np.uint8)
    data = TF.tiff_bytes(rgb, compression=compression, predictor=2)
    gray, bgr = TOOL.read(host, data)
    want = _cv2_of(data, tmp_path)
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.mark.parametrize("big,alpha,cut", [(False, False, False),
                                           (True, False, False),
                                           (False, True, False),
                                           (True, True, True)])
def test_clipped_16bit_grey_tiles_are_libtiffs(host, tmp_path, big, alpha,
                                               cut):
    """16-bit grey tiles clipped at the image's right edge: libtiff's
    put16bitbwtile skews each row by the clipped pixels' count in bytes,
    which cv2 shows; the port reads them so."""
    rng = np.random.default_rng(int(big) + 2 * int(alpha))
    img = rng.integers(0, 65536, (33, 41) + ((2,) if alpha else ())).astype(
        np.uint16)
    data = TF.tiff_bytes(img, photometric=1, compression=5, tile=(16, 16),
                         big=big, extra_samples=(2,) if alpha else None)
    if cut:
        data = TF.cut_chunk(data, 2, TF.tags_of(data)[325][2] // 2)
    gray, bgr = TOOL.read(host, data)
    want = _cv2_of(data, tmp_path)
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.mark.parametrize("name", ["lab8_lzw_pred2", "lab16", "old_lzw",
                                  "short_deflate_pred2"])
def test_load_view_of_rare_tiff_matches_jax(tmp_path, monkeypatch, host,
                                            name):
    """The JAX package's _load_view (cv2.imread) and the port's, reading
    the same workspace image (named 00000000.jpg) through the host reader
    and the raster kernel's plain twin: the same grey and BGR arrays and
    camera."""
    from mpmvs_tpu import pipeline as jpipeline

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    shutil.copyfile(os.path.join(TIFF_DIR, f"{name}.tif"),
                    os.path.join(ws, "images", "00000000.jpg"))
    g, _ = _cv2(name)
    scene = make_plane_scene(num_views=1, height=g.shape[0], width=g.shape[1],
                             seed=4)
    write_cam_txt(os.path.join(ws, "cams", "00000000_cam.txt"),
                  scene.cameras.view(0))

    def host_read(path, device):
        with open(path, "rb") as f:
            return tuple(torch.from_numpy(a) for a in TOOL.read(host,
                                                                f.read()))

    monkeypatch.setattr(tpipeline.image_io, "read_image", host_read)
    got = tpipeline._load_view(ws, 0, 3200, "cpu")
    want = jpipeline._load_view(ws, 0, 3200)
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.color, np.asarray(want.color))
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(n(getattr(got.camera, f)),
                                      np.asarray(getattr(want.camera, f)))


# ----------------------------- on the card -----------------------------

# the uncompressed fixtures cut short: (strip or tile cut, what cv2 makes
# of it: "zeros" its rows read as zeros, "whole" its count estimated whole)
SHORT_NONE = {"short_none_strip2_of_4": (2, "zeros"),
              "short_none_strip3_of_4_last": (3, "zeros"),
              "short_none_grey_strip2_1byte": (2, "zeros"),
              "short_none_miniswhite_strip3": (3, "zeros"),
              "short_none_grey16_mm_strip2": (2, "zeros"),
              "short_none_palette_strip2": (2, "zeros"),
              "short_none_rgba_strip3": (3, "zeros"),
              "short_none_planar2_strip1": (1, "zeros"),
              "short_none_two_strips_first": (0, "zeros"),
              "short_none_strip0_of_4_estimated": (0, "whole"),
              "short_none_tile1_estimated": (1, "whole"),
              "short_none_single_strip_data_there": (0, "whole")}


def _imread(data: bytes, tmp_path, name: str = "probe.tif"):
    import cv2

    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return cv2.imread(path, cv2.IMREAD_GRAYSCALE), cv2.imread(
        path, cv2.IMREAD_COLOR)


def test_short_uncompressed_fixtures_are_all_there():
    assert set(SHORT_NONE) | {"short_none_rows7_estimated_short"} == {
        k for k in RARE if k.startswith("short_none")}


@pytest.mark.parametrize("name", sorted(SHORT_NONE))
def test_short_uncompressed_read_is_cv2s_rule(tmp_path, name):
    """cv2.imread of the file equals its read of the same file with the
    cut chunk's bytes zeroed in full (or with its count whole, where libtiff
    estimates the counts): what the host reader makes of it."""
    data = _bytes(name)
    index, rule = SHORT_NONE[name]
    tags = TF.tags_of(data)
    tiled = 325 in tags
    offs, counts = tags[324 if tiled else 273], tags[325 if tiled else 279]
    full = max(counts)
    if rule == "whole" and len(counts) == 1:
        full = len(data) - offs[0]  # the image's bytes, data beyond them
    fixed = bytearray(data + bytes(max(0, offs[index] + full - len(data))))
    if rule == "zeros":
        fixed[offs[index]:offs[index] + full] = bytes(full)
    fixed = TF.cut_chunk(bytes(fixed), index, full) if full <= 65535 else \
        bytes(fixed)
    want = _imread(bytes(fixed), tmp_path)
    got = _cv2(name)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cv2_read_of_short_strips_depends_on_the_bytes_alone(tmp_path):
    """cv2.imread of every short uncompressed fixture in two fresh
    processes, one reading them in reverse order after other TIFFs (whose
    strips fill libtiff's buffers first): the committed arrays each time."""
    import hashlib
    import subprocess
    import sys

    names = sorted(k for k in RARE if k.startswith("short_none"))
    others = [os.path.join(TIFF_DIR, f"{k}.tif") for k in
              ("rgb8_adobe_deflate", "cmyk8_none", "short_lzw")]
    code = ("import cv2, hashlib, sys\n"
            "for p in sys.argv[1:]:\n"
            "    a = [cv2.imread(p, m) for m in (0, 1)]\n"
            "    print(' '.join(hashlib.sha256(x.tobytes()).hexdigest()\n"
            "                   for x in a))\n")
    paths = [os.path.join(TIFF_DIR, f"{k}.tif") for k in names]
    want = [" ".join(hashlib.sha256(a.tobytes()).hexdigest()
                     for a in _cv2(k)) for k in names]
    for order in (paths, others + paths[::-1]):
        out = subprocess.run([sys.executable, "-c", code, *order],
                             capture_output=True, text=True,
                             check=True).stdout.split("\n")
        got = out[:len(order)][-len(paths):]
        if order is not paths:
            got = got[::-1]
        assert got == want


@functools.lru_cache(maxsize=None)
def _full_size():
    """3200x2130 RGB, grey-16 and palette TIFFs of one strip, of 16-row
    strips and of 256x256 tiles, and the fixture maker (make_fixtures.py
    needs cv2, so it is loaded here, not at import)."""
    mf = _module("make_fixtures")
    rgb = mf.picture(2130, 3200, 5)
    g16 = rgb[..., 0].astype(np.uint16) * 257 + 3
    cmap = (np.arange(3 * 256).reshape(3, 256) * 85 % 65536).astype(
        np.uint16)
    return mf, {
        "one": TF.tiff_bytes(rgb),
        "one_grey16": TF.tiff_bytes(g16, photometric=1),
        "strips16": TF.tiff_bytes(rgb, rows_per_strip=16),
        "strips16_grey16": TF.tiff_bytes(g16, photometric=1,
                                         rows_per_strip=16),
        "strips16_palette": TF.tiff_bytes(rgb[..., 1].copy(), photometric=3,
                                          colormap=cmap, rows_per_strip=16),
        "tiles256": TF.tiff_bytes(rgb, tile=(256, 256))}


# (source, how it is cut): mf._short's (index, keep), or ("count", index,
# byte count) for mf._with_count, or ("end", bytes taken off the file)
# before the count is set whole
FULL_SIZE_CUTS = {
    "one_cut_half": ("one", 0, 1 / 2),
    "one_count_short_data_there": ("one", "count", 0, 100),
    "one_count_past_end": ("one", "end", 5000),
    "one_grey16_cut": ("one_grey16", 0, 1 / 3),
    "one_grey16_count_short_data_there": ("one_grey16", "count", 0, 100),
    "strips16_strip2_half": ("strips16", 2, 1 / 2),
    "strips16_strip0_half": ("strips16", 0, 1 / 2),
    "strips16_last_half": ("strips16", -1, 1 / 2),
    "strips16_strip2_count0": ("strips16", "count", 2, 0),
    "strips16_grey16_strip5": ("strips16_grey16", 5, 1 / 2),
    "strips16_palette_strip9": ("strips16_palette", 9, 1 / 2),
    "tiles256_tile1": ("tiles256", 1, 1 / 5),
    "tiles256_tile3": ("tiles256", 3, 1 / 5)}


@pytest.mark.parametrize("name", sorted(FULL_SIZE_CUTS))
def test_short_uncompressed_rule_holds_at_full_size(host, tmp_path, name):
    """At 3200x2130 libtiff splits a single uncompressed strip into virtual
    strips of about 8 KiB (ChopUpSingleUncompressedStrip, after the byte
    count's estimate), and each of the multi-strip and tiled files' chunks
    is far above that: the host read still refuses where cv2.imread of the
    file returns None and is cv2's array where it reads."""
    mf, sources = _full_size()
    source, *how = FULL_SIZE_CUTS[name]
    data = sources[source]
    if how[0] == "count":
        data = mf._with_count(data, how[1], how[2])
    elif how[0] == "end":
        count = TF.tags_of(data)[279][0]
        data = mf._with_count(data[:-how[1]], 0, count)
    else:
        data = mf._short(data, *how)
    want = _imread(data, tmp_path)
    if want[0] is None:
        assert want[1] is None
        with pytest.raises(ValueError, match=re.escape(images._CODE_ERRORS[4007])):
            TOOL.read(host, data)
        return
    gray, bgr = TOOL.read(host, data)
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", RARE)
def test_card_read_is_cv2(dev, name):
    images.RASTER_COUNTS.reset()
    gray, bgr = images.read_image(os.path.join(TIFF_DIR, f"{name}.tif"), dev)
    want = _cv2(name)
    assert torch.equal(gray.cpu(), torch.as_tensor(want[0]))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want[1]))
    assert (images.RASTER_COUNTS.kernel, images.RASTER_COUNTS.plain) == (1, 0)
    assert images.RASTER_COUNTS.forms.get("cielab", 0) == int(name in LAB)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAB)
def test_card_cielab_form_equals_plain(dev, name):
    r = images.raster_rows(_bytes(name), images._library())
    samples = torch.from_numpy(r.samples).to(dev)
    tables = torch.from_numpy(r.tables).to(dev)
    got = images.raster_to_bgr_kernel(samples, r.form, tables)
    want = images.raster_to_bgr_plain(samples, r.form, tables)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_card_cielab_form_equals_plain_full_size(dev, bits):
    rng = np.random.default_rng(bits)
    lab = rng.integers(0, 1 << bits, (2130, 3200, 3)).astype(
        np.uint8 if bits == 8 else np.uint16)
    data = TF.tiff_bytes(lab, photometric=8, compression=8,
                         rows_per_strip=64)
    r = images.raster_rows(data, images._library())
    samples = torch.from_numpy(r.samples).to(dev)
    tables = torch.from_numpy(r.tables).to(dev)
    got = images.raster_to_bgr_kernel(samples, r.form, tables)
    want = images.raster_to_bgr_plain(samples, r.form, tables)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RARE_REFUSED))
def test_card_refuses(dev, name):
    with pytest.raises(ValueError, match=RARE_REFUSED[name][1]):
        images.read_image(os.path.join(TIFF_DIR, "refused", f"{name}.tif"),
                          dev)
