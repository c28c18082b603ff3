"""libjpeg-turbo's inter-block smoothing of progressive JPEGs on the card,
held against cv2 and the JAX package on the CPU.

* Every progressive fixture under ``tests/data/jpeg/truncated`` (cv2's
  4:2:0, 4:2:2, 4:4:0, 4:4:4, grey and restart encodes and Pillow's CMYK
  and YCCK, Huffman and arithmetic-coded, cut before every scan and inside
  every scan, and a whole arithmetic file whose script stops at Al 1): the
  host decoder's latch (``jpeg_entropy::smoothing``, libjpeg's
  smoothing_ok) says whether libjpeg smooths it, and the smoothing's
  arithmetic built for the host (``csrc/jpeg_smooth.h``, as
  ``jpeg_smooth_kernel``'s threads run it) equals the plain twin
  (``images.jpeg_smooth_plain``) block for block; the reads themselves are
  held to cv2's arrays by tests/test_torch_jpeg_arith.py.
* The latch's rules: set when a scan starts, the rows past the last one
  the input had data for on the status from before the scan, no smoothing
  of a sequential or a whole simple-progression file.
* The host build and the twin on random coefficients and latches: every
  sampling factor, the iMCU-row walk's edges, both estimate forms.
* libjpeg-turbo's SIMD IDCT (``csrc/jpeg_idct.h``), which the smoothed and
  the cut files' blocks reach past jidctint's range: cv2 reads coefficient
  blocks of every magnitude, with 8- and 16-bit tables, as the host decode
  does.
* chip_smoke.py phase 8f's 3200x2130 source reads as cv2 reads it.
* ``mpmvs_tpu.pipeline._load_view`` and the port's read the same grey, BGR
  and camera from a cut progressive workspace image.
* On the card (``cuda``): the kernel against the twin on every fixture and
  at 3200x2130, and the reads with their launches.

    python -m pytest --noconftest -m cuda tests/test_torch_jpeg_smooth.py
"""

import hashlib
import importlib.util
import json
import os
import shutil
import struct
import sys

import numpy as np
import pytest
import torch

from mpmvs_torch import pipeline as tpipeline
from mpmvs_torch.io import images
from mpmvs_torch.io.cams import write_cam_txt
from mpmvs_torch.utils.synthetic import make_plane_scene

from torch_parity import CAMERA_FIELDS, n

torch.set_num_threads(1)

JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
TRUNCATED = os.path.join(JPEG, "truncated")
SMOOTHED = sorted(f[:-4] for f in os.listdir(TRUNCATED)
                  if f.startswith("prog_") and f.endswith(".jpg")) + [
    "arith_420_stops_at_al1"]


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(JPEG, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _module("check_host_decoder")


def _bytes(name):
    with open(os.path.join(TRUNCATED, f"{name}.jpg"), "rb") as f:
        return f.read()


def _cv2(name):
    want = np.load(os.path.join(TRUNCATED, "cv2_arrays.npz"))
    return want[f"gray_{name}"], want[f"bgr_{name}"]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host decoder")
    return TOOL.build(str(tmp_path_factory.mktemp("host_smooth")))


@pytest.fixture(scope="module")
def maker():
    sys.path.insert(0, JPEG)
    return _module("make_truncated")


@pytest.mark.parametrize("name", SMOOTHED)
def test_smoothing_arithmetic_equals_plain(host, name):
    """jpeg_smooth.h built for the host, a block at a time as the kernel's
    threads run it, equals the plain twin on each component of each
    fixture libjpeg smooths."""
    data = _bytes(name)
    latch = TOOL.smoothing(host, data)
    coefs = TOOL.coefficients(host, data)[0]
    for coef, p in zip(coefs, latch):
        assert coef.shape == (p.blocks_h, p.blocks_w, 64)
        got = TOOL.smooth_host(host, coef, p)
        want = images.jpeg_smooth_plain(torch.from_numpy(coef), p).numpy()
        np.testing.assert_array_equal(got, want)


def test_every_fixture_but_cuts_in_the_last_scans_is_smoothed(host):
    """libjpeg sets a scan's status when the scan starts: a cut inside the
    last scans (each finishing its coefficients' bits) is not smoothed, a
    cut anywhere before them is."""
    for name in SMOOTHED:
        smoothed = bool(TOOL.smoothing(host, _bytes(name)))
        assert smoothed == (name not in NOT_SMOOTHED), name


# the cuts libjpeg reads unsmoothed: inside the last scan of the YCbCr and
# grey scripts (every coefficient's last bit known when it starts), and
# inside the four-component script's last four, each a component's
NOT_SMOOTHED = {f"prog_{a}{k}_in_s{s}"
                for k in ("420", "422", "440", "444", "420_restart2")
                for a, s in (("", 10), ("arith_", 10))} | {
    "prog_grey_in_s6", "prog_arith_grey_in_s6"} | {
    f"prog_{a}{k}_in_s18" for k in ("cmyk", "ycck")
    for a in ("", "arith_")}


def test_latch_of_a_cut_scan(host, maker):
    """A 4:2:0 file cut inside its second scan (Y's first AC band, Al 2):
    Y's AC 1-5 at 2 from the scan's start, its rows past the cut on the
    status before the scan (-1, the DC path); Cb and Cr on their DC scan's
    (-1), and before it, set by the first scan (0)."""
    data = maker.sources()["420"]
    _, start, end = maker.scan_starts(data)[1]
    y, cb, cr = TOOL.smoothing(host, data[:(start + end) // 2])
    assert y.bits == (1, 2, 2, 2, 2, 2, -1, -1, -1, -1)
    assert y.prev[1:] == (-1,) * 9
    assert cb.bits == cr.bits == (1,) + (-1,) * 9
    assert cb.prev[1:] == cr.prev[1:] == (0,) * 9
    assert 0 <= y.last_good < y.total_imcu_rows - 1
    whole = TOOL.smoothing(host, data[:end])
    assert whole[0].last_good == whole[0].total_imcu_rows - 1


def test_whole_and_sequential_files_are_not_smoothed(host, maker):
    for data in maker.sources().values():
        assert TOOL.smoothing(host, data) == ()
    with open(os.path.join(JPEG, "420_q95.jpg"), "rb") as f:
        assert TOOL.smoothing(host, f.read()) == ()


def test_script_that_stops_at_al1_is_smoothed(host):
    """A whole arithmetic-coded file whose every coefficient stops at Al 1:
    libjpeg smooths it, estimates clamped below 2."""
    (y, cb, cr) = TOOL.smoothing(host, _bytes("arith_420_stops_at_al1"))
    for p in (y, cb, cr):
        assert p.bits == (1,) * 10
        assert p.last_good == p.total_imcu_rows - 1


def _random_case(rng, v: int, hib: int, wib: int):
    """Random coefficients and a latch for a component of factor v."""
    total = -(-hib // v)
    bh, bw = total * v, wib + int(rng.integers(0, 3))
    coef = np.zeros((bh, bw, 64), np.int16)
    coef[..., 0] = rng.integers(-900, 900, (bh, bw))
    mask = rng.random((bh, bw, 64)) < 0.3
    coef[mask] = rng.integers(-9, 10, int(mask.sum()))
    pick = lambda: tuple(int(x) for x in rng.choice([-1, 0, 1, 2, 3], 10))
    bits, prev = pick(), pick()
    if rng.random() < 0.5:  # the DC-only path
        bits = (bits[0],) + (-1,) * 9
    return coef, images.Smoothing(
        bw, bh, wib, hib, v, total, int(rng.integers(-1, total)), bits,
        prev, tuple(int(x) for x in rng.integers(1, 120, 10)))


@pytest.mark.parametrize("v", [1, 2, 3, 4])
def test_smoothing_arithmetic_equals_plain_random(host, v):
    """Random coefficients and latches (every v factor, heights whose last
    iMCU row holds 1 to v block rows, widths of 1 to 9 blocks, either
    estimate form, rows on either side of last_good): host build and twin
    equal, block for block."""
    rng = np.random.default_rng(v)
    for hib in range(1, 4 * v + 2):
        coef, p = _random_case(rng, v, hib, int(rng.integers(1, 10)))
        got = TOOL.smooth_host(host, coef, p)
        want = images.jpeg_smooth_plain(torch.from_numpy(coef), p).numpy()
        np.testing.assert_array_equal(got, want)


def test_window_rows_are_libjpegs():
    """The rows the window reads: clamped in the image, the MCU padding's
    row read two rows above the last iMCU row of one block row, and the
    last iMCU row indexed by its own count (v 2, 3 block rows: row 2 reads
    row 1 twice above it)."""
    p = images.Smoothing(1, 6, 1, 5, 2, 3, 2, (0,) * 10, (0,) * 10,
                         (1,) * 10)
    rows = images._smooth_rows(p)
    assert rows[3].tolist() == [1, 2, 3, 4, 5]  # row 5: the padding's
    assert rows[4].tolist() == [2, 3, 4, 4, 4]
    q = p._replace(blocks_h=4, height_in_blocks=3, total_imcu_rows=2)
    assert images._smooth_rows(q)[2].tolist() == [1, 1, 2, 2, 2]


def _extreme_jpeg(seed: int, sixteen: bool):
    """A grey arithmetic-coded JPEG of random coefficient blocks up to
    +-30000 (some DC-only and row-0-only), with an 8- or 16-bit table."""
    jf = _module("jpeg_file")
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 65536 if sixteen else 256, 64)
    coef = rng.integers(-30000, 30001, (5, 7, 64))
    coef[rng.random(coef.shape) < 0.4] = 0
    coef[0, 0, 8:] = 0
    coef[0, 1, 1:] = 0
    coef[1, 1, 8:] = 0
    zz = [int(q[k]) for k in jf.ZIGZAG.reshape(-1)]
    body = bytes([0x10 if sixteen else 0]) + (
        struct.pack(">64H", *zz) if sixteen else bytes(zz))
    return jf.arithmetic_jpeg([coef.astype(np.int16)], [(1, 1)], (37, 51),
                              jf.segment(0xDB, body))


@pytest.mark.parametrize("seed,sixteen", [(1, False), (2, True),
                                          (3, False), (4, True)])
def test_idct_is_libjpeg_turbos_simd_form(host, tmp_path, seed, sixteen):
    """cv2 (libjpeg-turbo's AVX2 islow IDCT) reads blocks whose sums leave
    jidctint's range (16-bit wraps, saturation, the DC shortcut) as the
    host decode with jpeg_idct.h does."""
    import cv2

    data = _extreme_jpeg(seed, sixteen)
    path = str(tmp_path / "extreme.jpg")
    with open(path, "wb") as f:
        f.write(data)
    gray, _ = TOOL.decode(host, data)
    np.testing.assert_array_equal(gray, cv2.imread(path,
                                                   cv2.IMREAD_GRAYSCALE))


def test_conversion_source_is_read_as_cv2_reads_it(host):
    """Phase 8f's 3200x2130 progressive source cut inside its sixth scan:
    the host read's hashes are cv2's (conversion/cv2.json)."""
    with open(os.path.join(JPEG, "conversion", "cv2.json")) as f:
        rec = json.load(f)["progressive_cut"]
    with open(os.path.join(JPEG, "conversion",
                           "plane_3200x2130_progressive_cut.jpg"), "rb") as f:
        data = f.read()
    sha = lambda b: hashlib.sha256(b).hexdigest()
    assert sha(data) == rec["source_sha256"]
    assert TOOL.smoothing(host, data)
    gray, bgr = TOOL.decode(host, data)
    assert sha(gray.tobytes()) == rec["gray_sha256"]
    assert sha(bgr.tobytes()) == rec["bgr_sha256"]


@pytest.mark.parametrize("name", ["prog_420_in_s4", "prog_arith_422_in_s2",
                                  "prog_ycck_after_s5"])
def test_load_view_of_cut_progressive_matches_jax(tmp_path, monkeypatch,
                                                  host, name):
    """The JAX package's _load_view (cv2.imread) and the port's, reading
    the same cut progressive workspace image through the host decoder, its
    smoothing and the colour kernels' plain version: the same grey and BGR
    arrays and camera."""
    from mpmvs_tpu import pipeline as jpipeline

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    shutil.copyfile(os.path.join(TRUNCATED, f"{name}.jpg"),
                    os.path.join(ws, "images", "00000000.jpg"))
    g, _ = _cv2(name)
    scene = make_plane_scene(num_views=1, height=g.shape[0], width=g.shape[1],
                             seed=4)
    write_cam_txt(os.path.join(ws, "cams", "00000000_cam.txt"),
                  scene.cameras.view(0))

    def host_read(path, device):
        with open(path, "rb") as f:
            return tuple(torch.from_numpy(a) for a in TOOL.decode(host,
                                                                  f.read()))

    monkeypatch.setattr(tpipeline.image_io, "read_image", host_read)
    got = tpipeline._load_view(ws, 0, 3200, "cpu")
    want = jpipeline._load_view(ws, 0, 3200)
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.color, np.asarray(want.color))
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(n(getattr(got.camera, f)),
                                      np.asarray(getattr(want.camera, f)))


def test_smoothing_kernel_refuses_cpu_tensors():
    p = images.Smoothing(1, 1, 1, 1, 1, 1, 0, (0,) * 10, (0,) * 10,
                         (1,) * 10)
    with pytest.raises(ValueError, match="CUDA"):
        images.jpeg_smooth_kernel(torch.zeros((1, 1, 64), dtype=torch.int16),
                                  p)


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMOOTHED)
def test_card_smoothing_equals_plain(dev, name):
    handle, info = images.host_decode(_bytes(name))
    comps, _, layout = images.upload_coefficients(handle, info, dev)
    images.SMOOTH_COUNTS.reset()
    for (coef, *_), p in zip(comps, layout.smooth):
        got = images.jpeg_smooth_kernel(coef, p)
        assert torch.equal(got, images.jpeg_smooth_plain(coef, p))
    assert images.SMOOTH_COUNTS.kernel == len(layout.smooth)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMOOTHED)
def test_card_read_is_cv2(dev, name):
    """read_image on the card: cv2's arrays, one smoothing launch a
    component where libjpeg smooths, none of the plain twin."""
    images.SMOOTH_COUNTS.reset()
    gray, bgr = images.read_image(os.path.join(TRUNCATED, f"{name}.jpg"),
                                  dev)
    want = _cv2(name)
    assert torch.equal(gray.cpu(), torch.as_tensor(want[0]))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want[1]))
    smoothed = name not in NOT_SMOOTHED
    ncomp = 4 if "cmyk" in name or "ycck" in name else (
        1 if "grey" in name else 3)
    assert images.SMOOTH_COUNTS.kernel == (ncomp if smoothed else 0)
    assert images.SMOOTH_COUNTS.plain == 0


@pytest.mark.cuda
def test_card_smoothing_equals_plain_full_size(dev):
    path = os.path.join(JPEG, "conversion",
                        "plane_3200x2130_progressive_cut.jpg")
    with open(path, "rb") as f:
        handle, info = images.host_decode(f.read())
    comps, _, layout = images.upload_coefficients(handle, info, dev)
    assert layout.smooth
    for (coef, *_), p in zip(comps, layout.smooth):
        assert torch.equal(images.jpeg_smooth_kernel(coef, p),
                           images.jpeg_smooth_plain(coef, p))
