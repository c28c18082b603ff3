"""Arithmetic-coded JPEGs (SOF9, SOF10) on the card, held against cv2 and
the JAX package on the CPU.

* Every fixture under ``tests/data/jpeg/arith`` (4:2:0, 4:2:2, 4:4:4 and
  grey, sequential and progressive, restarts (one with fill bytes before
  its RSTn markers), DAC conditioning, CMYK and
  YCCK, EXIF orientations, 1-4 pixels wide, and the Huffman stream marked
  SOF9 that cv2 reads anyway) and under ``truncated`` (streams cut short):
  the host decoder (``csrc/jpeg_arith.h`` in ``jpeg_entropy.h``, built with
  g++ by ``tests/data/jpeg/check_host_decoder.py``), the IDCT it builds and
  the colour kernels' plain version give ``cv2.imread``'s grey and BGR
  arrays, 0 entries differing.
* The fixture writer (``jpeg_file.arithmetic_jpeg``, a port of jcarith.c)
  held to libjpeg: each committed transcode is the writer's bytes of its
  Huffman original's coefficients, and cv2 reads it equal to the original;
  the host decoder reads back the coefficients the writer coded on random
  blocks of every magnitude, sequential and progressive, with restarts and
  conditioning.
* A true arithmetic-coded lossless file (SOF11) and a hierarchical one stay
  refused, with their codes, and cv2 refuses both.
* chip_smoke.py phase 8e's 3200x2130 source reads as cv2 reads it (the
  hashes in ``conversion/cv2.json``).
* ``mpmvs_tpu.pipeline._load_view`` and the port's read the same grey, BGR
  and camera from an arithmetic-coded workspace image.
* On the card (``cuda``): each fixture through ``images.read_image``, its
  launches counted.

    python -m pytest --noconftest -m cuda tests/test_torch_jpeg_arith.py
"""

import hashlib
import importlib.util
import json
import os
import shutil
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
ARITH = os.path.join(JPEG, "arith")
NAMES = sorted(f[:-4] for f in os.listdir(ARITH) if f.endswith(".jpg"))
TRUNCATED = sorted(f[:-4] for f in os.listdir(os.path.join(JPEG, "truncated"))
                   if f.endswith(".jpg"))
REFUSED = {"refused/arithmetic_lossless": (2007, "arithmetic-coded lossless"),
           "refused/hierarchical": (2008, "hierarchical")}


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(JPEG, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _module("check_host_decoder")


def _bytes(rel):
    with open(os.path.join(JPEG, f"{rel}.jpg"), "rb") as f:
        return f.read()


def _cv2(folder, name):
    want = np.load(os.path.join(JPEG, folder, "cv2_arrays.npz"))
    return want[f"gray_{name}"], want[f"bgr_{name}"]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host decoder")
    return TOOL.build(str(tmp_path_factory.mktemp("host_arith")))


@pytest.mark.parametrize("name", NAMES)
def test_host_read_is_cv2(host, name):
    gray, bgr = TOOL.decode(host, _bytes(f"arith/{name}"))
    want = _cv2("arith", name)
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.mark.parametrize("name", TRUNCATED)
def test_host_read_of_cut_stream_is_cv2(host, name):
    """A stream cut short: libjpeg's insufficient-data rule (Huffman: the
    scan's later MCUs stay zero) and the QM decoder's zeros past the
    data."""
    gray, bgr = TOOL.decode(host, _bytes(f"truncated/{name}"))
    want = _cv2("truncated", name)
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.fixture(scope="module")
def maker():
    sys.path.insert(0, JPEG)
    return _module("make_arith_lossless")


@pytest.mark.parametrize("name", sorted(set(NAMES) - {"patched_sof9",
                                                     "fill_restart3_420"}))
def test_transcode_is_the_writers_and_reads_as_its_original(host, maker,
                                                            tmp_path, name):
    """The committed file is jcarith.c's port's transcode of its Huffman
    original, and cv2 reads the two alike, grey and BGR: the writer held to
    libjpeg."""
    import cv2

    src, kw = maker.ARITH[name]
    original = _bytes(src)
    data = maker.transcode(host, original, **kw)
    assert data == _bytes(f"arith/{name}")
    paths = [str(tmp_path / "a.jpg"), str(tmp_path / "h.jpg")]
    for p, b in zip(paths, (data, original)):
        with open(p, "wb") as f:
            f.write(b)
    for mode in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
        a, b = (cv2.imread(p, mode) for p in paths)
        assert a is not None
        np.testing.assert_array_equal(a, b)


def test_fill_bytes_before_restarts_read_as_without(host, maker, tmp_path):
    """``fill_restart3_420`` is ``restart3_420`` with a fill byte 0xFF before
    each RSTn marker, and cv2 reads the two alike: the QM decoder finds the
    marker code past the fill bytes."""
    import cv2

    plain = _bytes("arith/restart3_420")
    filled = _bytes("arith/fill_restart3_420")
    assert filled == maker.with_fill(plain) and len(filled) > len(plain)
    paths = [str(tmp_path / "f.jpg"), str(tmp_path / "p.jpg")]
    for p, b in zip(paths, (filled, plain)):
        with open(p, "wb") as f:
            f.write(b)
    for mode in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR):
        a, b = (cv2.imread(p, mode) for p in paths)
        np.testing.assert_array_equal(a, b)
    for got, want in zip(TOOL.decode(host, filled), TOOL.decode(host, plain)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    {}, {"progressive": True}, {"restart": 1},
    {"progressive": True, "restart": 3,
     "dac": {("dc", 0): (3, 9), ("ac", 0): 1}},
    {"dac": {("dc", 0): (0, 15), ("ac", 0): 63}, "interleave": False}],
    ids=["sequential", "progressive", "restart1", "progressive_dac",
         "scans_dac"])
def test_decoder_reads_back_the_writers_coefficients(host, maker, case):
    """Random quantized blocks of every magnitude (up to +-1023 AC and
    +-2047 DC differences), 4:2:0: the host decoder reads back every
    coefficient the writer coded, padding blocks of interleaved MCUs
    too."""
    jf = maker.jf
    rng = np.random.default_rng(len(str(case)))
    shapes = [(6, 8), (3, 4), (3, 4)]
    coefs = []
    for bh, bw in shapes:
        c = np.where(rng.random((bh, bw, 64)) < 0.3,
                     rng.integers(-1023, 1024, (bh, bw, 64)),
                     rng.integers(-3, 4, (bh, bw, 64)))
        c[..., 0] = rng.integers(-1024, 1024, (bh, bw))
        coefs.append(c.astype(np.int64))
    tables = jf.segment(0xDB, bytes([0]) + bytes([1] * 64))
    data = jf.arithmetic_jpeg(coefs, [(2, 2), (1, 1), (1, 1)], (45, 59),
                              tables, **case)
    got = TOOL.coefficients(host, data)[0]
    for g, c in zip(got, coefs):  # every block is coded, here
        np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_host_refuses_what_cv2_refuses(host, tmp_path, name):
    import cv2

    data = _bytes(name)
    assert TOOL.status(host, data) == REFUSED[name][0]
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path, cv2.IMREAD_GRAYSCALE) is None
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None


def test_conversion_source_is_read_as_cv2_reads_it(host):
    """chip_smoke.py phase 8e's arithmetic source (3200x2130, 4:2:0):
    conversion/cv2.json holds the sha-256 of the file and of cv2's grey,
    BGR and converted workspace image of it, and the host decoder gives
    those arrays."""
    import cv2

    with open(os.path.join(JPEG, "conversion", "cv2.json")) as f:
        want = json.load(f)["arith"]
    path = os.path.join(JPEG, "conversion", "plane_3200x2130_arith.jpg")
    with open(path, "rb") as f:
        data = f.read()
    sha = lambda b: hashlib.sha256(b).hexdigest()
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    assert {k: want[k] for k in ("source_sha256", "gray_sha256",
                                 "bgr_sha256", "workspace_sha256")} == {
        "source_sha256": sha(data),
        "gray_sha256": sha(cv2.imread(path,
                                      cv2.IMREAD_GRAYSCALE).tobytes()),
        "bgr_sha256": sha(bgr.tobytes()),
        "workspace_sha256": sha(cv2.imencode(".jpg", bgr)[1].tobytes())}
    gray, got = TOOL.decode(host, data)
    assert (sha(gray.tobytes()), sha(got.tobytes())) == (
        want["gray_sha256"], want["bgr_sha256"])


@pytest.mark.parametrize("name", ["420", "progressive_restart2", "ycck",
                                  "exif6"])
def test_load_view_of_arith_matches_jax(tmp_path, monkeypatch, host, name):
    """The JAX package's _load_view (cv2.imread) and the port's, reading
    the same arithmetic-coded workspace image through the host decoder and
    the colour kernels' plain version: the same grey and BGR arrays and
    camera."""
    from mpmvs_tpu import pipeline as jpipeline

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    shutil.copyfile(os.path.join(ARITH, f"{name}.jpg"),
                    os.path.join(ws, "images", "00000000.jpg"))
    g, _ = _cv2("arith", name)
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


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [f"arith/{k}" for k in NAMES]
                         + [f"truncated/{k}" for k in TRUNCATED])
def test_card_read_is_cv2(dev, name):
    """read_image on the card: cv2's arrays; one IDCT launch a component
    and one colour launch, no plain call, and the read counted as an
    arithmetic-coded one where it is."""
    folder, stem = name.split("/")
    handle, info = images.host_decode(_bytes(name))
    images._library().jpeg_host_free(handle)
    for c in (images.IDCT_COUNTS, images.COUNTS, images.CODEC_COUNTS):
        c.reset()
    gray, bgr = images.read_image(os.path.join(JPEG, f"{name}.jpg"), dev)
    want = _cv2(folder, stem)
    assert torch.equal(gray.cpu(), torch.as_tensor(want[0]))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want[1]))
    assert (images.IDCT_COUNTS.kernel, images.IDCT_COUNTS.plain,
            images.COUNTS.kernel, images.COUNTS.plain) == (info[0], 0, 1, 0)
    assert images.CODEC_COUNTS.forms.get("jpeg_arith", 0) == \
        info[images.INFO_ARITHMETIC]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REFUSED))
def test_card_refuses(dev, name):
    with pytest.raises(ValueError, match=REFUSED[name][1]):
        images.read_image(os.path.join(JPEG, f"{name}.jpg"), dev)
