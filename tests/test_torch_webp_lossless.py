"""The card's lossless (VP8L) and animated WebP reads, held against
cv2.imread on the CPU, without the card.

The JAX package reads every image with OpenCV, lossless and animated WebP
included (an animated file as its first frame on the canvas); the port
reads them on the card: the container is walked in ``io/images.py``
(``webp_container``), the host entropy-decodes a VP8L frame
(``csrc/webp_lossless.h``, built here with g++ and skipped without it),
and three kernels undo its transforms and make cv2's arrays
(``vp8l_predictor_kernel``, ``vp8l_colour_kernel``,
``webp_argb_to_bgr_kernel``: ``csrc/vp8l_transform.h``; their plain twins
in ``io/images.py``). A lossy first frame of an animated file takes the
lossy kernels and is placed on the canvas.

* Every fixture under ``tests/data/webp/lossless`` (``make_lossless.py``):
  the host build, with the kernels' arithmetic run in the predictor's
  wavefront order on one host lane, gives cv2's grey and BGR arrays, 0
  entries differing; the container, transforms and decode counts are the
  ones the fixture script asked for and recorded; between them the
  fixtures hold every transform, all 14 predictor modes (and 14-15), every
  bundling width, the colour cache on and off, meta prefix codes, simple
  and single-symbol codes, 2-D distances and an offset first frame.
* Each plain twin equals the host build, launch by launch, on every
  fixture and on random inputs that cross the predictor's bands.
* ``chip_smoke.py``'s full-size lossless source (3200x2130) through the
  host build gives cv2's recorded hashes.
* What cv2 refuses raises, naming WebP and the cause, on the host path and
  on the card path before any copy to the card (the container's refusals
  before any library load), and the host decoder returns its code.
* ``mpmvs_tpu.pipeline._load_view`` against the port's read of workspaces
  holding a lossless, an oriented and an animated view.
* On the card (``cuda``, skipped without one): each kernel equals its twin
  on every fixture and at 3200x2130, and the fixtures read to cv2's arrays
  with the launches counted, no plain call.

OpenCV and the JAX package are imported inside the CPU tests, so the
``cuda`` tests run where neither is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_webp_lossless.py
"""

import ctypes
import hashlib
import importlib.util
import json
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
LOSSLESS = os.path.join(DATA, "webp", "lossless")
NAMES = sorted(f[:-5] for f in os.listdir(LOSSLESS) if f.endswith(".webp"))
FULL = os.path.join(DATA, "webp", "conversion",
                    "plane_3200x2130_lossless.webp")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(DATA, "webp", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool("check_host_webp")
MAKER = _tool("make_lossless")
REFUSED = TOOL.LOSSLESS_REFUSED
DECODER_REFUSED = sorted(r for r, (code, _) in REFUSED.items() if code)
CONTAINER_REFUSED = sorted(r for r, (code, _) in REFUSED.items()
                           if code is None)


def _bytes(path):
    with open(path if os.path.isabs(path) else os.path.join(DATA, path),
              "rb") as f:
        return f.read()


def _fixture(name):
    return _bytes(os.path.join(LOSSLESS, f"{name}.webp"))


def _cv2_arrays(name):
    want = np.load(os.path.join(LOSSLESS, "cv2_arrays.npz"))
    return want[f"gray_{name}"], want[f"bgr_{name}"]


def _manifest():
    with open(os.path.join(LOSSLESS, "fixtures.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def host_webp(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host WebP decoder")
    return TOOL.build(str(tmp_path_factory.mktemp("host_webp_lossless")))


@pytest.mark.parametrize("name", NAMES)
def test_host_lossless_read_is_cv2(host_webp, name):
    """The host decode and the kernels' arithmetic built for the host (the
    predictor band by band, step by step, lane by lane): cv2's grey and
    BGR, 0 entries differ."""
    want_g, want_bgr = _cv2_arrays(name)
    g, bgr = TOOL.read(host_webp, _fixture(name))
    np.testing.assert_array_equal(bgr, want_bgr)
    np.testing.assert_array_equal(g, want_g)


@pytest.mark.parametrize("name", NAMES)
def test_lossless_plain_twins_equal_host_build(host_webp, name):
    """vp8l_predictor_plain, vp8l_colour_plain and webp_argb_to_bgr_plain
    (a lossy animated frame: the lossy twins), each on the host build's
    input of its launch, equal its output: 0 entries differ."""
    got = TOOL.lossless_plain_mismatches(host_webp, _fixture(name))
    assert got == (0,) * len(got)


@pytest.mark.parametrize("name", NAMES)
def test_lossless_fixture_is_the_manifest(host_webp, name):
    """The container (kind, canvas, offset, size, EXIF orientation) and the
    VP8L header, transform list and decode counts read now are those
    make_lossless.py asked for and recorded."""
    want = _manifest()[name]
    assert MAKER.describe(_fixture(name), host_webp) == want


def test_fixtures_cover_the_lossless_features():
    """Between them the fixtures hold every transform, all 14 predictor
    modes (and 14-15, written by hand), every bundling width, the colour
    cache on and off, meta prefix codes, simple and single-symbol codes,
    2-D distance codes, lossy (with and without ALPH) and lossless first
    frames at offset 0 and at an offset, and EXIF orientations 1-8."""
    m = _manifest()
    ll = [d for d in m.values() if d["kind"] == "lossless"]
    transforms = {t for d in ll for t in d["transforms"]}
    modes = {k for d in ll for k in d.get("modes", [])}
    bundling = {b for d in ll for t, b in zip(d["transforms"], d["bits"])
                if t == images.VP8L_COLOUR_INDEXING}
    colours = {d["colours"] for d in ll if d["colours"]}
    assert transforms == {0, 1, 2, 3}
    assert modes == set(range(16))
    assert bundling == {0, 1, 2, 3} and {2, 4, 16, 256} <= colours
    assert {d["cache_bits"] > 0 for d in ll} == {True, False}
    assert any(d["meta_bits"] for d in ll) and any(d["groups"] > 1
                                                   for d in ll)
    assert all(any(d[k] for d in ll) for k in (
        "simple_codes", "single_codes", "normal_codes", "plane_refs",
        "back_refs", "cache_hits"))
    frames = {(d["kind"], d["offset"] != [0, 0], d["alph"])
              for d in m.values() if d["animated"]}
    assert {("lossy", False, False), ("lossy", False, True),
            ("lossy", True, True), ("lossy", True, False),
            ("lossless", False, False), ("lossless", True, False)} <= frames
    assert {d["exif"] for d in ll if not d["animated"]} == set(range(1, 9))
    assert any(d["size"][0] % 2 for d in ll)
    assert any(d["size"][0] % (1 << b) for d in ll
               for t, b in zip(d["transforms"], d["bits"])
               if t == images.VP8L_PREDICTOR)
    assert [1, 1] in [d["size"] for d in ll]


def test_host_full_size_lossless_is_cv2(host_webp):
    """chip_smoke.py's full-size lossless source (3200x2130) through the
    host build: the sha-256 of its grey and BGR are cv2's, recorded
    beside it."""
    with open(os.path.join(os.path.dirname(FULL), "cv2.json")) as f:
        want = json.load(f)["lossless"]
    data = _bytes(FULL)
    assert hashlib.sha256(data).hexdigest() == want["source_sha256"]
    g, bgr = TOOL.read(host_webp, data)
    sha = lambda a: hashlib.sha256(a.tobytes()).hexdigest()
    assert (sha(g), sha(bgr)) == (want["gray_sha256"], want["bgr_sha256"])


def test_fixtures_hold_what_libwebps_encoder_never_writes():
    """Written bit by bit: 1200 prefix-code groups (libwebp maps more than
    1000 to the used ones), read as cv2 reads them, and a backward
    reference before the first pixel, refused as cv2 refuses it."""
    m = _manifest()["groups_1200"]
    assert m["groups"] == 1200 and m["meta_bits"] == 2
    assert "webp/lossless/refused/backref_before_first_pixel.webp" in REFUSED


@pytest.mark.parametrize("rel", sorted(REFUSED))
def test_host_lossless_read_refuses(host_webp, rel):
    """What cv2 refuses raises on the host path, naming WebP and why."""
    code, cause = REFUSED[rel]
    with pytest.raises(ValueError, match=cause) as e:
        TOOL.read(host_webp, _bytes(rel))
    assert "WebP" in str(e.value)
    if code:
        assert images._CODE_ERRORS[code] in str(e.value)


@pytest.mark.parametrize("rel", DECODER_REFUSED)
def test_host_lossless_decoder_error_codes(host_webp, rel):
    """The host decoder, given the VP8L payload whole (the container's
    header check skipped), refuses it with its own code."""
    data = _bytes(rel)
    payload = dict(images._riff_chunks(data, 12, len(data)))[b"VP8L"]
    info = (ctypes.c_int * 21)()
    argb = np.zeros(1 << 16, np.uint32)
    data = np.zeros(1 << 12, np.uint32)
    err = host_webp.vp8l_host_decode(payload, len(payload), info,
                                     argb.ctypes.data, data.ctypes.data, None)
    assert err == REFUSED[rel][0]
    assert "WebP" in images._CODE_ERRORS[err]


@pytest.mark.parametrize("rel", CONTAINER_REFUSED + [
    r for r in DECODER_REFUSED if REFUSED[r][0] == 5008])
def test_card_lossless_reads_raise_before_the_card(rel):
    """On a CUDA device what the container check refuses raises its cause
    before any library load or copy to the card (so also here, where there
    is neither a card nor nvcc)."""
    for fn in (images.decode, images.decode_colour):
        with pytest.raises(ValueError, match=REFUSED[rel][1]):
            fn(_bytes(rel), "cuda")


@pytest.mark.parametrize("rel", DECODER_REFUSED)
def test_card_lossless_reads_raise_before_any_copy(host_webp, monkeypatch,
                                                   rel):
    """On a CUDA device the host decode's refusals raise before anything
    is copied to the card: with the host build as the card's library, the
    read raises its code's cause before it asks for the device."""
    monkeypatch.setattr(images, "_library", lambda: host_webp)

    def no_copy(device):
        raise AssertionError("reached the card")

    monkeypatch.setattr(images, "_cuda_device", no_copy)
    with pytest.raises(ValueError, match=REFUSED[rel][1]):
        images.decode(_bytes(rel), "cuda")


@pytest.mark.parametrize("name", ["pillow_71x53", "exif_6",
                                  "offset_lossless_flags1",
                                  "animated_lossy_71x53"])
def test_cpu_decode_is_cv2(name):
    """On the CPU the port reads a lossless or animated WebP through
    OpenCV, as the JAX package does."""
    want_g, want_bgr = _cv2_arrays(name)
    g, bgr = images.decode(_fixture(name), "cpu")
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(bgr.numpy(), want_bgr)


# random inputs for the twins against the host build of the kernels'
# arithmetic: (H, W, bits) crossing the predictor's 32-row bands
PREDICTOR_CASES = [(1, 1, 2), (5, 3, 2), (33, 40, 2), (70, 45, 3),
                   (65, 100, 4), (40, 9, 9)]


@pytest.mark.parametrize("H, W, bits", PREDICTOR_CASES)
def test_predictor_twin_equals_host_on_random_modes(host_webp, H, W, bits):
    """vp8l_predictor_plain and the kernel's arithmetic in its order on
    random residuals and random modes 0-15: 0 words differ."""
    rng = np.random.default_rng(H * 1000 + W)
    res = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64).astype(np.uint32)
    tiles = images._subsample(W, bits) * images._subsample(H, bits)
    modes = (rng.integers(0, 2 ** 32, tiles, dtype=np.uint64).astype(
        np.uint32) & ~np.uint32(0xF00)) | (rng.integers(
            0, 16, tiles).astype(np.uint32) << 8)
    out = np.zeros_like(res)
    host_webp.vp8l_host_predictor(res.ctypes.data, modes.ctypes.data, bits,
                                  W, H, out.ctypes.data)
    got = images.vp8l_predictor_plain(torch.from_numpy(res.view(np.int32)),
                                      torch.from_numpy(modes.view(np.int32)),
                                      bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), out)


# (types in the order undone, bits of each) of a colour run
COLOUR_CASES = [((1,), (2,)), ((2,), (0,)), ((3,), (0,)), ((3,), (3,)),
                ((1, 2), (3, 0)), ((1, 2, 3), (4, 0, 1)), ((2, 3), (0, 2))]


@pytest.mark.parametrize("types, bits", COLOUR_CASES)
def test_colour_twin_equals_host_on_random_runs(host_webp, types, bits):
    """vp8l_colour_plain and vp8l_colour_kernel's arithmetic on a random
    image, multipliers and palette (with indices past it): 0 words
    differ."""
    rng = np.random.default_rng(sum(types) * 10 + sum(bits))
    H, W = 23, 37
    run, w = [], W  # widths from the output back
    for t, b in zip(reversed(types), reversed(bits)):
        run.insert(0, (t, b, w))
        if t == images.VP8L_COLOUR_INDEXING:
            w = images._subsample(w, b)
    rnd = lambda n: rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32)
    argb = rnd((H, w))
    ts = []
    for t, b, xs in run:
        data = (rnd(images._subsample(xs, b) * images._subsample(H, b))
                if t == images.VP8L_CROSS_COLOUR else
                np.concatenate([rnd((1 << (8 >> b)) - 1), [0]]).astype(
                    np.uint32) if t == images.VP8L_COLOUR_INDEXING else
                np.zeros(0, np.uint32))
        ts.append(images.VP8LTransform(t, b, xs, data))
    desc, ptrs = TOOL._colour_args(ts)
    desc = [len(ts), w, W, H] + desc
    out = np.zeros((H, W), np.uint32)
    host_webp.vp8l_host_colour(argb.ctypes.data,
                               (ctypes.c_int * len(desc))(*desc), ptrs,
                               out.ctypes.data)
    t32 = lambda a: torch.from_numpy(a.view(np.int32))
    got = images.vp8l_colour_plain(t32(argb), [t._replace(data=t32(t.data))
                                               for t in ts])
    np.testing.assert_array_equal(got.numpy().view(np.uint32), out)


@pytest.mark.parametrize("canvas, offset", [(None, (0, 0)), ((9, 8), (2, 3)),
                                            ((5, 4), (0, 0))])
def test_argb_twin_equals_host(host_webp, canvas, offset):
    """webp_argb_to_bgr_plain and the kernel's arithmetic: 0 entries
    differ, zeros off the frame."""
    rng = np.random.default_rng(3)
    argb = rng.integers(0, 2 ** 32, (4, 5), dtype=np.uint64).astype(
        np.uint32)
    info = images.WebPFile("lossless", b"", None, canvas or (5, 4), offset,
                           (5, 4), canvas is not None)
    want = TOOL.host_canvas(host_webp, argb, info)
    got = images.webp_argb_to_bgr_plain(
        torch.from_numpy(argb.view(np.int32)), canvas, offset)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", ["pillow_71x53", "palette_16", "exif_6",
                                  "offset_lossless_flags1",
                                  "animated_lossy_71x53"])
def test_load_view_of_lossless_matches_jax(tmp_path, monkeypatch, host_webp,
                                           name):
    """The JAX package's _load_view (cv2.imread) and the port's, reading
    the same workspace image (a lossless, oriented or animated WebP named
    00000000.jpg) through the host build: the same grey and BGR arrays and
    camera."""
    from mpmvs_tpu import pipeline as jpipeline

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    shutil.copyfile(os.path.join(LOSSLESS, f"{name}.webp"),
                    os.path.join(ws, "images", "00000000.jpg"))
    g, _ = _cv2_arrays(name)
    scene = make_plane_scene(num_views=1, height=g.shape[0],
                             width=g.shape[1], seed=4)
    write_cam_txt(os.path.join(ws, "cams", "00000000_cam.txt"),
                  scene.cameras.view(0))

    def host_read(path, device):
        with open(path, "rb") as f:
            return tuple(torch.from_numpy(a)
                         for a in TOOL.read(host_webp, f.read()))

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


COUNTERS = ("VP8L_PREDICTOR_COUNTS", "VP8L_COLOUR_COUNTS", "WEBP_ARGB_COUNTS",
            "VP8_RECON_COUNTS", "VP8_FILTER_COUNTS", "WEBP_COLOUR_COUNTS")


def _counts():
    return {k: (getattr(images, k).kernel, getattr(images, k).plain)
            for k in COUNTERS}


def _expected_launches(data):
    """Launches of one read: per kernel counter, from the file's frame."""
    info = images.webp_container(data)
    want = dict.fromkeys(COUNTERS, 0)
    if info.kind == "lossy":
        frame, _ = images.webp_frame(data, images._library())
        want.update(VP8_RECON_COUNTS=1, WEBP_COLOUR_COUNTS=1,
                    VP8_FILTER_COUNTS=int(frame.header["level"] > 0))
    else:
        img = images.vp8l_decode(info.frame, images._library())
        runs = images.vp8l_runs(img.transforms)
        want.update(WEBP_ARGB_COUNTS=1, VP8L_PREDICTOR_COUNTS=sum(
            r[0].type == images.VP8L_PREDICTOR for r in runs))
        want["VP8L_COLOUR_COUNTS"] = len(runs) - want[
            "VP8L_PREDICTOR_COUNTS"]
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_card_lossless_read_is_cv2(dev, name):
    want_g, want_bgr = _cv2_arrays(name)
    path = os.path.join(LOSSLESS, f"{name}.webp")
    launches = _expected_launches(_fixture(name))
    before = _counts()
    bgr = images.read_colour(path, dev)
    assert bgr.device.type == "cuda"
    assert torch.equal(bgr.cpu(), torch.as_tensor(want_bgr))
    g, bgr2 = images.read_image(path, dev)
    assert torch.equal(g.cpu(), torch.as_tensor(want_g))
    assert torch.equal(bgr2.cpu(), torch.as_tensor(want_bgr))
    after = _counts()
    assert {k: after[k][0] - before[k][0] for k in COUNTERS} == {
        k: 2 * v for k, v in launches.items()}
    assert all(after[k][1] == before[k][1] for k in COUNTERS)


@pytest.mark.cuda
@pytest.mark.parametrize("rel", sorted(REFUSED))
def test_card_lossless_read_refuses(dev, rel):
    with pytest.raises(ValueError, match=REFUSED[rel][1]):
        images.read_image(os.path.join(DATA, rel), dev)


def _kernels_vs_plain(dev, data):
    """Each lossless kernel against its twin on the same CUDA inputs, launch
    by launch: entries that differ (each inverse-transform launch, then
    the conversion)."""
    img, info, _ = images.vp8l_frame(data, images._library())
    argb, transforms = images.vp8l_upload(img, dev)
    out = []
    for run in images.vp8l_runs(transforms):
        if run[0].type == images.VP8L_PREDICTOR:
            got = images.vp8l_predictor_kernel(argb, run[0].data,
                                               run[0].bits)
            want = images.vp8l_predictor_plain(argb, run[0].data,
                                               run[0].bits)
        else:
            got = images.vp8l_colour_kernel(argb, run)
            want = images.vp8l_colour_plain(argb, run)
        out.append(int((got != want).sum()))
        argb = got
    got = images.webp_argb_to_bgr_kernel(argb, info.canvas, info.offset)
    want = images.webp_argb_to_bgr_plain(argb, info.canvas, info.offset)
    out.append(sum(int((a != b).sum()) for a, b in zip(got, want)))
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n_ for n_ in NAMES if _manifest()[n_][
    "kind"] == "lossless"])
def test_lossless_kernels_equal_plain(dev, name):
    got = _kernels_vs_plain(dev, _fixture(name))
    assert got == (0,) * len(got)


@pytest.mark.cuda
@pytest.mark.parametrize("H, W, bits", PREDICTOR_CASES + [(2130, 3200, 5)])
def test_predictor_kernel_equals_plain_on_random_modes(dev, H, W, bits):
    g = torch.Generator().manual_seed(H + W)
    res = torch.randint(-2 ** 31, 2 ** 31, (H, W), generator=g,
                        dtype=torch.int64).to(torch.int32).to(dev)
    tiles = images._subsample(W, bits) * images._subsample(H, bits)
    modes = (torch.randint(0, 16, (tiles,), generator=g) << 8).to(
        torch.int32).to(dev)
    got = images.vp8l_predictor_kernel(res, modes, bits)
    want = images.vp8l_predictor_plain(res, modes, bits)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_lossless_kernels_equal_plain_full_size(dev):
    """At 3200x2130 (chip_smoke.py's source), and the read's hashes are
    cv2's."""
    data = _bytes(FULL)
    got = _kernels_vs_plain(dev, data)
    assert got == (0,) * len(got)
    with open(os.path.join(os.path.dirname(FULL), "cv2.json")) as f:
        want = json.load(f)["lossless"]
    g, bgr = images.decode(data, dev)
    sha = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    assert (sha(g), sha(bgr)) == (want["gray_sha256"], want["bgr_sha256"])
