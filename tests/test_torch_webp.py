"""The card's lossy WebP reads, held against cv2.imread on the CPU, without
the card.

The JAX package reads every image with OpenCV, lossy WebP included; the
port reads it on the card: the host parses the RIFF and the VP8 frame and
entropy-decodes every macroblock (``csrc/webp_decode.h``, built here with
g++ and skipped without it), and three kernels rebuild, filter and convert
it (``vp8_reconstruct_kernel``, ``vp8_loop_filter_kernel``,
``webp_yuv_to_bgr_kernel``: ``csrc/vp8_recon.h``, ``vp8_filter.h``,
``webp_colour.h``; their plain twins in ``io/images.py``).

* Every fixture under ``tests/data/webp`` (sizes 1x1 to 8x300, qualities 5
  and 100, noisy and flat images, the simple and normal filters, sharpness
  0-7, no filter, 1-4 segments, 1/2/4/8 token partitions, ALPH, ICCP, EXIF
  orientations 1-8): the host decode with the kernels' arithmetic built for
  the host, run in the wavefront's order, gives cv2's grey and BGR arrays,
  0 entries differing; the frame header it reads is the one
  ``make_fixtures.py`` read.
* Each plain twin equals the host build, stage by stage, on every fixture.
* The full-size source of ``chip_smoke.py``'s ``phase_webp_parts``
  (3200x2130) read through the host build gives cv2's recorded hashes.
* What stays refused (truncated, a RIFF that is not WEBP, a VP8X canvas
  other than the frame) raises, naming WebP and the cause, before any
  library load or copy to the card; the host decoder's error codes name
  the same. Lossless and animated files read
  (``tests/test_torch_webp_lossless.py``).
* ``mpmvs_tpu.pipeline._load_view`` against the port's read of a workspace
  whose ``00000000.jpg`` holds WebP bytes: equal arrays and camera.
* On the card (``cuda``, skipped without one): the fixtures read to cv2's
  arrays through the three kernels, each kernel equals its plain twin, also
  at 3200x2130, and the counters count the launches, no plain call.

OpenCV and the JAX package are imported inside the CPU tests, so the
``cuda`` tests run where neither is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_webp.py
"""

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
WEBP_DIR = os.path.join(DATA, "webp")
NAMES = sorted(f[:-5] for f in os.listdir(WEBP_DIR) if f.endswith(".webp"))
FULL = os.path.join(WEBP_DIR, "conversion", "plane_3200x2130.webp")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "check_host_webp", os.path.join(WEBP_DIR, "check_host_webp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
# the host decoder's code of each refused file, where it reaches the host
# (the lossless and animated files once here now read:
# tests/test_torch_webp_lossless.py)
CODES = {"webp/refused/truncated.webp": 5001,
         "webp/refused/not_webp.webp": 5002}


def _bytes(rel):
    with open(os.path.join(DATA, rel), "rb") as f:
        return f.read()


def _cv2_arrays(name):
    want = np.load(os.path.join(WEBP_DIR, "cv2_arrays.npz"))
    return want[f"gray_{name}"], want[f"bgr_{name}"]


@pytest.fixture(scope="module")
def host_webp(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host WebP decoder")
    return TOOL.build(str(tmp_path_factory.mktemp("host_webp")))


@pytest.mark.parametrize("name", NAMES)
def test_host_webp_read_is_cv2(host_webp, name):
    """The host decode and the three kernels' arithmetic built for the host
    (MBs in anti-diagonal order): cv2's grey and BGR, 0 entries differ."""
    want_g, want_bgr = _cv2_arrays(name)
    g, bgr = TOOL.read(host_webp, _bytes(f"webp/{name}.webp"))
    np.testing.assert_array_equal(bgr, want_bgr)
    np.testing.assert_array_equal(g, want_g)


@pytest.mark.parametrize("name", NAMES)
def test_plain_twins_equal_host_build(host_webp, name):
    """vp8_reconstruct_plain, vp8_loop_filter_plain and
    webp_yuv_to_bgr_plain, each on the host build's input of its stage,
    equal the host build's output: 0 entries differ."""
    assert TOOL.plain_mismatches(host_webp,
                                 _bytes(f"webp/{name}.webp")) == (0, 0, 0)


@pytest.mark.parametrize("name", NAMES)
def test_host_header_is_the_fixtures(host_webp, name):
    """The frame header the host decoder reads (size, filter type, level,
    sharpness, partitions, segmentation, base quantizer) is the one
    make_fixtures.py read and asked libwebp for."""
    want = TOOL.header_fields()[name]
    frame, _ = images.webp_frame(_bytes(f"webp/{name}.webp"), host_webp)
    got = frame.header
    for k in ("width", "height", "simple", "level", "sharpness",
              "partitions", "use_segment", "update_map", "base_q"):
        assert got[k] == want[k], k
    assert got["filter_type"] == (0 if want["level"] == 0 else
                                  1 if want["simple"] else 2)
    assert frame.records.shape == (got["mb_w"] * got["mb_h"], 4)


@pytest.mark.parametrize("name", ["lf_deltas", "lf_deltas_clipped"])
def test_loop_filter_deltas_are_read(host_webp, name):
    """Frames whose header carries the loop filter's reference and mode
    deltas (libwebp's encoder never writes them): the host decoder reads
    them, the filter levels of intra and sub-block MBs move by them
    (clipped to 0-63), and the read is cv2's."""
    want = TOOL.header_fields()[name]["lf_deltas"]
    frame, _ = images.webp_frame(_bytes(f"webp/{name}.webp"), host_webp)
    level = frame.header["level"] + want[0]
    lim = frame.params[24:48].reshape(4, 2, 3)[0]  # segment 0: i16, i4x4
    for i4x4 in (0, 1):
        lv = min(63, max(0, level + (want[4] if i4x4 else 0)))
        assert lim[i4x4][0] == (2 * lv + lim[i4x4][1] if lv else 0)
    g, bgr = TOOL.read(host_webp, _bytes(f"webp/{name}.webp"))
    want_g, want_bgr = _cv2_arrays(name)
    np.testing.assert_array_equal(bgr, want_bgr)
    np.testing.assert_array_equal(g, want_g)


def test_fixtures_cover_the_frame_features(host_webp):
    """Between them the fixtures hold both filters, every sharpness, no
    filter, each high-edge-variance threshold, 1-4 segments, 1/2/4/8 token
    partitions, skipped MBs, both luma forms and every sub-block mode."""
    seen = {k: set() for k in ("filter", "sharpness", "hev", "segments",
                               "partitions", "i4x4", "submodes", "skipped",
                               "ymode")}
    for name in NAMES:
        frame, _ = images.webp_frame(_bytes(f"webp/{name}.webp"), host_webp)
        h, r = frame.header, frame.records
        seen["filter"].add(h["filter_type"])
        seen["partitions"].add(h["partitions"])
        if h["filter_type"]:
            seen["sharpness"].add(h["sharpness"])
            seen["hev"].update(frame.params[24:48].reshape(4, 2, 3)[
                (r[:, 0] >> 5) & 3, r[:, 0] & 1][:, 2].tolist())
        seen["segments"].add(len(set(((r[:, 0] >> 5) & 3).tolist())))
        i4x4 = (r[:, 0] & 1) == 1
        seen["i4x4"].update(i4x4.tolist())
        seen["ymode"].update(((r[~i4x4, 0] >> 1) & 3).tolist())
        sub = np.concatenate([(r[i4x4, 1:3, None] >> (4 * np.arange(8)))
                              & 15]).reshape(-1)
        seen["submodes"].update(sub.tolist())
        if ((r[:, 3] == 0) & ~i4x4).any():  # a 16x16 MB without coefficients
            seen["skipped"].add(True)
    assert seen == {"filter": {0, 1, 2}, "sharpness": set(range(8)),
                    "hev": {0, 1, 2}, "segments": {1, 2, 3, 4},
                    "partitions": {1, 2, 4, 8}, "i4x4": {False, True},
                    "submodes": set(range(10)), "skipped": {True},
                    "ymode": {0, 1, 2, 3}}


def test_host_full_size_read_is_cv2(host_webp):
    """chip_smoke.py's full-size source (3200x2130) through the host build:
    the sha-256 of its grey and BGR are cv2's, recorded beside it."""
    with open(os.path.join(os.path.dirname(FULL), "cv2.json")) as f:
        want = json.load(f)
    data = _bytes(os.path.relpath(FULL, DATA))
    assert hashlib.sha256(data).hexdigest() == want["source_sha256"]
    g, bgr = TOOL.read(host_webp, data)
    sha = lambda a: hashlib.sha256(a.tobytes()).hexdigest()
    assert (sha(g), sha(bgr)) == (want["gray_sha256"], want["bgr_sha256"])


@pytest.mark.parametrize("rel", sorted(TOOL.REFUSED))
def test_host_webp_read_refuses(host_webp, rel):
    with pytest.raises(ValueError, match=TOOL.REFUSED[rel]):
        TOOL.read(host_webp, _bytes(rel))


@pytest.mark.parametrize("rel", sorted(CODES))
def test_host_decoder_error_codes(host_webp, rel):
    """The host decoder, given the file whole (the container check
    skipped), refuses it with its own code, whose message names WebP."""
    import ctypes

    data = _bytes(rel)
    info = (ctypes.c_int * len(images.VP8_HEADER_FIELDS))()
    err = host_webp.webp_host_header(data, len(data), info)
    assert err == CODES[rel]
    assert "WebP" in images._CODE_ERRORS[err]


@pytest.mark.parametrize("rel", sorted(TOOL.REFUSED))
def test_card_reads_raise_before_the_card(rel):
    """On a CUDA device a refused WebP raises its cause before any library
    load or copy to the card (so also here, where there is neither a card
    nor nvcc)."""
    data = _bytes(rel)
    for fn in (images.decode, images.decode_colour):
        with pytest.raises(ValueError, match=TOOL.REFUSED[rel]):
            fn(data, "cuda")


def test_image_format_names_webp():
    assert images.image_format(_bytes("webp/flat_q75.webp")) == "WebP"
    assert images.image_format(_bytes(
        "webp/lossless/imencode_45x37.webp")) == "WebP"
    kind = images.image_format(_bytes("webp/refused/not_webp.webp"))
    assert kind.startswith("RIFF") and "not a WebP" in kind


@pytest.mark.parametrize("name", ["size_17x33", "exif_6", "alpha"])
def test_cpu_decode_is_cv2(name):
    """On the CPU the port reads a WebP through OpenCV, as the JAX package
    does."""
    want_g, want_bgr = _cv2_arrays(name)
    g, bgr = images.decode(_bytes(f"webp/{name}.webp"), "cpu")
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(bgr.numpy(), want_bgr)
    np.testing.assert_array_equal(
        images.decode_colour(_bytes(f"webp/{name}.webp"), "cpu").numpy(),
        want_bgr)


@pytest.mark.parametrize("name", ["segments_4", "exif_6", "alpha"])
def test_load_view_of_webp_matches_jax(tmp_path, monkeypatch, host_webp,
                                       name):
    """The JAX package's _load_view (cv2.imread) and the port's, reading
    the same workspace image (a lossy WebP named 00000000.jpg; segments,
    an EXIF orientation, alpha) through the host build: the same grey and
    BGR arrays and camera."""
    from mpmvs_tpu import pipeline as jpipeline

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    shutil.copyfile(os.path.join(WEBP_DIR, f"{name}.webp"),
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


def _counts():
    return [(c.kernel, c.plain) for c in (
        images.VP8_RECON_COUNTS, images.VP8_FILTER_COUNTS,
        images.WEBP_COLOUR_COUNTS)] + [images.CODEC_COUNTS.forms.get(
            "webp", 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_card_webp_read_is_cv2(dev, name):
    want_g, want_bgr = _cv2_arrays(name)
    path = os.path.join(WEBP_DIR, f"{name}.webp")
    before = _counts()
    bgr = images.read_colour(path, dev)
    assert bgr.device.type == "cuda"
    assert torch.equal(bgr.cpu(), torch.as_tensor(want_bgr))
    g, bgr2 = images.read_image(path, dev)
    assert torch.equal(g.cpu(), torch.as_tensor(want_g))
    assert torch.equal(bgr2.cpu(), torch.as_tensor(want_bgr))
    filtered = TOOL.header_fields()[name]["level"] > 0
    (r0, f0, c0, w0), (r1, f1, c1, w1) = before, _counts()
    assert (r1[0] - r0[0], f1[0] - f0[0], c1[0] - c0[0], w1 - w0) == (
        2, 2 * filtered, 2, 2)
    assert (r1[1], f1[1], c1[1]) == (r0[1], f0[1], c0[1])


@pytest.mark.cuda
@pytest.mark.parametrize("rel", sorted(TOOL.REFUSED))
def test_card_webp_read_refuses(dev, rel):
    with pytest.raises(ValueError, match=TOOL.REFUSED[rel]):
        images.read_image(os.path.join(DATA, rel), dev)


def _kernels_vs_plain(dev, data):
    """Each kernel against its plain twin on the same CUDA inputs: entries
    that differ (reconstruction, loop filter, colour)."""
    frame, _ = images.webp_frame(data, images._library())
    (H, W), (mb_h, mb_w) = frame.size, frame.mbs
    rec = torch.from_numpy(frame.records).to(dev)
    coefs = torch.from_numpy(frame.coefs).to(dev)
    prm = frame.params
    planes = images.vp8_reconstruct_kernel(rec, coefs, prm, mb_w, mb_h)
    want = images.vp8_reconstruct_plain(rec, coefs, torch.from_numpy(prm),
                                        mb_w, mb_h)
    out = [sum(int((a != b).sum()) for a, b in zip(planes, want))]
    plain = images.vp8_loop_filter_plain(*planes, rec, torch.from_numpy(prm),
                                         mb_w, mb_h)
    images.vp8_loop_filter_kernel(*planes, rec, prm, mb_w, mb_h)
    out.append(sum(int((a != b).sum()) for a, b in zip(planes, plain)))
    got = images.webp_yuv_to_bgr_kernel(*planes, W, H)
    want = images.webp_yuv_to_bgr_plain(*planes, W, H)
    out.append(sum(int((a != b).sum()) for a, b in zip(got, want)))
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_webp_kernels_equal_plain(dev, name):
    assert _kernels_vs_plain(dev, _bytes(f"webp/{name}.webp")) == (0, 0, 0)


@pytest.mark.cuda
def test_webp_kernels_equal_plain_full_size(dev):
    """At 3200x2130 (chip_smoke.py's source), and the read's hashes are
    cv2's."""
    data = _bytes(os.path.relpath(FULL, DATA))
    assert _kernels_vs_plain(dev, data) == (0, 0, 0)
    with open(os.path.join(os.path.dirname(FULL), "cv2.json")) as f:
        want = json.load(f)
    g, bgr = images.decode(data, dev)
    sha = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    assert (sha(g), sha(bgr)) == (want["gray_sha256"], want["bgr_sha256"])
