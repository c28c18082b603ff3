"""Lossless JPEGs (SOF3) on the card, held against cv2 and the JAX package
on the CPU.

* Every fixture under ``tests/data/jpeg/lossless`` (predictors 1-7, point
  transforms, precisions 2-8, restarts, grey, RGB and CMYK, sampling
  factors, odd sizes, EXIF orientations, a stream cut short): the host
  decoder (``csrc/jpeg_lossless.h``, built with g++ by
  ``tests/data/jpeg/check_host_lossless.py``), the undifferencing's plain
  twin (``images.ljpeg_undiff_plain``) and the colour kernels' plain
  version give ``cv2.imread``'s arrays in each mode cv2 reads, 0 entries
  differing; the mode cv2 refuses is refused, naming it (a grey file reads
  in grey only, RGB in colour only); every file under
  ``lossless/refused`` and ``refused/lossless.jpg`` is refused with its
  code, and cv2 refuses each.
* The kernels' arithmetic built for the host, run as the kernels run it
  (the scan form's two passes, the wavefront band by band and lane by
  lane), equals the twin on random differences at every predictor, with
  restarts; the twin equals a row-by-row loop written from jdlossls.c.
* The JAX converter (cv2.imwrite(dst, cv2.imread(src))) and the port's,
  reading three-component lossless sources named ``.jpeg`` through the host
  build, write the same workspace bytes.
* On the card (``cuda``, skipped without one): each fixture through
  ``images.read_image`` / ``read_colour``, with its launches; each form
  against the twin up to 3200x2130.

    python -m pytest --noconftest -m cuda tests/test_torch_jpeg_lossless.py
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from mpmvs_torch.io import images

torch.set_num_threads(1)

JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
LOSSLESS = os.path.join(JPEG, "lossless")
NAMES = sorted(f[:-4] for f in os.listdir(LOSSLESS) if f.endswith(".jpg"))
# what stays refused: the host decoder's code and the cause its error names
REFUSED = {"lossless/refused/rgb_jfif": (2014, "YCbCr or YCCK"),
           "lossless/refused/rgb_adobe1": (2014, "YCbCr or YCCK"),
           "lossless/refused/rgb_adobe2": (2014, "YCbCr or YCCK"),
           "lossless/refused/cmyk_adobe1": (2014, "YCbCr or YCCK"),
           "lossless/refused/cmyk_adobe2": (2014, "YCbCr or YCCK"),
           "lossless/refused/one_bit": (2006, "precision"),
           "lossless/refused/twelve_bit": (2006, "precision"),
           "lossless/refused/sixteen_bit": (2006, "precision"),
           "lossless/refused/pt_precision": (2012, "scan libjpeg refuses"),
           "lossless/refused/restart_partial_row": (2013, "whole MCU rows"),
           "lossless/refused/two_components": (2002, "unsupported layout"),
           "lossless/refused/truncated_header": (2001, "truncated"),
           "refused/lossless": (2012, "scan libjpeg refuses")}
MODE_REFUSALS = {1: (2015, "grey only"), 3: (2016, "colour only")}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "check_host_lossless", os.path.join(JPEG, "check_host_lossless.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def _bytes(rel):
    with open(os.path.join(JPEG, f"{rel}.jpg"), "rb") as f:
        return f.read()


def _cv2(name):
    """cv2.imread's (grey or None, BGR or None) of lossless/<name>."""
    want = np.load(os.path.join(LOSSLESS, "cv2_arrays.npz"))
    return (want[f"gray_{name}"] if f"gray_{name}" in want else None,
            want[f"bgr_{name}"] if f"bgr_{name}" in want else None)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host decoder")
    return TOOL.build(str(tmp_path_factory.mktemp("host_lossless")))


@pytest.mark.parametrize("name", NAMES)
def test_host_read_is_cv2(host, name):
    """The host decode and the plain twins give cv2's arrays in each mode
    cv2 reads; the other mode raises, naming it."""
    data = _bytes(f"lossless/{name}")
    grey, bgr = _cv2(name)
    img = TOOL.lossless(host, data)
    n = len(img.diffs)
    assert (grey is not None, bgr is not None) == {
        1: (True, False), 3: (False, True), 4: (True, True)}[n]
    if n == 1:
        np.testing.assert_array_equal(TOOL.grey_plane(host, data), grey)
    else:
        np.testing.assert_array_equal(TOOL.read(host, data, grey=False)[1],
                                      bgr)
    if n == 4:
        g, c = TOOL.read(host, data)
        np.testing.assert_array_equal(g, grey)
        np.testing.assert_array_equal(c, bgr)
        return
    _, cause = MODE_REFUSALS[n]
    with pytest.raises(ValueError, match=cause):
        TOOL.read(host, data, grey=n == 3)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_host_refuses_what_cv2_refuses(host, tmp_path, name):
    import cv2

    data = _bytes(name)
    assert TOOL.status(host, data) == REFUSED[name][0]
    with pytest.raises(ValueError, match=REFUSED[name][1]):
        TOOL.lossless(host, data)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path, cv2.IMREAD_GRAYSCALE) is None
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("shape", [(1, 1, 0), (33, 70, 0), (70, 33, 5),
                                   (65, 97, 1), (100, 40, 17)],
                         ids=lambda s: "x".join(map(str, s)))
def test_form_arithmetic_equals_twin(host, predictor, shape):
    """The scan form (predictors 1-4) and the wavefront (5-7), built for
    the host and run pass by pass, lane by lane as on the card, equal the
    twin on random differences (all 16-bit values, restarts at random
    rows), at point transforms 0 and 3."""
    rng = np.random.default_rng(100 * predictor + shape[0])
    diff, first = TOOL.random_case(rng, *shape)
    assert TOOL.form_mismatches(host, diff, first, predictor) == 0
    assert TOOL.form_mismatches(host, diff, first, predictor, 8, 3) == 0


def _libjpeg_rows(diff, first, predictor, precision, pt):
    """jdlossls.c's undifferencing row by row, sample by sample."""
    h, w = diff.shape
    x = np.zeros((h, w), np.int64)
    init = 1 << (precision - pt - 1)
    for r in range(h):
        for c in range(w):
            if first[r]:
                pred = init if c == 0 else x[r, c - 1]
            elif c == 0:
                pred = x[r - 1, 0]
            else:
                ra, rb, rc = x[r, c - 1], x[r - 1, c], x[r - 1, c - 1]
                pred = [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                        rb + ((ra - rc) >> 1), (ra + rb) >> 1][predictor - 1]
            x[r, c] = (int(diff[r, c]) + pred) & 0xFFFF
    return ((x << pt) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_twin_equals_libjpeg_rows(predictor):
    rng = np.random.default_rng(predictor)
    diff, first = TOOL.random_case(rng, 23, 31, 4)
    for precision, pt in ((8, 0), (6, 2), (2, 0)):
        got = images.ljpeg_undiff_plain(torch.from_numpy(diff),
                                        torch.from_numpy(first), predictor,
                                        precision, pt)
        np.testing.assert_array_equal(
            got.numpy(), _libjpeg_rows(diff, first, predictor, precision,
                                       pt))


def test_host_diffs_are_the_writers(host):
    """The host decode's differences and first-row marks are those the
    fixture writer coded (jpeg_file.predict), restarts and a point
    transform included."""
    import sys

    sys.path.insert(0, JPEG)
    import jpeg_file as jf

    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, (29, 37)) for _ in range(3)]
    for kw in ({"predictor": 6, "restart_rows": 3, "pt": 2},
               {"predictor": 2, "restart_rows": 1}):
        img = TOOL.lossless(host, jf.lossless_jpeg(planes, **kw))
        first = jf.first_rows(29, 1, kw["restart_rows"])
        init = 1 << (8 - kw.get("pt", 0) - 1)
        for p, d, f in zip(planes, img.diffs, img.firsts):
            x = p >> kw.get("pt", 0)
            want = (x - jf.predict(x, kw["predictor"], first, init)) & 0xFFFF
            np.testing.assert_array_equal(d.astype(np.int64) & 0xFFFF, want)
            np.testing.assert_array_equal(f.astype(bool), first)


def test_bands_of_first_rows():
    firsts = [np.array([1, 0, 0, 1, 0], np.uint8), np.array([1, 1], np.uint8)]
    np.testing.assert_array_equal(images.ljpeg_bands(firsts),
                                  [[0, 3, 5], [0, 1, 2]])


def test_conversion_of_lossless_sources_matches_jax(tmp_path, monkeypatch,
                                                    host):
    """The JAX converter and the port's (its image step reading through the
    host build: ``read_colour`` of a lossless RGB or CMYK ``.jpeg``) write
    the same workspace, byte for byte."""
    from mpmvs_tpu.preprocess.convert import convert_colmap as jax_convert
    from mpmvs_torch.preprocess import convert
    from test_torch_preprocess import _tree, _write_text_model

    dense = os.path.join(str(tmp_path), "dense")
    _write_text_model(os.path.join(dense, "sparse"))
    os.makedirs(os.path.join(dense, "images"))
    sources = ["rgb_p7", "rgb_422_p7_restart1", "rgb_exif6_p4", "cmyk_p1"]
    path = os.path.join(dense, "sparse", "images.txt")
    with open(path) as f:
        text = f.read()
    for i, name in enumerate(sources):
        shutil.copyfile(os.path.join(LOSSLESS, f"{name}.jpg"),
                        os.path.join(dense, "images", f"img{i}.jpeg"))
        text = text.replace(f" img{i}.jpg\n", f" img{i}.jpeg\n")
    with open(path, "w") as f:
        f.write(text)

    def host_colour(path, device):
        with open(path, "rb") as f:
            return torch.from_numpy(TOOL.read(host, f.read(), grey=False)[1])

    monkeypatch.setattr(convert.image_io, "read_colour", host_colour)
    out_t, out_j = str(tmp_path / "ws_t"), str(tmp_path / "ws_j")
    os.makedirs(out_j)
    jax_convert(dense, out_j, log=lambda *a: None)
    convert.convert_colmap(dense, out_t, log=lambda *a: None, device="cpu")
    got, want = _tree(out_t), _tree(out_j)
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("images")]) == 4
    for k in want:
        assert got[k] == want[k], k


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_card_lossless_read_is_cv2(dev, name):
    """read_image and read_colour on the card: cv2's arrays in each mode
    cv2 reads, the other refused; one undifferencing form a predictor and
    one colour launch a read, no plain call."""
    path = os.path.join(LOSSLESS, f"{name}.jpg")
    grey, bgr = _cv2(name)
    img = images.lossless_image(*images.host_decode(
        _bytes(f"lossless/{name}")))
    images.LJPEG_COUNTS.reset()
    images.COUNTS.reset()
    n = len(img.diffs)
    if n == 1:
        with pytest.raises(ValueError, match="grey only"):
            images.read_colour(path, dev)
        assert images.LJPEG_COUNTS.kernel == 0
        return
    c = images.read_colour(path, dev)
    assert torch.equal(c.cpu(), torch.as_tensor(bgr))
    per_predictor = sum(2 if p <= 4 else 1 for p in set(img.predictors))
    assert images.LJPEG_COUNTS.kernel == per_predictor
    assert (images.COUNTS.kernel, images.COUNTS.plain,
            images.LJPEG_COUNTS.plain) == (1, 0, 0)
    if n == 3:
        with pytest.raises(ValueError, match="colour only"):
            images.read_image(path, dev)
    else:
        g, c = images.read_image(path, dev)
        assert torch.equal(g.cpu(), torch.as_tensor(grey))
        assert torch.equal(c.cpu(), torch.as_tensor(bgr))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REFUSED))
def test_card_refuses(dev, name):
    with pytest.raises(ValueError, match=REFUSED[name][1]):
        images.read_colour(os.path.join(JPEG, f"{name}.jpg"), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("shape", [(1, 1, 0), (65, 97, 1), (100, 40, 17),
                                   (333, 257, 0), (2130, 3200, 16),
                                   (2130, 3200, 0)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_forms_equal_twin(dev, predictor, shape):
    """Each form on the card against the twin on random differences: 0
    samples differ, three planes in one launch."""
    rng = np.random.default_rng(predictor)
    h, w, every = shape
    cases = [TOOL.random_case(rng, h, w) for _ in range(3)]
    if every:
        for _, first in cases:
            first[::every] = 1
    diffs = [torch.from_numpy(d).to(dev) for d, _ in cases]
    firsts = [torch.from_numpy(f).to(dev) for _, f in cases]
    bands = torch.from_numpy(images.ljpeg_bands([f for _, f in cases])).to(
        dev)
    got = images.ljpeg_undiff_kernel(diffs, firsts, bands, predictor, 8,
                                     [0, 2, 5])
    for g, d, f, pt in zip(got, diffs, firsts, [0, 2, 5]):
        want = images.ljpeg_undiff_plain(d, f, predictor, 8, pt)
        assert torch.equal(g, want), int((g != want).sum())
