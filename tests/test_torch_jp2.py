"""The card's JPEG 2000 reads, held to cv2.imread.

On the CPU (no card, no nvcc), ``tests/data/jp2/check_host_jp2.py``
builds the host half (``csrc/j2k_decode.h``, ``j2k_t1.h``: parse, tier-2,
tier-1) and the arithmetic of ``j2k_idwt_kernel`` and
``j2k_colour_kernel`` (``j2k_idwt.h``, ``j2k_colour.h``, launch by launch)
with g++:

* every fixture under ``tests/data/jp2`` reads to ``cv2.imread``'s grey and
  BGR arrays (0 entries differ), and each plain twin
  (``images.j2k_idwt_plain``, ``images.j2k_colour_plain``) equals the
  host build of its kernel's arithmetic on the same words, launch by
  launch;
* what stays refused raises with its code (``refused/refused.json``), and
  a raw one-component codestream, which cv2 reads in grey only, reads to
  cv2's grey;
* two files cut to every length short of the whole are refused, or read to
  cv2's arrays where cv2 reads them (``cuts.json``);
* the two 3200x2130 sources of chip_smoke.py's phase 8g read to the
  sha-256 of cv2's arrays (``conversion/cv2.json``).

The ``cuda`` tests hold the card's reads and both kernels to the same
arrays and twins, with their launches:

    python -m pytest --noconftest -m cuda tests/test_torch_jp2.py
"""

import hashlib
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mpmvs_torch.io import images

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
JP2 = os.path.join(DATA, "jp2")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "check_host_jp2", os.path.join(JP2, "check_host_jp2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
NAMES = TOOL.NAMES
REFUSED = TOOL.refused_record()
with open(os.path.join(JP2, "cuts.json")) as _f:
    CUTS = json.load(_f)
with open(os.path.join(JP2, "conversion", "cv2.json")) as _f:
    CONVERSION = json.load(_f)
SOURCES = {"lossless": "plane_3200x2130_lossless.jp2",
           "97_rpcl": "plane_3200x2130_97_rpcl.jp2",
           "53_rct": "plane_3200x2130_53_rct.jp2"}


def _bytes(*parts):
    with open(os.path.join(JP2, *parts), "rb") as f:
        return f.read()


def _cv2_arrays(name):
    want = np.load(os.path.join(JP2, "cv2_arrays.npz"))
    return want[f"gray_{name}"], want[f"bgr_{name}"]


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def host_jp2(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host JPEG 2000 decoder")
    return TOOL.load(TOOL.build(str(tmp_path_factory.mktemp("host_jp2"))))


def test_fixtures_cover_the_layouts():
    """Both writers, both wavelets, the five progressions, tiles, layers,
    raw codestreams and precisions besides 8 and 16 bits are among the
    fixtures."""
    with open(os.path.join(JP2, "fixtures.json")) as f:
        made = json.load(f)
    assert sorted(made) == NAMES
    assert {m["writer"] for m in made.values()} >= {"cv2.imwrite", "Pillow"}
    progs = {m["options"].get("progression") for m in made.values()}
    assert progs >= {"LRCP", "RLCP", "RPCL", "PCRL", "CPRL"}
    assert any(n.endswith(".j2k") for n in NAMES)
    assert len(NAMES) >= 60
    assert {"pil_grey16_53_prec12.jp2", "pil_tiles_1x1_53.jp2",
            "pil_stops_after_sot.jp2", "pil_size_1x1_97.jp2"} <= set(NAMES)


def test_fixtures_take_every_colour_form(host_jp2):
    """The RCT after the 5/3 wavelet, the ICT after the 9/7 one and no
    colour transform after either are among the fixtures."""
    forms = set()
    for name in NAMES:
        img = images.j2k_host_image(_bytes(name), host_jp2)
        form = images.j2k_colour_form(img, colour=False).form
        forms.add((form, int(img.tcs[0, 6])))
    assert forms >= {("rct", 1), ("ict", 0), ("none", 1), ("none", 0)}


def test_full_size_sources_take_every_colour_form(host_jp2):
    """The 3200x2130 sources take each colour form at the size of a view:
    none after the 5/3 wavelet, the ICT after the 9/7 one, the RCT after
    the 5/3 one."""
    forms = {}
    for key, name in SOURCES.items():
        img = images.j2k_host_image(_bytes("conversion", name), host_jp2)
        forms[key] = (images.j2k_colour_form(img).form,
                      images.j2k_schedule(img)[0].form)
    assert forms == {"lossless": ("none", 53), "97_rpcl": ("ict", 97),
                     "53_rct": ("rct", 53)}


@pytest.mark.parametrize("name", NAMES)
def test_host_read_and_twins_are_cv2(host_jp2, name):
    """The host build reads cv2's grey and BGR (0 entries differ), and each
    twin equals the host build of its kernel, launch by launch."""
    grey, bgr, diffs = TOOL.read(host_jp2, _bytes(name), twins=True)
    want_g, want_bgr = _cv2_arrays(name)
    np.testing.assert_array_equal(bgr, want_bgr)
    np.testing.assert_array_equal(grey, want_g)
    assert not any(diffs["idwt"]) and diffs["colour"] == 0, diffs


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_host_refuses_with_its_code(host_jp2, name):
    rec = REFUSED[name]
    data = _bytes("refused", name)
    with pytest.raises(ValueError, match=images._CODE_ERRORS[rec["code"]]
                       [:40].replace("(", r"\(")):
        TOOL.read(host_jp2, data)
    if rec["cv2_reads_grey"] and not rec["cv2_reads_colour"]:
        grey, _ = TOOL.read(host_jp2, data, colour=False)
        want = np.load(os.path.join(JP2, "refused", "cv2_arrays.npz"))
        np.testing.assert_array_equal(grey, want[f"gray_{name}"])


@pytest.mark.parametrize("name", sorted(CUTS))
def test_host_cut_sweep_is_cv2(host_jp2, name):
    """Every length short of the whole: refused, or cv2's arrays where cv2
    reads the cut file (the codestream ends right after a SOT marker)."""
    data = _bytes(name)
    rec = CUTS[name]
    arrays = np.load(os.path.join(JP2, "cuts_arrays.npz"))
    read = []
    for length in range(rec["length"]):
        try:
            grey, bgr = TOOL.read(host_jp2, data[:length])
        except ValueError:
            continue
        read.append(length)
        np.testing.assert_array_equal(grey,
                                      arrays[f"gray_{name}_{length}"])
        np.testing.assert_array_equal(bgr, arrays[f"bgr_{name}_{length}"])
    assert read == rec["cv2_reads"]


@pytest.mark.parametrize("key", sorted(SOURCES))
def test_host_full_size_sources_are_cv2(host_jp2, key):
    grey, bgr = TOOL.read(host_jp2, _bytes("conversion", SOURCES[key]))
    assert _sha(grey) == CONVERSION[key]["gray_sha256"]
    assert _sha(bgr) == CONVERSION[key]["bgr_sha256"]


def test_image_format_names_jpeg_2000():
    assert images.image_format(_bytes("pil_rgb_53.jp2")) == "JP2"
    assert images.image_format(_bytes("pil_rgb_53.j2k")) == "J2K"
    assert images.image_format(b"\xff\x4f\xff\x52") == "unknown"


def test_cpu_decode_of_bytes_is_imdecode():
    import cv2

    for name in ("pil_rgb_97.jp2", "pil_rgb_97_layers.j2k", "cv2_grey.jp2"):
        data = _bytes(name)
        g, bgr = images.decode(data, "cpu")
        buf = np.frombuffer(data, np.uint8)
        np.testing.assert_array_equal(
            g.numpy(), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(
            images.decode_colour(data, "cpu").numpy(),
            cv2.imdecode(buf, cv2.IMREAD_COLOR))


def test_wrappers_take_cuda_tensors_only(host_jp2):
    img = images.j2k_host_image(_bytes("pil_rgb_97.jp2"), host_jp2)
    coef = torch.from_numpy(img.coef.view(np.int32).copy())
    lv = images.j2k_schedule(img)[0]
    with pytest.raises(ValueError, match="CUDA"):
        images.j2k_idwt_kernel(coef, coef.clone(), lv)
    with pytest.raises(ValueError, match="CUDA"):
        images.j2k_colour_kernel(coef, images.j2k_colour_form(img))


def test_schedule_runs_every_level_of_every_tile_component(host_jp2):
    """Each level of each tile-component is in exactly one launch pair, its
    wavelet's, lowest level first."""
    img = images.j2k_host_image(_bytes("pil_prog_cprl.jp2"), host_jp2)
    sched = images.j2k_schedule(img)
    assert [lv.level for lv in sched] == sorted(lv.level for lv in sched)
    assert sum(len(lv.jobs) for lv in sched) == len(img.levels)
    assert {lv.form for lv in sched} == {97}
    assert all(lv.rows == lv.jobs[:, 3].sum() and
               lv.cols == lv.jobs[:, 2].sum() for lv in sched)


# ------------------------------ the card ------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches(img, col):
    sched = images.j2k_schedule(img)
    want = {}
    for lv in sched:
        want[str(lv.form)] = want.get(str(lv.form), 0) + 2
    want[col.form] = 1
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_card_read_is_cv2(dev, name):
    """read_image and read_colour on the card: cv2's arrays, with the
    schedule's launches (two a level, one colour launch) and no plain
    call."""
    want_g, want_bgr = _cv2_arrays(name)
    path = os.path.join(JP2, name)
    img = images.j2k_host_image(_bytes(name), images._library())
    want = _launches(img, images.j2k_colour_form(img))
    images.J2K_COUNTS.reset()
    g, bgr = images.read_image(path, dev)
    assert g.device.type == "cuda"
    assert torch.equal(g.cpu(), torch.as_tensor(want_g))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want_bgr))
    assert torch.equal(images.read_colour(path, dev).cpu(),
                       torch.as_tensor(want_bgr))
    assert images.J2K_COUNTS.forms == {k: 2 * v for k, v in want.items()}
    assert images.J2K_COUNTS.plain == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_card_kernels_equal_twins(dev, name):
    img = images.j2k_host_image(_bytes(name), images._library())
    coef, sched, col = images.j2k_upload(img, dev)
    scratch = torch.empty_like(coef)
    for lv in sched:
        want = images.j2k_idwt_plain(coef, lv)
        images.j2k_idwt_kernel(coef, scratch, lv)
        assert torch.equal(coef, want), (name, lv.level, lv.form)
    got = images.j2k_colour_kernel(coef, col)
    want = images.j2k_colour_plain(coef, col)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REFUSED))
def test_card_refuses(dev, name):
    with pytest.raises(ValueError, match=images._CODE_ERRORS[
            REFUSED[name]["code"]][:40].replace("(", r"\(")):
        images.read_image(os.path.join(JP2, "refused", name), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(SOURCES))
def test_card_full_size_sources_are_cv2(dev, key):
    g, bgr = images.read_image(os.path.join(JP2, "conversion", SOURCES[key]),
                               dev)
    assert _sha(g.cpu().numpy()) == CONVERSION[key]["gray_sha256"]
    assert _sha(bgr.cpu().numpy()) == CONVERSION[key]["bgr_sha256"]
