"""Workspace image files and the config file of mpmvs_torch without OpenCV
or PyYAML on the card, held against mpmvs_tpu on the CPU.

* ``pipeline._load_view`` on the CPU against the JAX package's: the same
  grey and BGR arrays and camera, bit for bit, with and without the resize
  of an image above ``max_image_size`` (``ops.resize.resize_u8`` is
  cv2.resize's INTER_LINEAR bit for bit).
* ``utils.workspace.write_workspace`` on the CPU writes the JAX package's
  files byte for byte.
* The PNG writer (standard-library zlib) read back by cv2: equal.
* The flat YAML parser against ``yaml.safe_load``, and
  ``ConfigParams.from_yaml`` against the JAX package's.
* The colour kernel's plain version (libjpeg-turbo's fancy upsampling and
  fixed-point YCbCr -> BGR) against a loop written from libjpeg's own; the
  IDCT kernel's plain version against jidctint.c's loops transcribed, on
  random blocks, extreme ones included (the range limit's wrap).
* Previews: the triangulation overlay against the JAX package's
  ``cv2.line`` drawing on a Delaunay triangulation of random seeds: at most
  0.1% of pixels differ; the JET map within 1 of OpenCV's in every entry.
* The JPEGs that cv2 reads as another image than their planes (EXIF
  orientations 2..8, RGB components, CMYK and YCCK, every sampling layout
  libjpeg takes; ``tests/data/jpeg/layouts`` and the first three under
  ``refused/``): the host decoder, built with g++ (skipped without it),
  with the colour kernels' plain version and ``images.orient``, gives cv2's
  grey and BGR arrays, and so it does for the YCbCr layouts beside them
  (EXIF orientation 1, Adobe transform 1 or 2, ids 'R', 'G', 'B' or an
  Adobe transform 0 under a JFIF marker); what stays refused (12-bit,
  arithmetic, lossless, a sampling layout libjpeg refuses) is refused with
  its code.
* The colour kernels' arithmetic (``csrc/jpeg_colour.h``, built for the
  host) equals the plain version entry for entry on every JPEG fixture, on
  every (x, k) pair of OpenCV's CMYK -> BGR rule, every (Y, Cb, Cr) triple
  of libjpeg's YCCK step and 10^7 seeded CMYK pixels; the port's
  ``_load_view`` of a CMYK and a YCCK workspace image equals the JAX
  package's.
* The encoder without the card: its kernels' plain versions and the host's
  entropy coding (``csrc/jpeg_encode.h``, built with g++) give
  ``cv2.imencode``'s bytes for every fixture under ``tests/data/jpeg/encode``
  (colour and grey, 1x1 to 120x176, qualities 75 to 100); the kernels'
  arithmetic (``csrc/jpeg_fdct.h``, built for the host) equals the plain
  versions entry for entry.
* PNG reads without the card: ``images.png_rows`` (the host unfilter and
  de-interlace of ``csrc/png_unfilter.h``, built with g++) and
  ``images.raster_to_bgr_plain`` give ``cv2.imread``'s BGR and grey for
  every colour type at every bit depth, Adam7, tRNS, gAMA and sRGB, with
  an eXIf orientation; BMP, WebP and the TIFFs the card does not read
  (JPEG-compressed, float, old-style LZW) are refused, naming the
  cause (the TIFF reads: tests/test_torch_raster.py).
* On the card (``cuda``, skipped without one): the fixtures under
  ``tests/data/jpeg`` (and ``layouts/``, and ``refused/`` where they have
  cv2 arrays) decode to cv2's arrays, 0 entries differ, grey and BGR; the
  rest of ``refused/`` raises, naming the cause; the PNGs read to cv2's BGR
  and what stays refused raises;
  the IDCT and colour kernels (YCbCr and RGB forms, and the four-component
  kernel's CMYK and YCCK forms) and the encoder's two kernels equal their
  plain versions (also at 3200x2130); the encoder
  writes cv2.imencode's stored bytes for every encoder fixture.

OpenCV, PyYAML and the JAX package are imported inside the CPU tests, so
the ``cuda`` tests run where none of them is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_images.py
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpmvs_torch import pipeline as tpipeline
from mpmvs_torch import prior as tprior
from mpmvs_torch.io import images
from mpmvs_torch.io.cams import write_cam_txt
from mpmvs_torch.params import ConfigParams, parse_flat_yaml
from mpmvs_torch.utils import visualize
from mpmvs_torch.utils.synthetic import make_plane_scene
from mpmvs_torch.utils.workspace import write_workspace

from torch_parity import CAMERA_FIELDS, n

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
FIXTURE_NAMES = sorted(f[:-4] for f in os.listdir(FIXTURES)
                       if f.endswith(".jpg"))
LINE_DIFF_TOL = 1e-3
PNG_DIR = os.path.join(os.path.dirname(FIXTURES), "png")
PNG_NAMES = sorted(f[:-4] for f in os.listdir(PNG_DIR) if f.endswith(".png"))
# what the card refuses of the sources a converter meets (files under
# tests/data): the cause its error names. The interlaced, 16-bit, 1-bit grey
# and 4-bit palette PNGs and the TIFF once here now read (PNG_NAMES,
# tests/test_torch_raster.py)
PNG_REFUSED = {"png/refused/image.bmp": "BMP",
               "png/refused/image.webp": "WebP",
               "tiff/refused/jpeg.tif": "JPEG-compressed",
               "tiff/refused/float.tif": "float",
               "tiff/refused/old_lzw.tif": "old-style LZW"}
LAYOUT_NAMES = sorted(f[:-4] for f in os.listdir(os.path.join(
    FIXTURES, "layouts")) if f.endswith(".jpg"))
# the JPEGs cv2 reads as another image than their planes, which the card
# refused until it applied EXIF orientations and RGB components: the
# fixture each was made from
FORMERLY_REFUSED = {"exif_orientation6": "420_q95", "adobe_rgb": "444_q100",
                    "rgb_ids": "444_q100"}
# what the card still refuses: the host decoder's code and the cause its
# error names (the Adobe CMYK JPEG once here now reads: layouts/cmyk_pil)
REFUSED = {"twelve_bit": (2006, "12-bit"), "arithmetic": (2007, "arithmetic"),
           "lossless": (2008, "lossless"),
           "fractional": (2011, "sampling layout"),
           "mcu_blocks": (2011, "sampling layout")}
REFUSED_DIR_NAMES = sorted(f[:-4] for f in os.listdir(os.path.join(
    FIXTURES, "refused")))


ENCODE_DIR = os.path.join(FIXTURES, "encode")
ENCODE_NAMES = sorted(f[:-4] for f in os.listdir(ENCODE_DIR)
                      if f.endswith(".jpg"))


def _encode_case(name):
    """(source array, quality, cv2.imencode's bytes) of an encoder
    fixture ``<kind>_<h>x<w>_q<q>``."""
    key, q = name.rsplit("_q", 1)
    src = np.load(os.path.join(ENCODE_DIR, "sources.npz"))[key]
    with open(os.path.join(ENCODE_DIR, f"{name}.jpg"), "rb") as f:
        return src, int(q), f.read()


def _fixture_module(name):
    """tests/data/jpeg/<name>.py, imported."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture_bytes(name):
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        return f.read()


def _cv2_arrays(name):
    """cv2.imread's (grey, BGR) of ``<dir>/<name>`` under tests/data/jpeg,
    or None where the card must refuse it."""
    want = np.load(os.path.join(FIXTURES, "cv2_arrays.npz"))
    if f"bgr_{name}" not in want:
        return None
    return want[f"gray_{name}"], want[f"bgr_{name}"]


def _png_bytes(name):
    with open(os.path.join(PNG_DIR, name), "rb") as f:
        return f.read()


def _data_bytes(rel):
    with open(os.path.join(os.path.dirname(FIXTURES), rel), "rb") as f:
        return f.read()


def _colour_picture(h, w, seed):
    """Smooth random colours, (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    small = torch.as_tensor(rng.uniform(0, 255, (1, 3, h // 8 + 2,
                                                 w // 8 + 2)))
    big = F.interpolate(small, size=(h, w), mode="bilinear",
                        align_corners=True)[0].permute(1, 2, 0)
    return big.round().clamp(0, 255).to(torch.uint8).numpy()


@pytest.fixture(scope="module")
def colour_workspace(tmp_path_factory):
    """One 4:2:0 q95 colour view of 90x136 and its camera."""
    import cv2

    folder = str(tmp_path_factory.mktemp("ws_colour"))
    os.makedirs(os.path.join(folder, "images"))
    os.makedirs(os.path.join(folder, "cams"))
    scene = make_plane_scene(num_views=1, height=90, width=136, seed=4)
    cv2.imwrite(os.path.join(folder, "images", "00000000.jpg"),
                _colour_picture(90, 136, 1), [cv2.IMWRITE_JPEG_QUALITY, 95])
    write_cam_txt(os.path.join(folder, "cams", "00000000_cam.txt"),
                  scene.cameras.view(0))
    return folder


@pytest.mark.parametrize("max_size", [3200, 100, 77])
def test_load_view_matches_jax(colour_workspace, max_size):
    from mpmvs_tpu import pipeline as jpipeline

    got = tpipeline._load_view(colour_workspace, 0, max_size, "cpu")
    want = jpipeline._load_view(colour_workspace, 0, max_size)
    assert got.image.dtype == np.float32 and got.color.dtype == np.float32
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.color, np.asarray(want.color))
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(n(getattr(got.camera, f)),
                                      np.asarray(getattr(want.camera, f)))
    if max_size < 136:
        assert max(got.image.shape) == max_size


def test_write_workspace_matches_jax(tmp_path):
    from mpmvs_tpu.utils.synthetic import make_plane_scene as jax_plane_scene
    from mpmvs_tpu.utils.workspace import write_workspace as jax_workspace

    scene = make_plane_scene(num_views=3, height=40, width=56, seed=2)
    jscene = jax_plane_scene(num_views=3, height=40, width=56, seed=2)
    write_workspace(scene, str(tmp_path / "t"), device="cpu")
    jax_workspace(jscene, str(tmp_path / "j"))
    for sub in ("images", "cams"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert sorted(os.listdir(tmp_path / "t" / sub)) == names
        for name in names:
            assert ((tmp_path / "t" / sub / name).read_bytes()
                    == (tmp_path / "j" / sub / name).read_bytes()), name
    assert ((tmp_path / "t" / "pair.txt").read_bytes()
            == (tmp_path / "j" / "pair.txt").read_bytes())


@pytest.mark.parametrize("channels", [1, 3])
def test_png_writer_reads_back(tmp_path, channels):
    import cv2

    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    images.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, img)


JAX_TEST_CONFIG = ('%YAML:1.0\n---\nInput-folder: "/data/in"\n'
                   'Output-folder: "/data/out/"\n'
                   "Geometric consistency iterations: 2\nPlaner prior: 1\n"
                   "Geometric consistency planer prior: 0\nSky segment: 0\n"
                   "Use dynamic_consistency to fuse: 1\n"
                   "Max source images num: 20\nMax image size: 3200\n")


def _every_key_config():
    values = ["/in/dir", "'/out dir/'", 3, 0, 1, 1, 0, 1, 0, 1, 0, 12, 2400,
              1]
    lines = [f"{key}: {v}  # comment" if i % 3 == 0 else f"{key}: {v}"
             for i, (key, v) in enumerate(zip(ConfigParams._YAML_KEYS,
                                              values))]
    return "%YAML:1.0\n---\n# the reference's keys\n" + "\n".join(
        lines + ["seed: 9", "save_dmb: 1", "Unknown key: true"]) + "\n"


@pytest.mark.parametrize("text", [JAX_TEST_CONFIG, _every_key_config(),
                                  "a: 1.5\nb: yes\nc: Off\nd: ~\ne:\n"
                                  "f: 'it''s'\ng: x # c\nh: 1_000\n"
                                  "i: 0.5e+3\nj: 1e5\nk: -3\n"
                                  'm: "q # not a comment"  # c\n'],
                         ids=["jax-test", "every-key", "scalars"])
def test_yaml_parser_matches_pyyaml(text):
    import yaml

    lines = [ln for ln in text.splitlines() if not ln.startswith("%YAML")]
    want = yaml.safe_load("\n".join(lines))
    got = parse_flat_yaml(text)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v)
                                               for v in want.values()]


@pytest.mark.parametrize("text", [JAX_TEST_CONFIG, _every_key_config()],
                         ids=["jax-test", "every-key"])
def test_from_yaml_matches_jax(tmp_path, text):
    from mpmvs_tpu.params import ConfigParams as JaxConfig

    p = tmp_path / "config.yaml"
    p.write_text(text)
    got, want = ConfigParams.from_yaml(str(p)), JaxConfig.from_yaml(str(p))
    for f in ConfigParams.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f


def test_yaml_parser_refuses_nested_blocks():
    with pytest.raises(ValueError):
        parse_flat_yaml("a:\n  b: 1\n")
    with pytest.raises(ValueError):
        parse_flat_yaml("a: [1, 2]\n")


def _libjpeg_fancy(p, hs, vs, H, W):
    """jdsample.c's h2v2 / h2v1 / h1v2 fancy upsampling, loop by loop."""
    p = p.astype(np.int64)
    Hc, Wc = p.shape
    if hs == 1 and vs == 1:
        return p
    out = np.zeros((Hc * vs, Wc * hs), np.int64)
    for i in range(Hc):
        for v in range(vs):
            if vs == 2:
                i1 = max(i - 1, 0) if v == 0 else min(i + 1, Hc - 1)
                col = 3 * p[i] + p[i1]
            else:
                col = p[i]
            o = out[i * vs + v]
            if hs == 1:
                o[:] = (col + (1 if v == 0 else 2)) >> 2
                continue
            if vs == 2:
                o[0] = (col[0] * 4 + 8) >> 4
                o[1] = (col[0] * 3 + col[1] + 7) >> 4
                for j in range(1, Wc - 1):
                    o[2 * j] = (col[j] * 3 + col[j - 1] + 8) >> 4
                    o[2 * j + 1] = (col[j] * 3 + col[j + 1] + 7) >> 4
                j = Wc - 1
                o[2 * j] = (col[j] * 3 + col[j - 1] + 8) >> 4
                o[2 * j + 1] = (col[j] * 4 + 7) >> 4
            else:
                o[0], o[1] = col[0], (col[0] * 3 + col[1] + 2) >> 2
                for j in range(1, Wc - 1):
                    o[2 * j] = (col[j] * 3 + col[j - 1] + 1) >> 2
                    o[2 * j + 1] = (col[j] * 3 + col[j + 1] + 2) >> 2
                j = Wc - 1
                o[2 * j], o[2 * j + 1] = (col[j] * 3 + col[j - 1] + 1) >> 2, \
                    col[j]
    return out[:H, :W]


def _libjpeg_colour(y, ub, ur):
    """jdcolor.c's tables: Cr_r, Cb_b, Cr_g + Cb_g with 16 fraction bits."""
    fix = lambda x: int(x * 65536 + 0.5)
    xb, xr = ub - 128, ur - 128
    red = (fix(1.402) * xr + 32768) >> 16
    blue = (fix(1.772) * xb + 32768) >> 16
    green = (-fix(0.34414) * xb + 32768 - fix(0.71414) * xr) >> 16
    return np.clip(np.stack([y + blue, y + green, y + red], -1), 0, 255)


@pytest.mark.parametrize("hs,vs", [(2, 2), (2, 1), (1, 2), (1, 1)])
@pytest.mark.parametrize("H,W", [(8, 10), (7, 9)])
def test_ycc_plain_matches_libjpeg_loops(hs, vs, H, W):
    rng = np.random.default_rng(H * 10 + hs + vs)
    Hc, Wc = -(-H // vs), -(-W // hs)
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    cb = rng.integers(0, 256, (Hc, Wc)).astype(np.uint8)
    cr = rng.integers(0, 256, (Hc, Wc)).astype(np.uint8)
    got = images.ycc_to_bgr_plain(torch.as_tensor(y), torch.as_tensor(cb),
                                  torch.as_tensor(cr), hs, vs)
    want = _libjpeg_colour(y.astype(np.int64),
                           _libjpeg_fancy(cb, hs, vs, H, W),
                           _libjpeg_fancy(cr, hs, vs, H, W))
    np.testing.assert_array_equal(n(got), want)
    grey = images.ycc_to_bgr_plain(torch.as_tensor(y))
    np.testing.assert_array_equal(n(grey), np.repeat(y[..., None], 3, -1))


def _jidctint_loops(coef, qt):
    """jidctint.c's jpeg_idct_islow (libjpeg 6b, as libjpeg-turbo keeps
    it), loop by loop: 64 natural-order coefficients and quantization
    values -> 8x8 samples."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_d(g):  # g(k) -> the k-th input of this pass
        z2, z3 = g(2), g(6)
        z1 = (z2 + z3) * 4433
        tmp2, tmp3 = z1 + z3 * -15137, z1 + z2 * 6270
        tmp0, tmp1 = (g(0) + g(4)) << 13, (g(0) - g(4)) << 13
        tmp10, tmp13, tmp11, tmp12 = (tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2,
                                      tmp1 - tmp2)
        tmp0, tmp1, tmp2, tmp3 = g(7), g(5), g(3), g(1)
        z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
        z5 = (z3 + z4) * 9633
        tmp0, tmp1, tmp2, tmp3 = (tmp0 * 2446, tmp1 * 16819, tmp2 * 25172,
                                  tmp3 * 12299)
        z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069, z4 * -3196
        z3 += z5
        z4 += z5
        tmp0 += z1 + z3
        tmp1 += z2 + z4
        tmp2 += z2 + z3
        tmp3 += z1 + z4
        return [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3]

    ws = [[0] * 8 for _ in range(8)]
    for c in range(8):
        col = one_d(lambda k: int(coef[8 * k + c]) * int(qt[8 * k + c]))
        for r in range(8):
            ws[r][c] = descale(col[r], 11)
    out = np.zeros((8, 8), np.uint8)
    for r in range(8):
        row = one_d(lambda k: ws[r][k])
        for c in range(8):
            i = descale(row[c], 18) & 1023
            out[r, c] = i + 128 if i < 128 else (
                255 if i < 512 else (0 if i < 896 else i - 896))
    return out


def test_idct_plain_matches_jidctint_loops():
    rng = np.random.default_rng(5)
    bh, bw = 3, 4
    coef = np.zeros((bh, bw, 64), np.int16)
    coef[..., :10] = rng.integers(-60, 61, (bh, bw, 10))
    coef[0, 0] = rng.integers(-1024, 1024, 64)           # dense
    coef[0, 1, 0] = 1023                                  # flat, saturating
    coef[0, 2, :3] = (-2048, 2047, -2048)                 # wraps the limit
    coef[1, 3] = rng.integers(-32768, 32768, 64)          # int16 extremes
    qt = rng.integers(1, 256, 64).astype(np.uint16)
    qt[7] = 65535                                         # a 16-bit table
    got = images.idct_islow_plain(torch.as_tensor(coef),
                                  torch.as_tensor(qt.view(np.int16)), 21, 29)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (21, 29)
    want = np.zeros((8 * bh, 8 * bw), np.uint8)
    for by in range(bh):
        for bx in range(bw):
            want[8 * by:8 * by + 8, 8 * bx:8 * bx + 8] = _jidctint_loops(
                coef[by, bx], qt)
    np.testing.assert_array_equal(n(got), want[:21, :29])


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_cpu_decode_is_cv2(name):
    want = np.load(os.path.join(FIXTURES, "decoded.npz"))
    gray, bgr = images.read_image(os.path.join(FIXTURES, f"{name}.jpg"),
                                  "cpu")
    np.testing.assert_array_equal(n(gray), want[f"gray_{name}"])
    np.testing.assert_array_equal(n(bgr), want[f"bgr_{name}"])


@pytest.mark.parametrize("name", sorted(FORMERLY_REFUSED))
def test_cv2_reads_refused_fixtures_as_another_image(name):
    import cv2

    base = cv2.imread(os.path.join(FIXTURES, f"{FORMERLY_REFUSED[name]}.jpg"))
    got = cv2.imread(os.path.join(FIXTURES, "refused", f"{name}.jpg"))
    if name.startswith("exif"):
        np.testing.assert_array_equal(got, np.rot90(base, -1))
    else:  # the YCbCr samples taken as R, G, B
        assert got.shape == base.shape and (got != base).mean() > 0.5
    # on the CPU the port reads through OpenCV, as the JAX package does
    gray, bgr = images.read_image(os.path.join(FIXTURES, "refused",
                                               f"{name}.jpg"), "cpu")
    np.testing.assert_array_equal(n(bgr), got)


@pytest.fixture(scope="module")
def host_decoder(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host decoder")
    tool = _fixture_module("check_host_decoder")
    return tool, tool.build(str(tmp_path_factory.mktemp("host_decoder")))


@pytest.mark.parametrize("name", REFUSED_DIR_NAMES)
def test_host_decoder_refuses(host_decoder, name):
    """A file under refused/ with cv2 arrays (EXIF orientation, RGB
    components) decodes to them; the rest is refused with its code."""
    tool, lib = host_decoder
    data = _fixture_bytes(os.path.join("refused", name))
    want = _cv2_arrays(f"refused/{name}")
    if want is None:
        assert tool.status(lib, data) == REFUSED[name][0]
        return
    gray, bgr = tool.decode(lib, data)
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_host_decoder_applies_layouts_as_cv2(host_decoder, name):
    tool, lib = host_decoder
    gray, bgr = tool.decode(lib, _fixture_bytes(f"layouts/{name}"))
    want = _cv2_arrays(f"layouts/{name}")
    np.testing.assert_array_equal(gray, want[0])
    np.testing.assert_array_equal(bgr, want[1])


@pytest.mark.parametrize("case", ["exif_orientation1", "adobe_ycc",
                                  "jfif_rgb_ids", "jfif_adobe_rgb",
                                  "adobe_transform2", "first_app1_only",
                                  "gray_exif5"])
def test_host_decoder_keeps_ycc_layouts(host_decoder, case):
    import cv2

    tool, lib = host_decoder
    make = _fixture_module("make_fixtures")
    data = {"exif_orientation1": lambda: make.after_soi(
                _fixture_bytes("420_q95"), make.exif_app1(1)),
            "adobe_ycc": lambda: make.after_soi(make.without_jfif(
                _fixture_bytes("444_q100")), make.adobe_app14(1)),
            "jfif_rgb_ids": lambda: make.with_ids(
                _fixture_bytes("444_q100"), b"RGB"),
            # libjpeg takes YCbCr where a JFIF marker is, whatever follows
            "jfif_adobe_rgb": lambda: make.after_soi(
                _fixture_bytes("444_q100"), make.adobe_app14(0)),
            "adobe_transform2": lambda: make.after_soi(make.without_jfif(
                _fixture_bytes("444_q100")), make.adobe_app14(2)),
            # OpenCV reads the first APP1's orientation only
            "first_app1_only": lambda: make.after_soi(
                _fixture_bytes("420_q95"),
                make.exif_app1(1) + make.exif_app1(3)),
            "gray_exif5": lambda: make.after_soi(
                _fixture_bytes("gray_q95"), make.exif_app1(5))}[case]()
    buf = np.frombuffer(data, np.uint8)
    gray, bgr = tool.decode(lib, data)
    np.testing.assert_array_equal(gray, cv2.imdecode(buf,
                                                     cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(bgr, cv2.imdecode(buf, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("name", [f"layouts/{n}" for n in LAYOUT_NAMES]
                         + FIXTURE_NAMES)
def test_colour_kernel_arithmetic_equals_plain(host_decoder, name):
    """The colour kernels' per-pixel arithmetic (csrc/jpeg_colour.h, built
    for the host, over the whole image as the kernels run it) equals
    images.colour_plain on the file's planes, grey and BGR."""
    tool, lib = host_decoder
    four = name.startswith(("layouts/cmyk", "layouts/ycck"))
    form = ("ycck" if "ycck" in name else "cmyk") if four else None
    before = images.COUNTS.plain_forms.get(form, 0)
    assert tool.kernel_mismatches(lib, _fixture_bytes(name)) == 0
    # the four-component plain calls are counted by form
    assert images.COUNTS.plain_forms.get(form, 0) == before + four


@pytest.mark.parametrize("part", ["pairs", "triples", "quads"])
def test_cmyk_arithmetic_sweeps_equal_plain(host_decoder, part):
    """The four-component kernel's steps built for the host against the
    plain twin: every (x, k) pair of OpenCV's CMYK -> BGR rule, every
    (Y, Cb, Cr) triple of libjpeg's YCCK step, 10^7 seeded CMYK pixels
    (grey and BGR)."""
    tool, lib = host_decoder
    assert tool.sweep_mismatches(lib, parts=(part,)) == {part: 0}


def test_fancy_upsampling_rule_is_libjpeg_turbos():
    """jinit_upsampler: fancy upsampling for h2v1 and h2v2 only where the
    component is more than 2 samples wide, for h1v2 at any width, and
    replication for every other integer ratio."""
    assert [images._fancy(w, 2, 2) for w in (1, 2, 3)] == [False, False,
                                                          True]
    assert [images._fancy(w, 2, 1) for w in (2, 3)] == [False, True]
    assert images._fancy(1, 1, 2) and images._fancy(100, 1, 2)
    assert not any(images._fancy(100, rh, rv) for rh, rv in (
        (1, 1), (4, 1), (1, 4), (3, 1), (2, 4), (4, 4)))


@pytest.mark.parametrize("name", ["cmyk_pil", "ycck_yk22_cc11"])
def test_load_view_of_four_components_matches_jax(tmp_path, monkeypatch,
                                                  host_decoder, name):
    """The JAX package's _load_view (cv2.imread) and the port's, reading
    the same CMYK or YCCK workspace image through the host decoder and the
    colour kernels' plain version: the same grey and BGR arrays and
    camera."""
    from mpmvs_tpu import pipeline as jpipeline

    tool, lib = host_decoder
    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    shutil.copyfile(os.path.join(FIXTURES, "layouts", f"{name}.jpg"),
                    os.path.join(ws, "images", "00000000.jpg"))
    g, _ = _cv2_arrays(f"layouts/{name}")
    scene = make_plane_scene(num_views=1, height=g.shape[0], width=g.shape[1],
                             seed=4)
    write_cam_txt(os.path.join(ws, "cams", "00000000_cam.txt"),
                  scene.cameras.view(0))

    def host_read(path, device):
        with open(path, "rb") as f:
            return tuple(torch.from_numpy(a) for a in tool.decode(lib,
                                                                  f.read()))

    monkeypatch.setattr(tpipeline.image_io, "read_image", host_read)
    got = tpipeline._load_view(ws, 0, 3200, "cpu")
    want = jpipeline._load_view(ws, 0, 3200)
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.color, np.asarray(want.color))
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(n(getattr(got.camera, f)),
                                      np.asarray(getattr(want.camera, f)))


def test_ycck_conversion_source_is_read_as_cv2_reads_it(host_decoder):
    """chip_smoke.py phase 8's YCCK source (3200x2130, Y and K at 2x2, Cb
    and Cr at 1x1): conversion/cv2.json holds the sha-256 of the file, of
    cv2.imread's grey and BGR arrays of it and of the JAX converter's
    workspace image of it, and the host decoder with the colour kernels'
    plain version gives those arrays."""
    import hashlib
    import json

    import cv2

    tool, lib = host_decoder
    folder = os.path.join(FIXTURES, "conversion")
    with open(os.path.join(folder, "cv2.json")) as f:
        want = json.load(f)
    data = _fixture_bytes("conversion/ycck_3200x2130")
    sha = lambda b: hashlib.sha256(b).hexdigest()
    buf = np.frombuffer(data, np.uint8)
    bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    assert want == {
        "source_sha256": sha(data),
        "gray_sha256": sha(cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).tobytes()),
        "bgr_sha256": sha(bgr.tobytes()),
        "workspace_sha256": sha(cv2.imencode(".jpg", bgr)[1].tobytes())}
    gray, got = tool.decode(lib, data)
    assert got.shape == (2130, 3200, 3)
    assert (sha(gray.tobytes()), sha(got.tobytes())) == (
        want["gray_sha256"], want["bgr_sha256"])


@pytest.fixture(scope="module")
def host_encoder(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the encoder's host sources")
    tool = _fixture_module("check_host_encoder")
    return tool, tool.build(str(tmp_path_factory.mktemp("host_encoder")))


@pytest.mark.parametrize("name", ENCODE_NAMES)
def test_host_encoder_writes_cv2_bytes(host_encoder, name):
    """The kernels' plain versions and the host's entropy coding give
    cv2.imencode's bytes."""
    tool, lib = host_encoder
    src, quality, want = _encode_case(name)
    assert tool.encode_plain(lib, src, quality) == want


@pytest.mark.parametrize("name", ENCODE_NAMES)
def test_encoder_kernel_arithmetic_equals_plain(host_encoder, name):
    """bgr_to_ycc_kernel's and fdct_islow_quant_kernel's arithmetic
    (csrc/jpeg_fdct.h, built for the host) equals the plain versions."""
    tool, lib = host_encoder
    src, quality, _ = _encode_case(name)
    assert tool.kernel_mismatches(lib, src, quality) == 0


@pytest.fixture(scope="module")
def host_raster(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host PNG and TIFF readers")
    spec = importlib.util.spec_from_file_location(
        "check_host_raster", os.path.join(os.path.dirname(FIXTURES), "tiff",
                                          "check_host_raster.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool, tool.build(str(tmp_path_factory.mktemp("host_raster")))


@pytest.mark.parametrize("name", PNG_NAMES)
def test_host_png_read_is_cv2(host_raster, name):
    """images.png_rows (the host unfilter and de-interlace) and
    raster_to_bgr_plain give cv2.imread's BGR and grey arrays, for every
    colour type at every bit depth."""
    tool, lib = host_raster
    want = np.load(os.path.join(PNG_DIR, "cv2_arrays.npz"))
    g, bgr = tool.read(lib, _png_bytes(f"{name}.png"))
    np.testing.assert_array_equal(bgr, want[f"bgr_{name}"])
    np.testing.assert_array_equal(g, want[f"gray_{name}"])


@pytest.mark.parametrize("name", sorted(PNG_REFUSED))
def test_host_png_read_refuses(host_raster, name):
    tool, lib = host_raster
    with pytest.raises(ValueError, match=PNG_REFUSED[name]):
        tool.read(lib, _data_bytes(name))


@pytest.mark.parametrize("orientation", range(1, 10))
def test_orient_is_opencvs(orientation):
    """images.orient against cv2.flip / cv2.transpose as OpenCV's
    ApplyExifOrientation chains them."""
    import cv2

    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    steps = {2: [1], 3: [-1], 4: [0], 5: ["t"], 6: ["t", 1], 7: ["t", -1],
             8: ["t", 0]}.get(orientation, [])
    want = img
    for st in steps:
        want = cv2.transpose(want) if st == "t" else cv2.flip(want, st)
    np.testing.assert_array_equal(
        n(images.orient(torch.as_tensor(img), orientation)), want)


def test_card_codec_refuses_other_formats(tmp_path):
    png = images.encode_png(np.zeros((4, 4), np.uint8))
    assert images.image_format(png) == "PNG"
    with pytest.raises(ValueError, match="PNG"):
        images.decode_planes(png, "cuda")
    with pytest.raises(FileNotFoundError):
        images.read_image(str(tmp_path / "missing.jpg"), "cpu")


def test_triangulation_overlay_against_cv2_lines():
    from mpmvs_tpu import prior as jprior

    rng = np.random.default_rng(3)
    H, W = 120, 160
    seeds = np.unique(rng.integers(0, [W, H], (300, 2)), axis=0)
    tris = tprior.delaunay_triangulate(seeds)
    pr = tprior.PlanarPrior(planes=None, mask=None, triangles=tris,
                            vertices=seeds)
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    got = tprior.draw_triangulation(gray, pr, device="cpu")
    want = jprior.draw_triangulation(gray, pr)
    differ = (got != want).any(-1).mean()
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
    assert differ <= LINE_DIFF_TOL, differ


def test_jet_within_one_of_opencv():
    import cv2

    want = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None],
                             cv2.COLORMAP_JET)[0]
    diff = np.abs(visualize.JET.astype(int) - want.astype(int))
    assert diff.max() <= 1


# ----------------------------- on the card -----------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_card_decode_equals_cv2(dev, name):
    want = np.load(os.path.join(FIXTURES, "decoded.npz"))
    gray, bgr = images.read_image(os.path.join(FIXTURES, f"{name}.jpg"), dev)
    assert gray.device.type == "cuda" and bgr.device.type == "cuda"
    got = {"gray": n(gray).astype(int), "bgr": n(bgr).astype(int)}
    bad = {k: (int((got[k] != want[f"{k}_{name}"]).sum()),
               int(np.abs(got[k] - want[f"{k}_{name}"]).max()))
           for k in got}
    assert bad == {"gray": (0, 0), "bgr": (0, 0)}, bad


@pytest.mark.cuda
@pytest.mark.parametrize("name", REFUSED_DIR_NAMES)
def test_card_decode_refuses(dev, name):
    """A file under refused/ with cv2 arrays decodes to them on the card;
    the rest raises, naming its cause."""
    path = os.path.join(FIXTURES, "refused", f"{name}.jpg")
    want = _cv2_arrays(f"refused/{name}")
    if want is None:
        with pytest.raises(ValueError, match=REFUSED[name][1]):
            images.read_image(path, dev)
        return
    gray, bgr = images.read_image(path, dev)
    assert torch.equal(gray.cpu(), torch.as_tensor(want[0]))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_card_decode_applies_layouts_as_cv2(dev, name):
    gray, bgr = images.read_image(os.path.join(FIXTURES, "layouts",
                                               f"{name}.jpg"), dev)
    want = _cv2_arrays(f"layouts/{name}")
    assert torch.equal(gray.cpu(), torch.as_tensor(want[0]))
    assert torch.equal(bgr.cpu(), torch.as_tensor(want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [f for f in REFUSED_DIR_NAMES
                                  if f not in REFUSED] + ["rgb_ids_420"])
def test_rgb_colour_kernel_equals_plain(dev, name):
    """The colour kernel's RGB form (and the YCbCr form on the files that
    are not RGB) against the plain versions."""
    sub = "layouts" if name in LAYOUT_NAMES else "refused"
    with open(os.path.join(FIXTURES, sub, f"{name}.jpg"), "rb") as f:
        planes, size, layout = images.decode_planes(f.read(), dev)
    before = images.COUNTS.forms.get("rgb", 0)
    got = images.colour_kernel(planes, layout.factors, size, layout.space)
    want = images.colour_plain(planes, layout.factors, size, layout.space)
    torch.cuda.synchronize()
    assert images.COUNTS.forms.get("rgb", 0) == before + layout.rgb
    assert layout.rgb == ("rgb" in name)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", PNG_NAMES)
def test_card_png_read_is_cv2(dev, name):
    want = np.load(os.path.join(PNG_DIR, "cv2_arrays.npz"))[f"bgr_{name}"]
    before = images.CODEC_COUNTS.forms.get("png", 0)
    bgr = images.read_colour(os.path.join(PNG_DIR, f"{name}.png"), dev)
    assert bgr.device.type == "cuda"
    assert images.CODEC_COUNTS.forms["png"] == before + 1
    assert torch.equal(bgr.cpu(), torch.as_tensor(want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PNG_REFUSED))
def test_card_png_read_refuses(dev, name):
    path = os.path.join(os.path.dirname(FIXTURES), name)
    with pytest.raises(ValueError, match=PNG_REFUSED[name]):
        images.read_colour(path, dev)
    with pytest.raises(ValueError):
        images.read_image(path, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 9), (101, 203, 3),
                                   (120, 176), (2130, 3200, 3),
                                   (2130, 3200)], ids=str)
def test_encoder_kernels_equal_plain(dev, shape):
    """bgr_to_ycc_kernel and fdct_islow_quant_kernel against their plain
    versions, 0 entries differ."""
    rng = np.random.default_rng(sum(shape))
    img = torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8),
                          device=dev)
    y0, k0 = images.YCC_COUNTS.kernel, images.FDCT_COUNTS.kernel
    got = images.bgr_to_ycc_kernel(img)
    want = images.bgr_to_ycc_plain(img)
    assert images.YCC_COUNTS.kernel == y0 + 1
    for k, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, b)
        qt = torch.as_tensor(rng.integers(1, 256, 64).astype(np.int16),
                             device=dev)
        assert torch.equal(images.fdct_islow_kernel(b, qt),
                           images.fdct_islow_plain(b, qt))
    torch.cuda.synchronize()
    assert images.FDCT_COUNTS.kernel == k0 + (1 if len(shape) == 2 else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_colour_kernel_equals_plain(dev, name):
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        planes, size, layout = images.decode_planes(f.read(), dev)
    before = images.COUNTS.kernel
    got = images.colour_kernel(planes, layout.factors, size, layout.space)
    want = images.colour_plain(planes, layout.factors, size, layout.space)
    torch.cuda.synchronize()
    assert images.COUNTS.kernel == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_layout_colour_kernels_equal_plain(dev, name):
    """Every layout's colour kernel (the four-component kernel's CMYK and
    YCCK forms, the three-component kernel at every sampling layout)
    against the plain version, one launch of the file's form."""
    with open(os.path.join(FIXTURES, "layouts", f"{name}.jpg"), "rb") as f:
        planes, size, layout = images.decode_planes(f.read(), dev)
    form = {images.SPACE_CMYK: "cmyk", images.SPACE_YCCK: "ycck",
            images.SPACE_RGB: "rgb"}.get(layout.space)
    before = (images.COUNTS.kernel, images.COUNTS.forms.get(form, 0))
    got = images.colour_kernel(planes, layout.factors, size, layout.space)
    want = images.colour_plain(planes, layout.factors, size, layout.space)
    torch.cuda.synchronize()
    assert images.COUNTS.kernel == before[0] + 1
    if form:
        assert images.COUNTS.forms[form] == before[1] + 1
    assert name.startswith(("cmyk", "ycck")) == (len(planes) == 4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_idct_kernel_equals_plain(dev, name):
    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        comps, _, _ = images.decode_coefficients(f.read(), dev)
    for coef, qt, ph, pw in comps:
        before = images.IDCT_COUNTS.kernel
        got = images.idct_islow_kernel(coef, qt, ph, pw)
        want = images.idct_islow_plain(coef, qt, ph, pw)
        torch.cuda.synchronize()
        assert images.IDCT_COUNTS.kernel == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENCODE_NAMES)
def test_card_encode_decodes_back(dev, name):
    """The card's encoder writes cv2.imencode's bytes, and so decodes back
    to what cv2's file decodes to."""
    src, quality, want = _encode_case(name)
    before = images.CODEC_COUNTS.forms.get("encode", 0)
    got = images.encode_jpeg(torch.as_tensor(src, device=dev), dev, quality)
    assert images.CODEC_COUNTS.forms["encode"] == before + 1
    differ = {"bytes": sum(a != b for a, b in zip(got, want))
              + abs(len(got) - len(want)), "length": (len(got), len(want))}
    for kind, a, b in zip(("gray", "bgr"), images.decode(got, dev),
                          images.decode(want, dev)):
        differ[kind] = (int((a != b).sum()), a.numel())
    assert got == want, differ
