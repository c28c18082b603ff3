"""The COLMAP converter of mpmvs_torch against mpmvs_tpu.preprocess, on the
models tests/test_preprocess.py builds (a text model of 4 images and 120
points, and a one-image binary model). The JAX package is imported inside
the CPU tests, so the ``cuda`` test runs without it.

* The readers: every camera, image and point equal, field for field.
* The whole conversion on the CPU: ``cams/*.txt`` and ``pair.txt``
  byte for byte, and the images byte for byte (``.jpg`` sources copied;
  ``.JPG`` and ``.png`` sources re-encoded at quality 95 by OpenCV in both
  packages).
* A model of fixture sources (``.jpg``, ``.JPG``, two ``.png``, one with
  an eXIf orientation; ``tests/data/jpeg/make_fixtures.py``'s
  ``CONVERSION``): the JAX converter writes the stored workspace images
  under ``tests/data/png/conversion``, and so does the port on the CPU.
* On the card (``cuda``): the same model converts to those stored bytes
  (the ``.jpg`` copied, the rest read and re-encoded by the card's codec);
  JPEG sources written by the card's encoder convert, a PNG source
  converts, and a BMP source raises, naming the cause.
"""

import os
import shutil
import struct

import numpy as np
import pytest
import torch

from mpmvs_torch.preprocess import colmap as tcolmap
from mpmvs_torch.preprocess.convert import convert_colmap, main

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# make_fixtures.CONVERSION: the model's image names and their sources
CONVERSION = {"img0.jpg": "jpeg/odd_101x203_q95.jpg",
              "img1.JPG": "jpeg/420_q95.jpg",
              "img2.png": "png/type3.png", "img3.png": "png/exif6.png"}


# tests/test_preprocess.py's text model (this file runs on the card without
# the JAX package, so it keeps its own copy)
def _write_text_model(model_dir, n_images=4, n_points=120, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cameras.txt"), "w") as f:
        f.write("# comment line\n")
        f.write("1 PINHOLE 160 120 150.0 150.0 80.0 60.0\n")
    pts = rng.uniform(-1, 1, (n_points, 3))
    pts[:, 2] = 0.0
    # cameras on a ring at z=-4 looking forward
    images = []
    for i in range(n_images):
        R = np.eye(3)
        C = np.array([0.4 * np.cos(i), 0.4 * np.sin(i), -4.0])
        t = -R @ C
        q = tcolmap.rotmat_to_qvec(R)
        images.append((q, t))
    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        for i, (q, t) in enumerate(images):
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} 1 img{i}.jpg\n")
            feats = []
            for pid in range(n_points):
                feats += [f"{rng.uniform(0, 160):.1f}",
                          f"{rng.uniform(0, 120):.1f}", str(pid + 1)]
            f.write(" ".join(feats) + "\n")
    with open(os.path.join(model_dir, "points3D.txt"), "w") as f:
        for pid in range(n_points):
            track = " ".join(f"{i + 1} {pid}" for i in range(n_images))
            f.write(f"{pid + 1} {pts[pid, 0]} {pts[pid, 1]} {pts[pid, 2]} "
                    f"100 120 140 0.5 {track}\n")
    return pts


def _write_binary_model(d):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 160, 120))  # PINHOLE
        f.write(struct.pack("<4d", 150.0, 150.0, 80.0, 60.0))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 1))
        f.write(struct.pack("<4d", 1, 0, 0, 0))
        f.write(struct.pack("<3d", 0.1, 0.2, 4.0))
        f.write(struct.pack("<i", 1))
        f.write(b"img0.jpg\x00")
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<ddq", 1.0, 2.0, 5))
        f.write(struct.pack("<ddq", 3.0, 4.0, -1))
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<Q", 5))
        f.write(struct.pack("<3d", 0.5, 0.6, 3.0))
        f.write(struct.pack("<3B", 10, 20, 30))
        f.write(struct.pack("<d", 0.8))
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<ii", 1, 0))


def _same(a, b):
    """Two dataclass records (or dicts of them) equal field for field."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_readers_match_jax(tmp_path, ext):
    from mpmvs_tpu.preprocess import colmap as jcolmap

    d = str(tmp_path / "sparse")
    if ext == ".txt":
        _write_text_model(d)
    else:
        _write_binary_model(d)
    for got, want in zip(tcolmap.read_model(d, ext),
                         jcolmap.read_model(d, ext)):
        _same(got, want)


def test_quaternions_match_jax():
    from mpmvs_tpu.preprocess import colmap as jcolmap

    rng = np.random.default_rng(3)
    for _ in range(10):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = tcolmap.qvec_to_rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec_to_rotmat(q))
        np.testing.assert_array_equal(tcolmap.rotmat_to_qvec(R),
                                      jcolmap.rotmat_to_qvec(R))


def _dense_folder(root, names):
    """A COLMAP dense folder: the text model and one 120x160 colour image a
    view, saved by OpenCV under ``names``."""
    import cv2

    dense = os.path.join(root, "dense")
    _write_text_model(os.path.join(dense, "sparse"))
    os.makedirs(os.path.join(dense, "images"))
    for i, name in enumerate(names):
        img = np.random.default_rng(i).integers(0, 255, (120, 160, 3))
        assert cv2.imwrite(os.path.join(dense, "images", name),
                           img.astype(np.uint8))
    # the model names img<i>.jpg; point it at the files as named
    path = os.path.join(dense, "sparse", "images.txt")
    with open(path) as f:
        text = f.read()
    for i, name in enumerate(names):
        text = text.replace(f" img{i}.jpg\n", f" {name}\n")
    with open(path, "w") as f:
        f.write(text)
    return dense


def _tree(folder):
    out = {}
    for sub, _, files in os.walk(folder):
        for name in files:
            p = os.path.join(sub, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, folder)] = f.read()
    return out


@pytest.mark.parametrize("names", [
    ["img0.jpg", "img1.jpg", "img2.jpg", "img3.jpg"],
    ["img0.JPG", "img1.png", "img2.jpg", "img3.JPG"]], ids=["jpg", "mixed"])
def test_conversion_matches_jax_byte_for_byte(tmp_path, names):
    from mpmvs_tpu.preprocess.convert import convert_colmap as jax_convert

    dense = _dense_folder(str(tmp_path), names)
    out_t, out_j = str(tmp_path / "ws_t"), str(tmp_path / "ws_j")
    os.makedirs(out_j)
    assert main(["--dense_folder", dense, "--save_folder", out_t,
                 "--device", "cpu"]) == 0
    jax_convert(dense, out_j, log=lambda *a: None)
    got, want = _tree(out_t), _tree(out_j)
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("cams")]) == 4
    for k in want:
        assert got[k] == want[k], k


def _fixture_model(root):
    """A dense folder of the text model whose images are CONVERSION's
    fixture files, and the workspace images a conversion must write."""
    dense = os.path.join(root, "dense")
    _write_text_model(os.path.join(dense, "sparse"))
    os.makedirs(os.path.join(dense, "images"))
    names = list(CONVERSION)
    for name, src in CONVERSION.items():
        shutil.copyfile(os.path.join(DATA, src),
                        os.path.join(dense, "images", name))
    path = os.path.join(dense, "sparse", "images.txt")
    with open(path) as f:
        text = f.read()
    for i, name in enumerate(names):
        text = text.replace(f" img{i}.jpg\n", f" {name}\n")
    with open(path, "w") as f:
        f.write(text)
    want = {}
    for i, name in enumerate(names):
        src = (os.path.join(DATA, CONVERSION[name]) if i == 0 else
               os.path.join(DATA, "png", "conversion", f"{i:08d}.jpg"))
        with open(src, "rb") as f:
            want[f"images/{i:08d}.jpg"] = f.read()
    return dense, want


def _converted_images(folder):
    return {k: v for k, v in _tree(folder).items() if k.startswith("images")}


def test_fixture_model_converts_as_jax(tmp_path):
    from mpmvs_tpu.preprocess.convert import convert_colmap as jax_convert

    dense, want = _fixture_model(str(tmp_path))
    out_t, out_j = str(tmp_path / "ws_t"), str(tmp_path / "ws_j")
    os.makedirs(out_j)
    jax_convert(dense, out_j, log=lambda *a: None)
    assert _converted_images(out_j) == want
    convert_colmap(dense, out_t, log=lambda *a: None, device="cpu")
    assert _converted_images(out_t) == want


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_converts_jpegs_and_refuses_other_formats(dev, tmp_path):
    from mpmvs_torch.io import images

    dense = os.path.join(str(tmp_path), "dense")
    _write_text_model(os.path.join(dense, "sparse"))
    os.makedirs(os.path.join(dense, "images"))
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 255, (120, 160, 3)).astype(np.uint8)
        images.write_jpeg(os.path.join(dense, "images", f"img{i}.jpg"), img,
                          dev)
    out = str(tmp_path / "ws")
    convert_colmap(dense, out, log=lambda *a: None, device=dev)
    for i in range(4):
        gray, bgr = images.read_image(
            os.path.join(out, "images", f"{i:08d}.jpg"), dev)
        assert tuple(bgr.shape) == (120, 160, 3)
    png = os.path.join(dense, "images", "img1.png")
    rgb = np.random.default_rng(1).integers(0, 255, (120, 160, 3))
    images.write_png(png, rgb.astype(np.uint8))
    path = os.path.join(dense, "sparse", "images.txt")
    with open(path) as f:
        text = f.read().replace(" img1.jpg\n", " img1.png\n")
    with open(path, "w") as f:
        f.write(text)
    convert_colmap(dense, str(tmp_path / "ws2"), log=lambda *a: None,
                   device=dev)
    with open(os.path.join(str(tmp_path / "ws2"), "images", "00000001.jpg"),
              "rb") as f:
        assert f.read() == images.encode_jpeg(rgb.astype(np.uint8), dev, 95)
    shutil.copyfile(os.path.join(DATA, "png", "refused", "image.gif"), png)
    with pytest.raises(ValueError, match="GIF"):
        convert_colmap(dense, str(tmp_path / "ws3"), log=lambda *a: None,
                       device=dev)


@pytest.mark.cuda
def test_card_converts_fixture_model_as_jax(dev, tmp_path):
    from mpmvs_torch.io import images

    dense, want = _fixture_model(str(tmp_path))
    images.CODEC_COUNTS.reset()
    convert_colmap(dense, str(tmp_path / "ws"), log=lambda *a: None,
                   device=dev)
    assert _converted_images(str(tmp_path / "ws")) == want
    assert images.CODEC_COUNTS.forms == {"decode": 1, "png": 2, "encode": 3}
