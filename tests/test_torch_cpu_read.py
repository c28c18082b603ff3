"""The port's read on the CPU is cv2.imread of the path, as the JAX
package's is (``mpmvs_tpu/pipeline.py`` ``_load_view``, its converter).

* Every image fixture under ``tests/data``, a case a directory:
  ``images.read_image`` and ``read_colour`` on the CPU give cv2.imread's
  arrays of the file, in both modes, or raise where it returns None. The
  JPEGs cut short, which ``cv2.imdecode`` of the bytes refuses, read; the
  TIFFs of orientations 5 to 8 raise, as cv2 5.0.0's imread fails on them.
* ``mpmvs_tpu.pipeline._load_view`` and the port's read the same grey,
  BGR and camera from a workspace whose view 0 is a cut progressive JPEG.
* The JAX converter and the port's on the CPU write the same workspace,
  byte for byte, from cut JPEG sources that are re-encoded.
"""

import os
import shutil

import cv2
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
JPEG = os.path.join(DATA, "jpeg")
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp", ".bmp",
              ".pbm", ".pgm", ".ppm", ".pam", ".gif")


def _image_files():
    """{directory under tests/data: [image file names]}."""
    out = {}
    for folder, _, files in os.walk(DATA):
        names = sorted(f for f in files if f.lower().endswith(IMAGE_EXTS))
        if names:
            out[os.path.relpath(folder, DATA)] = names
    return out


FILES = _image_files()
# the TIFFs of orientations 5 to 8 on which cv2 5.0.0's imread fails in
# both modes (an internal assertion); cv2_arrays.npz holds imdecode's
ORIENTED = {"orient5_lzw", "orient5_tiles_lzw", "orient6_lzw",
            "orient6_tiles_lzw", "orient7_lzw", "orient7_tiles_lzw",
            "orient8_lzw", "orient8_tiles_lzw", "orient7_grey1_tiles_lzw",
            "cmyk8_inkset1_packbits_orient6", "jpeg_ycbcr22_orient6",
            "jpeg_ycbcr22_tiles_orient7", "ycbcr22_notag_orient8",
            "lab16_mm_deflate_pred2_orient6"}


@pytest.mark.parametrize("folder", sorted(FILES))
def test_cpu_read_is_cv2_imread_of_the_path(folder):
    """read_image raises where cv2.imread returns None in either mode,
    read_colour where it does in IMREAD_COLOR; else both give its
    arrays."""
    for name in FILES[folder]:
        path = os.path.join(DATA, folder, name)
        grey = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if grey is None or bgr is None:
            with pytest.raises(ValueError, match="OpenCV cannot read"):
                images.read_image(path, "cpu")
        else:
            g, c = images.read_image(path, "cpu")
            np.testing.assert_array_equal(g.numpy(), grey, err_msg=path)
            np.testing.assert_array_equal(c.numpy(), bgr, err_msg=path)
        if bgr is None:
            with pytest.raises(ValueError, match="OpenCV cannot read"):
                images.read_colour(path, "cpu")
        else:
            np.testing.assert_array_equal(
                images.read_colour(path, "cpu").numpy(), bgr, err_msg=path)


def test_sweep_covers_the_reads_where_imdecode_and_imread_part():
    """Among the fixtures: the cut JPEGs, which only imread reads (libjpeg's
    file source feeds a fake EOI), and the oriented TIFFs, which only
    imdecode reads; the port's CPU read follows imread on both."""
    cut = [os.path.join(JPEG, "truncated", f) for f in
           FILES[os.path.join("jpeg", "truncated")] if f.startswith("prog_")]
    assert len(cut) > 350
    for path in cut[:20]:
        data = np.fromfile(path, np.uint8)
        assert cv2.imdecode(data, cv2.IMREAD_COLOR) is None
        assert images.read_colour(path, "cpu").shape[2] == 3
    assert {f[:-4] for f in FILES["tiff"]} >= ORIENTED
    for name in sorted(ORIENTED):
        path = os.path.join(DATA, "tiff", f"{name}.tif")
        assert cv2.imdecode(np.fromfile(path, np.uint8),
                            cv2.IMREAD_COLOR) is not None
        with pytest.raises(ValueError, match="OpenCV cannot read"):
            images.read_colour(path, "cpu")


def test_cpu_read_of_a_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        images.read_colour(os.path.join(DATA, "missing.jpg"), "cpu")


def test_load_view_of_cut_jpeg_matches_jax(tmp_path):
    """The JAX package's _load_view and the port's on the CPU, each
    through cv2.imread, read the same grey, BGR and camera from a
    workspace whose view 0 is cut inside its third scan."""
    from mpmvs_tpu import pipeline as jpipeline

    ws = str(tmp_path)
    os.makedirs(os.path.join(ws, "images"))
    os.makedirs(os.path.join(ws, "cams"))
    src = os.path.join(JPEG, "truncated", "prog_420_in_s3.jpg")
    shutil.copyfile(src, os.path.join(ws, "images", "00000000.jpg"))
    grey = cv2.imread(src, cv2.IMREAD_GRAYSCALE)
    scene = make_plane_scene(num_views=1, height=grey.shape[0],
                             width=grey.shape[1], seed=4)
    write_cam_txt(os.path.join(ws, "cams", "00000000_cam.txt"),
                  scene.cameras.view(0))
    got = tpipeline._load_view(ws, 0, 3200, "cpu")
    want = jpipeline._load_view(ws, 0, 3200)
    np.testing.assert_array_equal(got.image, np.asarray(want.image))
    np.testing.assert_array_equal(got.color, np.asarray(want.color))
    for f in CAMERA_FIELDS:
        np.testing.assert_array_equal(n(getattr(got.camera, f)),
                                      np.asarray(getattr(want.camera, f)))


def test_conversion_of_cut_sources_matches_jax(tmp_path):
    """The JAX converter and the port's on the CPU re-encode cut JPEG
    sources (named ``.jpeg``, so not copied) to the same workspace, byte
    for byte."""
    from mpmvs_tpu.preprocess.convert import convert_colmap as jax_convert
    from mpmvs_torch.preprocess import convert
    from test_torch_preprocess import _tree, _write_text_model

    dense = os.path.join(str(tmp_path), "dense")
    _write_text_model(os.path.join(dense, "sparse"))
    os.makedirs(os.path.join(dense, "images"))
    sources = ["truncated/prog_420_in_s3", "truncated/420_q95",
               "cut_segments/prog_420_dht3_at25",
               "cut_segments/seq_scans_sos2_at7"]
    path = os.path.join(dense, "sparse", "images.txt")
    with open(path) as f:
        text = f.read()
    for i, name in enumerate(sources):
        src = os.path.join(JPEG, f"{name}.jpg")
        assert cv2.imdecode(np.fromfile(src, np.uint8),
                            cv2.IMREAD_COLOR) is None
        shutil.copyfile(src, os.path.join(dense, "images", f"img{i}.jpeg"))
        text = text.replace(f" img{i}.jpg\n", f" img{i}.jpeg\n")
    with open(path, "w") as f:
        f.write(text)
    out_t, out_j = str(tmp_path / "ws_t"), str(tmp_path / "ws_j")
    os.makedirs(out_j)
    jax_convert(dense, out_j, log=lambda *a: None)
    convert.convert_colmap(dense, out_t, log=lambda *a: None, device="cpu")
    got, want = _tree(out_t), _tree(out_j)
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("images")]) == 4
    for k in want:
        assert got[k] == want[k], k
