"""Sky masking of mpmvs_torch against mpmvs_tpu (and OpenCV), on the CPU.

Tolerances:
* NcnnNet vs the JAX executor ``make_executor`` on the same normalised
  384x384 input: probability max |diff| <= 1e-4 (measured 5e-7: float32
  convolutions summed in another order).
* The OpenCV-free pre-processing against cv2 on uint8 images: ``pyr_down``
  and ``resize_u8`` equal (0 differing values), at down- and up-scaling
  sizes; ``resize_f32`` (the probability upsample) within 5e-5 (cv2's
  float resize rounds its sample weights more coarsely; measured 2.4e-5).
* ``segment_sky`` vs the JAX ``segment_sky``: probability max |diff| <= 1e-4
  (the two above together; measured 7e-6 at 1600x1700).
* ``bilateral_refine_plain`` vs ``bilateral_refine_pallas(interpret=True)``
  at 52x150: max |diff| <= 1e-5 (measured 1.8e-7: exp rounds apart in XLA
  and torch); a uniform image stays uniform to 1e-5 at the borders
  (out-of-image taps carry no weight).
* The thresholded masks against the JAX ``bilateral_refine`` (its jnp.roll
  oracle): at most 0.2% of pixels differ, as in tests/test_pallas.py.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu.models import ncnn as jncnn
from mpmvs_tpu.models import sky as jsky
from mpmvs_tpu.ops.pallas_bilateral import bilateral_refine_pallas
from mpmvs_torch import interop
from mpmvs_torch.models import sky as tsky
from mpmvs_torch.ops import bilateral_cuda

from torch_parity import n, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def net():
    return tsky.load_sky_net(tsky.VENDORED_NPZ, device="cpu")


def _sky_image(h, w, seed):
    """Sky-blue top band over random ground (tests/test_models.py:93-95)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    band = h * 2 // 5
    img[:band] = [235, 180, 135]
    img[band:] = rng.uniform(30, 120, (h - band, w, 3)).astype(np.uint8)
    return img


def test_net_matches_jax_executor():
    layers = jncnn.load_npz(tsky.VENDORED_NPZ)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 255, (384, 384, 3)).astype(np.float32)
    x = ((rgb - jsky._IMAGENET_MEAN) / jsky._IMAGENET_STD).transpose(2, 0, 1)
    want = np.asarray(jax.jit(jncnn.make_executor(layers, "input.1", "1959"))(
        jnp.asarray(x)))
    with torch.no_grad():
        got = n(interop.sky_net_from_layers(layers)(t(x)))
    assert got.shape == want.shape == (1, 384, 384)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(533, 800), (97, 131), (40, 51)])
def test_preprocessing_matches_cv2(shape):
    img = np.random.default_rng(shape[0]).integers(
        0, 256, shape + (3,)).astype(np.uint8)
    timg = t(img.astype(np.float32))
    np.testing.assert_array_equal(n(tsky.pyr_down(timg)).astype(np.uint8),
                                  cv2.pyrDown(img))
    np.testing.assert_array_equal(
        n(tsky.resize_u8(timg, 384, 384)).astype(np.uint8),
        cv2.resize(img, (384, 384), interpolation=cv2.INTER_LINEAR))
    prob = np.random.default_rng(1).uniform(0, 1, (384, 384)).astype(
        np.float32)
    want = cv2.resize(prob, (shape[1], shape[0]),
                      interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(n(tsky.resize_f32(t(prob), *shape)), want,
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize("shape", [(96, 128), (800, 1000)])
def test_segment_sky_matches_jax(net, shape):
    img = _sky_image(*shape, seed=shape[0])
    want = jsky.segment_sky(img.astype(np.float32),
                            model_dir=jsky.VENDORED_NPZ)
    got = n(tsky.segment_sky(t(img.astype(np.float32)), net))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    band = shape[0] * 2 // 5
    assert got[:band - 4].mean() > 0.8 and got[band + 4:].mean() < 0.2


def test_bilateral_plain_matches_pallas():
    rng = np.random.default_rng(3)
    H, W = 52, 150
    bgr = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    prob = rng.uniform(0, 1, (H, W)).astype(np.float32)
    want = np.asarray(bilateral_refine_pallas(jnp.asarray(bgr),
                                              jnp.asarray(prob),
                                              interpret=True))
    before = bilateral_cuda.COUNTS.plain
    got = n(bilateral_cuda.bilateral_refine(t(bgr), t(prob)))
    assert bilateral_cuda.COUNTS.plain == before + 1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mask = jsky.bilateral_refine(bgr, prob, use_pallas=False)
    assert (n(tsky.bilateral_refine(t(bgr), t(prob))) != mask).mean() < 0.002


def test_bilateral_uniform_image_edges():
    bgr = torch.full((24, 140, 3), 128.0)
    out = n(bilateral_cuda.bilateral_refine_plain(bgr, torch.full((24, 140),
                                                                  0.7)))
    np.testing.assert_allclose(out, 0.7, atol=1e-5)


def test_sky_masks_match_jax(net):
    img = _sky_image(60, 90, seed=4)
    bgr = img.astype(np.float32)
    prob = jsky.segment_sky(bgr, model_dir=jsky.VENDORED_NPZ)
    want = jsky.bilateral_refine(bgr, prob)
    tprob, got = tsky.sky_mask(t(bgr), net)
    assert got.dtype == torch.bool
    assert (n(got) != want).mean() < 0.002
    assert 0.3 < want.mean() < 0.5


def test_wrappers_reject_bad_inputs():
    bgr, prob = torch.zeros((8, 9, 3)), torch.zeros((8, 9))
    with pytest.raises(ValueError, match="must be"):
        bilateral_cuda.bilateral_refine(bgr[:, :8], prob)
    with pytest.raises(TypeError):
        bilateral_cuda.bilateral_refine(bgr.double(), prob)
    with pytest.raises(ValueError, match="radius"):
        bilateral_cuda.bilateral_refine(bgr, prob, radius=30)
    with pytest.raises(ValueError, match="CUDA"):
        bilateral_cuda.bilateral_refine_kernel(bgr, prob)
    with pytest.raises(ValueError, match="no bilateral"):
        bilateral_cuda.bilateral_refine(bgr.to("meta"), prob.to("meta"))


def test_model_location(monkeypatch, tmp_path):
    assert tsky.sky_model_available()
    monkeypatch.setenv("MPMVS_SKY_MODEL_DIR", str(tmp_path))
    assert tsky.default_model_dir() == str(tmp_path)
    assert not tsky.sky_model_available()
