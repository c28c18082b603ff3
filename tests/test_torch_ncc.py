"""The NCC module of mpmvs_torch (ops/ncc.py, ops/ncc_cuda.py) against the
JAX package's XLA ``ncc_eval`` on the same numpy inputs. The comparison
with the Pallas kernel in interpret mode is in test_torch_ncc_pallas.py;
the CUDA kernel against its plain version on the card, in
test_torch_kernel_cuda.py.

Tolerance: the fraction of cost entries that differ by more than 1e-4 must
stay below 1e-3 (measured 0 on these inputs). Costs are compared by that
fraction rather than by the max error because one ulp of a tap coordinate
— XLA fuses multiply-adds on the CPU, eager PyTorch does not — can move a
tap to another texel and shift one entry by far more than 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import geometry as jgeo
from mpmvs_tpu.ops import ncc as jncc
from mpmvs_tpu.ops import random as jr
from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_tpu.solver import build_solve_data
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch.ops import ncc as tncc
from mpmvs_torch.ops import ncc_cuda

from torch_parity import frac_beyond, n, t

torch.set_num_threads(1)

FRAC_TOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    scene = make_plane_scene(num_views=4, height=48, width=96, seed=7)
    params = JaxParams()
    data = build_solve_data(jnp.asarray(scene.images), scene.cameras)
    return scene, params, data


def _fields(scene, data, kind, K, rows, r0, W):
    x, y = jgeo.pixel_grid(rows, W)
    y = y + r0
    if kind == "random":
        planes = [jr.random_plane_field(jax.random.PRNGKey(100 + k),
                                        data.K_ref, x, y, data.depth_min,
                                        data.depth_max) for k in range(K)]
    else:
        gt = jnp.asarray(scene.gt_depth[0][r0:r0 + rows])
        nz = jnp.concatenate([jnp.zeros((rows, W, 2)),
                              -jnp.ones((rows, W, 1))], -1)
        planes = [jgeo.plane_from_depth_normal(data.K_ref, x, y,
                                               gt * (1.0 + 0.003 * k), nz)
                  for k in range(K)]
    return x, y, jnp.stack(planes)


def _torch_args(data):
    return (t(data.src_imgs), t(data.src_widths), t(data.src_heights),
            t(data.A), t(data.b), t(data.K_ref))


@pytest.mark.parametrize("scale", [0, 1])
def test_refside_matches(setup, scale):
    """Reference-side moments: exp rounds an ulp apart, var_ref is a
    difference of two ~1e4 moments (atol 0.05 on values up to ~4e3)."""
    scene, params, data = setup
    offs = params.tap_offsets(scale)
    for phase in (None, 1):
        rj = jncc.ncc_refside(data.ref_img, 12, 16, offs, 5.0, 3.0, phase)
        rt = tncc.ncc_refside(t(data.ref_img), 12, 16, offs, 5.0, 3.0, phase)
        np.testing.assert_allclose(n(rt.w), np.asarray(rj.w), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(n(rt.m_ref), np.asarray(rj.m_ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(n(rt.var_ref), np.asarray(rj.var_ref),
                                   rtol=1e-4, atol=0.05)


@pytest.mark.parametrize("K", [9, 5])
@pytest.mark.parametrize("kind", ["gt", "random"])
@pytest.mark.parametrize("cap", [True, False])
def test_plain_multi_matches_xla(setup, K, kind, cap):
    scene, params, data = setup
    r0, rows, W = 8, 16, 96
    offs = params.tap_offsets(0)
    cap_r = params.cap_radius(0) if cap else 0.0
    x, y, planes = _fields(scene, data, kind, K, rows, r0, W)
    rj = jncc.ncc_refside(data.ref_img, r0, rows, offs, 5.0, 3.0)
    ref = np.stack([np.asarray(jncc.ncc_eval(
        rj, data.src_imgs, data.src_widths, data.src_heights, data.A, data.b,
        data.K_ref, planes[k], x, y, offs, params.cost_max,
        cap_radius=cap_r)) for k in range(K)])
    rt = tncc.ncc_refside(t(data.ref_img), r0, rows, offs, 5.0, 3.0)
    before = ncc_cuda.COUNTS.plain
    got = ncc_cuda.ncc_eval_multi(rt, *_torch_args(data), t(planes), t(x),
                                  t(y), offs, params.cost_max, cap_r)
    assert ncc_cuda.COUNTS.plain == before + 1  # CPU tensors -> plain
    assert got.shape == (K, 3, rows, W)
    assert frac_beyond(got, ref, 1e-4) < FRAC_TOL
    # the inputs exercise both valid costs and cost_max (oob/degenerate)
    valid = (ref < params.cost_max).mean()
    assert 0.3 < valid <= 1.0
    if kind == "random":
        assert valid < 0.99


def test_one_is_multi_k1(setup):
    scene, params, data = setup
    offs = params.tap_offsets(2)
    x, y, planes = _fields(scene, data, "random", 2, 8, 20, 96)
    rt = tncc.ncc_refside(t(data.ref_img), 20, 8, offs, 5.0, 3.0)
    multi = ncc_cuda.ncc_eval_multi(rt, *_torch_args(data), t(planes), t(x),
                                    t(y), offs, 2.0, 40.0)
    one = ncc_cuda.ncc_eval_one(rt, *_torch_args(data), t(planes[1]), t(x),
                                t(y), offs, 2.0, 40.0)
    np.testing.assert_array_equal(n(one), n(multi[1]))


def test_dispatch_rejects_other_devices(setup):
    """Only CPU tensors take the plain version; the kernel wrapper refuses
    CPU tensors and the dispatcher refuses devices it has no kernel for."""
    scene, params, data = setup
    offs = params.tap_offsets(0)
    x, y, planes = _fields(scene, data, "gt", 1, 8, 8, 96)
    rt = tncc.ncc_refside(t(data.ref_img), 8, 8, offs, 5.0, 3.0)
    args = (rt,) + _torch_args(data)
    with pytest.raises(ValueError, match="CUDA"):
        ncc_cuda.ncc_eval_multi_kernel(*args, t(planes), t(x), t(y), offs)
    with pytest.raises(ValueError, match="no NCC implementation"):
        ncc_cuda.ncc_eval_multi(*args, t(planes).to("meta"), t(x), t(y), offs)
