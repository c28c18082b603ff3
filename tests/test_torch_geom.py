"""The geometric mode of mpmvs_torch against mpmvs_tpu, on the CPU.

Inputs come from numpy with a seed: a 3-view make_plane_scene, a warm start
(ground-truth depth x (1 +- 2%) noise, ground-truth normals with noise,
uniform costs) and source depth maps (ground truth x (1 +- 1%), with 5% of
their pixels zeroed so the zero-depth penalty is exercised).

Tolerances:
* geom_consistency_cost: entries finite and below the 3.0 clamp in both
  agree within 1e-4 px, except where the projected source coordinate lies
  within 1e-3 px of a texel boundary: there one ulp of the projection can
  move the truncating fetch one texel over in one package (a nearest-fetch
  flip). Entries that differ by more than 1e-4 are at most 1e-3 of all.
* one geom checkerboard_step (same state, key and band_rows): the fraction
  of active pixels whose plane (atol 1e-4), cost (atol 1e-4), geometric cost
  (atol 1e-4) or views differ stays at most 3%. Both packages draw the same
  numbers and part only on float-tie adoptions (XLA fuses multiply-adds on
  the CPU, eager PyTorch does not), as in test_torch_propagation.py (2%
  there); here the nearest-fetch flips above add near-ties, and measured
  2.1% / 2.0% of the active pixels (phase 0 / 1) part, nearly all on the
  adopted plane with costs equal within 1e-4.
* a whole geom solve_view warm-started from the same result with the same
  key and band_rows: at most 5% of pixels beyond 0.1% relative depth, as
  in test_torch_solver.py, and both reach median |d-gt|/gt < 1%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu.ops import geom_cost as jgc
from mpmvs_tpu.ops import propagation as jprop
from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_tpu.solver import SolveResult as JaxResult
from mpmvs_tpu.solver import _initial_state, build_solve_data
from mpmvs_tpu.solver import solve_view as jax_solve
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch import interop
from mpmvs_torch.ops import geom_cost as tgc
from mpmvs_torch.ops import propagation as tprop
from mpmvs_torch.solver import solve_view

from torch_parity import cams, frac_beyond, n, t

torch.set_num_threads(1)

BAND_ROWS = 16
PARAMS = JaxParams(band_rows=BAND_ROWS, max_iterations=2, max_scale=0,
                   geom_iterations=2)
TPARAMS = interop.params_from_jax_fields(dataclasses.asdict(PARAMS))
H, W = 48, 64


@pytest.fixture(scope="module")
def setup():
    scene = make_plane_scene(num_views=3, height=H, width=W, seed=4)
    rng = np.random.default_rng(11)
    gt = scene.gt_depth
    warm_depth = (gt[0] * rng.uniform(0.98, 1.02, (H, W))).astype(np.float32)
    nrm = np.broadcast_to(scene.gt_normal_world, (H, W, 3)) + rng.normal(
        0, 0.05, (H, W, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    cost = rng.uniform(0.05, 0.6, (H, W)).astype(np.float32)
    warm = (warm_depth, nrm, cost, np.zeros((H, W), np.float32))
    src_depths = (gt[1:] * rng.uniform(0.99, 1.01, gt[1:].shape)).astype(
        np.float32)
    src_depths[rng.uniform(size=src_depths.shape) < 0.05] = 0.0
    return scene, warm, src_depths


def test_geom_consistency_cost_matches(setup):
    scene, warm, src_depths = setup
    data = build_solve_data(jnp.asarray(scene.images), scene.cameras,
                            jnp.asarray(src_depths))
    rng = np.random.default_rng(5)
    # hypotheses around the true plane: depth +-3%, tilted normals
    x, y = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    d = scene.gt_depth[0] * rng.uniform(0.97, 1.03, (H, W))
    n_cam = np.asarray(data.R_ref) @ scene.gt_normal_world
    nrm = n_cam + rng.normal(0, 0.1, (H, W, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    K = np.asarray(data.K_ref)
    X = np.stack([(x - K[0, 2]) / K[0, 0] * d, (y - K[1, 2]) / K[1, 1] * d,
                  d], -1)
    plane = np.concatenate([nrm, -(nrm * X).sum(-1, keepdims=True)],
                           -1).astype(np.float32)
    args = [data.src_depths, data.src_widths, data.src_heights, data.K_ref,
            data.R_ref, data.C_ref, data.t_ref, data.K_src, data.R_src,
            data.t_src, data.C_src]
    cj = np.asarray(jgc.geom_consistency_cost(*args, jnp.asarray(plane),
                                              jnp.asarray(x), jnp.asarray(y)))
    ct = n(tgc.geom_consistency_cost(*[t(a) for a in args], t(plane), t(x),
                                     t(y)))
    assert ct.shape == cj.shape == (2, H, W)
    both = (cj < 3.0) & (ct < 3.0)
    assert both.mean() > 0.5 and (cj == 3.0).any()  # real errors and penalties
    # projected source coordinates: near a texel boundary a fetch may flip
    Xw = np.stack([(x - K[0, 2]) / K[0, 0], (y - K[1, 2]) / K[1, 1],
                   np.ones_like(x)], -1) * (
        -plane[..., 3:] / (nrm * np.stack(
            [(x - K[0, 2]) / K[0, 0], (y - K[1, 2]) / K[1, 1],
             np.ones_like(x)], -1)).sum(-1, keepdims=True))
    Xw = (Xw - np.asarray(data.t_ref)) @ np.asarray(data.R_ref)
    h = (np.einsum("sij,hwj->shwi", np.asarray(data.R_src), Xw)
         + np.asarray(data.t_src)[:, None, None]) @ np.asarray(
             data.K_src).transpose(0, 2, 1)[:, None]
    pt = h[..., :2] / h[..., 2:]
    tie = (np.abs(pt - np.round(pt)) < 1e-3).any(-1)
    ok = both & ~tie
    np.testing.assert_allclose(ct[ok], cj[ok], atol=1e-4, rtol=0)
    assert frac_beyond(ct, cj, 1e-4) <= 1e-3
    # the candidate-stacked form the band step uses: (8, ...) planes
    stacked = n(tgc.geom_consistency_cost(*[t(a) for a in args],
                                          t(np.stack([plane, plane])), t(x),
                                          t(y)))
    np.testing.assert_array_equal(stacked[:, 0], ct)


@pytest.mark.parametrize("phase", [0, 1])
def test_geom_checkerboard_step_matches(setup, phase):
    scene, warm, src_depths = setup
    data = build_solve_data(jnp.asarray(scene.images), scene.cameras,
                            jnp.asarray(src_depths))
    key = jax.random.PRNGKey(23)
    k_init, k_step = jax.random.split(key)
    state = _initial_state(data, PARAMS, k_init, "geom",
                           JaxResult(*map(jnp.asarray, warm)), BAND_ROWS)
    jout = jprop.checkerboard_step(state, data, PARAMS, 0, jnp.int32(1),
                                   phase, k_step, True, False, BAND_ROWS)
    tdata = interop.solve_data_from_numpy(
        {f: getattr(data, f) for f in tprop.SolveData._fields})
    tstate = interop.state_from_numpy(*(np.asarray(a) for a in state))
    tout = tprop.checkerboard_step(tstate, tdata, TPARAMS, 0, 1, phase,
                                   interop.key_from_numpy(k_step), geom=True,
                                   band_rows=BAND_ROWS)
    yy, xx = np.mgrid[0:H, 0:W]
    active = (xx + yy) % 2 == phase
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(n(a)[~active], np.asarray(b)[~active])
    differ = ((np.abs(n(tout.plane) - np.asarray(jout.plane)).max(-1) > 1e-4)
              | (np.abs(n(tout.cost) - np.asarray(jout.cost)) > 1e-4)
              | (np.abs(n(tout.geom_cost) - np.asarray(jout.geom_cost)) > 1e-4)
              | (n(tout.sel) != np.asarray(jout.sel)))[active].mean()
    assert differ <= 0.03, differ
    # the geometric share is tracked: nonzero on most active pixels
    assert (np.asarray(jout.geom_cost)[active] > 0).mean() > 0.5


def test_geom_solve_matches(setup):
    scene, warm, src_depths = setup
    key = jax.random.PRNGKey(31)
    rj = jax_solve(jnp.asarray(scene.images), scene.cameras, key, PARAMS,
                   "geom", warm=JaxResult(*map(jnp.asarray, warm)),
                   src_depths=jnp.asarray(src_depths))
    rt = solve_view(scene.images, cams(scene.cameras),
                    interop.key_from_numpy(key), TPARAMS, "geom",
                    device="cpu", warm=interop.result_from_numpy(*warm),
                    src_depths=src_depths)
    dj, dt = np.asarray(rj.depth), n(rt.depth)
    assert (np.abs(dt - dj) / dj > 1e-3).mean() <= 0.05
    assert (np.abs(n(rt.geom_cost) - np.asarray(rj.geom_cost)) > 1e-3
            ).mean() <= 0.05
    gt = scene.gt_depth[0]
    for d in (dj, dt):
        assert np.isfinite(d).all()
        assert np.median(np.abs(d - gt) / gt) < 0.01
