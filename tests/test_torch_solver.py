"""A whole photometric solve of mpmvs_torch against mpmvs_tpu: the same
make_plane_scene, the same PRNGKey, the same params (the JAX package's
solver-test preset) and the same banding (one band at this size in both).

Tolerance: both packages draw the same random numbers, so they run the same
search; they part only where an adoption flips on a float tie (XLA fuses
multiply-adds on the CPU, eager PyTorch does not), after which the pixel's
search path diverges until propagation re-converges. Measured as the
fraction of pixels whose depth differs by more than 0.1% relative, bounded
by 5%; normals (atol 0.02) and costs (atol 0.01) likewise. Both must reach
the JAX solver test's accuracy bar (median |d-gt|/gt < 1%)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_tpu.solver import solve_view as jax_solve
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch import interop
from mpmvs_torch.ops import ncc_cuda
from mpmvs_torch.solver import (PatchMatchSolver, init_band_count,
                                solve_view)

from torch_parity import cams, n

torch.set_num_threads(1)

FAST = JaxParams(max_iterations=2, max_scale=0, geom_iterations=1)
FRAC_TOL = 0.05


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(num_views=3, height=64, width=80, seed=3)


@pytest.fixture(scope="module")
def results(scene):
    rj = jax_solve(jnp.asarray(scene.images), scene.cameras,
                   jax.random.PRNGKey(0), FAST, "photometric")
    params = interop.params_from_jax_fields(dataclasses.asdict(FAST))
    before = ncc_cuda.COUNTS.plain
    rt = solve_view(scene.images, cams(scene.cameras),
                    interop.key_from_numpy(jax.random.PRNGKey(0)), params,
                    device="cpu")
    calls = ncc_cuda.COUNTS.plain - before
    return [np.asarray(a) for a in rj], [n(a) for a in rt], calls


def test_solve_matches_per_pixel(scene, results):
    rj, rt, _ = results
    (dj, nj, cj, gj), (dt, nt, ct, gt_) = rj, rt
    assert dt.shape == dj.shape == (64, 80) and nt.shape == (64, 80, 3)
    depth_off = (np.abs(dt - dj) / dj > 1e-3).mean()
    normal_off = (np.abs(nt - nj).max(-1) > 0.02).mean()
    cost_off = (np.abs(ct - cj) > 0.01).mean()
    assert depth_off <= FRAC_TOL, depth_off
    assert normal_off <= FRAC_TOL, normal_off
    assert cost_off <= FRAC_TOL, cost_off
    np.testing.assert_array_equal(gt_, 0.0)


def test_both_reach_the_accuracy_bar(scene, results):
    rj, rt, _ = results
    gt = scene.gt_depth[0]
    for d in (rj[0], rt[0]):
        assert np.isfinite(d).all()
        assert np.median(np.abs(d - gt) / gt) < 0.01


def test_ncc_call_count(results):
    """Init bands + (scales x iterations x 2 colours) x bands x 2 calls."""
    _, _, calls = results
    assert calls == init_band_count(64, 64) + 1 * 2 * 2 * 1 * 2


def test_solver_class_is_reproducible():
    params = interop.params_from_jax_fields(
        dataclasses.asdict(FAST) | {"max_iterations": 1})
    sc = make_plane_scene(num_views=3, height=32, width=48, seed=3)
    small, c = sc.images, cams(sc.cameras)
    a = PatchMatchSolver(params, seed=4, device="cpu").photometric(small, c)
    b = PatchMatchSolver(params, seed=4, device="cpu").photometric(small, c)
    np.testing.assert_array_equal(n(a.depth), n(b.depth))
    other = PatchMatchSolver(params, seed=5, device="cpu").photometric(small, c)
    assert not np.array_equal(n(other.depth), n(a.depth))


def test_solver_class_runs_the_warm_modes():
    """``geometric``, ``planar_prior`` and ``geom_planar_prior`` warm-start
    from a photometric result and stay on the plane; the geometric ones
    track a geometric share."""
    from mpmvs_torch.prior import build_planar_prior

    params = interop.params_from_jax_fields(
        dataclasses.asdict(FAST) | {"max_iterations": 1})
    sc = make_plane_scene(num_views=3, height=32, width=48, seed=3)
    small, c = sc.images, cams(sc.cameras)
    solver = PatchMatchSolver(params, seed=4, device="cpu")
    photo = solver.photometric(small, c)
    pr = build_planar_prior(sc.gt_depth[0], np.full((32, 48), 0.05,
                                                    np.float32),
                            n(c.K[0]).astype(np.float64), 0.1, 100.0,
                            device="cpu")
    planes, mask = interop.prior_from_numpy(pr.planes, pr.mask)
    src = sc.gt_depth[1:]
    outs = {"geometric": solver.geometric(small, c, photo, src),
            "planar_prior": solver.planar_prior(small, c, photo, planes,
                                                mask),
            "geom_planar_prior": solver.geom_planar_prior(
                small, c, photo, src, planes, mask)}
    gt = sc.gt_depth[0]
    for name, res in outs.items():
        d = n(res.depth)
        assert np.isfinite(d).all(), name
        assert np.median(np.abs(d - gt) / gt) < 0.01, name
        assert (n(res.geom_cost) > 0).any() == name.startswith("geom"), name


def test_modes_not_ported_raise(scene):
    """Every mode of the JAX package is ported: an unknown mode raises, and
    a warm mode called without its inputs names what it lacks."""
    params = interop.params_from_jax_fields(dataclasses.asdict(FAST))
    key = interop.key_from_numpy(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="unknown mode"):
        solve_view(scene.images, cams(scene.cameras), key, params, "sorted",
                   device="cpu")
    for mode, lacks in (("geom", "warm, src_depths"),
                        ("prior", "warm, prior_planes, prior_mask"),
                        ("geom_prior",
                         "warm, src_depths, prior_planes, prior_mask")):
        with pytest.raises(ValueError, match=lacks):
            solve_view(scene.images, cams(scene.cameras), key, params, mode,
                       device="cpu")
