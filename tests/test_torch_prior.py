"""The planar prior and the prior modes of mpmvs_torch against mpmvs_tpu,
on the CPU.

* Seeds (photometric and geometric), Delaunay triangles, triangle planes:
  identical to ``mpmvs_tpu.prior`` (the same numpy and scipy code).
* The rasterizer: ``fill_triangles`` against ``cv2.fillConvexPoly`` (what
  the JAX package calls) on a triangulation of random seeds 5 px apart:
  the index maps part on at most 0.1% of pixels, and only within a pixel
  of a triangle edge (OpenCV steps edge x in 16-bit fixed point, so a
  rounding tie can fall the other way; measured 0.016%). The prior masks
  and planes built from them part on the same pixels.
* Whole ``prior`` and ``geom_prior`` solves from the same warm start, prior,
  key and band_rows: at most 5% of pixels beyond 0.1% relative depth, as in
  test_torch_solver.py (float-tie adoptions, XLA fuses multiply-adds on the
  CPU and eager PyTorch does not), and both reach median |d-gt|/gt < 1%.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import prior as jprior
from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_tpu.solver import SolveResult as JaxResult
from mpmvs_tpu.solver import solve_view as jax_solve
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch import interop
from mpmvs_torch import prior as tprior
from mpmvs_torch.solver import solve_view

from torch_parity import cams, n

torch.set_num_threads(1)

H, W = 48, 64
PARAMS = JaxParams(band_rows=16, max_iterations=2, max_scale=0,
                   geom_iterations=2)
TPARAMS = interop.params_from_jax_fields(dataclasses.asdict(PARAMS))
K = np.array([[100.0, 0.0, 80.0], [0.0, 100.0, 60.0], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    cost = rng.uniform(0.0, 0.3, (120, 160)).astype(np.float32)
    depth = rng.uniform(4.0, 6.0, (120, 160)).astype(np.float32)
    geom = rng.uniform(0.0, 0.5, (120, 160)).astype(np.float32)
    return cost, depth, geom


@pytest.mark.parametrize("geometric", [False, True])
def test_seeds_triangles_planes_identical(maps, geometric):
    cost, depth, geom = maps
    g = geom if geometric else None
    sel = (jprior.select_seeds_geometric(cost, geom) if geometric
           else jprior.select_seeds_photometric(cost))
    sel_t = (tprior.select_seeds_geometric(cost, geom) if geometric
             else tprior.select_seeds_photometric(cost))
    np.testing.assert_array_equal(sel_t, sel)
    tris = jprior.delaunay_triangulate(sel)
    np.testing.assert_array_equal(tprior.delaunay_triangulate(sel), tris)
    np.testing.assert_array_equal(tprior.fit_triangle_planes(tris, depth, K),
                                  jprior.fit_triangle_planes(tris, depth, K))
    a = jprior.build_planar_prior(depth, cost, K, 2.0, 10.0, geom_cost=g)
    b = tprior.build_planar_prior(depth, cost, K, 2.0, 10.0, geom_cost=g,
                                   device="cpu")
    assert len(a.triangles) > 500
    np.testing.assert_array_equal(b.vertices, a.vertices)
    np.testing.assert_array_equal(b.triangles, a.triangles)
    assert (b.mask != a.mask).mean() <= 1e-3
    same = (b.planes == a.planes).all(-1)
    assert (~same).mean() <= 1e-3


def test_rasterizer_against_cv2(maps):
    cost, depth, _ = maps
    tris = jprior.delaunay_triangulate(jprior.select_seeds_photometric(cost))
    values = np.arange(1, len(tris) + 1, dtype=np.int32)
    want = np.zeros(cost.shape, np.int32)
    for i, tri in enumerate(tris):
        cv2.fillConvexPoly(want, tri.reshape(3, 1, 2), int(values[i]))
    got = np.zeros(cost.shape, np.int32)
    tprior.fill_triangles(got, tris, values, "cpu")
    differ = got != want
    assert differ.mean() <= 1e-3
    edges = np.zeros(cost.shape, np.uint8)
    for tri in tris:
        cv2.polylines(edges, [tri.reshape(3, 1, 2)], True, 1)
    near_edge = cv2.dilate(edges, np.ones((3, 3), np.uint8)) > 0
    assert near_edge[differ].all()
    # later triangles overwrite earlier ones: both maps hold every index of
    # a triangle that keeps a pixel
    assert set(np.unique(got)) == set(np.unique(want))


def test_fill_triangles_degenerate_and_chunked():
    """A collinear triangle draws its segment; chunking (forced here with a
    tiny chunk) keeps the triangle order."""
    a = np.zeros((8, 10), np.int32)
    tprior.fill_triangles(a, np.array([[[1, 1], [5, 5], [3, 3]]]),
                          np.array([7], np.int32), "cpu")
    want = np.zeros((8, 10), np.int32)
    cv2.fillConvexPoly(want, np.array([[1, 1], [5, 5], [3, 3]]).reshape(
        3, 1, 2), 7)
    np.testing.assert_array_equal(a, want)
    tris = np.array([[[0, 0], [6, 0], [0, 6]], [[1, 1], [7, 1], [1, 7]]])
    full = np.zeros((9, 9), np.int32)
    tprior.fill_triangles(full, tris, np.array([1, 2], np.int32), "cpu")
    old = tprior._RASTER_CHUNK
    try:
        tprior._RASTER_CHUNK = 4
        small = np.zeros((9, 9), np.int32)
        tprior.fill_triangles(small, tris, np.array([1, 2], np.int32),
                              "cpu")
    finally:
        tprior._RASTER_CHUNK = old
    np.testing.assert_array_equal(small, full)
    assert (full == 2).sum() > (full == 1).sum() > 0


@pytest.fixture(scope="module")
def prior_setup():
    """Warm start near the truth, with a patch of bad depth the prior can
    fix, and the prior built from the true depth over the whole view."""
    scene = make_plane_scene(num_views=3, height=H, width=W, seed=6)
    rng = np.random.default_rng(12)
    gt = scene.gt_depth
    depth = (gt[0] * rng.uniform(0.98, 1.02, (H, W))).astype(np.float32)
    depth[10:30, 20:40] *= 1.15
    nrm = np.broadcast_to(scene.gt_normal_world, (H, W, 3)).astype(
        np.float32).copy()
    cost = rng.uniform(0.05, 0.6, (H, W)).astype(np.float32)
    warm = (depth, nrm, cost, np.zeros((H, W), np.float32))
    Kc = n(cams(scene.cameras).K[0]).astype(np.float64)
    pr = jprior.build_planar_prior(gt[0], np.full((H, W), 0.05, np.float32),
                                   Kc, 0.1, 100.0)
    src_depths = (gt[1:] * rng.uniform(0.99, 1.01, gt[1:].shape)).astype(
        np.float32)
    return scene, warm, pr, src_depths


@pytest.mark.parametrize("mode", ["prior", "geom_prior"])
def test_prior_solves_match(prior_setup, mode):
    scene, warm, pr, src_depths = prior_setup
    assert pr is not None and pr.mask.mean() > 0.5
    key = jax.random.PRNGKey(41)
    geom = mode == "geom_prior"
    rj = jax_solve(jnp.asarray(scene.images), scene.cameras, key, PARAMS,
                   mode, warm=JaxResult(*map(jnp.asarray, warm)),
                   src_depths=jnp.asarray(src_depths) if geom else None,
                   prior_planes=jnp.asarray(pr.planes),
                   prior_mask=jnp.asarray(pr.mask))
    planes, mask = interop.prior_from_numpy(pr.planes, pr.mask)
    rt = solve_view(scene.images, cams(scene.cameras),
                    interop.key_from_numpy(key), TPARAMS, mode, device="cpu",
                    warm=interop.result_from_numpy(*warm),
                    src_depths=src_depths if geom else None,
                    prior_planes=planes, prior_mask=mask)
    dj, dt = np.asarray(rj.depth), n(rt.depth)
    assert (np.abs(dt - dj) / dj > 1e-3).mean() <= 0.05
    gt = scene.gt_depth[0]
    for d in (dj, dt):
        assert np.isfinite(d).all()
        assert np.median(np.abs(d - gt) / gt) < 0.01
    if geom:
        assert (np.abs(n(rt.geom_cost) - np.asarray(rj.geom_cost)) > 1e-3
                ).mean() <= 0.05
