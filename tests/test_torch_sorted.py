"""The port's bucket-sorted NCC path (mpmvs_torch.ops.ncc_sorted on CPU
tensors, the plain twin of csrc/ncc_samples.cu) against the JAX package's
``_sample_view_vals`` and ``ncc_eval_pallas_sorted`` run in interpret mode,
as tests/test_pallas.py runs them, and against the XLA ``ncc_eval``; then a
reference-semantics solve routed through it, and the ``sampler`` mapping.

Interpret mode compiles the Pallas kernel with its taps unrolled (about 28 s
for 36 taps on one CPU core), so the kernel comparisons use every fourth
tap of the scale-2 window (9 taps spread over it): each tap goes through
the same arithmetic, and the spread keeps the footprint cap busy.

Tolerances:
* samples and flags vs ``_sample_view_vals`` (one 8x128 tile, 3 sources,
  full-range random planes, cap on and off): at most 1e-3 of the flags
  differ (measured 0), and at most 1e-3 of the samples of unflagged pixels
  differ by more than 1e-2 on intensities in [0, 255] (measured 0; max
  |diff| 2e-3). XLA contracts the homography's multiply-adds into FMAs on
  the CPU and the port does not, so a tap coordinate may differ by a few
  ulps; bilinear sampling is continuous, so the sample moves by the
  texture's slope times that, while a tap on a wrong texel would be off by
  the texture's contrast. A flagged pixel's samples never reach a cost
  (it scores cost_max), and the TPU kernel clips its taps into the cap box
  where the port's kernels do not, so those are not compared.
* costs vs ``ncc_eval_pallas_sorted`` and vs XLA ``ncc_eval``: at most 1e-3
  of the entries differ by more than 1e-4 (XLA sums and fuses the taps in
  another order than the port, which sums them in sequence).
* a reference-semantics photometric solve, port ``sampler="sorted"`` vs JAX
  ``sampler="xla"`` (the same function), same key and band_rows: at most 5%
  of pixels beyond 0.1% relative depth, as test_torch_solver.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import geometry as jgeo
from mpmvs_tpu.ops import ncc as jncc
from mpmvs_tpu.ops.pallas_ncc import _sample_view_vals, ncc_eval_pallas_sorted
from mpmvs_tpu.ops.random import random_plane_field
from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_tpu.solver import build_solve_data
from mpmvs_tpu.solver import solve_view as jax_solve
from mpmvs_tpu.utils.synthetic import make_plane_scene
from mpmvs_torch import interop
from mpmvs_torch.ops import ncc as tncc
from mpmvs_torch.ops import ncc_cuda, ncc_sorted
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch.solver import init_band_count, solve_view
from mpmvs_torch.tools.ab_deviations import REFERENCE

from torch_parity import cams, frac_beyond, n, t

torch.set_num_threads(1)

FRAC_TOL = 1e-3
SAMPLE_TOL = 1e-2
SOLVE_FRAC_TOL = 0.05
OFFSETS = tuple(JaxParams().tap_offsets(2)[::4])
CAP = JaxParams().cap_radius(2)

_jit_sample_view_vals = jax.jit(
    _sample_view_vals,
    static_argnames=("offsets", "cost_max", "interpret", "cap_radius"))


def _scene(num_views):
    scene = make_plane_scene(num_views=num_views, height=32, width=128,
                             seed=7)
    data = build_solve_data(jnp.asarray(scene.images), scene.cameras)
    x, y = jgeo.pixel_grid(8, 128)
    y = y + 8.0
    plane = random_plane_field(jax.random.PRNGKey(5), data.K_ref, x, y,
                               data.depth_min, data.depth_max)
    return data, x, y, plane


@functools.lru_cache(maxsize=None)
def _four_views():
    return _scene(4)


@pytest.mark.parametrize("cap", [0.0, CAP], ids=["cap_off", "cap_on"])
def test_plain_samples_match_pallas_interpret(cap):
    data, x, y, plane = _four_views()
    S = data.src_imgs.shape[0]
    kinvt = jnp.swapaxes(jgeo.K_inv_pinhole(data.K_ref), -1, -2).reshape(1, 9)
    ab = jnp.concatenate([data.A.reshape(S, 9), data.b.reshape(S, 3)], 1)
    wh = jnp.stack([data.src_widths, data.src_heights], 1)
    xf, yf, pf = t(x).reshape(-1), t(y).reshape(-1), t(plane).reshape(-1, 4)
    T = len(OFFSETS)
    flags = []
    for s in range(S):
        perm = ncc_sorted.sort_view(t(data.A[s]), t(data.b[s]),
                                    t(data.K_ref), pf, xf, yf,
                                    *data.src_imgs.shape[1:])
        assert sorted(perm.tolist()) == list(range(xf.shape[0]))
        p = n(perm)
        want = np.asarray(_jit_sample_view_vals(
            data.src_imgs[s], wh[s:s + 1], ab[s:s + 1], kinvt,
            plane.reshape(-1, 4)[p], x.reshape(-1)[p], y.reshape(-1)[p],
            offsets=OFFSETS, cost_max=2.0, interpret=True, cap_radius=cap))
        got = ncc_sorted.sample_view_vals(
            t(data.src_imgs[s]), t(data.src_widths[s]),
            t(data.src_heights[s]), t(data.A[s]), t(data.b[s]),
            t(data.K_ref), pf, xf, yf, perm, OFFSETS, cap)
        assert got.shape == want.shape == (T + 1, 1024)
        assert (n(got[T]) != want[T]).mean() <= FRAC_TOL
        scored = want[T] < 0.5
        assert frac_beyond(got[:T][:, scored], want[:T][:, scored],
                           SAMPLE_TOL) <= FRAC_TOL
        flags.append(float(want[T].mean()))
    # both kinds of column occur: scored pixels and flagged ones
    assert 0.0 < min(flags) and max(flags) < 1.0


def test_ncc_eval_sorted_matches_pallas_sorted_and_xla():
    data, x, y, plane = _scene(3)
    rj = jncc.ncc_refside(data.ref_img, 8, 8, OFFSETS, 5.0, 3.0)
    args = (data.src_imgs, data.src_widths, data.src_heights, data.A,
            data.b, data.K_ref, plane, x, y)
    want = np.asarray(ncc_eval_pallas_sorted(rj, *args, OFFSETS, 2.0,
                                             interpret=True))
    xla = np.asarray(jncc.ncc_eval(rj, *args, OFFSETS, 2.0))
    rt = tncc.ncc_refside(t(data.ref_img), 8, 8, OFFSETS, 5.0, 3.0)
    before = ncc_sorted.COUNTS.plain
    got = ncc_sorted.ncc_eval_sorted(rt, *[t(a) for a in args], OFFSETS,
                                     2.0)
    assert ncc_sorted.COUNTS.plain - before == 2  # one call per view
    assert got.shape == want.shape == xla.shape == (2, 8, 128)
    assert frac_beyond(got, want, 1e-4) <= FRAC_TOL
    assert frac_beyond(got, xla, 1e-4) <= FRAC_TOL
    assert 0.0 < (xla < 2.0).mean() < 1.0


def test_ncc_eval_sorted_matches_plain_ncc_eval_with_cap():
    """The port against itself: the sorted path and ops.ncc.ncc_eval on a
    full 36-tap window, cap on, all three views."""
    data, x, y, plane = _four_views()
    offs = JaxParams().tap_offsets(0)
    cap = JaxParams().cap_radius(0)
    rt = tncc.ncc_refside(t(data.ref_img), 8, 8, offs, 5.0, 3.0)
    args = [t(a) for a in (data.src_imgs, data.src_widths,
                           data.src_heights, data.A, data.b, data.K_ref,
                           plane, x, y)]
    got = ncc_sorted.ncc_eval_sorted(rt, *args, offs, 2.0, cap)
    want = tncc.ncc_eval(rt, *args, offs, 2.0, cap)
    assert frac_beyond(got, want, 1e-4) <= FRAC_TOL


def test_other_devices_raise():
    data, x, y, plane = _four_views()
    meta = lambda a: t(a).to("meta")
    with pytest.raises(ValueError, match="no sample implementation"):
        ncc_sorted.sample_view_vals(
            meta(data.src_imgs[0]), meta(data.src_widths[0]),
            meta(data.src_heights[0]), meta(data.A[0]), meta(data.b[0]),
            meta(data.K_ref), meta(plane).reshape(-1, 4),
            meta(x).reshape(-1), meta(y).reshape(-1),
            torch.zeros(1024, dtype=torch.int64, device="meta"), OFFSETS)


def test_reference_semantics_solve_matches_jax():
    scene = make_plane_scene(num_views=3, height=64, width=80, seed=3)
    fast = JaxParams(max_iterations=2, max_scale=0, geom_iterations=1,
                     band_rows=64, sampler="xla", **REFERENCE)
    rj = jax_solve(jnp.asarray(scene.images), scene.cameras,
                   jax.random.PRNGKey(0), fast, "photometric")
    params = interop.params_from_jax_fields(
        dataclasses.asdict(fast) | {"sampler": "pallas_sorted"})
    assert params.sampler == "sorted"
    ncc_sorted.COUNTS.reset()
    ncc_cuda.COUNTS.reset()
    rt = solve_view(scene.images, cams(scene.cameras),
                    interop.key_from_numpy(jax.random.PRNGKey(0)), params,
                    device="cpu")
    # init: one sample call per source view and band; each of the
    # 2 iterations x 2 colours: 2 random trials x 2 views, and the K=9 and
    # K=3 calls of the K-stacked NCC
    S = 2
    assert ncc_sorted.COUNTS.plain == S * init_band_count(64, 64) + 4 * 2 * S
    assert ncc_cuda.COUNTS.plain == 4 * 2
    dj, dt = np.asarray(rj[0]), n(rt.depth)
    assert ((np.abs(dt - dj) / dj) > 1e-3).mean() <= SOLVE_FRAC_TOL
    gt = scene.gt_depth[0]
    for d in (dj, dt):
        assert np.median(np.abs(d - gt) / gt) < 0.01


@pytest.mark.parametrize("jax_value,port_value", [
    ("auto", "auto"), ("pallas", "auto"), ("xla", "auto"),
    ("pallas_sorted", "sorted")])
def test_sampler_mapping(jax_value, port_value):
    fields = dataclasses.asdict(JaxParams(sampler=jax_value))
    assert interop.params_from_jax_fields(fields).sampler == port_value


def test_unknown_sampler_raises():
    with pytest.raises(ValueError, match="sampler must be one of"):
        PatchMatchParams(sampler="pallas_sorted")
    with pytest.raises(ValueError, match="unknown sampler"):
        interop.params_from_jax_fields({"sampler": "texture"})
