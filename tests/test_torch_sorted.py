"""The port's bucket-sorted NCC path (mpmvs_torch.ops.ncc_sorted on CPU
tensors, the plain twins of csrc/ncc_samples.cu's kernels) against the JAX
package's ``_sample_view_vals`` and ``ncc_eval_pallas_sorted`` run in
interpret mode, as tests/test_pallas.py runs them, and against the XLA
``ncc_eval``; the fused kernel's pixel record and the int32 sort keys
against the refside and the JAX sort; then a reference-semantics solve
routed through the path, and the ``sampler`` mapping.

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
        got = ncc_sorted.sample_view_vals_plain(
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


@pytest.mark.parametrize("offs", [JaxParams().tap_offsets(0), OFFSETS],
                         ids=["36_taps", "9_taps"])
def test_pixel_record_is_the_refside_transposed(offs):
    """Row p of the fused kernel's pixel-major record holds pixel p's
    plane, x, y, inv_w and m_ref, then w_t and wr_t in blocks of four taps
    (zero weights up to T rounded up to 4), then var_ref, each equal to
    the (T, R, C) refside read at that pixel."""
    data, x, y, plane = _four_views()
    rt = tncc.ncc_refside(t(data.ref_img), 8, 8, offs, 5.0, 3.0)
    N, T = 8 * 128, len(offs)
    Tp = -(-T // 4) * 4
    rec = ncc_sorted.pixel_record(rt, t(plane).reshape(N, 4),
                                  t(x).reshape(N), t(y).reshape(N))
    assert rec.shape == (N, ncc_sorted.record_stride(T))
    assert rec.shape[1] % 4 == 0 and rec.shape[1] >= 8 + 2 * Tp + 1
    assert ncc_sorted.record_stride(36) == 84
    head = np.concatenate([np.asarray(plane).reshape(N, 4)] + [
        np.asarray(a).reshape(N, 1) for a in (x, y)] + [
        n(a).reshape(N, 1) for a in (rt.inv_w, rt.m_ref)], 1)
    np.testing.assert_array_equal(n(rec[:, :8]), head)
    blocks = n(rec[:, 8:8 + 2 * Tp]).reshape(N, Tp // 4, 2, 4)
    for half, a in enumerate((rt.w, rt.wr)):
        got = blocks[:, :, half, :].reshape(N, Tp)
        np.testing.assert_array_equal(got[:, :T], n(a.reshape(T, N)).T)
        assert not got[:, T:].any()
    np.testing.assert_array_equal(n(rec[:, 8 + 2 * Tp]),
                                  n(rt.var_ref).reshape(N))
    assert not n(rec[:, 8 + 2 * Tp + 1:]).any()


@pytest.mark.parametrize("view", [0, 1, 2])
def test_int32_keys_give_sort_view_and_jax_sort_order(view):
    """The int32 bucket keys order the pixels as sort_view does and as
    jax.lax.sort orders the same keys (ncc_eval_pallas_sorted's sort);
    keys from the JAX package's centre projection, bucketed as the port
    buckets, agree on all but 1e-3 of the pixels (XLA contracts the
    projection's multiply-adds on the CPU)."""
    data, x, y, plane = _four_views()
    N = 8 * 128
    pl = np.asarray(plane).reshape(N, 4).copy()
    pl[::37] = np.nan  # non-finite projections go to the edge buckets
    _, Hp, Wp = data.src_imgs.shape
    args = (t(data.A[view]), t(data.b[view]), t(data.K_ref), t(pl),
            t(x).reshape(N), t(y).reshape(N), Hp, Wp)
    keys = ncc_sorted.bucket_keys_plain(*args)
    assert keys.dtype == torch.int32 and keys.shape == (N,)
    n_rows, n_cols = -(-Hp // 8), -(-Wp // 32)
    assert 0 <= int(keys.min()) and int(keys.max()) < n_rows * n_cols
    assert len(np.unique(n(keys))) >= n_rows * n_cols // 3
    perm = ncc_sorted.sort_view(*args)
    np.testing.assert_array_equal(n(perm),
                                  np.argsort(n(keys), kind="stable"))
    _, order = jax.lax.sort((jnp.asarray(n(keys)),
                             jnp.arange(N, dtype=jnp.int32)), num_keys=1)
    np.testing.assert_array_equal(n(perm), np.asarray(order))
    pt = jgeo.homography_apply(data.A[view], data.b[view], data.K_ref,
                               jnp.asarray(pl), x.reshape(N), y.reshape(N))[0]
    cx, cy = (np.nan_to_num(np.asarray(pt[..., i])) for i in (0, 1))
    jkeys = (np.clip(np.floor(cy / 8), 0, n_rows - 1).astype(np.int32)
             * n_cols + np.clip(np.floor(cx / 32), 0, n_cols - 1)
             .astype(np.int32))
    assert (jkeys != n(keys)).mean() <= FRAC_TOL


def test_other_devices_raise():
    data, x, y, plane = _four_views()
    meta = lambda a: t(a).to("meta")
    with pytest.raises(ValueError, match="no sorted-path implementation"):
        ncc_sorted.ncc_eval_sorted(
            None, meta(data.src_imgs), meta(data.src_widths),
            meta(data.src_heights), meta(data.A), meta(data.b),
            meta(data.K_ref), meta(plane), meta(x), meta(y), OFFSETS)
    # the kernel wrappers refuse any tensor not on a CUDA device
    with pytest.raises(ValueError, match="need CUDA tensors"):
        ncc_sorted.view_keys_kernel(None, 0, meta(plane).reshape(-1, 4),
                                    meta(x).reshape(-1), meta(y).reshape(-1),
                                    32, 128)
    with pytest.raises(ValueError, match="need CUDA tensors"):
        ncc_sorted.sample_view_vals_kernel(
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
