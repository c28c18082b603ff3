"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
where ``torch.cuda.is_available()`` is false): the NCC kernel
(``csrc/ncc_eval.cu``), the sorted path's kernels (``csrc/ncc_samples.cu``:
the bucket keys, the fused costs and the raw samples), the geometric cost
(``csrc/geom_cost.cu``) and the sky stage's bilateral kernel in both forms
and its table builder (``csrc/bilateral_refine.cu``).

This file imports only the port (no JAX), so it runs on a CUDA machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)

Tolerances:
* the NCC kernel past 10 sources (S = 11 and 20, two groups of the tile
  launch; K in {1, 5, 9}; both launches): equal to the plain version,
  NaN for NaN.
* kernel vs plain version on the same CUDA tensors: the fraction of cost
  entries differing by more than 1e-4 stays below 1e-3, as in
  test_torch_ncc.py. The kernel repeats the plain version's operations one
  for one (-fmad=false, IEEE division), so on the H100 it is 0; the tests
  of pixel counts off the launches' blocks, K in {1, 3, 5, 9}, views
  narrower than the stack, degenerate planes, stacks in turn and stacks of
  any width, offset, layout or in-place write hold both launches to
  equality, NaN for NaN.
* a whole photometric solve on the card vs the same solve on the CPU: the
  draws are identical (integer threefry), but CUDA's and the CPU's exp, log
  and sqrt may round an ulp apart, which flips float-tie adoptions; bounded
  like test_torch_solver.py (at most 5% of pixels beyond 0.1% relative
  depth), and both reach median |d-gt|/gt < 1%. The same bound holds for a
  geom solve warm-started from it.
* sample kernel vs its plain version on the same CUDA tensors (a
  full-range random field, cap on and off, scales 0 and 2): equal, NaN for
  NaN, because both share ncc_eval.cu's operations one for one. The key
  kernel vs its plain version: equal keys. The fused sorted path vs its
  plain chain (keys, sort, samples, un-permute, ZNCC), at scales 0 and 2, cap on and off, pixel counts off the 128-pixel block,
  views narrower than the stack and non-finite planes: equal, NaN for NaN
  (the same tap arithmetic, sums in the same order, the same tail). The
  sorted path's costs vs the NCC kernel's at K=1: as the kernel vs plain
  above (the ZNCC sums the taps in the kernel's order, so they are
  expected to be equal).
* a reference-semantics solve with ``sampler="sorted"`` on the card vs on
  the CPU: as the photometric solve above; the sample kernel launches once
  per source view for the init band and for each random trial of every
  band step, the NCC kernel twice per band step (K=9 and K=3), and no plain
  version runs.
* one zero-extent source (the sharded pipeline's padding of a view with
  fewer sources: an all-zero image, identity camera, width = height = 0):
  the NCC kernel (both launches, K = 9, cap on) and the fused sorted path
  equal their plain versions, NaN for NaN, and score that source cost_max
  everywhere, as the JAX package does.
* bilateral kernel vs its plain version on the same CUDA tensors, at sizes
  that are not multiples of the 32x8 tile: max |diff| <= 1e-5 and at most
  1e-4 of the thresholded pixels differ (the kernel rounds each operation
  as the plain version's eager ops do, so they are expected to be equal);
  on a uniform image both equal each other exactly and stay within 1e-5 of
  the uniform value up to the borders. The table form on 8-bit guides, at
  radii 0, 18 and 24: equal to the plain version entry for entry (a table entry is the float
  form's weight of the same integer distance, and the builder's table
  equals the plain table bit for bit).
* the geometric-cost kernel vs its plain twin on the same CUDA tensors
  (``geom_cases``: K in {1, 5, 9} and S in {1, 10, 20} at a pixel count
  off the 256-thread block, one field and non-contiguous planes, degenerate
  planes, zero, negative and non-finite source depths, projections off
  every edge, sources narrower, shorter, wider and taller than the stack
  and of zero extent): equal, ``torch.equal``, each call one launch. The
  kernel repeats the twin's operations one for one (-fmad=false, IEEE
  division and square root). A geom solve on the card launches it 14
  times a band step and never runs the twin.
* the sky mask of a painted image on the card vs on the CPU: at most 0.2%
  of pixels differ (CUDA's and the CPU's exp round apart).
* the planar prior's rasterizer (integer torch ops) on the card vs on the
  CPU: equal.
"""

import numpy as np
import pytest
import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch import prior as tprior
from mpmvs_torch.models import sky
from mpmvs_torch.ops import (bilateral_cuda, geom_cost, geom_cost_cuda,
                             ncc_cuda, ncc_sorted)
from mpmvs_torch.ops import random as pmrand
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.ops.ncc import NCCRefSide, ncc_refside
from mpmvs_torch.ops.packing import packed_coords
from mpmvs_torch.ops.propagation import _band_geometry, _pad_rows, step_halo
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch.solver import (build_solve_data, init_band_count,
                                solve_band_rows, solve_view)
from mpmvs_torch.tools.ab_deviations import REFERENCE
from mpmvs_torch.utils.synthetic import make_plane_scene

import geom_cases
from torch_parity import frac_beyond, n

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

FRAC_TOL = 1e-3
SOLVE_FRAC_TOL = 0.05
PARAMS = PatchMatchParams()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data(dev):
    scene = make_plane_scene(num_views=4, height=48, width=96, seed=7)
    return build_solve_data(torch.as_tensor(scene.images, device=dev),
                            scene.cameras.to(dev))


def _band_args(data, K: int, scale: int, cap: bool):
    """ncc_eval_multi's arguments for rows 16..31 of the packed phase-1
    pixels, with K independent random plane fields."""
    rows, y0, phase = 16, 16, 1
    halo = step_halo(scale)
    offs = PARAMS.tap_offsets(scale)
    ref_pad = _pad_rows(data.ref_img, halo, halo)
    refside = ncc_refside(ref_pad[y0:y0 + rows + 2 * halo], halo, rows, offs,
                          PARAMS.sigma_spatial, PARAMS.sigma_color,
                          pack_phase=phase)
    W = data.ref_img.shape[1]
    x, y = packed_coords(y0, rows, W // 2, phase, device=data.ref_img.device)
    keys = tf.split(tf.PRNGKey(10 * scale + K, device=x.device), K)
    planes = torch.stack([pmrand.random_plane_field(
        keys[k], data.K_ref, x, y, data.depth_min, data.depth_max)
        for k in range(K)])
    return (refside, data.src_imgs, data.src_widths, data.src_heights, data.A,
            data.b, data.K_ref, planes, x, y, offs, PARAMS.cost_max,
            PARAMS.cap_radius(scale) if cap else 0.0)


@pytest.mark.parametrize("cap", [True, False])
@pytest.mark.parametrize("scale", [0, 2])
@pytest.mark.parametrize("K", [1, 5, 9])
def test_kernel_matches_plain(data, K, scale, cap):
    args = _band_args(data, K, scale, cap)
    before = ncc_cuda.COUNTS.kernel
    got = ncc_cuda.ncc_eval_multi(*args)
    want = ncc_cuda.ncc_eval_multi_plain(*args)
    torch.cuda.synchronize()
    assert ncc_cuda.COUNTS.kernel == before + 1
    assert got.shape == (K, 3, 16, 48)
    assert frac_beyond(got, want, 1e-4) < FRAC_TOL
    valid = (want < PARAMS.cost_max).float().mean().item()
    assert 0.1 < valid < 1.0  # both real costs and cost_max entries


@pytest.fixture(scope="module")
def data20(dev):
    """A 1+20-view scene: the tile launch runs sources in groups of
    NCC_VIEWS_MAX = 10 (csrc/ncc_eval.cu), so S = 11 and 20 take two."""
    scene = make_plane_scene(num_views=21, height=48, width=96, seed=8)
    return build_solve_data(torch.as_tensor(scene.images, device=dev),
                            scene.cameras.to(dev))


@pytest.mark.parametrize("scattered", [False, True])
@pytest.mark.parametrize("K", [1, 5, 9])
@pytest.mark.parametrize("S", [11, 20])
def test_kernel_equals_plain_past_ten_sources(data20, S, K, scattered):
    args = list(_band_args(data20, K, 0, True))
    args[1:6] = [a[:S].contiguous() for a in args[1:6]]
    got = ncc_cuda.ncc_eval_multi(*args, scattered=scattered)
    want = ncc_cuda.ncc_eval_multi_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (K, S, 16, 48)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), int((~same).sum())
    # every group has real costs
    assert bool((want[:, 10:] < PARAMS.cost_max).any())


def test_kernel_wrapper_rejects_bad_inputs(data):
    args = list(_band_args(data, 2, 0, True))
    planes = args[7]
    for bad, err in ((planes.double(), TypeError), (planes[..., :3], ValueError),
                     (planes.cpu(), ValueError)):
        args[7] = bad
        with pytest.raises(err):
            ncc_cuda.ncc_eval_multi_kernel(*args)
    args[7] = planes
    args[8] = args[8].cpu()  # x on the wrong device
    with pytest.raises(ValueError, match="x is on"):
        ncc_cuda.ncc_eval_multi_kernel(*args)


def _same(got, want) -> bool:
    """Equal entry for entry, NaN for NaN."""
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want)))
                .all())


def _rows_args(data, planes_fn, K: int, scale: int, rows: int, r0: int,
               cap: bool, c0: int = 20, cols: int = 45):
    """ncc_eval_multi's arguments for the pixels of rows r0..r0+rows-1 and
    columns c0..c0+cols-1 (rows x 45: for odd ``rows`` a multiple of
    neither launch's block, 32 and 128 pixels), with K plane fields from
    ``planes_fn(k, x, y)``."""
    halo = step_halo(scale)
    offs = PARAMS.tap_offsets(scale)
    ref_pad = _pad_rows(data.ref_img, halo, halo)
    crop = lambda a: a[..., c0:c0 + cols]
    refside = NCCRefSide(*map(crop, ncc_refside(
        ref_pad[r0:r0 + rows + 2 * halo], halo, rows, offs,
        PARAMS.sigma_spatial, PARAMS.sigma_color)))
    x, y = map(crop, geo.pixel_grid(rows, data.ref_img.shape[1],
                                    device=data.ref_img.device))
    y = y + float(r0)
    planes = torch.stack([planes_fn(k, x, y) for k in range(K)])
    return (refside, data.src_imgs, data.src_widths, data.src_heights, data.A,
            data.b, data.K_ref, planes, x, y, offs, PARAMS.cost_max,
            PARAMS.cap_radius(scale) if cap else 0.0)


def _random_planes(data, seed: int):
    return lambda k, x, y: pmrand.random_plane_field(
        tf.PRNGKey(seed + k, device=x.device), data.K_ref, x, y,
        data.depth_min, data.depth_max)


@pytest.mark.parametrize("scattered", [False, True])
@pytest.mark.parametrize("K", [1, 3, 5, 9])
@pytest.mark.parametrize("rows", [3, 5])
def test_kernel_equals_plain_off_tile(data, K, rows, scattered):
    """P = rows x 45 (135, 225) leaves the last block of either launch part
    empty."""
    args = _rows_args(data, _random_planes(data, 30 + K), K, 0, rows, 20,
                      cap=K != 3)
    assert (rows * 45) % 32 and (rows * 45) % 128
    got = ncc_cuda.ncc_eval_multi(*args, scattered=scattered)
    want = ncc_cuda.ncc_eval_multi_plain(*args)
    assert got.shape == (K, 3, rows, 45)
    assert _same(got, want)
    assert (want < PARAMS.cost_max).any() and (want == PARAMS.cost_max).any()


@pytest.mark.parametrize("cap,scattered", [(True, False), (False, True)])
def test_kernel_equals_plain_below_stack_extent(data, cap, scattered):
    """Source views whose valid extent is below the stack's Hp x Wp: taps
    clamp to the view's own last row and column."""
    S, Hp, Wp = data.src_imgs.shape
    small = data._replace(
        src_widths=torch.tensor([70.0, Wp, 51.0], device=data.A.device),
        src_heights=torch.tensor([Hp - 9.0, 31.0, Hp], device=data.A.device))
    args = _rows_args(small, _random_planes(data, 40), 5, 2, 6, 18, cap)
    got = ncc_cuda.ncc_eval_multi(*args, scattered=scattered)
    want = ncc_cuda.ncc_eval_multi_plain(*args)
    assert _same(got, want)
    full = ncc_cuda.ncc_eval_multi(*_rows_args(
        data, _random_planes(data, 40), 5, 2, 6, 18, cap),
        scattered=scattered)
    assert not _same(got, full)  # the extents reach the costs


@pytest.mark.parametrize("scattered", [False, True])
def test_kernel_equals_plain_degenerate_planes(data, scattered):
    """Planes with w = 0, NaN or infinite entries, and planes so close to
    the camera that the taps land far off the image."""
    base = _random_planes(data, 50)

    def planes(k, x, y):
        pl = base(k, x, y).clone()
        if k == 1:
            pl[..., 3] = 0.0
        elif k == 2:
            pl[::2, ::3] = float("nan")
            pl[1::2, ::5, 3] = float("inf")
        elif k == 3:
            pl[..., 3] = pl[..., 3] * 1e-4
        elif k == 4:
            pl[..., :3] = torch.tensor([1.0, 0.0, 0.0], device=pl.device)
        return pl

    args = _rows_args(data, planes, 5, 0, 4, 10, cap=True)
    got = ncc_cuda.ncc_eval_multi(*args, scattered=scattered)
    want = ncc_cuda.ncc_eval_multi_plain(*args)
    assert _same(got, want)
    nocap = args[:-1] + (0.0,)
    assert _same(ncc_cuda.ncc_eval_multi(*nocap, scattered=scattered),
                 ncc_cuda.ncc_eval_multi_plain(*nocap))


@pytest.mark.parametrize("scattered", [False, True])
def test_kernel_two_source_stacks_in_turn(data, dev, scattered):
    """Stacks of two scenes and sizes, and others at the first's shape,
    through the kernel in turn in one process, and the first again: the
    texture objects kept with each stack follow the stack they were made
    from."""
    scene = make_plane_scene(num_views=4, height=40, width=72, seed=11)
    other = build_solve_data(torch.as_tensor(scene.images, device=dev),
                             scene.cameras.to(dev))
    same_shape = data._replace(src_imgs=data.src_imgs.flip(-1).contiguous())
    stacks = [data, other, same_shape, data]
    stacks += [data._replace(src_imgs=data.src_imgs + float(i))
               for i in range(3)] + [data]
    for d in stacks:
        args = _rows_args(d, _random_planes(d, 60), 3, 0, 5, 12, cap=True)
        got = ncc_cuda.ncc_eval_multi(*args, scattered=scattered)
        want = ncc_cuda.ncc_eval_multi_plain(*args)
        assert _same(got, want)


def test_kernel_reads_any_source_stack(data):
    """Any float32 stack goes to the kernel: a narrow one (280-byte rows),
    one that starts a float past an allocation's start, a non-contiguous
    one, and a stack written in place after the kernel first read it."""
    args = list(_rows_args(data, _random_planes(data, 70), 2, 0, 3, 12,
                           cap=True))
    S, Hp, Wp = data.src_imgs.shape
    shifted = torch.zeros(S * Hp * Wp + 1, device=data.A.device)[1:]
    shifted = shifted.reshape(S, Hp, Wp).copy_(data.src_imgs)
    for src in (data.src_imgs[..., :70].contiguous(), shifted,
                data.src_imgs.transpose(1, 2).contiguous().transpose(1, 2)):
        args[1] = src
        assert _same(ncc_cuda.ncc_eval_multi_kernel(*args),
                     ncc_cuda.ncc_eval_multi_plain(*args))
    src = data.src_imgs.clone()
    args[1] = src
    before = ncc_cuda.ncc_eval_multi_kernel(*args)
    src.copy_(src.flip(-1).clone())
    got = ncc_cuda.ncc_eval_multi_kernel(*args)
    assert _same(got, ncc_cuda.ncc_eval_multi_plain(*args))
    assert not _same(got, before)


def test_solve_on_card_goes_through_the_kernel(dev):
    scene = make_plane_scene(num_views=3, height=64, width=80, seed=3)
    params = PatchMatchParams(max_iterations=2, max_scale=0)
    key = tf.PRNGKey(0)
    ncc_cuda.COUNTS.reset()
    on_card = solve_view(scene.images, scene.cameras, key, params,
                         device=dev)
    torch.cuda.synchronize()
    kernel, plain = ncc_cuda.COUNTS.kernel, ncc_cuda.COUNTS.plain
    br = solve_band_rows(params, 64, 80, 2)
    n_bands = _band_geometry(64, 80, 2, 0, False, br)[2]
    assert (kernel, plain) == (init_band_count(br, 64)
                               + params.max_iterations * 2 * n_bands * 2, 0)
    on_cpu = solve_view(scene.images, scene.cameras, key, params,
                        device="cpu")
    dc, dh = n(on_card.depth), n(on_cpu.depth)
    assert on_card.depth.device.type == "cuda"
    assert (np.abs(dc - dh) / dh > 1e-3).mean() <= SOLVE_FRAC_TOL
    gt = scene.gt_depth[0]
    for d in (dc, dh):
        assert np.isfinite(d).all()
        assert np.median(np.abs(d - gt) / gt) < 0.01
    # a geom solve warm-started from the photometric one, both devices
    kernel_before = ncc_cuda.COUNTS.kernel
    src = np.asarray(scene.gt_depth[1:])
    geom_card = solve_view(scene.images, scene.cameras, key, params, "geom",
                           device=dev, warm=on_card, src_depths=src)
    torch.cuda.synchronize()
    assert ncc_cuda.COUNTS.kernel - kernel_before == 1 + params.geom_iterations \
        * 2 * n_bands * 2
    geom_cpu = solve_view(scene.images, scene.cameras, key, params, "geom",
                          device="cpu", warm=on_cpu, src_depths=src)
    gc, gh = n(geom_card.depth), n(geom_cpu.depth)
    assert (np.abs(gc - gh) / gh > 1e-3).mean() <= SOLVE_FRAC_TOL
    assert np.median(np.abs(gc - gt) / gt) < 0.01


def _sample_args(data, scale: int, cap: bool, view: int):
    """sample_view_vals' arguments for a full-range random plane field over
    the whole reference view, sorted for source ``view``."""
    H, W = data.ref_img.shape
    x, y = geo.pixel_grid(H, W, device=data.ref_img.device)
    plane = pmrand.random_plane_field(
        tf.PRNGKey(20 + scale, device=x.device), data.K_ref, x, y,
        data.depth_min, data.depth_max)
    xf, yf, pf = x.reshape(-1), y.reshape(-1), plane.reshape(-1, 4)
    perm = ncc_sorted.sort_view(data.A[view], data.b[view], data.K_ref, pf,
                                xf, yf, *data.src_imgs.shape[1:])
    return (data.src_imgs[view], data.src_widths[view],
            data.src_heights[view], data.A[view], data.b[view], data.K_ref,
            pf, xf, yf, perm, PARAMS.tap_offsets(scale),
            PARAMS.cap_radius(scale) if cap else 0.0)


@pytest.mark.parametrize("cap", [True, False])
@pytest.mark.parametrize("scale", [0, 2])
def test_sample_kernel_matches_plain(data, scale, cap):
    T = len(PARAMS.tap_offsets(scale))
    flags = []
    for view in range(data.src_imgs.shape[0]):
        args = _sample_args(data, scale, cap, view)
        before = ncc_sorted.COUNTS.kernel
        got = ncc_sorted.sample_view_vals_kernel(*args)
        want = ncc_sorted.sample_view_vals_plain(*args)
        torch.cuda.synchronize()
        assert ncc_sorted.COUNTS.kernel == before + 1
        assert got.shape == (T + 1, 48 * 96)
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        assert bool(same.all()), view
        flags.append(want[T].mean().item())
    assert 0.0 < max(flags) and min(flags) < 1.0


@pytest.mark.parametrize("cap", [True, False])
def test_sorted_path_matches_ncc_kernel(data, cap):
    H, W = data.ref_img.shape
    offs = PARAMS.tap_offsets(2)
    halo = step_halo(2)
    refside = ncc_refside(_pad_rows(data.ref_img, halo, halo), halo, H, offs,
                          PARAMS.sigma_spatial, PARAMS.sigma_color)
    args = _sample_args(data, 2, cap, 0)
    x, y = args[7].reshape(H, W), args[8].reshape(H, W)
    plane = args[6].reshape(H, W, 4)
    common = (refside, data.src_imgs, data.src_widths, data.src_heights,
              data.A, data.b, data.K_ref)
    cap_r = args[11]
    got = ncc_sorted.ncc_eval_sorted(*common, plane, x, y, offs,
                                     PARAMS.cost_max, cap_r)
    want = ncc_cuda.ncc_eval_one(*common, plane, x, y, offs, PARAMS.cost_max,
                                 cap_r)
    assert got.shape == want.shape == (3, H, W)
    assert frac_beyond(got, want, 1e-4) < FRAC_TOL


def _sorted_call(d, planes_fn, scale: int, rows: int, r0: int, cap: bool):
    """ncc_eval_sorted's arguments for rows x 45 pixels (a multiple of
    neither 32 nor 128 for odd ``rows``), one field from
    ``planes_fn(0, x, y)``."""
    args = _rows_args(d, planes_fn, 1, scale, rows, r0, cap)
    return args[:7] + (args[7][0],) + args[8:]


@pytest.mark.parametrize("cap", [True, False])
@pytest.mark.parametrize("scale", [0, 2])
def test_fused_sorted_equals_plain_chain(data, scale, cap):
    """The whole view through the fused kernel, and 5 x 45 pixels."""
    H, W = data.ref_img.shape
    for rows, r0 in ((H, 0), (5, 20)):
        args = _sorted_call(data, _random_planes(data, 80 + scale), scale,
                            rows, r0, cap)
        before = (ncc_sorted.COUNTS.forms.get("fused", 0),
                  ncc_sorted.KEY_COUNTS.kernel)
        got = ncc_sorted.ncc_eval_sorted_kernel(*args)
        want = ncc_sorted.ncc_eval_sorted_plain(*args)
        torch.cuda.synchronize()
        S = data.src_imgs.shape[0]
        assert (ncc_sorted.COUNTS.forms["fused"],
                ncc_sorted.KEY_COUNTS.kernel) == (before[0] + S,
                                                  before[1] + S)
        assert got.shape == want.shape == (S, rows, 45)
        assert _same(got, want)
        assert (want < PARAMS.cost_max).any() and \
            (want == PARAMS.cost_max).any()


def zero_extent_data(device):
    """A 1+3-view scene whose last source is the sharded pipeline's dummy:
    all-zero image, identity camera, width = height = 0
    (parallel.view_sharding.SceneBatch.scene_inputs)."""
    from mpmvs_torch.camera import Camera, CameraStack

    scene = make_plane_scene(num_views=4, height=48, width=96, seed=7)
    images = torch.as_tensor(scene.images).clone()
    images[-1] = 0.0
    cams = [scene.cameras.view(v) for v in range(3)] + [Camera.create(
        K=np.eye(3), R=np.eye(3), t=np.zeros(3), width=0, height=0)]
    return build_solve_data(images.to(device),
                            CameraStack.stack(cams).to(device))


@pytest.mark.parametrize("scattered", [False, True])
def test_zero_extent_source_equals_plain(dev, scattered):
    d = zero_extent_data(dev)
    args = _rows_args(d, _random_planes(d, 60), 9, 0, 7, 18, True)
    got = ncc_cuda.ncc_eval_multi(*args, scattered=scattered)
    want = ncc_cuda.ncc_eval_multi_plain(*args)
    torch.cuda.synchronize()
    assert _same(got, want)
    assert bool((want[:, -1] == PARAMS.cost_max).all())
    assert bool((want[:, :-1] < PARAMS.cost_max).any())
    args = _sorted_call(d, _random_planes(d, 61), 0, 7, 18, True)
    got = ncc_sorted.ncc_eval_sorted_kernel(*args)
    want = ncc_sorted.ncc_eval_sorted_plain(*args)
    torch.cuda.synchronize()
    assert _same(got, want)
    assert bool((want[-1] == PARAMS.cost_max).all())


def test_fused_sorted_equals_plain_chain_below_stack_extent(data):
    S, Hp, Wp = data.src_imgs.shape
    small = data._replace(
        src_widths=torch.tensor([70.0, Wp, 51.0], device=data.A.device),
        src_heights=torch.tensor([Hp - 9.0, 31.0, Hp], device=data.A.device))
    args = _sorted_call(small, _random_planes(data, 90), 2, 7, 18, True)
    got = ncc_sorted.ncc_eval_sorted_kernel(*args)
    assert _same(got, ncc_sorted.ncc_eval_sorted_plain(*args))
    full = _sorted_call(data, _random_planes(data, 90), 2, 7, 18, True)
    assert not _same(got, ncc_sorted.ncc_eval_sorted_kernel(*full))


def test_fused_sorted_equals_plain_chain_nonfinite_planes(data):
    base = _random_planes(data, 95)

    def planes(k, x, y):
        pl = base(k, x, y).clone()
        pl[::2, ::3] = float("nan")
        pl[1::2, ::5, 3] = float("inf")
        pl[1::3, 1::4, 3] = 0.0
        pl[2::3, 2::4, 3] = pl[2::3, 2::4, 3] * 1e-4
        return pl

    for cap in (True, False):
        args = _sorted_call(data, planes, 0, 9, 10, cap)
        assert _same(ncc_sorted.ncc_eval_sorted_kernel(*args),
                     ncc_sorted.ncc_eval_sorted_plain(*args))


def test_key_kernel_equals_plain(data):
    args = _sample_args(data, 2, False, 1)
    A, b, K_ref, pf, xf, yf = args[3], args[4], args[5], args[6], args[7], \
        args[8]
    pf = pf.clone()
    pf[::7] = float("nan")
    pf[1::11, 3] = 0.0
    _, Hp, Wp = data.src_imgs.shape
    terms = ncc_sorted.view_terms(data.src_widths, data.src_heights, data.A,
                                  data.b, K_ref, pf.device)
    before = ncc_sorted.KEY_COUNTS.kernel
    got = ncc_sorted.view_keys_kernel(terms, 1, pf, xf, yf, Hp, Wp)
    want = ncc_sorted.bucket_keys_plain(A, b, K_ref, pf, xf, yf, Hp, Wp)
    assert ncc_sorted.KEY_COUNTS.kernel == before + 1
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert len(torch.unique(got)) > 10


def test_fused_wrapper_rejects_bad_inputs(data):
    args = list(_sorted_call(data, _random_planes(data, 97), 0, 3, 10,
                             True))
    record = ncc_sorted.pixel_record(args[0], args[7].reshape(-1, 4),
                                     args[8].reshape(-1), args[9].reshape(-1))
    N = record.shape[0]
    perm = torch.arange(N, device=record.device)
    terms = ncc_sorted.view_terms(data.src_widths, data.src_heights, data.A,
                                  data.b, data.K_ref, record.device)
    view = (data.src_imgs, 0, terms)
    offs = args[10]
    with pytest.raises(ValueError, match="record"):
        ncc_sorted.view_costs_kernel(record[:, :-4].contiguous(), *view,
                                     perm, offs)
    with pytest.raises(ValueError, match="perm has shape"):
        ncc_sorted.view_costs_kernel(record[1:], *view, perm, offs)
    with pytest.raises(ValueError, match="view"):
        ncc_sorted.view_costs_kernel(record, data.src_imgs, 3, terms, perm,
                                     offs)
    with pytest.raises(ValueError, match="terms"):
        ncc_sorted.view_costs_kernel(record, data.src_imgs, 0,
                                     terms._replace(ab=terms.ab[:2]), perm,
                                     offs)
    with pytest.raises(TypeError, match="int64"):
        ncc_sorted.view_costs_kernel(record, *view, perm.int(), offs)
    with pytest.raises(ValueError, match="CUDA"):
        ncc_sorted.view_costs_kernel(record.cpu(), *view, perm.cpu(), offs)


def test_sample_kernel_wrapper_rejects_bad_inputs(data):
    args = list(_sample_args(data, 0, True, 0))
    good = list(args)
    for i, bad, err, match in (
            (6, args[6].double(), TypeError, "float32"),
            (6, args[6][:, :3], ValueError, "plane"),
            (6, args[6].cpu(), ValueError, "CUDA"),
            (7, args[7].cpu(), ValueError, "x is on"),
            (9, args[9].to(torch.int32), TypeError, "int64"),
            (9, args[9][:-1], ValueError, "perm has shape"),
            (0, data.src_imgs, ValueError, "src_img")):
        args = list(good)
        args[i] = bad
        with pytest.raises(err, match=match):
            ncc_sorted.sample_view_vals_kernel(*args)


def test_sorted_solve_on_card_goes_through_the_sample_kernel(dev):
    scene = make_plane_scene(num_views=3, height=64, width=80, seed=3)
    params = PatchMatchParams(max_iterations=2, max_scale=0,
                              sampler="sorted", **REFERENCE)
    key = tf.PRNGKey(0)
    ncc_cuda.COUNTS.reset()
    ncc_sorted.COUNTS.reset()
    ncc_sorted.KEY_COUNTS.reset()
    on_card = solve_view(scene.images, scene.cameras, key, params,
                         device=dev)
    torch.cuda.synchronize()
    S = 2
    br = solve_band_rows(params, 64, 80, S)
    n_bands = _band_geometry(64, 80, S, 0, False, br)[2]
    steps = params.max_iterations * 2 * n_bands
    per_view = S * init_band_count(br, 64) + steps * 2 * S
    assert (ncc_sorted.COUNTS.kernel, ncc_sorted.COUNTS.plain) == (
        per_view, 0)
    assert ncc_sorted.COUNTS.forms == {"fused": per_view}
    assert (ncc_sorted.KEY_COUNTS.kernel,
            ncc_sorted.KEY_COUNTS.plain) == (per_view, 0)
    assert (ncc_cuda.COUNTS.kernel, ncc_cuda.COUNTS.plain) == (steps * 2, 0)
    on_cpu = solve_view(scene.images, scene.cameras, key, params,
                        device="cpu")
    dc, dh = n(on_card.depth), n(on_cpu.depth)
    assert (np.abs(dc - dh) / dh > 1e-3).mean() <= SOLVE_FRAC_TOL
    gt = scene.gt_depth[0]
    for d in (dc, dh):
        assert np.isfinite(d).all()
        assert np.median(np.abs(d - gt) / gt) < 0.01


def _bilateral_inputs(H, W, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    blocks = torch.rand((1, 3, max(H // 8, 1), max(W // 8, 1)), generator=g)
    bgr = (torch.nn.functional.interpolate(blocks, size=(H, W))[0]
           .permute(1, 2, 0) * 235.0 + torch.rand((H, W, 3), generator=g)
           * 20.0)
    prob = torch.rand((H, W), generator=g)
    return bgr.contiguous().to(dev), prob.to(dev)


@pytest.mark.parametrize("shape", [(37, 130), (213, 320), (8, 32)])
def test_bilateral_kernel_matches_plain(dev, shape):
    bgr, prob = _bilateral_inputs(*shape, seed=shape[0], dev=dev)
    before = bilateral_cuda.COUNTS.kernel
    got = bilateral_cuda.bilateral_refine(bgr, prob)
    want = bilateral_cuda.bilateral_refine_plain(bgr, prob)
    torch.cuda.synchronize()
    assert bilateral_cuda.COUNTS.kernel == before + 1
    assert got.shape == shape and got.device.type == "cuda"
    assert (got - want).abs().max().item() <= 1e-5
    assert ((got > 0.6) != (want > 0.6)).float().mean().item() <= 1e-4


def _guide_8bit(H, W, seed, dev):
    bgr, prob = _bilateral_inputs(H, W, seed, dev)
    return torch.clamp(torch.round(bgr), 0.0, 255.0), prob


@pytest.mark.parametrize("radius", [0, 18, 24])
@pytest.mark.parametrize("shape", [(8, 32), (37, 130), (213, 320)])
def test_bilateral_table_form_equals_plain(dev, shape, radius):
    bgr, prob = _guide_8bit(*shape, seed=shape[1], dev=dev)
    before = bilateral_cuda.COUNTS.forms.get("table", 0)
    got = bilateral_cuda.bilateral_refine_kernel(bgr, prob, radius)
    want = bilateral_cuda.bilateral_refine_plain(bgr, prob, radius)
    torch.cuda.synchronize()
    assert bilateral_cuda.COUNTS.forms["table"] == before + 1
    assert torch.equal(got, want)
    exact = bilateral_cuda._launch(bgr, prob, radius,
                                   bilateral_cuda.SIGMA_SPATIAL,
                                   bilateral_cuda.SIGMA_COLOR, "float")
    assert torch.equal(exact, want)


def test_bilateral_table_equals_plain_table(dev):
    bilateral_cuda.colour_table.cache_clear()
    before = bilateral_cuda.TABLE_COUNTS.kernel
    got = bilateral_cuda.colour_table(bilateral_cuda.SIGMA_COLOR,
                                      torch.device("cuda", 0))
    again = bilateral_cuda.colour_table(bilateral_cuda.SIGMA_COLOR,
                                        torch.device("cuda", 0))
    assert got is again and bilateral_cuda.TABLE_COUNTS.kernel == before + 1
    assert torch.equal(got, bilateral_cuda.colour_table_plain(
        bilateral_cuda.SIGMA_COLOR, dev))


def test_bilateral_form_follows_the_guide(dev):
    """One value off the integers, or out of [0, 255], and the wrapper
    takes the float form; an 8-bit guide takes the table form."""
    bgr, prob = _guide_8bit(40, 70, 3, dev)
    half, over = bgr.clone(), bgr.clone()
    half[7, 11, 1] += 0.5
    over[30, 2, 0] = 256.0
    for guide, form in ((bgr, "table"), (half, "float"), (over, "float")):
        bilateral_cuda.COUNTS.reset()
        got = bilateral_cuda.bilateral_refine(guide, prob)
        assert bilateral_cuda.COUNTS.forms == {form: 1}
        assert torch.equal(got, bilateral_cuda.bilateral_refine_plain(guide,
                                                                      prob))
    with pytest.raises(ValueError, match="form"):
        bilateral_cuda._launch(bgr, prob, 18, bilateral_cuda.SIGMA_SPATIAL,
                               bilateral_cuda.SIGMA_COLOR, "half")


def test_bilateral_kernel_uniform_image(dev):
    bgr = torch.full((24, 140, 3), 128.0, device=dev)
    prob = torch.full((24, 140), 0.7, device=dev)
    got = bilateral_cuda.bilateral_refine(bgr, prob)
    want = bilateral_cuda.bilateral_refine_plain(bgr, prob)
    assert torch.equal(got, want)
    assert (got - 0.7).abs().max().item() <= 1e-5


def test_bilateral_kernel_rejects_bad_inputs(dev):
    bgr, prob = _bilateral_inputs(16, 24, 0, dev)
    with pytest.raises(ValueError, match="CUDA"):
        bilateral_cuda.bilateral_refine_kernel(bgr.cpu(), prob.cpu())
    with pytest.raises(ValueError, match="bgr is on"):
        bilateral_cuda.bilateral_refine_kernel(bgr.cpu(), prob)
    with pytest.raises(ValueError, match="radius"):
        bilateral_cuda.bilateral_refine_kernel(bgr, prob, radius=25)


def test_sky_mask_on_card_matches_cpu(dev):
    rng = np.random.default_rng(2)
    img = np.zeros((120, 160, 3), np.float32)
    img[:48] = (235, 180, 135)
    img[48:] = rng.uniform(30, 120, (72, 160, 3)).astype(np.uint8)
    net_card = sky.load_sky_net(device=dev)
    before = bilateral_cuda.COUNTS.kernel
    _, m_card = sky.sky_mask(torch.as_tensor(img, device=dev), net_card)
    assert bilateral_cuda.COUNTS.kernel == before + 1
    _, m_cpu = sky.sky_mask(torch.as_tensor(img),
                            sky.load_sky_net(device="cpu"))
    assert (n(m_card) != n(m_cpu)).mean() <= 0.002
    assert n(m_card)[:40].mean() > 0.9 and n(m_card)[56:].mean() < 0.05


def test_prior_raster_on_card_matches_cpu(dev):
    rng = np.random.default_rng(4)
    seeds = np.stack([rng.integers(0, 300, 4000), rng.integers(0, 200, 4000)],
                     -1).astype(np.int32)
    tris = tprior.delaunay_triangulate(seeds)
    values = np.arange(1, len(tris) + 1, dtype=np.int32)
    on_card = np.zeros((200, 300), np.int32)
    tprior.fill_triangles(on_card, tris, values, dev)
    on_cpu = np.zeros((200, 300), np.int32)
    tprior.fill_triangles(on_cpu, tris, values, "cpu")
    np.testing.assert_array_equal(on_card, on_cpu)
    assert (on_card > 0).mean() > 0.9


@pytest.fixture(scope="module")
def geom_scene(dev):
    return geom_cases.scene_data(dev)


def _geom_equal(cases):
    """Each case through the dispatcher (one launch) equals the plain twin
    on the same CUDA tensors."""
    for c, plane, x, y, cap in cases:
        before = geom_cost_cuda.COUNTS.kernel
        got = geom_cases.call(geom_cost.geom_consistency_cost, c, plane, x,
                              y, cap)
        torch.cuda.synchronize()
        assert geom_cost_cuda.COUNTS.kernel == before + 1
        assert got.device.type == "cuda"
        want = geom_cases.call(geom_cost.geom_consistency_cost_plain, c,
                               plane, x, y, cap)
        assert torch.equal(got, want), int((got != want).sum())
        assert bool((want < cap).any()) and bool((want == cap).any())


@pytest.mark.parametrize("S", [1, 10, 20])
@pytest.mark.parametrize("K", [1, 4, 5, 9, 13])
def test_geom_kernel_equals_plain(geom_scene, K, S):
    _geom_equal(geom_cases.stacked_case(*geom_scene, K, S))


@pytest.mark.parametrize("K", [1, 3, 5])
def test_geom_kernel_does_not_spill(dev, K):
    """Each instantiation (1, 3 and 5 fields held, both index widths)
    keeps its fields and cameras in registers: no local memory."""
    for wide in (False, True):
        attrs = geom_cost_cuda.kernel_attributes(K, wide)
        assert attrs["local_bytes"] == 0 and 0 < attrs["registers"] <= 255


@pytest.mark.parametrize("case", ["layout", "degenerate", "edge", "axis"])
def test_geom_kernel_equals_plain_on_hard_inputs(geom_scene, case):
    cases = {"layout": geom_cases.layout_cases,
             "degenerate": geom_cases.degenerate_case,
             "edge": geom_cases.edge_cases,
             "axis": geom_cases.axis_case}[case](*geom_scene)
    _geom_equal(cases)


def test_geom_kernel_wrapper_rejects_bad_inputs(geom_scene):
    scene, data = geom_scene
    c = geom_cases.cams(data)
    x, y = geom_cases.packed(data, 4, 8)
    plane = geom_cases.planes(scene, data, 1, 1, x, y)[0]
    kernel = geom_cost_cuda.geom_consistency_cost_kernel
    for bad, err in ((plane.double(), TypeError),
                     (plane[..., :3], ValueError),
                     (plane.cpu(), ValueError)):
        with pytest.raises(err):
            geom_cases.call(kernel, c, bad, x, y)
    with pytest.raises(ValueError, match="x is on"):
        geom_cases.call(kernel, c, plane, x.cpu(), y)
    c["K_src"] = c["K_src"][:2]
    with pytest.raises(ValueError, match="K_src has shape"):
        geom_cases.call(kernel, c, plane, x, y)


def test_geom_solve_on_card_goes_through_the_kernel(dev):
    scene = make_plane_scene(num_views=3, height=64, width=80, seed=3)
    params = PatchMatchParams(max_iterations=1, max_scale=0)
    key = tf.PRNGKey(0)
    warm = solve_view(scene.images, scene.cameras, key, params, device=dev)
    geom_cost_cuda.COUNTS.reset()
    geom = solve_view(scene.images, scene.cameras, key, params, "geom",
                      device=dev, warm=warm,
                      src_depths=np.asarray(scene.gt_depth[1:]))
    torch.cuda.synchronize()
    br = solve_band_rows(params, 64, 80, 2, True)
    n_bands = _band_geometry(64, 80, 2, 0, True, br)[2]
    assert (geom_cost_cuda.COUNTS.kernel, geom_cost_cuda.COUNTS.plain) == (
        2 * params.geom_iterations * 2 * n_bands, 0)
    gt = scene.gt_depth[0]
    assert np.median(np.abs(n(geom.depth) - gt) / gt) < 0.01
