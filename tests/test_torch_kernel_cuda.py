"""The port's CUDA kernels on the card (marked ``cuda``; each test skips
where ``torch.cuda.is_available()`` is false): the NCC kernel
(``csrc/ncc_eval.cu``), the sorted path's sample kernel
(``csrc/ncc_samples.cu``) and the sky stage's bilateral kernel
(``csrc/bilateral_refine.cu``).

This file imports only the port (no JAX), so it runs on a CUDA machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

(``--noconftest`` skips tests/conftest.py, which configures JAX.)

Tolerances:
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
  full-range random field, cap on and off, scales 0 and 2, both output
  orders): equal, NaN for NaN, because both share ncc_eval.cu's operations
  one for one. The sorted path's costs vs the NCC kernel's at K=1: as the
  kernel vs plain above (the ZNCC sums the taps in the kernel's order, so
  they are expected to be equal).
* a reference-semantics solve with ``sampler="sorted"`` on the card vs on
  the CPU: as the photometric solve above; the sample kernel launches once
  per source view for the init band and for each random trial of every
  band step, the NCC kernel twice per band step (K=9 and K=3), and no plain
  version runs.
* bilateral kernel vs its plain version on the same CUDA tensors, at sizes
  that are not multiples of the 32x8 tile: max |diff| <= 1e-5 and at most
  1e-4 of the thresholded pixels differ (the kernel rounds each operation
  as the plain version's eager ops do, so they are expected to be equal);
  on a uniform image both equal each other exactly and stay within 1e-5 of
  the uniform value up to the borders.
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
from mpmvs_torch.ops import bilateral_cuda, ncc_cuda, ncc_sorted
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
        got = ncc_sorted.sample_view_vals(*args)
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
    on_card = solve_view(scene.images, scene.cameras, key, params,
                         device=dev)
    torch.cuda.synchronize()
    S = 2
    br = solve_band_rows(params, 64, 80, S)
    n_bands = _band_geometry(64, 80, S, 0, False, br)[2]
    steps = params.max_iterations * 2 * n_bands
    assert (ncc_sorted.COUNTS.kernel, ncc_sorted.COUNTS.plain) == (
        S * init_band_count(br, 64) + steps * 2 * S, 0)
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
