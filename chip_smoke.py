#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mpmvs_torch) on one CUDA card.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # phases 1, 2 and 5 (builds + kernel checks)

Phases, in order; any failure raises and the script exits non-zero:

1. Device and build: the card's name and power limit, and the ``nvcc``
   builds of ``mpmvs_torch/csrc/ncc_eval.cu``, ``ncc_samples.cu`` and
   ``bilateral_refine.cu``, started together, with their time.
2. NCC kernel vs plain: ``ncc_eval_multi`` on the card against its plain
   PyTorch version at K in {1, 5, 9}, S = 10, scales 0 and 2, on
   ground-truth and random planes at the default footprint cap, through
   both of the kernel's launches (tile and view-major); then both
   timed with CUDA events at the main path's band shape (K=9, scale 0),
   and the kernel alone at K=5 on a full-range random field at scale 0
   (view-major launch, as the solver takes it for such trials) and at K=1
   on the init field over every pixel at scale 2, each beside its bound and
   the time PERF.md holds from before the kernel's redesign.
3. At 3200x2130 with 10 sources and the solve's band rows, from the same
   inputs and key, through the kernel and through the plain version: the
   K=1 initial scoring of every pixel, and one half-iteration at scales 2,
   1 and 0; plus the scale-2 step with a constant-cost stand-in for the
   NCC, which times the eager glue around the kernel.
4. The photometric path at 3200x2130 with 1+10 views per estimated view
   (3 of 11 views estimated): ``Pipeline.load_arrays`` + ``Pipeline.run``
   (3 scales x 3 iterations, no geometric pass, no prior, no sky), writing
   .dmb files and the fused PLY to a temporary directory; checks depth
   accuracy, the PLY, and that every NCC call went through the kernel, as
   often as the schedule implies.
5. Bilateral kernel vs plain at 3200x2130: ``bilateral_refine`` on the card
   against its plain version on view 0's guide image (its top fifth painted
   sky blue from here on) with the sky net's probability, and on a
   structured random image; max |diff| <= 1e-5 and at most 1e-4 of the
   thresholded mask pixels differ; both timed with CUDA events.
6. The full path: the same 1+10-view scene with the sky band, default
   ``ConfigParams`` with ``sky_seg=True`` through ``Pipeline.run``: the
   photometric pass, ``geom_0`` with its planar-prior sub-run, ``geom_1``,
   sky masks, fusion. Checks depth accuracy on the non-sky rows after every
   pass, each view's sky fraction against the painted band, that fusing
   with the masks keeps no more points than without, and the launches of
   both kernels against the stated schedule.
7. The sorted path (runs after phase 3, before the sky is painted), on
   view 0's full-range random init field at 3200x2130 with 10 sources:
   (a) the sample kernel ``csrc/ncc_samples.cu`` against its plain version
   for every view, cap off and on, and, cap off, at scale 0 on a random
   field over the half-width packed pixels of a refinement trial: no entry
   may differ; (b)
   ``ncc_eval_sorted`` against the NCC kernel at K=1; (c) CUDA-event times
   of the NCC kernel at K=1 on the coherent default init field and on the
   full-range field (view-major launch), and of the sorted path split into
   sort, sample kernel, un-permute and ZNCC; (d) one photometric solve of
   view 0 with the reference's search semantics, with ``sampler="sorted"``
   and with ``"auto"``: seconds, median |d-gt|/gt < 1%, and both kernels'
   launches against the stated schedule, with no plain call; the two
   solves' depth, normal and cost may differ on at most MISMATCH_TOL of the
   pixels.

Before them, a line gives each kernel's bound (the least time the card
could take at the timed shape) beside its time. The last three lines of
standard output are the card's name and power limit (``nvidia-smi``), a
JSON object describing each kernel, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``mpmvs_torch`` package beside this file, the script exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H_FULL, W_FULL = 2130, 3200   # the reference's max_image_size operating point
N_SRC = 10                    # sources per reference view (bench.py's point)
PHASE2_ROWS = 64              # band rows of the kernel-vs-plain check
MISMATCH_TOL = 1e-3           # max fraction of entries differing by > 1e-4
ESTIMATED = (0, 1, 2)         # views estimated in phases 4 and 6
SKY_ROWS = H_FULL // 5        # top rows painted sky blue before phase 5
SKY_BGR = (235.0, 180.0, 135.0)
GROUND_MARGIN = 24            # rows below the band left out of depth checks
BILATERAL_ERR_TOL = 1e-5      # max |kernel - plain| of the refined map
BILATERAL_MASK_TOL = 1e-4     # max fraction of thresholded pixels differing
SKY_FRAC_TOL = 0.02           # |sky fraction - painted fraction| per view
# NCC launches per estimated view of the full path, from the schedule as
# stated (one band of 2130 rows in every mode, asserted in main):
#   photometric: 1 init + 3 scales x 3 iterations x 2 colours x 2 calls
#   geom_0:      1 init + 2 iterations x 2 colours x 2 calls
#   prior run:   1 init + 3 iterations x 2 colours x 2 calls
#   geom_1:      1 init + 2 iterations x 2 colours x 2 calls
NCC_PHOTOMETRIC, NCC_GEOM, NCC_PRIOR = 1 + 3 * 3 * 2 * 2, 1 + 2 * 2 * 2, \
    1 + 3 * 2 * 2
# Launches of one photometric solve with the reference's search semantics
# (phase 7; tools.ab_deviations.REFERENCE), one band of H_FULL rows: with
# sampler="sorted", the sample kernel once per source view for
# the init field and for each of the 2 random trials of every band step
# (3 scales x 3 iterations x 2 colours), the NCC kernel twice per step (K=9
# candidates, K=3 trials); with "auto", the NCC kernel as in phase 4.
SAMPLES_SORTED = N_SRC + 3 * 3 * 2 * 2 * N_SRC
NCC_SORTED, NCC_AUTO = 3 * 3 * 2 * 2, 1 + 3 * 3 * 2 * 2
# The NCC kernel's times before its redesign (PERF.md section 6; NVIDIA
# H100 80GB HBM3 at 700 W): K=9 at the band shape, K=1 on the coherent
# init field; K=5 on a full-range field was not timed then.
NCC_MS_BEFORE = {"K=9 gt": "61.87-62.2 ms",
                 "K=5 full-range": "not measured", "K=1 init": "17.2 ms"}


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def differs(a, b):
    """Entries that differ by > 1e-4; a non-finite entry differs unless both
    are NaN or both the same infinity."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    return torch.where(fin, (a - b).abs() > 1e-4, ~same)


def compare(a, b):
    """(fraction of entries differing by > 1e-4, max |a - b| over entries
    finite in both)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    diff = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    return differs(a, b).float().mean().item(), diff.max().item()


def state_diff(a, b, mask):
    """(fraction of the masked pixels whose plane, cost or view selection
    differ between two PatchMatchStates, max |cost diff|)."""
    bad = (differs(a.plane, b.plane).any(-1) | differs(a.cost, b.cost)
           | (a.sel != b.sel)) & mask
    frac = bad.float().sum().item() / mask.float().sum().item()
    return frac, compare(a.cost, b.cost)[1]


def view_sel():
    """pair lists of the 11-view scene: ESTIMATED views take all others as
    sources; the rest are sources only."""
    V = N_SRC + 1
    return [[j for j in range(V) if j != i] if i in ESTIMATED else []
            for i in range(V)]


def paint_sky(scene):
    """Paint the top SKY_ROWS of every view flat sky blue (colours) and its
    grey (images, cv2's BGR -> grey weights), in place, as the sky tests of
    the JAX package do (tests/test_models.py:93-95)."""
    b, g, r = SKY_BGR
    scene.colors[:, :SKY_ROWS] = SKY_BGR
    scene.images[:, :SKY_ROWS] = 0.114 * b + 0.587 * g + 0.299 * r


def make_scene():
    """The 3200x2130, 1+10-view synthetic plane scene (host arrays)."""
    from mpmvs_torch.utils.synthetic import make_plane_scene

    t0 = time.perf_counter()
    scene = make_plane_scene(num_views=N_SRC + 1, height=H_FULL,
                             width=W_FULL, seed=0)
    log(f"scene: {N_SRC + 1} views at {W_FULL}x{H_FULL} in "
        f"{time.perf_counter() - t0:.1f} s")
    return scene


def band_inputs(data, params, scale: int, y0: int, rows: int, phase: int):
    """Reference side and packed coordinates of one band, as _band_step
    builds them."""
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.packing import packed_coords
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo

    halo = step_halo(scale)
    H, W = data.ref_img.shape
    ref_pad = _pad_rows(data.ref_img, halo, halo)
    refside = ncc_refside(ref_pad[y0:y0 + rows + 2 * halo], halo, rows,
                          params.tap_offsets(scale), params.sigma_spatial,
                          params.sigma_color, pack_phase=phase)
    x_p, y_p = packed_coords(y0, rows, W // 2, phase, device=data.ref_img.device)
    return refside, x_p, y_p


def test_planes(data, scene, params, kind: str, K: int, x_p, y_p, key):
    """K plane fields at the packed pixels: the ground-truth plane with
    slightly scaled depths, or independent random planes."""
    import torch
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf

    dev = x_p.device
    if kind == "random":
        keys = tf.split(key, K)
        return torch.stack([pmrand.random_plane_field(
            keys[k], data.K_ref, x_p, y_p, data.depth_min, data.depth_max)
            for k in range(K)])
    gt = torch.as_tensor(scene.gt_depth[0], device=dev)
    d = gt[y_p.long(), x_p.long()]
    n_world = torch.as_tensor(scene.gt_normal_world, device=dev)
    n_cam = geo.normal_world_to_cam(data.R_ref, n_world.expand(d.shape + (3,)))
    return torch.stack([geo.plane_from_depth_normal(
        data.K_ref, x_p, y_p, d * (1.0 + 0.002 * k), n_cam) for k in range(K)])


def phase_kernel_vs_plain(data, scene, params, band_rows: int):
    """Phase 2. Returns (worst mismatch fraction, max abs err, kernel ms,
    plain ms) with the times at the main path's band shape."""
    import torch
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.ncc_cuda import (ncc_eval_multi, ncc_eval_multi_plain)
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo
    from mpmvs_torch.solver import _init_plane
    from mpmvs_torch.utils.roofline import ncc_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    args = (data.src_imgs, data.src_widths, data.src_heights, data.A, data.b,
            data.K_ref)
    worst, max_err = 0.0, 0.0
    key = tf.PRNGKey(7, device=data.ref_img.device)
    for scale in (0, 2):
        offs = params.tap_offsets(scale)
        cap = params.cap_radius(scale)
        refside, x_p, y_p = band_inputs(data, params, scale, H_FULL // 4 * 2,
                                        PHASE2_ROWS, 0)
        for kind in ("gt", "random"):
            for K in (1, 5, 9):
                planes = test_planes(data, scene, params, kind, K, x_p, y_p,
                                     tf.fold_in(key, 10 * scale + K))
                want = ncc_eval_multi_plain(refside, *args, planes, x_p, y_p,
                                            offs, params.cost_max, cap)
                for launch in ("tile", "view-major"):
                    got = ncc_eval_multi(refside, *args, planes, x_p, y_p,
                                         offs, params.cost_max, cap,
                                         scattered=launch == "view-major")
                    torch.cuda.synchronize()
                    frac, err = compare(got, want)
                    unequal = int((~((got == want) | (torch.isnan(got)
                                                      & torch.isnan(want))))
                                  .sum().item())
                    valid = (want < params.cost_max).float().mean().item()
                    log(f"  scale {scale} {kind:6s} K={K} {launch:10s}: "
                        f"frac>1e-4 {frac:.3e} max|diff| {err:.3e}, entries "
                        f"not bit-equal {unequal} of {got.numel()} "
                        f"(cost<{params.cost_max} in {valid:.3f})")
                    worst, max_err = max(worst, frac), max(max_err, err)
    if worst > MISMATCH_TOL:
        raise AssertionError(f"kernel vs plain: {worst:.3e} of entries "
                             f"differ by > 1e-4 (limit {MISMATCH_TOL})")

    # timing at the main path's band shape: K=9 candidates at scale 0
    offs = params.tap_offsets(0)
    refside, x_p, y_p = band_inputs(data, params, 0, 0, band_rows, 0)
    planes = test_planes(data, scene, params, "gt", 9, x_p, y_p, key)
    call = lambda fn: (lambda: fn(refside, *args, planes, x_p, y_p, offs,
                                  params.cost_max, params.cap_radius(0)))
    ms_kernel = cuda_time_ms(call(ncc_eval_multi), reps=5)
    ms_plain = cuda_time_ms(call(ncc_eval_multi_plain), reps=2)
    taps = 9 * N_SRC * band_rows * (W_FULL // 2) * len(offs)
    log(f"  timing K=9 S={N_SRC} {band_rows}x{W_FULL // 2}: kernel "
        f"{ms_kernel:.3f} ms ({taps / ms_kernel / 1e6:.3f} Gtaps/s), plain "
        f"{ms_plain:.3f} ms ({taps / ms_plain / 1e6:.3f} Gtaps/s)")

    # the kernel alone at the band step's K=5 trial call on a full-range
    # field, and at init scoring (K=1, every pixel, scale 2)
    src_bytes = 4 * N_SRC * H_FULL * W_FULL
    trials = test_planes(data, scene, params, "random", 5, x_p, y_p,
                         tf.fold_in(key, 5))
    ms_k5 = cuda_time_ms(lambda: ncc_eval_multi(
        refside, *args, trials, x_p, y_p, offs, params.cost_max,
        params.cap_radius(0), scattered=True), reps=5)
    del refside, planes, trials
    scale = params.max_scale
    halo = step_halo(scale)
    refside = ncc_refside(_pad_rows(data.ref_img, halo, halo), halo, H_FULL,
                          params.tap_offsets(scale), params.sigma_spatial,
                          params.sigma_color)
    x, y = geo.pixel_grid(H_FULL, W_FULL, device=x_p.device)
    init = _init_plane(data, params, key, "photometric")[None]
    ms_k1 = cuda_time_ms(lambda: ncc_eval_multi(
        refside, *args, init, x, y, params.tap_offsets(scale),
        params.cost_max, params.cap_radius(scale)), reps=5)
    del refside, init
    T = len(offs)
    for label, ms, K, P in (
            ("K=9 gt", ms_kernel, 9, band_rows * (W_FULL // 2)),
            ("K=5 full-range", ms_k5, 5, band_rows * (W_FULL // 2)),
            ("K=1 init", ms_k1, 1, H_FULL * W_FULL)):
        b_ms, b_by = ncc_bound(K, N_SRC, P, T, src_bytes, True)
        log(f"  NCC kernel {label}: {ms:.3f} ms "
            f"({K * N_SRC * P * T / ms / 1e6:.3f} Gtaps/s); bound "
            f"{b_ms:.3f} ms ({b_by}), {b_ms / ms:.3f} of it reached; before "
            f"the redesign (PERF.md): {NCC_MS_BEFORE[label]}")
    return worst, max_err, ms_kernel, ms_plain


def phase_half_iteration(data, params, band_rows: int):
    """Phase 3, at full size and the solve's band rows, kernel vs plain from
    the same inputs and key: the K=1 initial scoring of every pixel, then
    one checkerboard_step at scales 2, 1 and 0. The scale-2 step is also
    timed with a constant-cost stand-in for the NCC (the eager glue alone).
    Returns the max |cost diff| over these comparisons."""
    import torch
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc_cuda import (COUNTS, ncc_eval_multi,
                                          ncc_eval_multi_plain)
    from mpmvs_torch.ops.propagation import checkerboard_step
    from mpmvs_torch.solver import initial_state
    from mpmvs_torch.utils.trace import cuda_time_ms

    H, W = data.ref_img.shape
    dev = data.ref_img.device
    key = tf.PRNGKey(3, device=dev)
    state = initial_state(data, params, key, band_rows, ncc_eval_multi)
    plain_init = initial_state(data, params, key, band_rows,
                               ncc_eval_multi_plain)
    torch.cuda.synchronize()
    frac, max_err = state_diff(state, plain_init,
                               torch.ones(H, W, dtype=torch.bool, device=dev))
    del plain_init
    log(f"  initial scoring (K=1) {W}x{H}, S={N_SRC}, bands of {band_rows} "
        f"rows: pixels whose cost or views differ kernel vs plain {frac:.3e}"
        f", max|cost diff| {max_err:.3e}")
    if frac > MISMATCH_TOL:
        raise AssertionError(f"initial scoring kernel vs plain differ on "
                             f"{frac:.3e} of pixels (limit {MISMATCH_TOL})")
    k_step = tf.fold_in(key, 1)

    def glue_only(refside, src, w, h, A, b, K, planes, x, y, offs, cmax, cap,
                  scattered=False):
        return torch.full((planes.shape[0], src.shape[0]) + tuple(x.shape),
                          0.5, device=x.device)

    def step(fn, scale=2):
        return checkerboard_step(state, data, params, scale, 0, 0, k_step,
                                 band_rows=band_rows, ncc_multi=fn)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = {}
    for name, fn in (("kernel", ncc_eval_multi), ("glue", glue_only)):
        ms[name] = cuda_time_ms(lambda: step(fn), reps=3)
    peak = torch.cuda.max_memory_allocated() - base
    ms["plain"] = cuda_time_ms(lambda: step(ncc_eval_multi_plain), reps=1)
    log(f"  half-iteration {W}x{H}, S={N_SRC}, bands of {band_rows} rows: "
        f"kernel {ms['kernel']:.1f} ms, plain {ms['plain']:.1f} ms, glue "
        f"alone {ms['glue']:.1f} ms -> NCC share with kernel "
        f"{(ms['kernel'] - ms['glue']) / ms['kernel']:.3f}; peak extra "
        f"memory {peak / 2**30:.3f} GiB")
    active = ((torch.arange(H, device=dev)[:, None]
               + torch.arange(W, device=dev)[None, :]) % 2) == 0
    for scale in (2, 1, 0):
        a = step(ncc_eval_multi, scale)
        b = step(ncc_eval_multi_plain, scale)
        torch.cuda.synchronize()
        frac, err = state_diff(a, b, active)
        adopted = ((a.cost != state.cost) & active).float().sum().item() / (
            active.float().sum().item())
        max_err = max(max_err, err)
        log(f"  step at scale {scale}: pixels whose adopted plane, cost or "
            f"views differ kernel vs plain {frac:.3e}, max|cost diff| "
            f"{err:.3e} (cost changed on {adopted:.3f} of active pixels)")
        if frac > MISMATCH_TOL:
            raise AssertionError(f"half-iteration at scale {scale}: kernel "
                                 f"vs plain differ on {frac:.3e} of pixels "
                                 f"(limit {MISMATCH_TOL})")
    COUNTS.reset()
    return max_err


def phase_pipeline(scene, params):
    """Phase 4: the photometric slice through Pipeline at full size.
    Returns the kernel launches counted during the run."""
    import numpy as np
    import torch
    from mpmvs_torch.io import read_dmb, read_ply_binary
    from mpmvs_torch.ops.ncc_cuda import COUNTS
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.pipeline import Pipeline

    # three estimated views: with two, each would be the other's only (and
    # so last) fusion source, which the reference's last-source rule never
    # counts, and the cloud would be empty
    estimable = ESTIMATED
    S = N_SRC
    # the schedule as stated, not as the banding code computes it: the H100
    # band budget (8192 MB) holds 3200x2130 at S=10 in one band of all
    # H_FULL rows, so per view 1 init-scoring call (K=1) + scales x
    # iterations x 2 colours x 1 band x 2 calls (K=9 candidates, K=5 trials)
    expected = len(estimable) * (
        1 + (params.max_scale + 1) * params.max_iterations * 2 * 1 * 2)

    with tempfile.TemporaryDirectory(prefix="mpmvs_smoke_") as out:
        cfg = ConfigParams(input_folder=out, output_folder=out,
                           geom_iterations=0, planar_prior=False,
                           max_source_images=S)
        pipe = Pipeline(cfg, params, device="cuda", write_jpg=False)
        pipe.load_arrays(scene.images, scene.colors, scene.cameras,
                         view_sel())
        torch.cuda.reset_peak_memory_stats()
        COUNTS.reset()
        t0 = time.perf_counter()
        ply = pipe.run(log=lambda m: log("  " + m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = COUNTS.kernel, COUNTS.plain
        peak = torch.cuda.max_memory_allocated()

        taps_view = (H_FULL * W_FULL * S * 36
                     + params.max_iterations * (params.max_scale + 1) * 2
                     * 14 * S * 36 * (H_FULL * W_FULL // 2))
        for v in estimable:
            d = read_dmb(os.path.join(out, "MPMVS", f"2333_{v:08d}",
                                      "depths.dmb"))
            if d.shape != (H_FULL, W_FULL) or not np.isfinite(d).all():
                raise AssertionError(f"view {v}: depth map not finite/shaped")
            gt = scene.gt_depth[v]
            rel = float(np.median(np.abs(d - gt) / gt))
            sec = sum(t for u, stage, t in pipe.solve_log if u == v)
            log(f"  view {v}: solve {sec:.2f} s, {taps_view / sec / 1e9:.3f} "
                f"Gtaps/s, median |d-gt|/gt {rel:.5f}")
            if not rel < 0.01:
                raise AssertionError(f"view {v}: median rel error {rel}")
        pts, _, _ = read_ply_binary(ply)
        log(f"  run {wall:.1f} s; PLY {len(pts)} points; band rows {H_FULL}; "
            f"peak memory {peak / 2**30:.3f} GiB; kernel launches {launches} "
            f"(schedule implies {expected}); plain calls {plain}")
        if len(pts) == 0:
            raise AssertionError("fused PLY has no points")
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times, schedule "
                             f"implies {expected}")
    if plain != 0:
        raise AssertionError(f"plain NCC ran {plain} times on the main path")
    return launches


def phase_bilateral(scene):
    """Phase 5. Returns (max |diff| over both inputs, kernel ms, plain ms)
    with the times on the view-0 guide image."""
    import torch
    import torch.nn.functional as F
    from mpmvs_torch.models import sky
    from mpmvs_torch.ops import bilateral_cuda
    from mpmvs_torch.utils.trace import cuda_time_ms

    dev = torch.device("cuda")
    net = sky.load_sky_net(device=dev)
    bgr = torch.as_tensor(scene.colors[0], device=dev)
    prob = sky.segment_sky(bgr, net)
    gen = torch.Generator(device=dev).manual_seed(5)
    # structured random: colour blocks with sharp edges, per-pixel noise,
    # and a smooth random probability
    blocks = torch.rand((1, 3, 54, 80), generator=gen, device=dev) * 235.0
    rbgr = (F.interpolate(blocks, size=(H_FULL, W_FULL), mode="nearest")[0]
            .permute(1, 2, 0) + torch.rand((H_FULL, W_FULL, 3), generator=gen,
                                           device=dev) * 20.0).contiguous()
    logits = torch.randn((1, 1, 27, 40), generator=gen, device=dev) * 3.0
    rprob = torch.sigmoid(F.interpolate(logits, size=(H_FULL, W_FULL),
                                        mode="bilinear")[0, 0]).contiguous()
    max_err = 0.0
    for name, (g, p) in (("guide image + net probability", (bgr, prob)),
                         ("structured random", (rbgr, rprob))):
        got = bilateral_cuda.bilateral_refine(g, p)
        want = bilateral_cuda.bilateral_refine_plain(g, p)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        frac = ((got > sky.THRESHOLD) != (want > sky.THRESHOLD)).float(
        ).mean().item()
        bitwise = (got == want).float().mean().item()
        log(f"  {name}: max|diff| {err:.3e}, equal entries {bitwise:.6f}, "
            f"thresholded pixels differing {frac:.3e} (mask fraction "
            f"{(want > sky.THRESHOLD).float().mean().item():.4f})")
        if not err <= BILATERAL_ERR_TOL or not frac <= BILATERAL_MASK_TOL:
            raise AssertionError(f"bilateral kernel vs plain on {name}: "
                                 f"max|diff| {err} (limit "
                                 f"{BILATERAL_ERR_TOL}), mask fraction "
                                 f"{frac} (limit {BILATERAL_MASK_TOL})")
        max_err = max(max_err, err)
    ms_kernel = cuda_time_ms(lambda: bilateral_cuda.bilateral_refine(bgr, prob),
                             reps=10)
    ms_plain = cuda_time_ms(
        lambda: bilateral_cuda.bilateral_refine_plain(bgr, prob), reps=1)
    taps = H_FULL * W_FULL * (2 * bilateral_cuda.RADIUS + 1) ** 2
    log(f"  timing {W_FULL}x{H_FULL}, 37x37 taps: kernel {ms_kernel:.3f} ms "
        f"({taps / ms_kernel / 1e6:.3f} Gtaps/s), plain {ms_plain:.3f} ms")
    return max_err, ms_kernel, ms_plain


def phase_full_path(scene, params):
    """Phase 6: the default schedule with sky masks through Pipeline.run.
    Returns (NCC launches, bilateral launches) counted during the run."""
    import numpy as np
    import torch
    from mpmvs_torch.io import read_ply_binary
    from mpmvs_torch.ops import bilateral_cuda, ncc_cuda
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.pipeline import Pipeline

    ground = slice(SKY_ROWS + GROUND_MARGIN, H_FULL)
    errors = {}

    with tempfile.TemporaryDirectory(prefix="mpmvs_full_") as out:
        cfg = ConfigParams(input_folder=out, output_folder=out,
                           max_source_images=N_SRC, sky_seg=True)
        pipe = Pipeline(cfg, params, device="cuda", write_jpg=False)
        pipe.load_arrays(scene.images, scene.colors, scene.cameras,
                         view_sel())
        log(f"  schedule: {[tag for tag, _, _ in pipe.pass_schedule()]}, "
            f"sky masks, fusion")
        mark_done = pipe._mark_pass_done

        def check_pass(tag):
            """Depth accuracy of every estimated view on the non-sky rows,
            as the pass leaves it."""
            for v in ESTIMATED:
                d = pipe.views[v].result.depth[ground].cpu().numpy()
                gt = scene.gt_depth[v][ground]
                errors[(tag, v)] = float(np.median(np.abs(d - gt) / gt))
            mark_done(tag)

        pipe._mark_pass_done = check_pass
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ncc_cuda.COUNTS.reset()
        bilateral_cuda.COUNTS.reset()
        t0 = time.perf_counter()
        ply = pipe.run(log=lambda m: log("  " + m))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ncc = (ncc_cuda.COUNTS.kernel, ncc_cuda.COUNTS.plain)
        bil = (bilateral_cuda.COUNTS.kernel, bilateral_cuda.COUNTS.plain)
        peak = torch.cuda.max_memory_allocated()

        for (tag, v), rel in errors.items():
            log(f"  after {tag}: view {v} median |d-gt|/gt on rows "
                f"{ground.start}-{H_FULL - 1} {rel:.5f}")
        for v in ESTIMATED:
            secs = {stage: [round(t, 3) for u, st, t in pipe.solve_log
                            if u == v and st == stage]
                    for stage in ("photometric", "geom", "prior_build",
                                  "prior")}
            log(f"  view {v} seconds: {secs}")
        sky_s = pipe.timer.stats["sky_masks"].total
        fusion_s = pipe.timer.stats["fusion"].total
        n_sky = len(read_ply_binary(ply)[0])
        masks = {v: pipe.views[v].sky_mask for v in ESTIMATED}
        band = SKY_ROWS / H_FULL
        for v, m in masks.items():
            log(f"  view {v}: sky fraction {m.mean():.4f} (painted band "
                f"{band:.4f}); sky pixels below the band "
                f"{m[ground].mean():.2e}")
        for v in ESTIMATED:
            pipe.views[v].sky_mask = None
        n_all = len(read_ply_binary(pipe.fuse(log=lambda m: None))[0])
        n_prior = sum(stage == "prior" for _, stage, _ in pipe.solve_log)
        log(f"  run {wall:.1f} s (sky stage {sky_s:.2f} s for "
            f"{len(ESTIMATED)} views, fusion {fusion_s:.2f} s); peak memory "
            f"{peak / 2**30:.3f} GiB; PLY {n_sky} points with sky masks, "
            f"{n_all} without")

    bad = {k: e for k, e in errors.items() if not e < 0.01}
    if len(errors) != len(ESTIMATED) * len(pipe.pass_schedule()) or bad:
        raise AssertionError(f"median rel error >= 1% on non-sky rows: {bad}")
    off = {v: float(m.mean()) for v, m in masks.items()
           if not abs(m.mean() - band) < SKY_FRAC_TOL}
    if off:
        raise AssertionError(f"sky fractions {off} not within {SKY_FRAC_TOL}"
                             f" of the painted {band:.3f}")
    if not 0 < n_sky <= n_all:
        raise AssertionError(f"fusion: {n_sky} points with sky masks, "
                             f"{n_all} without")
    if n_prior < len(ESTIMATED):
        log(f"  prior build returned None for {len(ESTIMATED) - n_prior} "
            f"view(s): their {NCC_PRIOR} NCC launches drop out")
    expected = (len(ESTIMATED) * (NCC_PHOTOMETRIC + 2 * NCC_GEOM)
                + n_prior * NCC_PRIOR)
    log(f"  launches: NCC {ncc[0]} (schedule implies {expected}), plain NCC "
        f"{ncc[1]}; bilateral {bil[0]} (one per estimated view: "
        f"{len(ESTIMATED)}), plain bilateral {bil[1]}")
    if ncc != (expected, 0) or bil != (len(ESTIMATED), 0):
        raise AssertionError(f"launches (kernel, plain): NCC {ncc}, expected "
                             f"({expected}, 0); bilateral {bil}, expected "
                             f"({len(ESTIMATED)}, 0)")
    return ncc[0], bil[0]


def phase_sorted(data, scene, params):
    """Phase 7: the sorted path (csrc/ncc_samples.cu) at 3200x2130 with 10
    sources, on view 0's full-range random init field. Returns a dict of
    what the kernels line and the log need."""
    import numpy as np
    import torch
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import ncc_cuda, ncc_sorted
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.packing import packed_coords
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import _init_plane, solve_view
    from mpmvs_torch.tools.ab_deviations import REFERENCE
    from mpmvs_torch.utils.roofline import ncc_bound, samples_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    dev = data.ref_img.device
    H, W = data.ref_img.shape
    S, Hp, Wp = data.src_imgs.shape
    N = H * W
    scale = params.max_scale
    offs = params.tap_offsets(scale)
    T = len(offs)
    x, y = geo.pixel_grid(H, W, device=dev)
    xf, yf = x.reshape(N), y.reshape(N)
    key = tf.PRNGKey(11, device=dev)
    rand = pmrand.random_plane_field(key, data.K_ref, x, y, data.depth_min,
                                     data.depth_max)
    pf = rand.reshape(N, 4)
    coherent = _init_plane(data, params, key, "photometric")
    view = lambda s: (data.src_imgs[s], data.src_widths[s],
                      data.src_heights[s], data.A[s], data.b[s], data.K_ref)
    perm0 = ncc_sorted.sort_view(data.A[0], data.b[0], data.K_ref, pf, xf,
                                 yf, Hp, Wp)
    out = {}

    # (a) sample kernel vs its plain version, every view: the init field at
    # scale 2, cap off (the reference semantics) and at the default cap;
    # then, cap off, scale-0 taps on a full-range field over the packed
    # half-width pixels of one colour, the shape of a refinement trial
    x_p, y_p = packed_coords(0, H, W // 2, 0, device=dev)
    trial = pmrand.random_plane_field(tf.PRNGKey(12, device=dev), data.K_ref,
                                      x_p, y_p, data.depth_min,
                                      data.depth_max).reshape(-1, 4)
    x_p, y_p = x_p.reshape(-1), y_p.reshape(-1)
    cases = [(f"init scale {scale}, cap {cap:g}", pf, xf, yf, offs, cap)
             for cap in (0.0, params.cap_radius(scale))]
    cases.append(("trial scale 0, cap 0", trial, x_p, y_p,
                  params.tap_offsets(0), 0.0))
    n_diff, max_err = 0, 0.0
    for label, pl, xs, ys, taps, cap in cases:
        flagged, before = [], n_diff
        for s in range(S):
            perm = ncc_sorted.sort_view(data.A[s], data.b[s], data.K_ref, pl,
                                        xs, ys, Hp, Wp)
            args = view(s) + (pl, xs, ys, perm, taps, cap)
            got = ncc_sorted.sample_view_vals_kernel(*args)
            want = ncc_sorted.sample_view_vals_plain(*args)
            torch.cuda.synchronize()
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            n_diff += int((~same).sum().item())
            max_err = max(max_err, compare(got, want)[1])
            flagged.append(want[-1].mean().item())
            del got, want
        log(f"  (a) sample kernel vs plain, {label}, {S} views, "
            f"{len(taps) + 1} x {pl.shape[0]} entries each: "
            f"{n_diff - before} differ, max|diff| {max_err:.3e}; flagged "
            f"pixels {min(flagged):.3f}-{max(flagged):.3f}")
    out["samples_max_abs_err"] = max_err
    del trial, x_p, y_p
    if n_diff:
        raise AssertionError(f"sample kernel vs plain: {n_diff} entries "
                             f"differ")

    # (b) the sorted path vs the NCC kernel at K=1 on the full-range field
    halo = step_halo(scale)
    refside = ncc_refside(_pad_rows(data.ref_img, halo, halo), halo, H, offs,
                          params.sigma_spatial, params.sigma_color)
    common = (refside, data.src_imgs, data.src_widths, data.src_heights,
              data.A, data.b, data.K_ref)
    got = ncc_sorted.ncc_eval_sorted(*common, rand, x, y, offs,
                                     params.cost_max, 0.0)
    want = ncc_cuda.ncc_eval_one(*common, rand, x, y, offs, params.cost_max,
                                 0.0, scattered=True)
    torch.cuda.synchronize()
    frac, err = compare(got, want)
    out["sorted_vs_k1"] = (frac, err)
    log(f"  (b) sorted path vs NCC kernel K=1, full-range field: frac>1e-4 "
        f"{frac:.3e}, max|diff| {err:.3e} (cost<{params.cost_max} in "
        f"{(want < params.cost_max).float().mean().item():.3f})")
    del got, want
    if frac > MISMATCH_TOL:
        raise AssertionError(f"sorted path vs NCC kernel: {frac:.3e} of "
                             f"entries differ by > 1e-4 (limit "
                             f"{MISMATCH_TOL})")

    # (c) CUDA-event times over all 10 views, warmed up
    cap_def = params.cap_radius(scale)
    ms_coh = cuda_time_ms(lambda: ncc_cuda.ncc_eval_one(
        *common, coherent, x, y, offs, params.cost_max, cap_def), reps=5)
    ms_rand = cuda_time_ms(lambda: ncc_cuda.ncc_eval_one(
        *common, rand, x, y, offs, params.cost_max, 0.0, scattered=True),
        reps=5)
    ms_coh_plain = cuda_time_ms(lambda: ncc_cuda.ncc_eval_multi_plain(
        *common, coherent[None], x, y, offs, params.cost_max, cap_def),
        reps=1)
    ms_path = cuda_time_ms(lambda: ncc_sorted.ncc_eval_sorted(
        *common, rand, x, y, offs, params.cost_max, 0.0), reps=3)
    stage = np.zeros(4)
    reps = 3
    for rep in range(reps + 1):
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
              for _ in range(S)]
        for s in range(S):
            e = ev[s]
            e[0].record()
            perm = ncc_sorted.sort_view(data.A[s], data.b[s], data.K_ref, pf,
                                        xf, yf, Hp, Wp)
            e[1].record()
            vals = ncc_sorted.sample_view_vals_kernel(
                *view(s), pf, xf, yf, perm, offs, 0.0)
            e[2].record()
            vals = ncc_sorted.unpermute(vals, perm)
            e[3].record()
            ncc_sorted.zncc_from_samples(refside, vals[:T].reshape(T, H, W),
                                         vals[T].reshape(H, W) > 0.5,
                                         params.cost_max)
            e[4].record()
            del vals
        torch.cuda.synchronize()
        if rep:  # the first pass warms up
            stage += [sum(ev[s][i].elapsed_time(ev[s][i + 1])
                          for s in range(S)) for i in range(4)]
    stage /= reps
    ms_plain = cuda_time_ms(lambda: ncc_sorted.sample_view_vals_plain(
        *view(0), pf, xf, yf, perm0, offs, 0.0), reps=1)
    taps = N * S * T
    log(f"  (c) K=1, {W}x{H}, S={S}, scale {scale}: NCC kernel on the "
        f"coherent default init field {ms_coh:.3f} ms "
        f"({taps / ms_coh / 1e6:.3f} Gtaps/s; plain {ms_coh_plain:.3f} "
        f"ms); on the full-range field (view-major launch) "
        f"{ms_rand:.3f} ms ({taps / ms_rand / 1e6:.3f} Gtaps/s); sorted path "
        f"{ms_path:.3f} ms = sort {stage[0]:.3f} + sample kernel "
        f"{stage[1]:.3f} + un-permute {stage[2]:.3f} + ZNCC {stage[3]:.3f} "
        f"(event sums over the views); plain samples of one view "
        f"{ms_plain:.3f} ms")
    ms_kernel = stage[1] / S
    out.update(ms_coh=ms_coh, ms_rand=ms_rand, ms_path=ms_path, stage=stage,
               samples_ms=ms_kernel,
               samples_plain_ms=ms_plain)
    out["samples_bound"] = samples_bound(N, T, 4 * Hp * Wp, False)
    src_bytes = 4 * S * Hp * Wp
    out["k1_init_bound"] = ncc_bound(1, S, N, T, src_bytes, False)
    log(f"  bounds (ms, set by): sample kernel per view "
        f"{out['samples_bound'][0]:.3f} ({out['samples_bound'][1]}) vs "
        f"{ms_kernel:.3f} measured; NCC kernel K=1 over the init field "
        f"{out['k1_init_bound'][0]:.3f} ({out['k1_init_bound'][1]}) vs "
        f"{ms_coh:.3f} coherent, {ms_rand:.3f} full-range")
    del refside, common, perm0, rand, coherent
    torch.cuda.empty_cache()

    # (d) photometric solves of view 0 with the reference semantics
    solves, results = {}, {}
    gt = scene.gt_depth[0]
    for sampler in ("sorted", "auto"):
        p = PatchMatchParams(sampler=sampler, **REFERENCE)
        ncc_cuda.COUNTS.reset()
        ncc_sorted.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_view(scene.images, scene.cameras, tf.PRNGKey(0), p,
                         device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = (ncc_sorted.COUNTS.kernel, ncc_sorted.COUNTS.plain,
                  ncc_cuda.COUNTS.kernel, ncc_cuda.COUNTS.plain)
        d = res.depth.cpu().numpy()
        rel = float(np.median(np.abs(d - gt) / gt))
        expected = ((SAMPLES_SORTED, 0, NCC_SORTED, 0) if sampler == "sorted"
                    else (0, 0, NCC_AUTO, 0))
        log(f"  (d) reference-semantics solve, sampler={sampler!r}: "
            f"{sec:.2f} s, median |d-gt|/gt {rel:.5f}; launches (sample "
            f"kernel, plain, NCC kernel, plain) {counts}, the schedule "
            f"implies {expected}")
        if not (np.isfinite(d).all() and rel < 0.01):
            raise AssertionError(f"sampler={sampler!r}: median rel error "
                                 f"{rel}")
        if counts != expected:
            raise AssertionError(f"sampler={sampler!r}: launches {counts}, "
                                 f"expected {expected}")
        solves[sampler] = (sec, rel, counts)
        results[sampler] = res
    # the sorted path computes the NCC kernel's costs (b), so from the same
    # inputs and key the two solves should agree
    a, b = results["sorted"], results["auto"]
    bad = (differs(a.depth, b.depth) | differs(a.normal, b.normal).any(-1)
           | differs(a.cost, b.cost))
    frac = bad.float().mean().item()
    log(f"  (d) sorted vs auto solve: depth, normal or cost differ by > 1e-4 "
        f"on {frac:.3e} of the pixels (limit {MISMATCH_TOL})")
    if frac > MISMATCH_TOL:
        raise AssertionError(f"sorted and auto solves differ on {frac:.3e} "
                             f"of the pixels")
    del results, a, b
    out["solves"] = solves
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1, 2 and 5 only, no result line")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "mpmvs_torch")):
        print("mpmvs_torch/ not found beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mpmvs_torch.ops import bilateral_cuda
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import build_solve_data, solve_band_rows
    from mpmvs_torch.tools import build_kernels
    from mpmvs_torch.utils.roofline import bilateral_bound, ncc_bound

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"phase 1: device {name}; nvidia-smi: {smi}; torch {torch.__version__}"
        f" CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_kernels(dev, verbose=True)
    log(f"  kernel builds (in parallel) {time.perf_counter() - t0:.2f} s")

    params = PatchMatchParams()
    scene = make_scene()
    data = build_solve_data(torch.as_tensor(scene.images, device=dev),
                            scene.cameras.to(dev))
    for geom in (False, True):
        band_rows = solve_band_rows(params, H_FULL, W_FULL, N_SRC, geom)
        if band_rows != H_FULL:
            raise AssertionError(f"band rows {band_rows} (geom/prior modes: "
                                 f"{geom}): the H100 band budget should hold "
                                 f"{W_FULL}x{H_FULL} at S={N_SRC} in one "
                                 f"band")

    log("phase 2: NCC kernel vs plain")
    worst, max_err, ms_k, ms_p = phase_kernel_vs_plain(data, scene, params,
                                                       band_rows)
    if not args.quick:
        log("phase 3: initial scoring and half-iterations, kernel vs plain")
        max_err = max(max_err, phase_half_iteration(data, params, band_rows))
    if not args.quick:
        log("phase 7: the sorted path (sample kernel) and the reference "
            "semantics")
        sorted_out = phase_sorted(data, scene, params)
    del data
    torch.cuda.empty_cache()
    if not args.quick:
        log("phase 4: photometric path through Pipeline")
        phase_pipeline(scene, params)
    paint_sky(scene)
    log("phase 5: bilateral kernel vs plain")
    bil_err, bil_ms, bil_plain_ms = phase_bilateral(scene)
    if args.quick:
        log(f"quick: NCC worst mismatch {worst:.3e}, max err {max_err:.3e}; "
            f"bilateral max err {bil_err:.3e}")
        return 0
    torch.cuda.empty_cache()
    log("phase 6: full path (photometric, geom_0 + prior, geom_1, sky, "
        "fusion) through Pipeline")
    ncc_launches, bil_launches = phase_full_path(scene, params)

    # bounds at the timed shapes: the NCC kernel at phase 2's K=9 band
    # (scale 0, default cap), the bilateral kernel over view 0's in-image
    # taps, the sample kernel per view at phase 7's init field
    P = band_rows * (W_FULL // 2)
    k1_bound = ncc_bound(9, N_SRC, P, len(params.tap_offsets(0)),
                         4 * N_SRC * H_FULL * W_FULL, True)
    bil_bound = bilateral_bound(H_FULL, W_FULL, bilateral_cuda.RADIUS)
    sam_bound = sorted_out["samples_bound"]
    log(f"bounds (ms, set by) vs measured: NCC kernel K=9 band "
        f"{k1_bound[0]:.3f} ({k1_bound[1]}) vs {ms_k:.3f}; bilateral "
        f"{bil_bound[0]:.3f} ({bil_bound[1]}) vs {bil_ms:.3f}; sample kernel "
        f"{sam_bound[0]:.3f} ({sam_bound[1]}) vs "
        f"{sorted_out['samples_ms']:.3f}")
    log(smi)
    # library_ms: no single PyTorch call computes any of these functions
    # (PERF.md section 6)
    log(json.dumps({"kernels": [{
        "name": "ncc_eval_multi", "route": "cuda",
        "source": "mpmvs_torch/csrc/ncc_eval.cu",
        "replaces": "mpmvs_tpu/ops/pallas_ncc.py:94",
        "launches": ncc_launches, "max_abs_err": max_err,
        "ms": ms_k, "plain_ms": ms_p, "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1], "library_ms": None}, {
        "name": "bilateral_refine", "route": "cuda",
        "source": "mpmvs_torch/csrc/bilateral_refine.cu",
        "replaces": "mpmvs_tpu/ops/pallas_bilateral.py:41",
        "launches": bil_launches, "max_abs_err": bil_err,
        "ms": bil_ms, "plain_ms": bil_plain_ms, "bound_ms": bil_bound[0],
        "bound_by": bil_bound[1], "library_ms": None}, {
        "name": "ncc_samples", "route": "cuda",
        "source": "mpmvs_torch/csrc/ncc_samples.cu",
        "replaces": "mpmvs_tpu/ops/pallas_ncc.py:733",
        "launches": sorted_out["solves"]["sorted"][2][0],
        "max_abs_err": sorted_out["samples_max_abs_err"],
        "ms": sorted_out["samples_ms"],
        "plain_ms": sorted_out["samples_plain_ms"],
        "bound_ms": sam_bound[0], "bound_by": sam_bound[1],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
