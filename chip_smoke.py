#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mpmvs_torch) on one CUDA card.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --quick    # phases 1, 2 and 5 (builds + kernel checks)

Phases, in order; any failure raises and the script exits non-zero:

1. Device and build: the card's name and power limit, and the ``nvcc``
   builds of ``mpmvs_torch/csrc/ncc_eval.cu`` and ``bilateral_refine.cu``,
   started together, with their time.
2. NCC kernel vs plain: ``ncc_eval_multi`` on the card against its plain
   PyTorch version at K in {1, 5, 9}, S = 10, scales 0 and 2, on
   ground-truth and random planes at the default footprint cap; then both
   timed with CUDA events at the main path's band shape.
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

The last three lines of standard output are the card's name and power limit
(``nvidia-smi``), a JSON object describing each kernel, and
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
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc_cuda import (ncc_eval_multi, ncc_eval_multi_plain)
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
                got = ncc_eval_multi(refside, *args, planes, x_p, y_p, offs,
                                     params.cost_max, cap)
                want = ncc_eval_multi_plain(refside, *args, planes, x_p, y_p,
                                            offs, params.cost_max, cap)
                torch.cuda.synchronize()
                frac, err = compare(got, want)
                log(f"  scale {scale} {kind:6s} K={K}: frac>1e-4 {frac:.3e} "
                    f"max|diff| {err:.3e} (cost<{params.cost_max} in "
                    f"{(want < params.cost_max).float().mean().item():.3f})")
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

    def glue_only(refside, src, w, h, A, b, K, planes, x, y, offs, cmax, cap):
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
    from mpmvs_torch.ops import bilateral_cuda, ncc_cuda, nvcc
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import build_solve_data, solve_band_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"phase 1: device {name}; nvidia-smi: {smi}; torch {torch.__version__}"
        f" CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    nvcc.build_all({ncc_cuda.SOURCE: ncc_cuda.NVCC_FLAGS,
                    bilateral_cuda.SOURCE: bilateral_cuda.NVCC_FLAGS},
                   verbose=True)
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

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "ncc_eval_multi", "route": "cuda",
        "source": "mpmvs_torch/csrc/ncc_eval.cu",
        "replaces": "mpmvs_tpu/ops/pallas_ncc.py:94",
        "launches": ncc_launches, "max_abs_err": max_err,
        "ms": ms_k, "plain_ms": ms_p}, {
        "name": "bilateral_refine", "route": "cuda",
        "source": "mpmvs_torch/csrc/bilateral_refine.cu",
        "replaces": "mpmvs_tpu/ops/pallas_bilateral.py:41",
        "launches": bil_launches, "max_abs_err": bil_err,
        "ms": bil_ms, "plain_ms": bil_plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
