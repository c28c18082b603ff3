"""Microbenchmark of the port's kernels on one CUDA card: the NCC kernel
(``csrc/ncc_eval.cu``, ``--kernel ncc``, the default), the sorted path
(``csrc/ncc_samples.cu``, ``--kernel sorted``), the bilateral kernel
(``csrc/bilateral_refine.cu``, ``--kernel bilateral``) and the geometric
cost (``csrc/geom_cost.cu``, ``--kernel geom``), and the lossless WebP
predictor (``csrc/jpeg_codec.cu``, ``--kernel vp8l``: random images from
one band of 32 rows to 3200x2130, no scene), and the JPEG colour kernels
(``--kernel colour``: ``ycc_to_bgr_kernel`` and ``cmyk_to_bgr_kernel`` on
random 3200x2130 planes, no scene), and the JPEG 2000 kernels
(``csrc/jpeg_codec.cu``, ``--kernel j2k``: each level of
``j2k_idwt_kernel`` and ``j2k_colour_kernel`` on the three 3200x2130
sources of ``tests/data/jp2/conversion``, no scene).

Port of tools/kernel_bench.py (the JAX package's Pallas-kernel bench):
the same operating point (``make_plane_scene`` at 3200x2130 with 11
views, a middle row band) and the same field classes, built with the
port's ``ops/random.py``:

  * ``coherent`` -- cone normals + smooth tile-banded depths, what the
    init field and the propagated candidates look like;
  * ``trials`` -- full-hemisphere normals + banded depths, the random
    refinement trials (the footprint-cap-bound worst case);
  * ``full`` -- full-hemisphere normals + full-range depths
    (``random_plane_field``), the reference-semantics init field.

A configuration is K stacked fields at one window scale over one pixel
set: ``packed`` (one checkerboard colour of the band, as a band step
scores it) or ``all`` (every pixel of the band, as init scoring does).
Two more cases take the band step's own calls: ``step-default`` and
``step-reference`` run one real half-iteration (scale 0, colour 0) from a
converged state, the scene's true planes, under the default or the
reference's search semantics (``tools.ab_deviations.REFERENCE``), and
time the two NCC calls it makes, the K=9 candidates and the K=5
refinement trials, on the very inputs the solver built.

Without ``--k`` the default suite runs: K=9 and K=5 at scale 0 on packed
pixels (coherent, trials), K=1 at scale 2 on all pixels (coherent, full),
then both step cases. ``--launch`` picks the kernel's launch: ``auto``
(the default) takes the one the solver takes (for the synthetic fields:
view-major for ``full``, tile for the others), ``both`` times each case
under each. Each case prints one JSON line: CUDA-event ms after a
warm-up, Gtaps/s, the bound (``utils.roofline.ncc_bound``, the least time
the card could take for the same work), the share of it reached, and the
card's name and power limit. ``--check`` also holds the kernel against
its plain version on the same inputs. Without a CUDA device the tool
exits non-zero::

    python -m mpmvs_torch.tools.kernel_bench
    python -m mpmvs_torch.tools.kernel_bench --k 9 --cases trials --check
    python -m mpmvs_torch.tools.kernel_bench --k 5 --cases step-reference \\
        --launch both

``--kernel sorted`` times ``ops.ncc_sorted`` on view 0's full-range random
field, the field the path serves: ``init`` (every pixel, scale 2, cap off:
the reference semantics' init call), ``init-cap`` (the same at the default
cap) and ``trial`` (one colour's packed half-width pixels, scale 0, cap
off: a random-depth refinement trial). Per case it prints the whole call
through the fused kernel, split into the pixel
record, the key kernel and sort, and the fused kernel (CUDA-event sums
over the views); the raw-samples chain of the same call (sort, raw-samples
kernel, un-permute, ZNCC); and the plain chain once. ``--kernel
bilateral`` times ``ops.bilateral_cuda`` at the scene's size on view 0's
colour image (``float`` guide) and on it rounded to 8-bit values
(``8bit``): the float form on both, the table form on the 8-bit guide, and
the plain version once. ``--sass`` adds each
form's instructions per tap in its unrolled interior row, counted from
``cuobjdump -sass`` of the built library, and the issue floor they set at
the card's maximum SM clock. ``--check`` holds every form against its
plain version (entries not bit-equal)::

    python -m mpmvs_torch.tools.kernel_bench --kernel sorted --check
    python -m mpmvs_torch.tools.kernel_bench --kernel bilateral --check \\
        --sass

``--kernel geom`` times ``ops.geom_cost_cuda`` at the geom band shape
(the solve's geom band, one colour's packed half-width pixels, the
sources' true depth maps), with the solve's camera table: ``gt`` (K=1,
view 0's true planes), ``stack`` (K=9, the true planes at 9 depth scales,
the candidates' call), ``trials`` (K=5, the refinement trials' call: two
full-range random depths, three at the true depth, one of those scaled)
and ``trial`` (K=1, a full-range random field, whose projections leave
the sources). Per case: CUDA-event ms, the bound
(``utils.roofline.geom_bound``) and the share of it reached, the
instantiation's registers a thread and spilled bytes, the plain twin
once; ``--check`` counts the entries that differ from the twin;
``--sass`` adds the instructions a (field, source, pixel) in the
instantiation's source loop and the issue floor they set at the card's
maximum SM clock (``utils.roofline.geom_issue_floor_ms``)::

    python -m mpmvs_torch.tools.kernel_bench --kernel geom --check --sass

What is TPU-only in the JAX tool (``--quad``, ``WIN_BLOCKS``) has no
counterpart here.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from typing import NamedTuple

import torch

Tensor = torch.Tensor

STEPS = ("step-default", "step-reference")
SUITE = ((9, 0, "packed", ("coherent", "trials")),
         (5, 0, "packed", ("coherent", "trials")),
         (1, 2, "all", ("coherent", "full")),
         (None, 0, "packed", STEPS))
LAUNCHES = {"tile": False, "view-major": True}


def _stack(key: Tensor, K: int, K_ref: Tensor, x: Tensor, y: Tensor,
           normal_fn, depth_fn) -> Tensor:
    """K plane fields; field i from the i-th of K keys split into a normal
    key and a depth key (tools/kernel_bench.py:86-98)."""
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import threefry as tf

    fields = []
    for k in tf.split(key, K):
        k_n, k_d = tf.split(k)
        fields.append(geo.plane_from_depth_normal(
            K_ref, x, y, depth_fn(k_d), normal_fn(k_n)))
    return torch.stack(fields)


def _banded(x, y, dmin, dmax, frac):
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf

    return lambda k: pmrand.smooth_banded_uniform(*tf.split(k), x, y, dmin,
                                                  dmax, frac)


def coherent_planes(key, K, K_ref, x, y, dmin, dmax, params) -> Tensor:
    """(K, ..., 4): normals in the init cone, banded depths."""
    from mpmvs_torch.ops import random as pmrand

    cone = math.radians(params.init_normal_cone_deg)
    return _stack(key, K, K_ref, x, y,
                  lambda k: pmrand.cone_normal_field(k, K_ref, x, y, cone),
                  _banded(x, y, dmin, dmax, params.random_band_frac))


def trial_planes(key, K, K_ref, x, y, dmin, dmax, params) -> Tensor:
    """(K, ..., 4): full-hemisphere normals, banded depths."""
    from mpmvs_torch.ops import random as pmrand

    return _stack(key, K, K_ref, x, y,
                  lambda k: pmrand.random_normal_field(k, K_ref, x, y),
                  _banded(x, y, dmin, dmax, params.random_band_frac))


def full_planes(key, K, K_ref, x, y, dmin, dmax, params) -> Tensor:
    """(K, ..., 4): ``random_plane_field`` per field (full-range depths)."""
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf

    return torch.stack([pmrand.random_plane_field(k, K_ref, x, y, dmin, dmax)
                        for k in tf.split(key, K)])


FIELDS = {"coherent": coherent_planes, "trials": trial_planes,
          "full": full_planes}


class Bench(NamedTuple):
    data: object       # SolveData of view 0
    params: object     # PatchMatchParams
    band_rows: int
    y0: int            # first row of the band
    device: dict       # tools.device_record
    gt_plane: Tensor   # (H, W, 4) view 0's true planes
    color0: object     # (H, W, 3) view 0's BGR colours, on the host
    src_depths: Tensor  # (V-1, H, W) the sources' true depth maps


def setup(height: int, width: int, views: int, band_rows: int,
          cap_mult=None, seed: int = 0, device: str = "cuda") -> Bench:
    """The scene on ``device`` and the band: ``band_rows`` 0 takes the
    solve's own band height (``solver.solve_band_rows``)."""
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import build_solve_data, solve_band_rows
    from mpmvs_torch.tools import device_record
    from mpmvs_torch.utils.synthetic import make_plane_scene

    dev = torch.device(device)
    pkw = {} if cap_mult is None else {"footprint_cap_mult": cap_mult}
    params = PatchMatchParams(**pkw)
    scene = make_plane_scene(num_views=views, height=height, width=width,
                             seed=seed)
    data = build_solve_data(torch.as_tensor(scene.images, device=dev),
                            scene.cameras.to(dev))
    br = band_rows or solve_band_rows(params, height, width, views - 1)
    x, y = geo.pixel_grid(height, width, device=dev)
    n_world = torch.as_tensor(scene.gt_normal_world, device=dev)
    gt_plane = geo.plane_from_depth_normal(
        data.K_ref, x, y, torch.as_tensor(scene.gt_depth[0], device=dev),
        geo.normal_world_to_cam(data.R_ref,
                                n_world.expand(height, width, 3)))
    return Bench(data, params, br, (height // 2 // br) * br,
                 device_record(dev), gt_plane, scene.colors[0],
                 torch.as_tensor(scene.gt_depth[1:], device=dev))


def case_inputs(bench: Bench, K: int, scale: int, pixels: str, field: str,
                key_seed: int = 7):
    """ncc_eval_multi's arguments for one case."""
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.packing import packed_coords
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo

    data, params, br, y0 = bench.data, bench.params, bench.band_rows, bench.y0
    dev = data.ref_img.device
    W = data.ref_img.shape[1]
    offs = params.tap_offsets(scale)
    halo = step_halo(scale)
    ref_s = _pad_rows(data.ref_img, halo, halo)[y0:y0 + br + 2 * halo]
    if pixels == "packed":
        phase = 0
        x, y = packed_coords(y0, br, W // 2, phase, device=dev)
    elif pixels == "all":
        phase = None
        x = torch.arange(W, dtype=torch.float32, device=dev)[None].expand(
            br, W).contiguous()
        y = (torch.arange(br, dtype=torch.float32, device=dev)[:, None]
             + float(y0)).expand(br, W).contiguous()
    else:
        raise ValueError(f"pixels must be 'packed' or 'all', got {pixels!r}")
    refside = ncc_refside(ref_s, halo, br, offs, params.sigma_spatial,
                          params.sigma_color, pack_phase=phase)
    planes = FIELDS[field](tf.PRNGKey(key_seed, device=dev), K, data.K_ref,
                           x, y, data.depth_min, data.depth_max, params)
    return (refside, data.src_imgs, data.src_widths, data.src_heights,
            data.A, data.b, data.K_ref, planes.contiguous(), x, y, offs,
            params.cost_max, params.cap_radius(scale))


def step_calls(bench: Bench, semantics: str, key_seed: int = 7):
    """The NCC calls of one half-iteration (``checkerboard_step`` at scale
    0, colour 0, the first iteration) from the converged state, the true
    planes, under ``semantics`` ("default" or "reference"):
    [(args, kwargs)] in call order, the K=9 candidates then the K=5
    refinement trials; kwargs hold the launch the solver picked. The calls
    are answered with a constant cost, so the step adopts neighbours'
    true planes and draws its trials around them."""
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.propagation import PatchMatchState, checkerboard_step
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.tools.ab_deviations import REFERENCE

    params = PatchMatchParams(**{"default": {}, "reference": REFERENCE}[
        semantics])
    data, plane = bench.data, bench.gt_plane
    S = data.src_imgs.shape[0]
    calls = []

    def capture(*args, **kwargs):
        calls.append((args, kwargs))
        planes, x = args[7], args[8]
        return torch.full((planes.shape[0], S) + tuple(x.shape), 0.5,
                          device=x.device)

    H, W = plane.shape[:2]
    state = PatchMatchState(
        plane=plane, cost=torch.ones((H, W), device=plane.device),
        geom_cost=torch.zeros((H, W), device=plane.device),
        sel=torch.full((H, W), (1 << S) - 1, dtype=torch.int32,
                       device=plane.device))
    checkerboard_step(state, data, params, 0, 0, 0,
                      tf.PRNGKey(key_seed, device=plane.device),
                      band_rows=bench.band_rows, ncc_multi=capture)
    return calls


def time_call(bench: Bench, args, head: dict, scattered: bool,
              reps: int = 5, check: bool = False) -> dict:
    """Time ``ncc_eval_multi_kernel(*args)`` under one launch with CUDA
    events; ``head`` and the measurements as one result dict."""
    from mpmvs_torch.ops.ncc_cuda import (ncc_eval_multi_kernel,
                                          ncc_eval_multi_plain)
    from mpmvs_torch.utils.roofline import ncc_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    S, Hp, Wp = args[1].shape
    K = args[7].shape[0]
    R, C = args[8].shape
    P, T = R * C, len(args[10])
    cap = args[12]
    ms = cuda_time_ms(lambda: ncc_eval_multi_kernel(
        *args, scattered=scattered), reps=reps)
    out = ncc_eval_multi_kernel(*args, scattered=scattered)
    b_ms, b_by = ncc_bound(K, S, P, T, 4 * S * Hp * Wp, cap > 0)
    taps = K * S * P * T
    res = dict(head, k=K, launch="view-major" if scattered else "tile",
               band_rows=bench.band_rows,
               shape=f"{C}x{R} px, {S} src {Wp}x{Hp}", cap_radius=cap,
               ms=ms, gtaps_per_s=taps / ms / 1e6, bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / ms,
               mean_cost=out.mean().item())
    if check:
        want = ncc_eval_multi_plain(*args)
        same = (out == want) | (torch.isnan(out) & torch.isnan(want))
        res["entries_differing"] = int((~same).sum().item())
        fin = torch.isfinite(out) & torch.isfinite(want)
        res["max_abs_err"] = (out - want)[fin].abs().max().item()
        del want
    res.update(kind=bench.device["kind"],
               nvidia_smi=bench.device["nvidia_smi"])
    return res


def _launches(launch: str, auto: bool):
    """The ``scattered`` flags to time: the solver's (``auto``) or the
    named launch, or both."""
    if launch == "auto":
        return (auto,)
    if launch == "both":
        return (False, True)
    return (LAUNCHES[launch],)


def run_case(bench: Bench, K: int, scale: int, pixels: str, field: str,
             reps: int = 5, check: bool = False, launch: str = "auto"):
    """Time one case: a list of result dicts, one per launch and, for the
    step cases, per NCC call of the step (``K`` and ``pixels`` then come
    from the call)."""
    if field in STEPS:
        calls = [(args, kw.get("scattered", False)) for args, kw in
                 step_calls(bench, field.split("-", 1)[1])]
        calls = [c for c in calls if K is None or c[0][7].shape[0] == K]
        pixels = "packed"
    else:
        calls = [(case_inputs(bench, K, scale, pixels, field),
                  field == "full")]
    res = []
    for args, auto in calls:
        for scattered in _launches(launch, auto):
            res.append(time_call(
                bench, args, {"case": field, "scale": scale,
                              "pixels": pixels, "solver_launch":
                              "view-major" if auto else "tile"},
                scattered, reps, check))
    return res


SORTED_CASES = ("init", "init-cap", "trial")


def sorted_inputs(bench: Bench, case: str, key_seed: int = 11):
    """``ncc_eval_sorted``'s arguments for one case: view 0's full-range
    random field over every pixel at scale 2 (``init``, cap off;
    ``init-cap``, the default cap) or over one colour's packed half-width
    pixels at scale 0 (``trial``, cap off)."""
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc import ncc_refside
    from mpmvs_torch.ops.packing import packed_coords
    from mpmvs_torch.ops.propagation import _pad_rows, step_halo

    data, params = bench.data, bench.params
    dev = data.ref_img.device
    H, W = data.ref_img.shape
    if case not in SORTED_CASES:
        raise ValueError(f"sorted case must be one of {SORTED_CASES}, got "
                         f"{case!r}")
    scale = params.max_scale if case.startswith("init") else 0
    halo = step_halo(scale)
    offs = params.tap_offsets(scale)
    ref_pad = _pad_rows(data.ref_img, halo, halo)
    if case == "trial":
        x, y = packed_coords(0, H, W // 2, 0, device=dev)
        phase = 0
    else:
        x, y = geo.pixel_grid(H, W, device=dev)
        phase = None
    refside = ncc_refside(ref_pad, halo, H, offs, params.sigma_spatial,
                          params.sigma_color, pack_phase=phase)
    plane = pmrand.random_plane_field(tf.PRNGKey(key_seed, device=dev),
                                      data.K_ref, x, y, data.depth_min,
                                      data.depth_max)
    cap = params.cap_radius(scale) if case == "init-cap" else 0.0
    return (refside, data.src_imgs, data.src_widths, data.src_heights,
            data.A, data.b, data.K_ref, plane, x, y, offs, params.cost_max,
            cap)


def _event_sums(setup, stages, S: int, reps: int) -> dict:
    """Device ms of one call, averaged over ``reps`` calls after a warm-up:
    ``setup = (name, fn())`` runs once, then for every view s the
    ``stages`` [(name, fn(s, carry) -> carry)] in order, the carry starting
    as setup's result; each stage's time is summed over the views."""
    names = [setup[0]] + [n for n, _ in stages]
    total = [0.0] * len(names)
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(2 + S * len(stages))]
        ev[0].record()
        base = setup[1]()
        ev[1].record()
        k = 1
        for s in range(S):
            carry = base
            for _, fn in stages:
                carry = fn(s, carry)
                k += 1
                ev[k].record()
        del base, carry
        torch.cuda.synchronize()
        if rep:  # the first call warms up
            total[0] += ev[0].elapsed_time(ev[1])
            k = 1
            for s in range(S):
                for j in range(len(stages)):
                    total[1 + j] += ev[k].elapsed_time(ev[k + 1])
                    k += 1
    return {n: t / reps for n, t in zip(names, total)}


def sorted_split(args, reps: int = 3) -> dict:
    """Device ms of one ``ncc_eval_sorted_kernel`` call split into the pixel
    record (once), the key kernel and sort, and the fused kernel (sums over
    the views), each stage as the call runs it."""
    from mpmvs_torch.ops import ncc_sorted

    refside, src, widths, heights, A, b, K_ref, plane, x, y, offs, cmax, \
        cap = args
    S, Hp, Wp = src.shape
    pf, xf, yf = ncc_sorted._flat(plane, x, y)
    terms = ncc_sorted.view_terms(widths, heights, A, b, K_ref, pf.device)
    out = torch.empty((S, xf.shape[0]), device=xf.device)

    def keys_sort(s, rec):
        keys = ncc_sorted.view_keys_kernel(terms, s, pf, xf, yf, Hp, Wp)
        return rec, torch.sort(keys, stable=True).indices

    def fused(s, st):
        rec, perm = st
        ncc_sorted.view_costs_kernel(rec, src, s, terms, perm, offs, cmax,
                                     cap, out[s])
        return rec

    return _event_sums(
        ("record", lambda: ncc_sorted.pixel_record(refside, pf, xf, yf)),
        [("keys_sort", keys_sort), ("fused_kernel", fused)], S, reps)


def samples_chain(args) -> Tensor:
    """``ncc_eval_sorted``'s costs (S, R, C) through the raw-samples form on
    CUDA tensors, the path before the fused kernel: per view the sort, the
    raw-samples kernel, the un-permute and the ZNCC in torch."""
    from mpmvs_torch.ops import ncc_sorted

    refside, src, widths, heights, A, b, K_ref, plane, x, y, offs, cmax, \
        cap = args
    S, Hp, Wp = src.shape
    R, C = x.shape
    T = len(offs)
    pf, xf, yf = ncc_sorted._flat(plane, x, y)
    costs = []
    for s in range(S):
        perm = ncc_sorted.sort_view(A[s], b[s], K_ref, pf, xf, yf, Hp, Wp)
        vals = ncc_sorted.unpermute(ncc_sorted.sample_view_vals_kernel(
            src[s], widths[s], heights[s], A[s], b[s], K_ref, pf, xf, yf,
            perm, offs, cap), perm)
        costs.append(ncc_sorted.zncc_from_samples(
            refside, vals[:T].reshape(T, R, C), vals[T].reshape(R, C) > 0.5,
            cmax))
    return torch.stack(costs)


def samples_chain_split(args, reps: int = 3) -> dict:
    """Device ms of :func:`samples_chain` split into its stages (sums over
    the views)."""
    from mpmvs_torch.ops import ncc_sorted

    refside, src, widths, heights, A, b, K_ref, plane, x, y, offs, cmax, \
        cap = args
    S, Hp, Wp = src.shape
    R, C = x.shape
    T = len(offs)
    pf, xf, yf = ncc_sorted._flat(plane, x, y)

    def sort(s, _):
        return ncc_sorted.sort_view(A[s], b[s], K_ref, pf, xf, yf, Hp, Wp)

    def samples(s, perm):
        return perm, ncc_sorted.sample_view_vals_kernel(
            src[s], widths[s], heights[s], A[s], b[s], K_ref, pf, xf, yf,
            perm, offs, cap)

    def unpermute(s, st):
        perm, vals = st
        return ncc_sorted.unpermute(vals, perm)

    def zncc(s, vals):
        return ncc_sorted.zncc_from_samples(
            refside, vals[:T].reshape(T, R, C), vals[T].reshape(R, C) > 0.5,
            cmax)

    split = _event_sums(("none", lambda: None),
                        [("sort", sort), ("samples_kernel", samples),
                         ("unpermute", unpermute), ("zncc", zncc)], S, reps)
    del split["none"]
    return split


def _same_count(a: Tensor, b: Tensor) -> int:
    """Entries of ``a`` not bit-equal to ``b`` (NaN equals NaN)."""
    return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum().item())


def run_sorted(bench: Bench, case: str, reps: int = 3,
               check: bool = False) -> list:
    """Time one sorted-path case: one result dict for the fused path, one
    for the raw-samples chain and one for the plain chain."""
    from mpmvs_torch.ops import ncc_sorted
    from mpmvs_torch.utils.roofline import keys_bound, sorted_bound
    from mpmvs_torch.utils.trace import cuda_time_ms

    args = sorted_inputs(bench, case)
    S, Hp, Wp = args[1].shape
    R, C = args[8].shape
    N, T = R * C, len(args[10])
    cap = args[12] > 0
    head = dict(kernel="sorted", case=case, shape=f"{C}x{R} px, {S} src "
                f"{Wp}x{Hp}", cap_radius=args[12], taps=T)
    res, want = [], None
    if check:
        want = ncc_sorted.ncc_eval_sorted_plain(*args)
    b_ms, b_by = sorted_bound(N, T, 4 * Hp * Wp, cap)
    k_ms = keys_bound(N)[0]
    ms = cuda_time_ms(lambda: ncc_sorted.ncc_eval_sorted_kernel(*args),
                      reps=reps)
    split = sorted_split(args, reps)
    r = dict(head, form="fused", ms=ms, split_ms=split,
             fused_ms_per_view=split["fused_kernel"] / S,
             bound_ms_per_view=b_ms, bound_by=b_by,
             share_of_bound=b_ms / (split["fused_kernel"] / S),
             keys_bound_ms_per_view=k_ms)
    if check:
        r["entries_differing"] = _same_count(
            ncc_sorted.ncc_eval_sorted_kernel(*args), want)
    res.append(r)
    chain = samples_chain_split(args, reps)
    res.append(dict(head, form="samples", ms=sum(chain.values()),
                    split_ms=chain))
    if check:
        res[-1]["entries_differing"] = _same_count(samples_chain(args), want)
    plain_ms = cuda_time_ms(lambda: ncc_sorted.ncc_eval_sorted_plain(*args),
                            reps=1)
    res.append(dict(head, form="plain", ms=plain_ms))
    return res


def bilateral_inputs(color0, device) -> dict:
    """{guide name: (bgr, prob)} at the scene's size: view 0's colour image
    ``color0`` (``float``) and it rounded to 8-bit values (``8bit``), each
    with a smooth random probability."""
    import torch.nn.functional as F

    bgr = torch.as_tensor(color0, device=device)
    H, W = bgr.shape[:2]
    gen = torch.Generator(device=device).manual_seed(5)
    logits = torch.randn((1, 1, max(H // 80, 1), max(W // 80, 1)),
                         generator=gen, device=device) * 3.0
    prob = torch.sigmoid(F.interpolate(logits, size=(H, W),
                                       mode="bilinear")[0, 0]).contiguous()
    eight = torch.clamp(torch.round(bgr), 0.0, 255.0).contiguous()
    return {"float": (bgr.contiguous(), prob), "8bit": (eight, prob)}


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)(.*)")


def _sass_functions(library: str) -> dict:
    """{mangled kernel name: [(address, opcode, operands), ...]} from
    ``cuobjdump -sass`` of ``library``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    functions, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            functions[current] = []
        elif current is not None:
            m = SASS_LINE.search(line)
            if m:
                functions[current].append(
                    (int(m.group(1), 16), m.group(2), m.group(3)))
    return functions


def _densest_loop(items: list, marker: str) -> list:
    """The opcodes of the loop (a branch back to an earlier address) with
    the most ``marker`` instructions (the opcode, with or without further
    modifiers), as written: those that a branch skips included, a called
    routine (an IEEE division's or square root's slow path) not. Of loops
    with as many markers, the innermost."""
    count = lambda body: sum(_is(o, marker) for o in body)
    best = []
    for addr, op, rest in items:
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            body = [o for a, o, _ in items if lo <= a <= addr]
            if count(body) > count(best):
                best = body
    return best


def _is(op: str, marker: str) -> bool:
    return op == marker or op.startswith(marker + ".")


def _per(body: list, n: float):
    """(instructions, {opcode: count}) of ``body`` over n units."""
    hist = collections.Counter(op.split(".")[0] for op in body)
    return len(body) / n, {op: c / n for op, c in hist.most_common()}


def sass_per_tap(library: str) -> dict:
    """{kernel form: (instructions a tap, {opcode: count a tap})} of the
    bilateral kernel in ``library``: in each form the loop with the most
    texel loads (``LDS.128`` in the float form, ``LDS.64`` in the table
    form) is the unrolled interior row, one texel load a tap."""
    out = {}
    for name, items in _sass_functions(library).items():
        m = re.search(r"bilateral_refine_kernelI(6float4|5uint2)E", name)
        if m:
            texel = "LDS.128" if m.group(1) == "6float4" else "LDS.64"
            body = _densest_loop(items, texel)
            out["float" if texel == "LDS.128" else "table"] = _per(
                body, sum(_is(o, texel) for o in body))
    return out


def sass_per_entry(library: str) -> dict:
    """{(fields held, 64-bit indices): (instructions a (field, source,
    pixel), {opcode: count an entry})} of the geometric-cost kernel's
    instantiations in ``library``. The loop with the most stores is the
    source loop: its main path ends at the chunk's last cost store, and
    the IEEE recomputation of the entries the fast path does not keep
    (as many stores again, rarely taken) follows it."""
    out = {}
    for name, items in _sass_functions(library).items():
        m = re.search(r"geom_cost_kernelILi(\d+)ELb([01])E", name)
        if m:
            kc = int(m.group(1))
            body = _densest_loop(items, "STG")
            stores = [i for i, o in enumerate(body) if _is(o, "STG")]
            out[kc, m.group(2) == "1"] = _per(body[:stores[kc - 1] + 1], kc)
    return out


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0])


def run_bilateral(bench: Bench, reps: int = 10, check: bool = False,
                  sass: bool = False) -> list:
    """Time the bilateral kernel's forms (one result dict each) and the
    plain version."""
    from mpmvs_torch.ops import bilateral_cuda as bc
    from mpmvs_torch.ops import nvcc
    from mpmvs_torch.utils.roofline import bilateral_bound, issue_floor_ms
    from mpmvs_torch.utils.trace import cuda_time_ms

    inputs = bilateral_inputs(bench.color0, bench.data.ref_img.device)
    H, W = inputs["float"][1].shape
    b_ms, b_by = bilateral_bound(H, W, bc.RADIUS)
    taps = H * W * (2 * bc.RADIUS + 1) ** 2
    floors = {}
    if sass:
        clock = max_sm_clock_mhz()
        for form, (per_tap, hist) in sass_per_tap(
                nvcc.build(bc.SOURCE, bc.NVCC_FLAGS)).items():
            floors[form] = dict(instructions_per_tap=per_tap,
                                opcodes_per_tap=hist, max_sm_clock_mhz=clock,
                                issue_floor_ms=issue_floor_ms(per_tap, taps,
                                                              clock))
    res = []
    for guide, form in (("float", "float"), ("8bit", "float"),
                        ("8bit", "table")):
        bgr, prob = (a.contiguous() for a in inputs[guide])
        fn = lambda: bc._launch(bgr, prob, bc.RADIUS, bc.SIGMA_SPATIAL,
                                bc.SIGMA_COLOR, form)
        ms = cuda_time_ms(fn, reps=reps)
        r = dict(kernel="bilateral", guide=guide, form=form,
                 shape=f"{W}x{H}", radius=bc.RADIUS, ms=ms,
                 gtaps_per_s=taps / ms / 1e6, bound_ms=b_ms, bound_by=b_by,
                 share_of_bound=b_ms / ms, **floors.get(form, {}))
        if check:
            r["entries_differing"] = _same_count(
                fn(), bc.bilateral_refine_plain(bgr, prob))
        res.append(r)
    bgr, prob = inputs["8bit"]
    res.append(dict(kernel="bilateral", guide="8bit", form="plain",
                    shape=f"{W}x{H}", ms=cuda_time_ms(
                        lambda: bc.bilateral_refine_plain(bgr, prob),
                        reps=1)))
    return res


GEOM_CASES = ("gt", "stack", "trials", "trial")


def geom_inputs(bench: Bench, case: str, key_seed: int = 13):
    """``geom_consistency_cost``'s arguments for one case at the geom band
    shape (the solve's geom band from row 0, its colour-0 packed pixels)."""
    from mpmvs_torch import geometry as geo
    from mpmvs_torch.ops import random as pmrand
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.packing import pack_quincunx, packed_coords
    from mpmvs_torch.solver import solve_band_rows

    data, params = bench.data, bench.params
    dev = data.ref_img.device
    H, W = data.ref_img.shape
    S = data.src_imgs.shape[0]
    if case not in GEOM_CASES:
        raise ValueError(f"geom case must be one of {GEOM_CASES}, got "
                         f"{case!r}")
    br = solve_band_rows(params, H, W, S, True)
    x, y = packed_coords(0, br, W // 2, 0, device=dev)
    gt = torch.movedim(pack_quincunx(torch.movedim(
        bench.gt_plane[:br], -1, 0), 0), 0, -1)
    rand = lambda: pmrand.random_plane_field(
        tf.PRNGKey(key_seed, device=dev), data.K_ref, x, y, data.depth_min,
        data.depth_max)
    if case == "gt":
        plane = gt.contiguous()
    elif case == "stack":
        scale = 1.0 + 0.002 * torch.arange(9, device=dev)
        plane = torch.cat([gt[None, ..., :3].expand(9, -1, -1, -1),
                           gt[None, ..., 3:] * scale[:, None, None, None]],
                          -1)
    elif case == "trials":
        # the band step's trial depths and normals: random, current,
        # random, current, the current depth scaled
        r = rand()
        d_gt, d_r = (geo.depth_from_plane(data.K_ref, p, x, y)
                     for p in (gt, r))
        n_gt, n_r = gt[..., :3], r[..., :3]
        plane = torch.stack([geo.plane_from_depth_normal(
            data.K_ref, x, y, d, nrm) for d, nrm in (
                (d_r, n_gt), (d_gt, n_r), (d_r, n_r), (d_gt, n_gt),
                (d_gt * 1.002, n_gt))])
    else:
        plane = rand()
    return (bench.src_depths, data.src_widths, data.src_heights, data.K_ref,
            data.R_ref, data.C_ref, data.t_ref, data.K_src, data.R_src,
            data.t_src, data.C_src, plane, x, y, params.geom_cost_max)


def run_geom(bench: Bench, case: str, reps: int = 20, check: bool = False,
             floors: dict = None) -> dict:
    """Time the geometric-cost kernel on one case beside its bound and the
    plain twin (one result dict); ``floors`` (from ``geom_floors``) adds
    the instantiation's instructions an entry and issue floor."""
    from mpmvs_torch.ops import geom_cost, geom_cost_cuda
    from mpmvs_torch.utils.roofline import geom_bound, geom_issue_floor_ms
    from mpmvs_torch.utils.trace import cuda_time_ms

    args = geom_inputs(bench, case)
    src, plane, x = args[0], args[11], args[12]
    S, Hs, Ws = src.shape
    K = plane.numel() // (4 * x.numel())
    R, C = x.shape
    kernel = lambda: geom_cost_cuda.geom_consistency_cost_kernel(
        *args, cams=bench.data.geom_cams)
    b_ms, b_by = geom_bound(K, S, R * C, src.numel() * 4)
    ms = cuda_time_ms(kernel, reps)
    plain_ms = cuda_time_ms(
        lambda: geom_cost.geom_consistency_cost_plain(*args), reps=1)
    wide = geom_cost_cuda.wide_index(S, Hs, Ws)
    r = dict(kernel="geom", case=case, k=K,
             shape=f"{C}x{R} px, {S} src {Ws}x{Hs}", ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             share_of_bound=b_ms / ms, index_bits=64 if wide else 32,
             **geom_cost_cuda.kernel_attributes(K, wide))
    if floors is not None:
        per_entry, hist = floors["per_entry"][r["fields_held"], wide]
        floor = geom_issue_floor_ms(K, S, R * C, per_entry,
                                    floors["max_sm_clock_mhz"])
        r.update(instructions_per_entry=per_entry, opcodes_per_entry=hist,
                 max_sm_clock_mhz=floors["max_sm_clock_mhz"],
                 issue_floor_ms=floor, share_of_issue_floor=floor / ms)
    if check:
        r["entries_differing"] = _same_count(
            kernel(), geom_cost.geom_consistency_cost_plain(*args))
    return r


def geom_floors() -> dict:
    """The geometric-cost kernel's instructions an entry by instantiation
    (``sass_per_entry`` of the built library) and the card's maximum SM
    clock, for ``run_geom``."""
    from mpmvs_torch.ops import geom_cost_cuda, nvcc

    return {"per_entry": sass_per_entry(nvcc.build(
                geom_cost_cuda.SOURCE, geom_cost_cuda.NVCC_FLAGS)),
            "max_sm_clock_mhz": max_sm_clock_mhz()}


# (rows, columns) of the lossless WebP predictor's cases: one band of 32
# rows (the walk of one warp), then more bands (each waits on the one
# above), up to phase 8c's image
VP8L_CASES = ((32, 3200), (64, 3200), (128, 3200), (512, 3200),
              (2130, 3200), (2130, 1600))


def run_vp8l(reps: int, check: bool) -> list:
    """``vp8l_predictor_kernel`` on random residuals and random modes 0-13
    (blocks of 32) at VP8L_CASES: ms, and ns a step of the wavefront's
    critical path if bands did not wait (W + 2 (H - 1) steps)."""
    from mpmvs_torch.io import images
    from mpmvs_torch.utils.trace import cuda_time_ms

    out = []
    for H, W in VP8L_CASES:
        g = torch.Generator().manual_seed(H * 7 + W)
        res = torch.randint(-2 ** 31, 2 ** 31, (H, W), generator=g,
                            dtype=torch.int64).to(torch.int32).cuda()
        bits = 5
        tiles = images._subsample(W, bits) * images._subsample(H, bits)
        modes = (torch.randint(0, 14, (tiles,), generator=g) << 8).to(
            torch.int32).cuda()
        fn = lambda: images.vp8l_predictor_kernel(res, modes, bits)
        ms = cuda_time_ms(fn, reps)
        steps = W + 2 * (H - 1)
        r = dict(kernel="vp8l_predictor", shape=f"{W}x{H}",
                 bands=(H + 31) // 32, ms=ms, ideal_steps=steps,
                 ns_a_step=ms * 1e6 / steps)
        if check and H <= 512:
            r["entries_differing"] = int((fn() != images.vp8l_predictor_plain(
                res, modes, bits)).sum())
        out.append(r)
    return out


# (name, ratios a plane, colour space name): a 4:2:0 JPEG, phase 8's YCCK
# source's layout (Y, K at full size, Cb, Cr at 2x2), a CMYK file's at 1x1
COLOUR_CASES = (("ycc_420", ((1, 1), (2, 2), (2, 2)), "SPACE_YCC"),
                ("ycck_file", ((1, 1), (2, 2), (2, 2), (1, 1)), "SPACE_YCCK"),
                ("cmyk_11", ((1, 1),) * 4, "SPACE_CMYK"))


def run_colour(reps: int, check: bool, H: int = 2130, W: int = 3200) -> list:
    """The JPEG colour kernels through ``images.colour_kernel`` on random
    planes of an (H, W) image at COLOUR_CASES, and, where the tree has the
    chunked form (``images.Chunks``), on a JPEG-compressed TIFF's planes
    at 4:2:0 in strips of 16 rows (``chunks_420``, phase 8d's layout):
    CUDA-event ms of back-to-back calls (``ms``, the wrapper's host work
    included where it is the longer) and of the launches alone from a
    CUDA graph (``graph_ms``, ``utils.trace.cuda_graph_ms``), the bytes
    bound (``utils.roofline``) and, with
    ``check``, the entries that differ from ``images.colour_plain``. Of
    the image module it uses only what the colour kernels' callers had
    before the chunked form, so with this module and ``utils/trace.py``
    copied in it times an older tree too."""
    from mpmvs_torch.io import images
    from mpmvs_torch.utils import roofline
    from mpmvs_torch.utils.trace import cuda_graph_ms, cuda_time_ms

    g = torch.Generator().manual_seed(H + W)
    rand = lambda h, w: torch.randint(0, 256, (h, w), generator=g,
                                      dtype=torch.uint8).cuda()
    cases = [(name, [rand(-(-H // rv), -(-W // rh)) for rh, rv in factors],
              factors, getattr(images, space), None,
              # a YCbCr JPEG's grey is its full-size Y plane, not written
              lambda p, h, w, grey=space != "SPACE_YCC":
              roofline.colour_bound(p, h, w, grey))
             for name, factors, space in COLOUR_CASES]
    if hasattr(images, "Chunks"):
        n = -(-H // 16)
        k = images.Chunks(0, W, 16, 1, n, 0, W,
                          (16,) * (n - 1) + (H - 16 * (n - 1),))
        factors = ((1, 1), (2, 2), (2, 2))
        cases.append(("chunks_420", [rand(n * 16 // rv, -(-W // rh))
                                     for rh, rv in factors],
                      factors, images.SPACE_YCC, k,
                      lambda p, h, w, k=k, f=factors:
                      roofline.chunked_colour_bound(k, f, h, w)))
    out = []
    for name, planes, factors, space, chunks, bound in cases:
        args = (planes, factors, (H, W), space) + ((chunks,) if chunks
                                                   else ())
        fn = lambda: images.colour_kernel(*args)
        ms = cuda_time_ms(fn, reps)
        bnd = bound(planes, H, W)
        r = dict(kernel="colour", case=name, shape=f"{W}x{H}", ms=ms,
                 bound_ms=bnd[0], bound_by=bnd[1], share_of_bound=bnd[0] / ms)
        r["graph_ms"] = cuda_graph_ms(fn, reps)
        r["graph_share_of_bound"] = bnd[0] / r["graph_ms"]
        if check:
            got, want = fn(), images.colour_plain(*args)
            r["entries_differing"] = sum(int((a != b).sum())
                                         for a, b in zip(got, want))
        out.append(r)
    return out


J2K_SOURCES = ("plane_3200x2130_lossless.jp2", "plane_3200x2130_97_rpcl.jp2",
               "plane_3200x2130_53_rct.jp2")


def run_j2k(reps: int, check: bool) -> list:
    """The JPEG 2000 kernels on the three 3200x2130 sources of
    ``tests/data/jp2/conversion`` (a lossless 5/3 file with no colour
    transform, a tiled 9/7 ICT one, a rate-limited 5/3 RCT one), after the host's parse and tier-1:
    each level's two ``j2k_idwt_kernel`` launches and the
    ``j2k_colour_kernel`` launch, their CUDA-event ms (``ms``) and ms from
    a CUDA graph (``graph_ms``) beside the bounds of ``utils.roofline``,
    and with ``check`` the entries that differ from the twins
    (``images.j2k_idwt_plain``, ``j2k_colour_plain``). The levels run in
    place, so a timed level transforms its own output again: the same work
    on other values."""
    from mpmvs_torch.io import images
    from mpmvs_torch.utils import roofline
    from mpmvs_torch.utils.trace import cuda_graph_ms, cuda_time_ms

    folder = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "tests", "data", "jp2",
        "conversion")
    dev = torch.device("cuda")
    out = []
    for name in J2K_SOURCES:
        with open(os.path.join(folder, name), "rb") as f:
            img = images.j2k_host_image(f.read(), images._library())
        coef, sched, col = images.j2k_upload(img, dev)
        scratch = torch.empty_like(coef)
        for lv in sched:
            want = images.j2k_idwt_plain(coef, lv) if check else None
            images.j2k_idwt_kernel(coef, scratch, lv)
            work = coef.clone()
            fn = lambda: images.j2k_idwt_kernel(work, scratch, lv)
            bnd = roofline.j2k_idwt_bound(lv)
            r = dict(kernel="j2k_idwt", source=name, level=lv.level,
                     form=lv.form, jobs=lv.jobs.numel() // 8, rows=lv.rows,
                     cols=lv.cols, ms=cuda_time_ms(fn, reps),
                     graph_ms=cuda_graph_ms(fn, reps), bound_ms=bnd[0],
                     bound_by=bnd[1])
            if check:
                r["entries_differing"] = int((coef != want).sum())
            out.append(r)
        fn = lambda: images.j2k_colour_kernel(coef, col)
        bnd = roofline.j2k_colour_bound(col)
        r = dict(kernel="j2k_colour", source=name, form=col.form,
                 ms=cuda_time_ms(fn, reps), graph_ms=cuda_graph_ms(fn, reps),
                 bound_ms=bnd[0], bound_by=bnd[1])
        if check:
            r["entries_differing"] = sum(
                int((a != b).sum()) for a, b in zip(
                    fn(), images.j2k_colour_plain(coef, col)))
        out.append(r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=2130)
    ap.add_argument("--width", type=int, default=3200)
    ap.add_argument("--views", type=int, default=11)
    ap.add_argument("--band-rows", type=int, default=0,
                    help="rows of the band (0: the solve's band height)")
    ap.add_argument("--k", type=int, default=None,
                    help="stacked fields per call (default: the suite)")
    ap.add_argument("--scale", type=int, default=0)
    ap.add_argument("--pixels", default="packed", choices=("packed", "all"))
    ap.add_argument("--cases", default="coherent,trials",
                    help=f"comma-separated, of "
                    f"{sorted(FIELDS) + list(STEPS)}")
    ap.add_argument("--cap-mult", type=float, default=None,
                    help="override params.footprint_cap_mult")
    ap.add_argument("--launch", default="auto",
                    choices=("auto", "both") + tuple(LAUNCHES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check", action="store_true",
                    help="also compare with the plain version")
    ap.add_argument("--kernel", default="ncc",
                    choices=("ncc", "sorted", "bilateral", "geom", "vp8l",
                             "colour", "j2k"))
    ap.add_argument("--sorted-cases", default=",".join(SORTED_CASES),
                    help=f"comma-separated, of {list(SORTED_CASES)}")
    ap.add_argument("--sass", action="store_true",
                    help="count the bilateral forms' instructions a tap, "
                    "the geometric-cost kernel's an entry")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("no CUDA device: kernel_bench times the kernel on a card",
              file=sys.stderr)
        return 1
    from mpmvs_torch.ops import nvcc
    from mpmvs_torch.tools import build_kernels

    build_kernels(torch.device("cuda"), verbose=True)
    if args.kernel in ("vp8l", "colour", "j2k"):  # no scene
        from mpmvs_torch.tools import device_record

        rec = device_record(torch.device("cuda", 0))
        run = {"vp8l": run_vp8l, "colour": run_colour,
               "j2k": run_j2k}[args.kernel]
        for res in run(4 * args.reps, args.check):
            res.update(kind=rec["kind"], nvidia_smi=rec["nvidia_smi"])
            print(json.dumps(res), flush=True)
        return 0
    t0 = time.perf_counter()
    bench = setup(args.height, args.width, args.views, args.band_rows,
                  args.cap_mult)
    print(f"scene and band in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.kernel != "ncc":
        if args.kernel == "sorted":
            results = [r for case in args.sorted_cases.split(",")
                       for r in run_sorted(bench, case, min(args.reps, 3),
                                           args.check)]
        elif args.kernel == "geom":
            floors = geom_floors() if args.sass else None
            results = [run_geom(bench, case, 4 * args.reps, args.check,
                                floors) for case in GEOM_CASES]
        else:
            results = run_bilateral(bench, args.reps, args.check, args.sass)
        for res in results:
            res.update(kind=bench.device["kind"],
                       nvidia_smi=bench.device["nvidia_smi"])
            print(json.dumps(res), flush=True)
        return 0
    one = (args.k, args.scale, args.pixels, tuple(args.cases.split(",")))
    suite = SUITE if args.k is None else (one,)
    for K, scale, pixels, fields in suite:
        for field in fields:
            for res in run_case(bench, K, scale, pixels, field, args.reps,
                                args.check, args.launch):
                print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
