"""Adaptive checkerboard propagation + hypothesis refinement.

Counterpart of ``mpmvs_tpu.ops.propagation`` (CheckerboardPropagation /
PlaneHypothesisRefinement, src/PatchMatch.cu:642-998). The active
checkerboard colour's pixels are packed into a dense (rows, W//2) array
(ops/packing.py) and updated as tensor ops; the two-phase schedule (black
reads red's fresh values and vice versa) is what makes the in-place update
race-free.

Memory: one half-iteration's candidate cost tensors are (8 regions x S views
x pixels), so the step runs over row *bands*: each band reads the state with
a halo (propagation reach 23 px + NCC window radius) and computes its active
pixels' update from the previous state alone. Bands run as a Python loop;
peak memory is one band's working set (``auto_band_rows``).

The 8 sample regions (4 diagonal "V" wings x 12 candidates, 4 axial strips
x 10 candidates reaching ±23 px, PatchMatch.cu:769-779) each contribute the
neighbour with the lowest *current* cost; the 8 winners and the current
plane are scored against all sources in one K=9 NCC call, the 5 refinement
trials in one K=5 call (``ops.ncc_cuda.ncc_eval_multi``); with
``sampler="sorted"`` the two random-depth trials go through
``ops.ncc_sorted.ncc_eval_sorted`` and the other three through one K=3 call.

Modes, as in the JAX package: ``geom`` adds 0.2 x the forward-backward
reprojection error against the sources' depth maps (``ops/geom_cost``) to
every candidate and trial cost and tracks its share in ``geom_cost``; a
band step scores the 8 candidates and the current plane in one K=9 call
and the 5 trials in one K=5 call, with the camera table of the solve
(``SolveData.geom_cams``);
``prior`` adopts by the planar-prior score inside the prior mask
(``_prior_score``, PatchMatch.cu:924-978) and by min cost outside it; both
together are the ``geom_prior`` extension.

The JAX package's documented deviations are kept (mpmvs_tpu
propagation.py:29-39): regionless candidates cost +inf, a zero Monte-Carlo
weight sum keeps the pixel's state, candidates are scored at a clamped
disparity, adopting a candidate in prior mode also updates the stored cost,
and the refinement's geometric accumulator uses the view's own weight.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops import random as pmrand
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.ops.geom_cost import geom_consistency_cost
from mpmvs_torch.ops.ncc import ncc_refside
from mpmvs_torch.ops.ncc_cuda import ncc_eval_multi
from mpmvs_torch.ops.ncc_sorted import ncc_eval_sorted
from mpmvs_torch.ops.packing import (pack_quincunx, packed_coords,
                                     unpack_quincunx)
from mpmvs_torch.ops.sampling import shift_2d
from mpmvs_torch.ops.view_selection import monte_carlo_view_weights
from mpmvs_torch.parallel.mesh import map_items

Tensor = torch.Tensor

# Sample regions: (dx, dy) offsets, np = p + offset (PatchMatch.cu:769-779).
# 0: up-V, 1: down-V, 2: left-V, 3: right-V, 4-7: up/down/left/right strips.
DIRS: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((-5, -6), (5, -6), (-6, -7), (6, -7), (-7, -8), (7, -8), (-8, -9), (8, -9),
     (-9, -10), (9, -10), (-10, -11), (10, -11)),
    ((-5, 6), (5, 6), (-6, 7), (6, 7), (-7, 8), (7, 8), (-8, 9), (8, 9),
     (-9, 10), (9, 10), (-10, 11), (10, 11)),
    ((-6, -5), (-6, 5), (-7, -6), (-7, 6), (-8, -7), (-8, 7), (-9, -8), (-9, 8),
     (-10, -9), (-10, 9), (-11, -10), (-11, 10)),
    ((6, -5), (6, 5), (7, -6), (7, 6), (8, -7), (8, 7), (9, -8), (9, 8),
     (10, -9), (10, 9), (11, -10), (11, 10)),
    ((0, -5), (0, -7), (0, -9), (0, -11), (0, -13), (0, -15), (0, -17),
     (0, -19), (0, -21), (0, -23)),
    ((0, 5), (0, 7), (0, 9), (0, 11), (0, 13), (0, 15), (0, 17), (0, 19),
     (0, 21), (0, 23)),
    ((-5, 0), (-7, 0), (-9, 0), (-11, 0), (-13, 0), (-15, 0), (-17, 0),
     (-19, 0), (-21, 0), (-23, 0)),
    ((5, 0), (7, 0), (9, 0), (11, 0), (13, 0), (15, 0), (17, 0), (19, 0),
     (21, 0), (23, 0)),
)

# Immediate 4-neighbours whose view bitmasks seed the selection prior,
# gated on the matching V-wing having a valid candidate
# (PatchMatch.cu:788-793, 824-830). Order: up, down, left, right.
NEIGHBOR_OFFSETS = ((0, -1), (0, 1), (-1, 0), (1, 0))

PROPAGATION_REACH = 23  # max |offset| component — the halo a band needs
_MAX_DX = max(abs(dx) for region in DIRS for dx, _ in region)

# Working-set budget of one band on an H100 (80 GB), in the units of the
# cost model below. The JAX package fitted 256 MB to a TPU v5e. Measured on
# the H100 (PERF.md): a half-iteration at 3200x2130, S=10 takes 4.3 MiB of
# device memory per band row and runs fastest as one band (per-band cost is
# fixed host/launch overhead), so the budget lets that shape run as one
# band (~9 GiB); S=20 then takes two.
H100_BAND_BUDGET_MB = 8192

NCCMulti = Callable[..., Tensor]


class SolveData(NamedTuple):
    """Per-scene constants for one reference view's solve."""

    ref_img: Tensor            # (H, W) float32 grayscale
    src_imgs: Tensor           # (S, Hs, Ws) source images
    src_widths: Tensor         # (S,) float valid extents
    src_heights: Tensor        # (S,)
    K_ref: Tensor              # (3, 3)
    R_ref: Tensor
    t_ref: Tensor
    C_ref: Tensor
    K_src: Tensor              # (S, 3, 3)
    R_src: Tensor
    t_src: Tensor
    C_src: Tensor
    A: Tensor                  # (S, 3, 3) homography terms
    b: Tensor                  # (S, 3)
    depth_min: Tensor          # () scalar (already widened 0.6x/1.2x)
    depth_max: Tensor
    src_depths: Optional[Tensor] = None    # (S, Hs, Ws), geom mode
    prior_planes: Optional[Tensor] = None  # (H, W, 4), prior mode
    prior_mask: Optional[Tensor] = None    # (H, W) bool
    # the geometric-cost kernel's camera table (24 + 26 S floats,
    # ops.geom_cost_cuda.camera_table), built once a solve; None: each
    # call builds its own
    geom_cams: Optional[Tensor] = None


class PatchMatchState(NamedTuple):
    plane: Tensor      # (H, W, 4) (n_cam, w) during the solve
    cost: Tensor       # (H, W)
    geom_cost: Tensor  # (H, W)
    sel: Tensor        # (H, W) int32 view bitmask


def select_candidates(cost: Tensor, plane: Tensor):
    """Per-region min-cost neighbour hypothesis (whole-image oracle form).
    Returns (cand_planes (8, H, W, 4), cand_valid (8, H, W)). Strict-<
    keeps the first minimum like ``bestConf > nconf`` (PatchMatch.cu:809-812)."""
    H, W = cost.shape
    plane_flat = plane.reshape(H * W, 4)
    yy = torch.arange(H, device=cost.device)[:, None]
    xx = torch.arange(W, device=cost.device)[None, :]
    cands, valids = [], []
    for region in DIRS:
        best_c = torch.full((H, W), math.inf, dtype=cost.dtype,
                            device=cost.device)
        best_k = torch.zeros((H, W), dtype=torch.int64, device=cost.device)
        for k, (dx, dy) in enumerate(region):
            c = shift_2d(cost, dx, dy, fill=math.inf)
            take = c < best_c
            best_c = torch.where(take, c, best_c)
            best_k = torch.where(take, torch.full_like(best_k, k), best_k)
        dxs = torch.tensor([d[0] for d in region], device=cost.device)
        dys = torch.tensor([d[1] for d in region], device=cost.device)
        iy = torch.clamp(yy + dys[best_k], 0, H - 1)
        ix = torch.clamp(xx + dxs[best_k], 0, W - 1)
        cands.append(plane_flat[iy * W + ix])
        valids.append(torch.isfinite(best_c))
    return torch.stack(cands), torch.stack(valids)


def _select_candidates_packed(cost_s: Tensor, plane_s: Tensor, halo: int,
                              rows: int, phase: int, x_int: Tensor,
                              depth_s: Optional[Tensor] = None):
    """Banded + packed candidate harvest.

    cost_s/plane_s: (Hs, W[, 4]) band slice with ``halo`` rows above/below
    (out-of-image rows hold +inf cost). Returns (cand_planes (8, rows, W//2,
    4), cand_valid (8, rows, W//2), cand_src_depth or None) for the active
    colour's pixels of the central ``rows`` rows. ``x_int`` (rows, W//2):
    global x of each packed pixel. ``depth_s`` (Hs, W): the slice's stored
    depth, gathered at each candidate's source pixel when given.

    Equal to shifting the whole slice with +inf fill as the JAX package
    does: the halo covers every vertical offset, so only columns need fill.
    """
    Hs, W = cost_s.shape
    plane_flat = plane_s.reshape(Hs * W, 4)
    depth_flat = depth_s.reshape(Hs * W) if depth_s is not None else None
    cost_pad = F.pad(cost_s, (_MAX_DX, _MAX_DX), value=math.inf)
    r_local = (torch.arange(rows, device=cost_s.device)[:, None] + halo)
    x_int = x_int.to(torch.int64)
    cands, valids, src_ds = [], [], []
    for region in DIRS:
        best_c = torch.full(x_int.shape, math.inf, dtype=cost_s.dtype,
                            device=cost_s.device)
        best_k = torch.zeros(x_int.shape, dtype=torch.int64,
                             device=cost_s.device)
        for k, (dx, dy) in enumerate(region):
            c = pack_quincunx(cost_pad[halo + dy:halo + dy + rows,
                                       _MAX_DX + dx:_MAX_DX + dx + W], phase)
            take = c < best_c
            best_c = torch.where(take, c, best_c)
            best_k = torch.where(take, torch.full_like(best_k, k), best_k)
        dxs = torch.tensor([d[0] for d in region], device=cost_s.device)
        dys = torch.tensor([d[1] for d in region], device=cost_s.device)
        iy = torch.clamp(r_local + dys[best_k], 0, Hs - 1)
        ix = torch.clamp(x_int + dxs[best_k], 0, W - 1)
        lin = iy * W + ix
        cands.append(plane_flat[lin])
        valids.append(torch.isfinite(best_c))
        if depth_flat is not None:
            src_ds.append(depth_flat[lin])
    src_d = torch.stack(src_ds) if depth_flat is not None else None
    return torch.stack(cands), torch.stack(valids), src_d


def _weighted_total(costs_v: Tensor, weights: Tensor, norm: Tensor,
                    geom_v: Optional[Tensor] = None, geom_weight: float = 0.0):
    """sum_s w_s (c_s [+ geom_weight g_s]) / norm, with zero norm guarded
    to +inf. costs_v/geom_v: (S, …); weights: (…, S); norm: (…,).
    Returns (total (…,), geom share (…,) or None)."""
    w = torch.movedim(weights, -1, 0)
    safe_norm = torch.clamp(norm, min=1e-30)
    if geom_v is None:
        total = torch.sum(w * costs_v, 0) / safe_norm
        geom_total = None
    else:
        g = geom_weight * geom_v
        total = torch.sum(w * (costs_v + g), 0) / safe_norm
        geom_total = torch.sum(w * g, 0) / safe_norm
    total = torch.where(norm > 0, total, torch.full_like(total, math.inf))
    return total, geom_total


def _prior_score(cost: Tensor, depth: Tensor, plane_n: Tensor,
                 prior_planes: Tensor, prior_depth: Tensor,
                 depth_sigma: Tensor, angle_sigma: float, gamma: float,
                 beta: float) -> Tensor:
    """Planar-prior score to maximise, exp(-cost^2/beta) (gamma +
    exp(-dd^2/2sd^2) exp(-da^2/2sa^2)) (PatchMatch.cu:924-955); 0 where the
    cost is not finite."""
    depth_diff = depth - prior_depth
    angle_cos = torch.clamp(geo.dot3(prior_planes[..., :3], plane_n), -1.0,
                            1.0)
    angle_diff = torch.arccos(angle_cos)
    two_ds2 = 2.0 * depth_sigma * depth_sigma
    two_as2 = 2.0 * angle_sigma * angle_sigma
    prior = gamma + torch.exp(-depth_diff * depth_diff / two_ds2) * torch.exp(
        -angle_diff * angle_diff / two_as2)
    score = torch.exp(-cost * cost / beta) * prior
    return torch.where(torch.isfinite(cost), score, torch.zeros_like(score))


def step_halo(scale: int) -> int:
    """Rows of context a band needs above/below its output rows: candidate
    reach (23) or the NCC window radius 5*2^scale, whichever is larger;
    rounded up to even."""
    h = max(PROPAGATION_REACH + 1, 5 * (2 ** scale))
    return h + (h % 2)


def auto_band_rows(H: int, W: int, S: int, geom: bool,
                   budget_mb: int = H100_BAND_BUDGET_MB) -> int:
    """Even band height keeping one band's working set under ``budget_mb``,
    with the JAX package's cost model: ~48 S floats per packed row (56 S
    with the geometric term). Bands split H evenly; result in [32, H_even]."""
    h_even = H + (H % 2)
    floats_per_row = S * (W // 2 or 1) * (56 if geom else 48)
    rows_max = int(budget_mb * 1024 * 1024 // max(4 * floats_per_row, 1))
    rows_max = max(32, min(h_even, rows_max))
    n_bands = -(-h_even // rows_max)
    rows = -(-h_even // n_bands)
    return min(h_even, rows + (rows % 2))


def _take(arr: Tensor, idx: Tensor) -> Tensor:
    """arr (8, …[, c]) at per-pixel index idx (…) along axis 0."""
    if arr.ndim == idx.ndim + 2:
        g = idx[None, ..., None].expand((1,) + tuple(idx.shape)
                                        + (arr.shape[-1],))
    else:
        g = idx[None]
    return torch.gather(arr, 0, g)[0]


def _band_step(data: SolveData, params, scale: int, iteration: int,
               phase: int, key: Tensor, key_step: Tensor, geom: bool,
               prior: bool, halo: int, rows: int, y0: int, cost_s: Tensor,
               plane_s: Tensor, sel_s: Tensor, ref_s: Tensor, geom_c: Tensor,
               prior_planes_c: Optional[Tensor],
               prior_mask_c: Optional[Tensor], ncc_multi: NCCMulti):
    """One band's active-colour update (mpmvs_tpu propagation.py:272-665).
    ``geom_c``, ``prior_planes_c`` and ``prior_mask_c`` are the band's
    central rows (no halo). Returns packed (plane (rows, W//2, 4), cost,
    geom_cost, sel)."""
    Hs, W = cost_s.shape
    Wh = W // 2
    dev = cost_s.device
    offsets = params.tap_offsets(scale)
    k_mc, k_ref1, k_ref2, k_ref3, k_ref4, k_prior = tf.split(key, 6)

    x_p, y_p = packed_coords(y0, rows, Wh, phase, device=dev)
    x_int = x_p.to(torch.int64)

    crop = lambda a: a[..., halo:halo + rows, :]
    prep = lambda a: pack_quincunx(crop(a), phase)
    pack_vec = lambda a: torch.movedim(
        pack_quincunx(torch.movedim(a, -1, 0), phase), 0, -1)

    cost_c = prep(cost_s)
    sel_c = prep(sel_s)
    plane_c = torch.movedim(prep(torch.movedim(plane_s, -1, 0)), 0, -1)
    geom_cost_c = pack_quincunx(geom_c, phase)
    if prior:
        prior_planes_p = pack_vec(prior_planes_c)
        prior_mask_p = pack_quincunx(prior_mask_c, phase)

    refside = ncc_refside(ref_s, halo, rows, offsets, params.sigma_spatial,
                          params.sigma_color, pack_phase=phase)
    cap = params.cap_radius(scale)

    def ncc_batch(planes: Tensor, scattered: bool = False) -> Tensor:
        return ncc_multi(refside, data.src_imgs, data.src_widths,
                         data.src_heights, data.A, data.b, data.K_ref,
                         planes.contiguous(), x_p, y_p, offsets,
                         params.cost_max, cap, scattered=scattered)

    def gcost(planes: Tensor) -> Tensor:
        """(S, K, rows, Wh) geometric costs of K stacked fields, one call."""
        return geom_consistency_cost(
            data.src_depths, data.src_widths, data.src_heights, data.K_ref,
            data.R_ref, data.C_ref, data.t_ref, data.K_src, data.R_src,
            data.t_src, data.C_src, planes, x_p, y_p, params.geom_cost_max,
            cams=data.geom_cams)

    # ---- 1. candidate harvest + their multi-view photometric costs (the
    # current hypothesis rides the same K=9 call; its cost is used in step 4)
    clamp = params.disp_clamp_frac
    dmin, dmax = data.depth_min, data.depth_max
    if clamp > 0.0:
        # Disparity extrapolation clamp (the JAX package's deviation):
        # candidates are EVALUATED at a disparity within ±clamp x range of
        # their source pixel's stored depth; the original plane is adopted.
        y_s = (torch.arange(Hs, dtype=torch.float32, device=dev)
               + float(y0 - halo))
        x_s = torch.arange(W, dtype=torch.float32, device=dev)
        depth_s = geo.depth_from_plane(data.K_ref, plane_s, x_s[None, :],
                                       y_s[:, None])
        cand_planes, cand_valid, cand_src_d = _select_candidates_packed(
            cost_s, plane_s, halo, rows, phase, x_int, depth_s)
        cand_d = geo.depth_from_plane(data.K_ref, cand_planes, x_p, y_p)
        disp = 1.0 / cand_d
        disp_nb = torch.minimum(torch.maximum(1.0 / cand_src_d, 1.0 / dmax),
                                1.0 / dmin)
        disp_nb = torch.where(torch.isfinite(disp_nb), disp_nb,
                              (1.0 / dmax).expand_as(disp_nb))
        half_d = clamp * (1.0 / dmin - 1.0 / dmax)
        disp_ev = torch.minimum(torch.maximum(disp, disp_nb - half_d),
                                disp_nb + half_d)
        disp_ev = torch.where(torch.isfinite(disp_ev), disp_ev, disp_nb)
        clamped = disp_ev != disp
        plane_ev = geo.plane_from_depth_normal(data.K_ref, x_p, y_p,
                                               1.0 / disp_ev,
                                               cand_planes[..., :3])
        eval_planes = torch.where(clamped[..., None], plane_ev, cand_planes)
        # dead from here on: freed before the band's peak (steps 1-3)
        del depth_s, cand_src_d, cand_d, disp, disp_nb, disp_ev, clamped
        del plane_ev
    else:
        cand_planes, cand_valid, _ = _select_candidates_packed(
            cost_s, plane_s, halo, rows, phase, x_int)
    # the ORIGINAL candidates, then the current plane: the geometric cost's
    # K=9 fields (step 3) and, unclamped, the NCC call's; the candidates
    # live on as a view of it
    fields9 = torch.cat([cand_planes, plane_c[None]], 0)
    cand_planes = fields9[:8]
    if clamp > 0.0:
        batch9 = ncc_batch(torch.cat([eval_planes, plane_c[None]], 0))
        del eval_planes
    else:
        batch9 = ncc_batch(fields9)
    cost_array = batch9[:8]  # (8, S, rows, Wh)
    cost_vec_now = batch9[8]

    # ---- 2. Monte-Carlo view re-selection
    neighbor_sel = torch.stack([prep(shift_2d(sel_s, dx, dy, fill=0))
                                for (dx, dy) in NEIGHBOR_OFFSETS])
    weights, weight_norm, temp_selected = monte_carlo_view_weights(
        k_mc, cost_array, cand_valid, neighbor_sel, cand_valid[:4],
        iteration, params.num_mc_samples)

    # ---- 3. view-weighted final candidate costs (+ geometric consistency,
    # evaluated for the ORIGINAL candidate planes as in the JAX package, and
    # for the current plane, in one K=9 call)
    geom9 = gcost(fields9) if geom else None  # (S, 9, rows, Wh)
    geom_of = lambda g, i: None if g is None else g[:, i]
    totals = [_weighted_total(cost_array[i], weights, weight_norm,
                              geom_of(geom9, i), params.geom_weight)
              for i in range(8)]
    inf = torch.full_like(cost_c, math.inf)
    final_costs = torch.stack([torch.where(cand_valid[i], totals[i][0], inf)
                               for i in range(8)])
    min_idx = torch.argmin(final_costs, 0)

    # ---- 4. current hypothesis cost under the new view weights
    cost_now, geom_now = _weighted_total(
        cost_vec_now, weights, weight_norm, geom_of(geom9, 8),
        params.geom_weight)
    cost_now = torch.where(weight_norm > 0, cost_now, cost_c)
    if geom:
        geom_now = torch.where(weight_norm > 0, geom_now, geom_cost_c)
        geom_totals = torch.stack([tot[1] for tot in totals])
    else:
        geom_now = geom_cost_c
    # the per-view costs of steps 1-4 are dead: step 5's live set holds the
    # trials' instead
    del batch9, cost_array, cost_vec_now, geom9, totals

    best_cost = _take(final_costs, min_idx)
    best_valid = _take(cand_valid, min_idx) & torch.isfinite(best_cost)
    best_plane = _take(cand_planes, min_idx)
    best_depth = geo.depth_from_plane(data.K_ref, best_plane, x_p, y_p)
    depth_ok = (best_depth >= dmin) & (best_depth <= dmax)

    angle_sigma = math.pi * params.prior_angle_sigma_deg / 180.0
    depth_sigma = (dmax - dmin) * params.prior_depth_sigma_frac
    if prior:
        # prior-regularised adoption (PatchMatch.cu:924-978)
        prior_depth = geo.depth_from_plane(data.K_ref, prior_planes_p, x_p,
                                           y_p)
        cand_depths = geo.depth_from_plane(data.K_ref, cand_planes, x_p, y_p)
        restricted = _prior_score(
            final_costs, cand_depths, cand_planes[..., :3],
            prior_planes_p[None], prior_depth[None], depth_sigma,
            angle_sigma, params.prior_gamma, params.prior_beta)
        restricted = torch.where(cand_valid, restricted,
                                 torch.full_like(restricted, -math.inf))
        max_idx = torch.argmax(restricted, 0)
        r_best = _take(restricted, max_idx)
        r_valid = _take(cand_valid, max_idx)
        r_plane = _take(cand_planes, max_idx)
        r_cost = _take(final_costs, max_idx)
        r_depth = _take(cand_depths, max_idx)
        depth_now_cur = geo.depth_from_plane(data.K_ref, plane_c, x_p, y_p)
        r_now = _prior_score(cost_now, depth_now_cur, plane_c[..., :3],
                             prior_planes_p, prior_depth, depth_sigma,
                             angle_sigma, params.prior_gamma,
                             params.prior_beta)
        r_depth_ok = (r_depth >= dmin) & (r_depth <= dmax)
        adopt_m = prior_mask_p & r_valid & r_depth_ok & (r_best > r_now)
        # unmasked pixels use the plain min-cost rule (PatchMatch.cu:969-977);
        # the reference does not update the selected views on this sub-path
        adopt_u = (~prior_mask_p) & best_valid & depth_ok & (
            best_cost < cost_now)
        plane_now = torch.where(adopt_m[..., None], r_plane,
                                torch.where(adopt_u[..., None], best_plane,
                                            plane_c))
        cost_now = torch.where(adopt_m, r_cost,
                               torch.where(adopt_u, best_cost, cost_now))
        sel_now = torch.where(adopt_m, temp_selected, sel_c)
        # without an adoption the refinement baseline stays 0: the reference
        # never seeds it with the current plane's score (PatchMatch.cu:922,
        # :964), so refinement then takes the best of its 5 trials
        restricted_now = torch.where(adopt_m, r_best,
                                     torch.zeros_like(r_best))
        if geom:
            geom_now = torch.where(
                adopt_m, _take(geom_totals, max_idx),
                torch.where(adopt_u, _take(geom_totals, min_idx), geom_now))
    else:
        adopt = best_valid & depth_ok & (best_cost < cost_now)
        plane_now = torch.where(adopt[..., None], best_plane, plane_c)
        cost_now = torch.where(adopt, best_cost, cost_now)
        sel_now = torch.where(adopt, temp_selected, sel_c)
        if geom:
            geom_now = torch.where(adopt, _take(geom_totals, min_idx),
                                   geom_now)

    # ---- 5. refinement: 5 perturbed hypotheses (PlaneHypothesisRefinement)
    depth_now = geo.depth_from_plane(data.K_ref, plane_now, x_p, y_p)
    shape_p = tuple(x_p.shape)
    if params.coherent_random:
        # smooth tile-banded draw; the knot seed comes from the *step* key so
        # every band of this half-iteration draws the same global field
        k_band_seed = tf.fold_in(key_step, 101)
        frac = (params.random_band_frac if (geom or prior)
                else params.effective_band_frac())
        draw_depth = lambda k: pmrand.smooth_banded_uniform(
            k_band_seed, k, x_p, y_p, dmin, dmax, frac)
    else:
        frac = 1.0
        draw_depth = lambda k: tf.uniform(k, shape_p, dmin, dmax)
    if prior and not params.legacy_prior_refinement:
        # the intended semantics: a prior-guided random draw inside the mask
        d_rand_u = draw_depth(k_ref1)
        d_rand_p = (tf.uniform(k_prior, shape_p) * 6.0 * depth_sigma
                    + prior_depth - 3.0 * depth_sigma)
        depth_rand = torch.where(prior_mask_p, d_rand_p, d_rand_u)
        n_rand_u = pmrand.random_normal_field(k_ref2, data.K_ref, x_p, y_p)
        n_rand_p = pmrand.perturbed_normal_field(
            k_prior, data.K_ref, x_p, y_p, prior_planes_p[..., :3],
            angle_sigma)
        normal_rand = torch.where(prior_mask_p[..., None], n_rand_p, n_rand_u)
    else:
        # the reference: the second block always runs (PatchMatch.cu:660)
        depth_rand = draw_depth(k_ref1)
        normal_rand = pmrand.random_normal_field(k_ref2, data.K_ref, x_p, y_p)

    p = params.refine_perturbation
    depth_pert = depth_now * (1.0 + (tf.uniform(k_ref3, shape_p) * 2.0 - 1.0)
                              * p)
    normal_pert = pmrand.perturbed_normal_field(
        k_ref4, data.K_ref, x_p, y_p, plane_now[..., :3], p * math.pi)
    normal_now = plane_now[..., :3]

    trial_d = [depth_rand, depth_now, depth_rand, depth_now, depth_pert]
    trial_n = [normal_now, normal_rand, normal_rand, normal_pert, normal_now]
    trial_planes = [geo.plane_from_depth_normal(data.K_ref, x_p, y_p, d, n)
                    for d, n in zip(trial_d, trial_n)]
    trials = torch.stack(trial_planes)  # (5, rows, Wh, 4)
    if params.sampler == "sorted":
        # the random-depth trials 0 and 2 project incoherently: through the
        # bucket-sorted path, the others in one K=3 call (the JAX package's
        # trial_scattered split, mpmvs_tpu propagation.py:623-637)
        coherent = ncc_batch(torch.stack([trial_planes[i]
                                          for i in (1, 3, 4)]))
        scattered = [ncc_eval_sorted(
            refside, data.src_imgs, data.src_widths, data.src_heights,
            data.A, data.b, data.K_ref, trial_planes[i], x_p, y_p, offsets,
            params.cost_max, cap) for i in (0, 2)]
        trial_costs = [scattered[0], coherent[0], scattered[1], coherent[1],
                       coherent[2]]
    else:
        # (5, S, rows, Wh). With full-range random depths (trials 0 and 2)
        # the view-major launch is the faster one, with banded ones the
        # tile launch (both measured on this call, PERF.md section 6)
        trial_costs = ncc_batch(trials, frac >= 1.0)
    trial_geom = gcost(trials) if geom else None  # (S, 5, rows, Wh)
    del trials

    for i, (d_i, n_i, plane_i, c_v) in enumerate(zip(
            trial_d, trial_n, trial_planes, trial_costs)):
        t_cost, t_geom = _weighted_total(c_v, weights, weight_norm,
                                         geom_of(trial_geom, i),
                                         params.geom_weight)
        d_before = geo.depth_from_plane(data.K_ref, plane_i, x_p, y_p)
        in_range = (d_before >= dmin) & (d_before <= dmax)
        if prior:
            score_i = _prior_score(t_cost, d_i, n_i, prior_planes_p,
                                   prior_depth, depth_sigma, angle_sigma,
                                   params.prior_gamma, params.prior_beta)
            adopt_m = prior_mask_p & in_range & (score_i > restricted_now)
            adopt_u = (~prior_mask_p) & in_range & (t_cost < cost_now)
            adopt_i = adopt_m | adopt_u
            restricted_now = torch.where(adopt_m, score_i, restricted_now)
        else:
            adopt_i = in_range & (t_cost < cost_now)
        plane_now = torch.where(adopt_i[..., None], plane_i, plane_now)
        cost_now = torch.where(adopt_i, t_cost, cost_now)
        if geom:
            geom_now = torch.where(adopt_i, t_geom, geom_now)

    return plane_now, cost_now, geom_now, sel_now


def _band_geometry(H: int, W: int, S: int, scale: int, geom: bool,
                   band_rows: int):
    """(halo, band height, band count, bottom padding) for a step."""
    halo = step_halo(scale)
    br = band_rows if band_rows > 0 else auto_band_rows(H, W, S, geom)
    br = min(br - (br % 2), H) or H
    n_bands = -(-H // br)
    return halo, br, n_bands, n_bands * br - H


def _pad_rows(a: Tensor, top: int, bottom: int, value=None) -> Tensor:
    """Pad the leading (row) axis: constant ``value``, or edge-replicate
    when ``value`` is None."""
    if top == 0 and bottom == 0:
        return a
    if value is None:
        parts = [a[:1].expand((top,) + a.shape[1:]), a,
                 a[-1:].expand((bottom,) + a.shape[1:])]
    else:
        parts = [torch.full((top,) + a.shape[1:], value, dtype=a.dtype,
                            device=a.device), a,
                 torch.full((bottom,) + a.shape[1:], value, dtype=a.dtype,
                            device=a.device)]
    return torch.cat(parts, 0)


def _pad_step_inputs(state: PatchMatchState, data: SolveData, halo: int,
                     pad_b: int, prior: bool = False) -> dict:
    """Halo/band padding of the state and the per-step constants: +inf cost
    beyond the image (an invalid propagation source), edge-replicated
    reference rows (CUDA clamp addressing); the geometric cost and the prior
    need the central rows only."""
    out = dict(
        cost_pad=_pad_rows(state.cost, halo, halo + pad_b, math.inf),
        plane_pad=_pad_rows(state.plane, halo, halo + pad_b, 0.0),
        sel_pad=_pad_rows(state.sel, halo, halo + pad_b, 0),
        ref_pad=_pad_rows(data.ref_img, halo, halo + pad_b),
        geom_pad=_pad_rows(state.geom_cost, 0, pad_b, 0.0),
    )
    if prior:
        out["prior_planes_pad"] = _pad_rows(data.prior_planes, 0, pad_b, 0.0)
        out["prior_mask_pad"] = _pad_rows(data.prior_mask, 0, pad_b, False)
    return out


def _band_call(pads: dict, data: SolveData, params, scale: int,
               iteration: int, phase: int, key_b: Tensor, key_step: Tensor,
               geom: bool, prior: bool, halo: int, br: int, y0: int,
               ncc_multi: NCCMulti):
    """One band's update from the padded buffers."""
    Hs = br + 2 * halo
    sl = lambda a, h: a[y0:y0 + h]
    return _band_step(data, params, scale, iteration, phase, key_b, key_step,
                      geom, prior, halo, br, y0, sl(pads["cost_pad"], Hs),
                      sl(pads["plane_pad"], Hs), sl(pads["sel_pad"], Hs),
                      sl(pads["ref_pad"], Hs), sl(pads["geom_pad"], br),
                      sl(pads["prior_planes_pad"], br) if prior else None,
                      sl(pads["prior_mask_pad"], br) if prior else None,
                      ncc_multi)


def _merge_bands(state: PatchMatchState, phase: int, geom: bool,
                 plane_p: Tensor, cost_p: Tensor, geom_p: Tensor,
                 sel_p: Tensor) -> PatchMatchState:
    """Scatter packed active-colour results back into the dense state; the
    geometric cost changes only in geom mode."""
    plane = torch.movedim(unpack_quincunx(
        torch.movedim(plane_p, -1, 0), phase,
        torch.movedim(state.plane, -1, 0)), 0, -1)
    return PatchMatchState(
        plane=plane.contiguous(),
        cost=unpack_quincunx(cost_p, phase, state.cost),
        geom_cost=(unpack_quincunx(geom_p, phase, state.geom_cost) if geom
                   else state.geom_cost),
        sel=unpack_quincunx(sel_p, phase, state.sel))


def checkerboard_step(state: PatchMatchState, data: SolveData, params,
                      scale: int, iteration: int, phase: int, key: Tensor,
                      geom: bool = False, prior: bool = False,
                      band_rows: int = 0,
                      ncc_multi: NCCMulti = ncc_eval_multi,
                      group=None) -> PatchMatchState:
    """One half-iteration (one checkerboard colour), banded over rows.

    ``band_rows`` is the band height (0 = automatic). H and W must be even
    (the solver pads). Band b draws with ``fold_in(key, b)``, as in the JAX
    package, so parity runs give both packages the same ``band_rows``.
    ``ncc_multi`` is the NCC implementation; the default follows the
    tensors' device (ops.ncc_cuda.ncc_eval_multi). ``geom`` needs
    ``data.src_depths``, ``prior`` ``data.prior_planes`` and
    ``data.prior_mask``. With a ``group`` (parallel.mesh.RankGroup) each
    rank computes its slot of the bands, which within one colour read only
    the other colour's state, and the band outputs are all-gathered before
    the merge: every rank returns the state a solve without a group
    returns, bit for bit (parallel.tile_sharding)."""
    if geom and data.src_depths is None:
        raise ValueError("geom mode needs data.src_depths")
    if prior and (data.prior_planes is None or data.prior_mask is None):
        raise ValueError("prior mode needs data.prior_planes and prior_mask")
    H, W = state.cost.shape
    if H % 2 or W % 2:
        raise ValueError(f"checkerboard_step needs even H and W, got {(H, W)}")
    S = data.src_imgs.shape[0]
    halo, br, n_bands, pad_b = _band_geometry(H, W, S, scale, geom, band_rows)
    pads = _pad_step_inputs(state, data, halo, pad_b, prior)

    Wh = W // 2
    spec = [((br, Wh, 4), state.plane.dtype), ((br, Wh), state.cost.dtype),
            ((br, Wh), state.geom_cost.dtype), ((br, Wh), state.sel.dtype)]
    outs = map_items(group, n_bands, lambda b: _band_call(
        pads, data, params, scale, iteration, phase, tf.fold_in(key, b), key,
        geom, prior, halo, br, b * br, ncc_multi), spec)
    plane_p, cost_p, geom_p, sel_p = (torch.cat(leaf)[:H]
                                      for leaf in zip(*outs))
    return _merge_bands(state, phase, geom, plane_p, cost_p, geom_p, sel_p)
