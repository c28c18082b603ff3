"""Multi-scale-window bilateral-weighted ZNCC matching cost (plain PyTorch).

Counterpart of ``mpmvs_tpu.ops.ncc`` (ComputeBilateralNCC,
src/PatchMatch.cu:325-458):

  * :func:`ncc_refside` precomputes the reference side of the window —
    bilateral weights, weighted moments, variance — once per pixel set; every
    hypothesis evaluation reuses it.
  * :func:`ncc_eval` scores one plane field against every source view. It is
    the plain version of the CUDA kernel in ``csrc/ncc_eval.cu`` (reached
    through ``ops.ncc_cuda.ncc_eval_multi``); the kernel repeats its
    operations one for one.

Window schedule ("multi-scale windows"): tap stride 2*2^scale, radius
5*2^scale, always 36 taps (PatchMatch.cu:341-346).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops.packing import pack_quincunx
from mpmvs_torch.ops.sampling import bilinear_sample_batched, shift_2d

Tensor = torch.Tensor

K_MIN_VAR = 1e-5  # degenerate-variance threshold (PatchMatch.cu:406)


def spatial_weights(offsets: Sequence[Tuple[int, int]], sigma_spatial: float):
    """Static spatial bilateral factor exp(-sqrt(dx^2+dy^2) / (2 sigma_s^2))
    per tap (ComputeBilateralWeight, PatchMatch.cu:318-323: the reference
    divides the *distance*, not its square, by 2 sigma^2)."""
    return [math.exp(-math.sqrt(dx * dx + dy * dy)
                     / (2.0 * sigma_spatial * sigma_spatial))
            for (dx, dy) in offsets]


class NCCRefSide(NamedTuple):
    """Per-pixel-set reference-window precompute."""

    w: Tensor        # (T, …) bilateral weight per tap
    wr: Tensor       # (T, …) weight * ref tap value
    inv_w: Tensor    # (…,) 1 / sum_k w_k
    m_ref: Tensor    # (…,) weighted ref mean
    var_ref: Tensor  # (…,) weighted ref variance


def ncc_refside(ref_slice: Tensor, halo: int, out_rows: int,
                offsets: Sequence[Tuple[int, int]], sigma_spatial: float,
                sigma_color: float,
                pack_phase: Optional[int] = None) -> NCCRefSide:
    """Reference side of the bilateral ZNCC window. ``ref_slice`` (Hs, W)
    holds ``halo`` extra rows above and below the ``out_rows`` output rows
    (edge-replicated at image borders); horizontal taps clamp inside. With
    ``pack_phase`` set, outputs are quincunx-packed to (out_rows, W//2)."""
    crop = lambda a: a[..., halo:halo + out_rows, :]
    if pack_phase is None:
        prep = crop
    else:
        prep = lambda a: pack_quincunx(crop(a), pack_phase)

    center = prep(ref_slice)
    inv_2sc2 = 1.0 / (2.0 * sigma_color * sigma_color)
    sw = spatial_weights(offsets, sigma_spatial)

    ws, wrs = [], []
    sum_w = torch.zeros_like(center)
    sum_ref = torch.zeros_like(center)
    sum_ref2 = torch.zeros_like(center)
    for k, (dx, dy) in enumerate(offsets):
        tap = prep(shift_2d(ref_slice, dx, dy))
        w = sw[k] * torch.exp(-torch.abs(tap - center) * inv_2sc2)
        wr = w * tap
        ws.append(w)
        wrs.append(wr)
        sum_w = sum_w + w
        sum_ref = sum_ref + wr
        sum_ref2 = sum_ref2 + wr * tap

    inv_w = 1.0 / sum_w
    m_ref = sum_ref * inv_w
    var_ref = sum_ref2 * inv_w - m_ref * m_ref
    return NCCRefSide(w=torch.stack(ws), wr=torch.stack(wrs), inv_w=inv_w,
                      m_ref=m_ref, var_ref=var_ref)


def _finite_or_zero(v: Tensor) -> Tensor:
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def ncc_eval(refside: NCCRefSide, src_imgs: Tensor, src_widths: Tensor,
             src_heights: Tensor, A: Tensor, b: Tensor, K_ref: Tensor,
             plane: Tensor, x: Tensor, y: Tensor,
             offsets: Sequence[Tuple[int, int]], cost_max: float = 2.0,
             cap_radius: float = 0.0) -> Tensor:
    """Bilateral ZNCC cost of ``plane`` (…, 4) against every source view at
    the pixel set (x, y): (S, …) costs in [0, cost_max]. Off-image centre
    projections and degenerate-variance windows cost ``cost_max``
    (PatchMatch.cu:350-353, 406-408). ``cap_radius`` > 0 turns on the JAX
    package's footprint cap: a hypothesis whose projected window leaves a
    ±cap_radius box around its centre projection costs ``cost_max``."""
    S = src_imgs.shape[0]
    view_bshape = (S,) + (1,) * x.ndim

    pt, col_x, col_y, h_p = geo.homography_apply(
        A.reshape(view_bshape + (3, 3)), b.reshape(view_bshape + (3,)),
        K_ref, plane[None], x, y)

    W_v = src_widths.reshape(view_bshape)
    H_v = src_heights.reshape(view_bshape)
    oob = ((pt[..., 0] < 0.0) | (pt[..., 0] >= W_v)
           | (pt[..., 1] < 0.0) | (pt[..., 1] >= H_v)
           | ~torch.isfinite(pt[..., 0]) | ~torch.isfinite(pt[..., 1]))

    cap = cap_radius > 0.0
    if cap:
        inv_zc = 1.0 / h_p[..., 2]
        ccx = _finite_or_zero(h_p[..., 0] * inv_zc)
        ccy = _finite_or_zero(h_p[..., 1] * inv_zc)
        bx_lo, bx_hi = ccx - cap_radius, ccx + cap_radius
        by_lo, by_hi = ccy - cap_radius, ccy + cap_radius
        capped = torch.zeros_like(oob)

    view_idx = torch.arange(S, device=x.device).reshape(view_bshape)
    sum_src = torch.zeros((S,) + tuple(x.shape), dtype=refside.m_ref.dtype,
                          device=x.device)
    sum_src2 = torch.zeros_like(sum_src)
    sum_rs = torch.zeros_like(sum_src)
    for k, (dx, dy) in enumerate(offsets):
        h = h_p + dx * col_x + dy * col_y
        inv_z = 1.0 / h[..., 2]
        xs = h[..., 0] * inv_z
        ys = h[..., 1] * inv_z
        if cap:
            xf = _finite_or_zero(xs)
            yf = _finite_or_zero(ys)
            capped = (capped | (xf < bx_lo) | (xf > bx_hi)
                      | (yf < by_lo) | (yf > by_hi))
        src_tap = bilinear_sample_batched(src_imgs, view_idx, xs, ys,
                                          src_widths, src_heights)
        ws = refside.w[k][None] * src_tap
        sum_src = sum_src + ws
        sum_src2 = sum_src2 + ws * src_tap
        sum_rs = sum_rs + refside.wr[k][None] * src_tap

    return zncc_from_sums(refside, sum_src, sum_src2, sum_rs,
                          (oob | capped) if cap else oob, cost_max)


def zncc_from_sums(refside: NCCRefSide, sum_src: Tensor, sum_src2: Tensor,
                   sum_rs: Tensor, bad: Tensor, cost_max: float) -> Tensor:
    """ZNCC cost from the weighted source sums sum_t w s, sum_t w s^2 and
    sum_t wr s (any leading axes before the refside's pixel axes): cost_max
    where ``bad`` or either variance is degenerate (PatchMatch.cu:406-408),
    else clip(1 - cov / sqrt(var_ref var_src), 0, cost_max)."""
    m_src = sum_src * refside.inv_w
    var_src = sum_src2 * refside.inv_w - m_src * m_src
    covar = sum_rs * refside.inv_w - refside.m_ref * m_src
    degenerate = (refside.var_ref < K_MIN_VAR) | (var_src < K_MIN_VAR)
    denom = torch.sqrt(torch.clamp(refside.var_ref * var_src, min=1e-30))
    ncc = torch.clamp(1.0 - covar / denom, 0.0, cost_max)
    return torch.where(bad | degenerate, torch.full_like(ncc, cost_max), ncc)
