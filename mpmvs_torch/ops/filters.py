"""Checkerboard star-shaped median depth filter.

Counterpart of ``mpmvs_tpu.ops.filters`` (CheckerboardFilter,
src/PatchMatch.cu:1036-1174): each pixel's depth becomes the median of up to
21 star-neighbourhood depths (border-dependent subset), skipping pixels whose
cost is < 0.001; black first, then red reads black's filtered values
(PatchMatch.cu:1241-1243). Invalid taps are pushed to +inf, one sort of the
21-vector per pixel gives the median at the per-pixel valid count.
"""

from __future__ import annotations

import torch

from mpmvs_torch.ops.sampling import shift_2d

Tensor = torch.Tensor

# (dx, dy) and the border condition under which the reference includes the
# tap (PatchMatch.cu:1071-1141): include iff x >= min_x, x < W - max_x_off,
# y >= min_y, y < H - max_y_off.
_TAPS = (
    ((0, 0),   (0, 0, 0, 0)),
    ((0, -1),  (0, 0, 1, 0)),
    ((0, -3),  (0, 0, 3, 0)),
    ((0, -5),  (0, 0, 5, 0)),
    ((0, 1),   (0, 0, 0, 1)),
    ((0, 3),   (0, 0, 0, 3)),
    ((0, 5),   (0, 0, 0, 5)),
    ((-1, 0),  (1, 0, 0, 0)),
    ((-3, 0),  (3, 0, 0, 0)),
    ((-5, 0),  (5, 0, 0, 0)),
    ((1, 0),   (0, 1, 0, 0)),
    ((3, 0),   (0, 3, 0, 0)),
    ((5, 0),   (0, 5, 0, 0)),
    ((2, -1),  (0, 2, 1, 0)),
    ((2, 1),   (0, 2, 0, 1)),
    ((-2, -1), (2, 0, 1, 0)),
    ((-2, 1),  (2, 0, 0, 1)),
    ((-1, -2), (1, 0, 3, 0)),
    ((1, -2),  (0, 1, 3, 0)),
    ((-1, 2),  (1, 0, 0, 2)),
    ((1, 2),   (0, 1, 0, 2)),
)


def _filter_once(depth: Tensor, cost: Tensor, phase: int) -> Tensor:
    H, W = depth.shape
    yy = torch.arange(H, device=depth.device)[:, None]
    xx = torch.arange(W, device=depth.device)[None, :]
    inf = torch.full_like(depth, float("inf"))

    taps, valids = [], []
    for (dx, dy), (min_x, max_x, min_y, max_y) in _TAPS:
        valid = ((xx >= min_x) & (xx < W - max_x)
                 & (yy >= min_y) & (yy < H - max_y))
        taps.append(torch.where(valid, shift_2d(depth, dx, dy), inf))
        valids.append(valid.expand(H, W))
    stack = torch.stack(taps, -1)                  # (H, W, 21)
    count = torch.sum(torch.stack(valids, -1), -1)  # (H, W)
    s = torch.sort(stack, -1).values
    mid = count // 2
    take = lambda idx: torch.gather(s, -1, idx[..., None])[..., 0]
    med_odd = take(mid)
    med_even = 0.5 * (take(torch.clamp(mid - 1, min=0)) + take(mid))
    median = torch.where(count % 2 == 0, med_even, med_odd)

    active = ((xx + yy) % 2) == phase
    keep = cost < 0.001  # low-cost pixels are left untouched (PatchMatch.cu:1067)
    return torch.where(active & ~keep, median, depth)


def checkerboard_median_filter(depth: Tensor, cost: Tensor) -> Tensor:
    """Two-phase (black then red) star median filter of the depth map."""
    depth = _filter_once(depth, cost, phase=0)
    depth = _filter_once(depth, cost, phase=1)
    return depth
