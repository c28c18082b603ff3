"""Geometric consistency cost: forward-backward reprojection error.

Counterpart of ``mpmvs_tpu.ops.geom_cost.geom_consistency_cost``
(ComputeGeomConsistencyCost, PatchMatch.cu:617-640): the plane's depth at
the reference pixel is forward-projected into a source view, the source's
estimated depth is fetched (truncating nearest, the reference's ``(int)``
texture fetch), back-projected, re-projected into the reference, and the
pixel error is clamped at ``max_cost``. A zero source depth, or an error
that is not finite, scores the full ``max_cost``.

Plain PyTorch: the JAX package computes it with XLA gathers, not with a
Pallas kernel. Its Hopper kernel is ROADMAP queue 2 item 5.
"""

from __future__ import annotations

import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops.sampling import nearest_sample_batched

Tensor = torch.Tensor


def geom_consistency_cost(
    src_depths: Tensor,   # (S, Hs, Ws) source-view depth maps
    src_widths: Tensor,   # (S,)
    src_heights: Tensor,  # (S,)
    K_ref: Tensor, R_ref: Tensor, C_ref: Tensor, t_ref: Tensor,
    K_src: Tensor,        # (S, 3, 3)
    R_src: Tensor,        # (S, 3, 3)
    t_src: Tensor,        # (S, 3)
    C_src: Tensor,        # (S, 3)
    plane: Tensor,        # (..., 4) hypotheses at the pixels (x, y)
    x: Tensor, y: Tensor,  # (...) pixel coordinates
    max_cost: float = 3.0,
) -> Tensor:
    """Returns (S, ...) clamped reprojection errors."""
    S = src_depths.shape[0]
    nd = plane.ndim - 1
    per_view = lambda a: a.reshape((S,) + (1,) * nd + a.shape[1:])
    depth = geo.depth_from_plane(K_ref, plane, x, y)
    Xw = geo.backproject_world(K_ref, R_ref, C_ref, x, y, depth)  # (..., 3)
    src_pt, _ = geo.project_camera(per_view(K_src), per_view(R_src),
                                   per_view(t_src), Xw[None])     # (S, ..., 2)
    view = torch.arange(S, device=x.device).reshape((S,) + (1,) * nd)
    src_depth = nearest_sample_batched(src_depths, view, src_pt[..., 0],
                                       src_pt[..., 1], src_widths,
                                       src_heights)               # (S, ...)
    Xs = geo.backproject_world(per_view(K_src), per_view(R_src),
                               per_view(C_src), src_pt[..., 0],
                               src_pt[..., 1], src_depth)
    back_pt, _ = geo.project_camera(K_ref, R_ref, t_ref, Xs)
    err = torch.sqrt((x[None] - back_pt[..., 0]) ** 2
                     + (y[None] - back_pt[..., 1]) ** 2)
    cap = torch.full_like(err, max_cost)
    err = torch.where(torch.isfinite(err), err, cap)
    return torch.where(src_depth == 0.0, cap, torch.minimum(err, cap))
