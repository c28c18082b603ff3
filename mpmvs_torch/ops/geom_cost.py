"""Geometric consistency cost: forward-backward reprojection error.

Counterpart of ``mpmvs_tpu.ops.geom_cost.geom_consistency_cost``
(ComputeGeomConsistencyCost, PatchMatch.cu:617-640): the plane's depth at
the reference pixel is forward-projected into a source view, the source's
estimated depth is fetched (truncating nearest, the reference's ``(int)``
texture fetch), back-projected, re-projected into the reference, and the
pixel error is clamped at ``max_cost``. A zero source depth, or an error
that is not finite, scores the full ``max_cost``.

The JAX package computes it with XLA gathers, not with a Pallas kernel.
:func:`geom_consistency_cost` sends CUDA tensors to the hand-written
kernel (``ops.geom_cost_cuda``, ``csrc/geom_cost.cu``), which raises on a
build or launch failure, and CPU tensors to the plain twin
:func:`geom_consistency_cost_plain`; any other device raises. The solver
looks the dispatcher up as ``propagation.geom_consistency_cost`` at every
call, so a caller that replaces that name (the bench's ``geom_cost_zero``
control, ``tools.solve_trace``'s profiler range) reaches every call. The
solver passes the kernel's camera table, built once a solve, as ``cams``;
the twin takes the same keyword and reads the cameras themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops import geom_cost_cuda
from mpmvs_torch.ops.sampling import nearest_sample_batched

Tensor = torch.Tensor


def geom_consistency_cost_plain(
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
    cams: Optional[Tensor] = None,  # the kernel's camera table: not read
) -> Tensor:
    """Returns (S, ...) clamped reprojection errors: eager PyTorch, the
    kernel's plain twin."""
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


def geom_consistency_cost(
    src_depths: Tensor, src_widths: Tensor, src_heights: Tensor,
    K_ref: Tensor, R_ref: Tensor, C_ref: Tensor, t_ref: Tensor,
    K_src: Tensor, R_src: Tensor, t_src: Tensor, C_src: Tensor,
    plane: Tensor, x: Tensor, y: Tensor, max_cost: float = 3.0,
    cams: Optional[Tensor] = None,
) -> Tensor:
    """(S, ...) clamped reprojection errors of the plane field (..., 4):
    the CUDA kernel for CUDA tensors, the plain twin for CPU tensors.
    ``cams``: the kernel's camera table of these cameras
    (``geom_cost_cuda.camera_table``), or None."""
    dev = plane.device.type
    if dev == "cuda":
        fn = geom_cost_cuda.geom_consistency_cost_kernel
    elif dev == "cpu":
        geom_cost_cuda.COUNTS.plain += 1
        fn = geom_consistency_cost_plain
    else:
        raise ValueError(f"no geometric-cost implementation for device "
                         f"{plane.device}")
    return fn(src_depths, src_widths, src_heights, K_ref, R_ref, C_ref, t_ref,
              K_src, R_src, t_src, C_src, plane, x, y, max_cost, cams)
