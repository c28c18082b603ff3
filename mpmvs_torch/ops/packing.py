"""Checkerboard (quincunx) packing.

Counterpart of ``mpmvs_tpu.ops.packing``: the active checkerboard colour's
pixels are packed into a dense (H, W//2) array (row y keeps columns x with
(x + y) % 2 == phase), all per-pixel math runs on the packed array, and the
result is scattered back — the reference's half-height grid
(BlackPixelUpdate/RedPixelUpdate, src/PatchMatch.cu:1000-1019). Requires
even H and W (the solver pads to even and crops).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def pack_quincunx(F: Tensor, phase: int) -> Tensor:
    """(…, H, W) -> (…, H, W//2): keep pixels with (x + y) % 2 == phase."""
    H, W = F.shape[-2], F.shape[-1]
    if H % 2 or W % 2:
        raise ValueError(f"pack_quincunx needs even H and W, got {(H, W)}")
    even = F[..., 0::2, phase::2]
    odd = F[..., 1::2, (1 - phase)::2]
    stacked = torch.stack([even, odd], -2)  # (…, H/2, 2, W/2)
    return stacked.reshape(*F.shape[:-2], H, W // 2)


def _col_interleave(A: Tensor, B: Tensor, a_first: bool) -> Tensor:
    """Interleave columns of two (…, H, W/2) tensors into (…, H, W)."""
    pair = torch.stack([A, B] if a_first else [B, A], -1)
    return pair.reshape(*A.shape[:-1], A.shape[-1] * 2)


def unpack_quincunx(P: Tensor, phase: int, like: Tensor) -> Tensor:
    """Scatter packed values P (…, H, W//2) back onto the ``phase`` colour of
    a full tensor; the other colour keeps ``like``'s values."""
    H, W = like.shape[-2], like.shape[-1]
    if H % 2 or W % 2:
        raise ValueError(f"unpack_quincunx needs even H and W, got {(H, W)}")
    P_even, P_odd = P[..., 0::2, :], P[..., 1::2, :]
    L_even = like[..., 0::2, (1 - phase)::2]
    L_odd = like[..., 1::2, phase::2]
    even_rows = _col_interleave(P_even, L_even, a_first=(phase == 0))
    odd_rows = _col_interleave(P_odd, L_odd, a_first=(phase == 1))
    stacked = torch.stack([even_rows, odd_rows], -2)  # (…, H/2, 2, W)
    return stacked.reshape(like.shape)


def packed_coords(y0: int, H: int, Wh: int, phase: int, device=None):
    """Global pixel coordinates of the packed grid. ``y0``: global row of
    packed row 0 (even, so local parity equals global parity). Returns
    float32 (x (H, Wh), y (H, Wh))."""
    r = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    k = torch.arange(Wh, dtype=torch.float32, device=device)[None, :]
    parity = torch.remainder(r + phase, 2.0)
    x = 2.0 * k + parity
    y = (r + float(y0)).expand(H, Wh)
    return x.contiguous(), y.contiguous()
