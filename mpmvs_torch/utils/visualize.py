"""Depth / normal / cost map visualization.

Capability port of the reference's JPEG dump helpers (utility.cpp:310-520):
JET-colormapped depth with optional 3%-tail histogram contrast stretch,
normal maps scaled to 255 with flipped Y, cost maps scaled 255/2.
"""

from __future__ import annotations

import numpy as np


def depth_to_jet(depth: np.ndarray, hist_enhance: bool = True) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) BGR uint8. Invalid (<= 0) pixels are black
    (SaveDmb, utility.cpp:389-463)."""
    import cv2
    depth = np.asarray(depth, np.float32).copy()
    mask = depth > 0.0
    depth[~mask] = 0.0
    if not mask.any():
        return np.zeros(depth.shape + (3,), np.uint8)
    dmin, dmax = float(depth[mask].min()), float(depth.max())
    if hist_enhance:
        norm = (depth - dmin) / (dmax - dmin + 1e-8)
        u = (norm * 255.0).astype(np.uint8)
        hist = np.bincount(u.ravel(), minlength=256).astype(np.float64)
        total = u.size
        # 3% tails (getMax10/getMin10, utility.cpp:351-371)
        cum_lo = np.cumsum(hist[1:])
        lo_idx = int(np.argmax(cum_lo / total > 0.03)) if (cum_lo / total > 0.03).any() else 0
        cum_hi = np.cumsum(hist[::-1][:-2])
        hi_rel = int(np.argmax(cum_hi / total > 0.03)) if (cum_hi / total > 0.03).any() else 0
        new_min = dmin + (dmax - dmin) * (lo_idx / 256.0)
        new_max = dmin + (dmax - dmin) * ((255 - hi_rel + 1) / 256.0)
        depth = np.clip(depth, new_min, new_max)
        dmin, dmax = new_min, new_max
    norm = (depth - dmin) / (dmax - dmin + 1e-8)
    u = np.clip(norm * 255.0, 0, 255).astype(np.uint8)
    color = cv2.applyColorMap(u, cv2.COLORMAP_JET)
    color[~mask] = 0
    return color


def normal_to_img(normal: np.ndarray) -> np.ndarray:
    """(H, W, 3) world normals -> BGR uint8, Y flipped
    (SaveNormal, utility.cpp:310-320)."""
    n = np.asarray(normal, np.float32) * 255.0
    n[..., 1] = -n[..., 1]
    return np.clip(n, 0, 255).astype(np.uint8)


def cost_to_img(cost: np.ndarray, cost_max: float = 2.0) -> np.ndarray:
    """(H, W) costs in [0, cost_max] -> grayscale uint8
    (SaveCost, utility.cpp:465-477)."""
    return np.clip(np.asarray(cost, np.float32) * 255.0 / cost_max,
                   0, 255).astype(np.uint8)
