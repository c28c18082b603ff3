"""Bilinear resizes at OpenCV's sample positions, in torch on any device.

``resize_u8`` is ``cv2.resize(..., INTER_LINEAR)`` of a uint8 image, bit for
bit (tests/test_torch_sky.py, tests/test_torch_images.py): the sky net's
input and the pipeline's reads of images above ``max_image_size`` use it.
``resize_f32`` resizes a float map at the same positions in float32 (the
sky probability's upsample).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _sample_positions(n_in: int, n_out: int, clamp: bool):
    """OpenCV's linear-resize taps along one axis: source indices (i0, i1)
    and float32 weights (1 - f, f), from f = (float)((d + 0.5) * scale -
    0.5). Columns clamp the fraction at the borders; rows keep it and clip
    the indices (resizeGeneric_)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        lo = i0 < 0
        f[lo], i0[lo] = 0.0, 0
        hi = i0 >= n_in - 1
        f[hi], i0[hi] = 0.0, n_in - 1
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return np.clip(i0, 0, n_in - 1), i1, (np.float32(1.0) - f), f


def _taps(n_in: int, n_out: int, clamp: bool, device, fixed: bool):
    i0, i1, w0, w1 = _sample_positions(n_in, n_out, clamp)
    if fixed:  # saturate_cast<short>(w * 2048): round half to even
        w0 = np.rint(w0 * np.float32(2048.0)).astype(np.int64)
        w1 = np.rint(w1 * np.float32(2048.0)).astype(np.int64)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(i0), t(i1), t(w0), t(w1)


def resize_u8(img: Tensor, out_h: int, out_w: int) -> Tensor:
    """``cv2.resize(..., INTER_LINEAR)`` of a uint8-valued (H, W, C) tensor:
    11-bit weights per axis, the row pass in integers, the column pass
    rounded as OpenCV's vector path (VResizeLinearVec_32s8u)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _taps(w, out_w, True, img.device, True)
    y0, y1, b0, b1 = _taps(h, out_h, False, img.device, True)
    s = img.to(torch.int64)
    rows = s[:, x0] * a0[None, :, None] + s[:, x1] * a1[None, :, None]
    top = ((rows[y0] >> 4) * b0[:, None, None]) >> 16
    bot = ((rows[y1] >> 4) * b1[:, None, None]) >> 16
    return ((top + bot + 2) >> 2).clamp(0, 255).to(torch.float32)


def resize_f32(img: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bilinear resize of an (H, W) float32 map at OpenCV's sample
    positions, in float32."""
    h, w = img.shape
    x0, x1, a0, a1 = _taps(w, out_w, True, img.device, False)
    y0, y1, b0, b1 = _taps(h, out_h, False, img.device, False)
    rows = img[:, x0] * a0 + img[:, x1] * a1
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]
