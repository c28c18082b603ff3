"""Image sampling primitives (plain PyTorch).

Counterpart of ``mpmvs_tpu.ops.sampling``. Coordinates follow the CUDA
convention of the reference: ``tex2D`` at ``(px + 0.5, py + 0.5)`` with
linear filtering is plain bilinear interpolation in pixel-index space, with
clamp-to-edge addressing (PatchMatch.cu:363-377). The interpolation is an
f32 lerp on point loads, never the texture unit's 8-bit-weight filter.

Float -> int conversion of a coordinate is defined for every input: the
floor is clamped to ``[-1, lim + 1]`` (NaN -> 0) before the conversion, so
out-of-range and non-finite coordinates pick the same texel on the CPU, in
the CUDA kernel (csrc/ncc_eval.cu) and in the JAX package for every finite
coordinate. A non-finite coordinate gives a NaN fraction, hence a NaN
sample, whichever texel is read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _floor_index(f: Tensor, lim: Tensor):
    """Integer floor index and its right neighbour, both clipped to
    [0, lim], from a floored float coordinate ``f``."""
    fc = torch.nan_to_num(torch.clamp(f, min=-1.0), nan=0.0)
    fc = torch.minimum(fc, (lim + 1).to(f.dtype))
    i0 = fc.to(torch.int64)
    return (torch.minimum(torch.clamp(i0, min=0), lim),
            torch.minimum(torch.clamp(i0 + 1, min=0), lim))


def gather_2d(img: Tensor, iy: Tensor, ix: Tensor) -> Tensor:
    """img (H, W), integer index tensors of any shape -> values. Indices must
    already be in range."""
    H, W = img.shape
    return img.reshape(-1)[iy * W + ix]


def gather_2d_batched(imgs: Tensor, view: Tensor, iy: Tensor,
                      ix: Tensor) -> Tensor:
    """imgs (V, H, W); per-element view/iy/ix indices of a common shape."""
    V, H, W = imgs.shape
    return imgs.reshape(-1)[(view * H + iy) * W + ix]


def bilinear_sample(img: Tensor, x: Tensor, y: Tensor, width=None,
                    height=None) -> Tensor:
    """Bilinear sample img (H, W) at float pixel coords, clamp addressing.
    ``width``/``height`` optionally give the *valid* extent."""
    H, W = img.shape
    w_lim = torch.as_tensor((width if width is not None else W) - 1,
                            device=img.device).to(torch.int64)
    h_lim = torch.as_tensor((height if height is not None else H) - 1,
                            device=img.device).to(torch.int64)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0, x1 = _floor_index(x0f, w_lim)
    y0, y1 = _floor_index(y0f, h_lim)
    v00 = gather_2d(img, y0, x0)
    v01 = gather_2d(img, y0, x1)
    v10 = gather_2d(img, y1, x0)
    v11 = gather_2d(img, y1, x1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def bilinear_sample_batched(imgs: Tensor, view: Tensor, x: Tensor, y: Tensor,
                            widths: Tensor, heights: Tensor) -> Tensor:
    """Bilinear sample from stacked per-view images (mpmvs_tpu
    sampling.py:64-88). imgs (V, H, W), padded to a common shape; ``view``
    the integer view index per element; widths/heights (V,) valid extents,
    used for clamping (never beyond the stored extent). view/x/y broadcast
    to a common shape."""
    w_lim = torch.clamp(widths.to(torch.int64), max=imgs.shape[2])[view] - 1
    h_lim = torch.clamp(heights.to(torch.int64), max=imgs.shape[1])[view] - 1
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0, x1 = _floor_index(x0f, w_lim)
    y0, y1 = _floor_index(y0f, h_lim)
    v00 = gather_2d_batched(imgs, view, y0, x0)
    v01 = gather_2d_batched(imgs, view, y0, x1)
    v10 = gather_2d_batched(imgs, view, y1, x0)
    v11 = gather_2d_batched(imgs, view, y1, x1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def nearest_sample_batched(imgs: Tensor, view: Tensor, x: Tensor, y: Tensor,
                           widths: Tensor, heights: Tensor) -> Tensor:
    """Truncating nearest sample, the reference's geometric-consistency
    depth fetch ``tex2D(depth, (int)x + 0.5, (int)y + 0.5)``
    (PatchMatch.cu:626): truncation toward zero, then clamp."""
    w_lim = torch.clamp(widths.to(torch.int64), max=imgs.shape[2])[view] - 1
    h_lim = torch.clamp(heights.to(torch.int64), max=imgs.shape[1])[view] - 1
    xt = torch.nan_to_num(torch.clamp(torch.trunc(x), min=-1.0), nan=0.0)
    yt = torch.nan_to_num(torch.clamp(torch.trunc(y), min=-1.0), nan=0.0)
    ix = torch.minimum(torch.clamp(torch.minimum(
        xt, (w_lim + 1).to(x.dtype)).to(torch.int64), min=0), w_lim)
    iy = torch.minimum(torch.clamp(torch.minimum(
        yt, (h_lim + 1).to(y.dtype)).to(torch.int64), min=0), h_lim)
    return gather_2d_batched(imgs, view, iy, ix)


def shift_2d(img: Tensor, dx: int, dy: int, fill=None) -> Tensor:
    """Return a tensor whose value at (y, x) is img[y+dy, x+dx] over the last
    two axes. ``fill=None`` clamps to the border (texture clamp semantics);
    otherwise out-of-range positions take the fill value."""
    H, W = img.shape[-2], img.shape[-1]
    if fill is None:
        iy = torch.clamp(torch.arange(H, device=img.device) + dy, 0, H - 1)
        ix = torch.clamp(torch.arange(W, device=img.device) + dx, 0, W - 1)
        return img.index_select(-2, iy).index_select(-1, ix)
    pad_top, pad_bottom = max(-dy, 0), max(dy, 0)
    pad_left, pad_right = max(-dx, 0), max(dx, 0)
    padded = F.pad(img, (pad_left, pad_right, pad_top, pad_bottom),
                   mode="constant", value=fill)
    ys = pad_top + dy
    xs = pad_left + dx
    return padded[..., ys:ys + H, xs:xs + W]
