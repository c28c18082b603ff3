"""Joint bilateral refinement of the sky probability: the CUDA kernel and its
plain twin.

Counterpart of ``mpmvs_tpu.ops.pallas_bilateral.bilateral_refine_pallas``:
a (2R+1)^2 window (R = 18 in the sky stage) smooths the probability map,
guided by the BGR image,

    w   = sw[dy, dx] * exp(-|BGR(p + d) - BGR(p)| / sigma_color),
    sw  = exp(-|d| / sigma_spatial)   (a per-tap table),
    out = sum w * prob(p + d) / max(sum w, 1e-12),

taps outside the image excluded. :func:`bilateral_refine` picks the
implementation by device:

  * CUDA tensors go to the hand-written kernel ``csrc/bilateral_refine.cu``,
    built with ``nvcc`` for sm_90a at first use and bound with ctypes. A
    build or launch failure raises; nothing falls back to the plain version.
    The kernel has two forms, picked once per call from the guide
    (:func:`guide_form`): ``table`` for a guide whose values are all
    integers in [0, 255] (every image read from a workspace), where the
    colour factor of the exact integer squared distance is looked up in
    :func:`colour_table` (built on the card by the same source's builder
    kernel, once per sigma_color and device); ``float`` for any other
    guide, which computes it per tap.
  * CPU tensors go to :func:`bilateral_refine_plain`, a loop over the taps
    that shifts and accumulates whole images.
  * Any other device raises.

``COUNTS`` records kernel launches by form and plain calls;
``TABLE_COUNTS`` the table builder and its plain twin
(:func:`colour_table_plain`). Both versions multiply by 1/sigma_color where
the TPU kernel divides (identical for the sky's sigma_color = 8) and sum the
taps in the same row-major (dy, dx) order.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from mpmvs_torch.ops import nvcc

Tensor = torch.Tensor

SOURCE = "bilateral_refine.cu"
NVCC_FLAGS = ()  # the kernel rounds every multiply and add with _rn intrinsics
MAX_RADIUS = 24  # the kernel's constant-memory table holds (2*24+1)^2 taps
RADIUS = 18
SIGMA_SPATIAL = 2.0 * 6.0 * 6.0
SIGMA_COLOR = 2.0 * 2.0 * 2.0
FORMS = ("float", "table")
TABLE_SIZE = 3 * 255 * 255 + 1  # squared BGR distances of 8-bit guides

COUNTS = nvcc.LaunchCounts()
TABLE_COUNTS = nvcc.LaunchCounts()


def spatial_weights(radius: int, sigma_spatial: float) -> np.ndarray:
    """(2R+1)^2 float32 weights exp(-|d| / sigma_spatial), row-major in
    (dy, dx): the table of pallas_bilateral.py:112-114."""
    offs = np.arange(-radius, radius + 1)
    dist = np.sqrt(offs[:, None] ** 2 + offs[None, :] ** 2)
    return np.exp(-dist / sigma_spatial).astype(np.float32).reshape(-1)


def _inv_sigma(sigma_color: float) -> float:
    return float(np.float32(1.0 / sigma_color))


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(nvcc.build(SOURCE, NVCC_FLAGS))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bilateral_refine_launch.argtypes = [vp, vp, i, i, i, vp, f, vp, vp,
                                            vp]
    lib.bilateral_refine_launch.restype = i
    lib.bilateral_table_launch.argtypes = [f, vp, vp]
    lib.bilateral_table_launch.restype = i
    if lib.bilateral_table_size() != TABLE_SIZE:
        raise RuntimeError("bilateral_refine.cu's table size is not "
                           f"{TABLE_SIZE}")
    return lib


def colour_table_plain(sigma_color: float = SIGMA_COLOR,
                       device="cpu") -> Tensor:
    """The plain version of the table builder: the plain filter's colour
    factor exp(-sqrt(d2) / sigma_color) of every integer squared distance
    d2 < TABLE_SIZE, (TABLE_SIZE,) float32."""
    TABLE_COUNTS.plain += 1
    d2 = torch.arange(TABLE_SIZE, dtype=torch.float32, device=device)
    return torch.exp(-torch.sqrt(d2) * _inv_sigma(sigma_color))


def colour_table_kernel(sigma_color: float, device) -> Tensor:
    """Launch the table builder of ``csrc/bilateral_refine.cu`` on a CUDA
    device: (TABLE_SIZE,) float32."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the table builder needs a CUDA device, got "
                         f"{device}")
    table = torch.empty(TABLE_SIZE, dtype=torch.float32, device=device)
    err = _library().bilateral_table_launch(
        _inv_sigma(sigma_color), table.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"colour_table_kernel launch failed: CUDA error "
                           f"{err}")
    TABLE_COUNTS.launched()
    return table


@functools.lru_cache(maxsize=None)
def colour_table(sigma_color: float, device: torch.device) -> Tensor:
    """The table form's colour-factor table on ``device`` (a CUDA device,
    with its index), built once per sigma_color and device."""
    return colour_table_kernel(sigma_color, device)


def guide_form(bgr: Tensor) -> str:
    """``"table"`` if every value of ``bgr`` is an integer in [0, 255] (one
    reduction on its device), else ``"float"``."""
    eight_bit = (bgr == torch.round(bgr)) & (bgr >= 0.0) & (bgr <= 255.0)
    return "table" if bool(eight_bit.all()) else "float"


def _check(bgr: Tensor, prob: Tensor, radius: int):
    if prob.ndim != 2 or tuple(bgr.shape) != tuple(prob.shape) + (3,):
        raise ValueError(f"bgr {tuple(bgr.shape)} and prob {tuple(prob.shape)}"
                         " must be (H, W, 3) and (H, W)")
    if bgr.dtype != torch.float32 or prob.dtype != torch.float32:
        raise TypeError(f"bgr and prob must be float32, got {bgr.dtype}, "
                        f"{prob.dtype}")
    if bgr.device != prob.device:
        raise ValueError(f"bgr is on {bgr.device}, prob on {prob.device}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius} outside 0..{MAX_RADIUS}")


def bilateral_refine_kernel(bgr: Tensor, prob: Tensor, radius: int = RADIUS,
                            sigma_spatial: float = SIGMA_SPATIAL,
                            sigma_color: float = SIGMA_COLOR) -> Tensor:
    """Launch ``csrc/bilateral_refine.cu`` on CUDA tensors in the form the
    guide implies (:func:`guide_form`): the refined probability (H, W)."""
    _check(bgr, prob, radius)
    dev = prob.device
    if dev.type != "cuda":
        raise ValueError(f"the bilateral kernel needs CUDA tensors, got {dev}")
    bgr = bgr.contiguous()
    return _launch(bgr, prob.contiguous(), radius, sigma_spatial,
                   sigma_color, guide_form(bgr))


def _launch(bgr: Tensor, prob: Tensor, radius: int, sigma_spatial: float,
            sigma_color: float, form: str) -> Tensor:
    """One launch of the kernel's ``form`` on checked, contiguous CUDA
    tensors. The table form is right only on an 8-bit guide; the tools call
    this to time the float form on one."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    dev = prob.device
    H, W = prob.shape
    table = (colour_table(float(sigma_color), dev).data_ptr()
             if form == "table" else None)
    sw = np.ascontiguousarray(spatial_weights(radius, sigma_spatial))
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().bilateral_refine_launch(
        bgr.data_ptr(), prob.data_ptr(), H, W, radius, sw.ctypes.data,
        _inv_sigma(sigma_color), table, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bilateral_refine_kernel launch failed: CUDA "
                           f"error {err}")
    COUNTS.launched(form)
    return out


def bilateral_refine_plain(bgr: Tensor, prob: Tensor, radius: int = RADIUS,
                           sigma_spatial: float = SIGMA_SPATIAL,
                           sigma_color: float = SIGMA_COLOR) -> Tensor:
    """The plain version of the kernel: one shift-and-accumulate pass over
    whole images per tap, in the kernel's order and rounding."""
    _check(bgr, prob, radius)
    COUNTS.plain += 1
    H, W = prob.shape
    R = radius
    sw = spatial_weights(radius, sigma_spatial)
    inv = _inv_sigma(sigma_color)
    planes = torch.cat([bgr.permute(2, 0, 1), prob[None]], 0)  # (4, H, W)
    padded = F.pad(planes, (R, R, R, R))
    inside = F.pad(torch.ones((1, H, W), device=prob.device),
                   (R, R, R, R))[0] > 0
    cb, cg, cr = planes[0], planes[1], planes[2]
    zero = torch.zeros((), device=prob.device)
    num = torch.zeros((H, W), device=prob.device)
    den = torch.zeros((H, W), device=prob.device)
    tap = 0
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            s = padded[:, R + dy:R + dy + H, R + dx:R + dx + W]
            db, dg, dr = s[0] - cb, s[1] - cg, s[2] - cr
            dc = torch.sqrt(db * db + dg * dg + dr * dr)
            w = float(sw[tap]) * torch.exp(-dc * inv)
            w = torch.where(inside[R + dy:R + dy + H, R + dx:R + dx + W], w,
                            zero)
            num = num + w * s[3]
            den = den + w
            tap += 1
    return num / torch.clamp(den, min=1e-12)


def bilateral_refine(bgr: Tensor, prob: Tensor, radius: int = RADIUS,
                     sigma_spatial: float = SIGMA_SPATIAL,
                     sigma_color: float = SIGMA_COLOR) -> Tensor:
    """Refined probability (H, W) of ``prob`` (H, W) guided by ``bgr``
    (H, W, 3), float32: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    dev = prob.device.type
    if dev == "cuda":
        fn = bilateral_refine_kernel
    elif dev == "cpu":
        fn = bilateral_refine_plain
    else:
        raise ValueError(f"no bilateral implementation for device "
                         f"{prob.device}")
    return fn(bgr, prob, radius, sigma_spatial, sigma_color)
