"""K-stacked bilateral-ZNCC evaluation: the CUDA kernel and its plain twin.

Counterpart of ``mpmvs_tpu.ops.pallas_ncc.ncc_eval_pallas_multi`` /
``ncc_eval_pallas``. :func:`ncc_eval_multi` scores K stacked plane fields
against S source views over a pixel set and returns (K, S, R, C):

  * CUDA tensors go to the hand-written kernel ``csrc/ncc_eval.cu``, built
    with ``nvcc`` for sm_90a at first use into ``mpmvs_torch/_build/`` and
    bound with ctypes. A build or launch failure raises; nothing falls back
    to the plain version.
  * CPU tensors go to :func:`ncc_eval_multi_plain`, which calls the plain
    ``ops.ncc.ncc_eval`` once per field.
  * Any other device raises.

``COUNTS`` records kernel launches and plain calls, so a run can show which
implementation its NCC evaluations went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops import nvcc
from mpmvs_torch.ops.ncc import NCCRefSide, ncc_eval

Tensor = torch.Tensor

SOURCE = "ncc_eval.cu"
# -fmad=false: the plain version's eager ops round every multiply and add
NVCC_FLAGS = ("-fmad=false",)
MAX_TAPS = 64


COUNTS = nvcc.LaunchCounts()


class _Taps(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("dx", ctypes.c_int * MAX_TAPS),
                ("dy", ctypes.c_int * MAX_TAPS)]


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(nvcc.build(SOURCE, NVCC_FLAGS))
    fn = lib.ncc_eval_multi_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [_Taps] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _taps(offsets) -> _Taps:
    if not 0 < len(offsets) <= MAX_TAPS:
        raise ValueError(f"{len(offsets)} taps; the kernel takes 1..{MAX_TAPS}")
    t = _Taps()
    t.n = len(offsets)
    for i, (dx, dy) in enumerate(offsets):
        t.dx[i] = int(dx)
        t.dy[i] = int(dy)
    return t


def _f32_contig(name: str, a: Tensor, shape, device) -> Tensor:
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    if a.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {a.dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                         f"{tuple(shape)}")
    return a.contiguous()


def ncc_eval_multi_kernel(refside: NCCRefSide, src_imgs: Tensor,
                          src_widths: Tensor, src_heights: Tensor, A: Tensor,
                          b: Tensor, K_ref: Tensor, planes: Tensor, x: Tensor,
                          y: Tensor, offsets: Sequence[Tuple[int, int]],
                          cost_max: float = 2.0,
                          cap_radius: float = 0.0) -> Tensor:
    """Launch ``csrc/ncc_eval.cu`` on CUDA tensors: (K, S, R, C) costs."""
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"the NCC kernel needs CUDA tensors, got {dev}")
    Kh, R, C, four = planes.shape
    if four != 4:
        raise ValueError(f"planes must be (K, R, C, 4), got {tuple(planes.shape)}")
    S, Hp, Wp = src_imgs.shape
    T = len(offsets)
    P = R * C
    planes = _f32_contig("planes", planes, (Kh, R, C, 4), dev)
    if planes.data_ptr() % 16:
        planes = planes.clone()
    w = _f32_contig("refside.w", refside.w, (T, R, C), dev)
    wr = _f32_contig("refside.wr", refside.wr, (T, R, C), dev)
    inv_w = _f32_contig("refside.inv_w", refside.inv_w, (R, C), dev)
    m_ref = _f32_contig("refside.m_ref", refside.m_ref, (R, C), dev)
    var_ref = _f32_contig("refside.var_ref", refside.var_ref, (R, C), dev)
    xc = _f32_contig("x", x, (R, C), dev)
    yc = _f32_contig("y", y, (R, C), dev)
    src = _f32_contig("src_imgs", src_imgs, (S, Hp, Wp), dev)
    wh = torch.stack([_f32_contig("src_widths", src_widths, (S,), dev),
                      _f32_contig("src_heights", src_heights, (S,), dev)],
                     1).contiguous()
    ab = torch.cat([_f32_contig("A", A, (S, 3, 3), dev).reshape(S, 9),
                    _f32_contig("b", b, (S, 3), dev)], 1).contiguous()
    kinvt = geo.K_inv_pinhole(
        _f32_contig("K_ref", K_ref, (3, 3), dev)).T.contiguous()
    out = torch.empty((Kh, S, R, C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library()(
        w.data_ptr(), wr.data_ptr(), inv_w.data_ptr(), m_ref.data_ptr(),
        var_ref.data_ptr(), planes.data_ptr(), xc.data_ptr(), yc.data_ptr(),
        src.data_ptr(), wh.data_ptr(), ab.data_ptr(), kinvt.data_ptr(),
        _taps(offsets), Kh, S, P, Hp, Wp, float(cost_max), float(cap_radius),
        out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ncc_eval_multi_kernel launch failed: CUDA error "
                           f"{err}")
    COUNTS.kernel += 1
    return out


def ncc_eval_multi_plain(refside: NCCRefSide, src_imgs: Tensor,
                         src_widths: Tensor, src_heights: Tensor, A: Tensor,
                         b: Tensor, K_ref: Tensor, planes: Tensor, x: Tensor,
                         y: Tensor, offsets: Sequence[Tuple[int, int]],
                         cost_max: float = 2.0,
                         cap_radius: float = 0.0) -> Tensor:
    """The plain version of the kernel: ``ops.ncc.ncc_eval`` per field."""
    COUNTS.plain += 1
    return torch.stack([
        ncc_eval(refside, src_imgs, src_widths, src_heights, A, b, K_ref,
                 planes[k], x, y, offsets, cost_max, cap_radius)
        for k in range(planes.shape[0])])


def ncc_eval_multi(refside: NCCRefSide, src_imgs: Tensor, src_widths: Tensor,
                   src_heights: Tensor, A: Tensor, b: Tensor, K_ref: Tensor,
                   planes: Tensor, x: Tensor, y: Tensor,
                   offsets: Sequence[Tuple[int, int]], cost_max: float = 2.0,
                   cap_radius: float = 0.0) -> Tensor:
    """Costs (K, S, R, C) of K stacked plane fields (K, R, C, 4): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = planes.device.type
    if dev == "cuda":
        fn = ncc_eval_multi_kernel
    elif dev == "cpu":
        fn = ncc_eval_multi_plain
    else:
        raise ValueError(f"no NCC implementation for device {planes.device}")
    return fn(refside, src_imgs, src_widths, src_heights, A, b, K_ref,
              planes, x, y, offsets, cost_max, cap_radius)


def ncc_eval_one(refside: NCCRefSide, src_imgs: Tensor, src_widths: Tensor,
                 src_heights: Tensor, A: Tensor, b: Tensor, K_ref: Tensor,
                 plane: Tensor, x: Tensor, y: Tensor,
                 offsets: Sequence[Tuple[int, int]], cost_max: float = 2.0,
                 cap_radius: float = 0.0) -> Tensor:
    """One plane field (R, C, 4) -> (S, R, C): the K = 1 case."""
    return ncc_eval_multi(refside, src_imgs, src_widths, src_heights, A, b,
                          K_ref, plane[None], x, y, offsets, cost_max,
                          cap_radius)[0]
