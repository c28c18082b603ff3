"""The geometric-consistency cost on the card: the wrapper of
``csrc/geom_cost.cu``.

``ops.geom_cost.geom_consistency_cost`` sends CUDA tensors here and CPU
tensors to its plain twin, ``ops.geom_cost.geom_consistency_cost_plain``.
:func:`geom_consistency_cost_kernel` takes the twin's arguments and returns
the same (S, ...) float32 tensor: the kernel is built with ``nvcc`` for
sm_90a at first use into ``mpmvs_torch/_build/`` and bound with ctypes; one
launch scores a plane field of any leading shape (the K-stacked
``(K, rows, W/2, 4)`` included) against every source. A build or launch
failure raises; nothing falls back to the plain twin.

The kernel's camera table (:func:`camera_table`) is built once a solve,
with the solve's ``SolveData`` (``geom_cams``), and passed as ``cams``; a
call without it builds its own. :func:`wide_index` picks the kernel's
flat-index width from the depth stack's size.

``COUNTS`` records kernel launches, and the dispatcher's plain calls, so a
run can show which implementation its geometric costs went through.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from mpmvs_torch.ops import nvcc
from mpmvs_torch.ops.ncc_cuda import _f32_contig

Tensor = torch.Tensor

SOURCE = "geom_cost.cu"
# -fmad=false: the plain twin's eager ops round every multiply and add
NVCC_FLAGS = ("-fmad=false",)
INDEX32_ENTRIES = 2 ** 31  # stacks below this take 32-bit flat indices

COUNTS = nvcc.LaunchCounts()


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(nvcc.build(SOURCE, NVCC_FLAGS))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.geom_cost_launch.argtypes = (
        [vp] * 5 + [i] * 5 + [ctypes.c_float, i, vp, vp])
    lib.geom_cost_launch.restype = i
    lib.geom_cost_attributes.argtypes = [i, i, vp, vp, vp]
    lib.geom_cost_attributes.restype = i
    lib.geom_cost_max_sources.restype = i
    lib.max_sources = lib.geom_cost_max_sources()
    return lib


def camera_table(S: int, K_ref: Tensor, R_ref: Tensor, C_ref: Tensor,
                 t_ref: Tensor, K_src: Tensor, R_src: Tensor, t_src: Tensor,
                 C_src: Tensor, src_widths: Tensor,
                 src_heights: Tensor) -> Tensor:
    """The kernel's camera table of S sources, 24 + 26 S floats: the
    reference's K, R, t and C, then per source K, R, t, C, width and
    height."""
    f32 = lambda name, a, shape: _f32_contig(name, a, shape, K_ref.device)
    ref = [f32("K_ref", K_ref, (3, 3)).reshape(9),
           f32("R_ref", R_ref, (3, 3)).reshape(9), f32("t_ref", t_ref, (3,)),
           f32("C_ref", C_ref, (3,))]
    src = [f32("K_src", K_src, (S, 3, 3)).reshape(S, 9),
           f32("R_src", R_src, (S, 3, 3)).reshape(S, 9),
           f32("t_src", t_src, (S, 3)), f32("C_src", C_src, (S, 3)),
           f32("src_widths", src_widths, (S,))[:, None],
           f32("src_heights", src_heights, (S,))[:, None]]
    return torch.cat(ref + [torch.cat(src, 1).reshape(-1)])


def wide_index(S: int, Hs: int, Ws: int) -> bool:
    """Whether a (S, Hs, Ws) depth stack needs the kernel's 64-bit flat
    indices: 2^31 entries or more. Below, 32-bit indices are exact."""
    return S * Hs * Ws >= INDEX32_ENTRIES


def kernel_attributes(K: int, wide: bool = False) -> dict:
    """The fields a thread holds, registers a thread and spilled (local)
    bytes of the kernel that a launch of K fields takes, from
    ``cudaFuncGetAttributes``."""
    lib = _library()
    fields, regs, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.geom_cost_attributes(K, int(wide), ctypes.addressof(fields),
                                   ctypes.addressof(regs),
                                   ctypes.addressof(local))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {"fields_held": fields.value, "registers": regs.value,
            "local_bytes": local.value}


class KernelInputs(NamedTuple):
    """The launch's arguments: contiguous float32 tensors and sizes."""
    planes: Tensor   # (K, P, 4), 16-byte aligned
    x: Tensor        # (P,)
    y: Tensor        # (P,)
    depths: Tensor   # (S, Hs, Ws)
    cams: Tensor     # camera_table
    K: int
    P: int
    lead: tuple      # the output's shape after S


def kernel_inputs(src_depths: Tensor, src_widths: Tensor,
                  src_heights: Tensor, K_ref: Tensor, R_ref: Tensor,
                  C_ref: Tensor, t_ref: Tensor, K_src: Tensor, R_src: Tensor,
                  t_src: Tensor, C_src: Tensor, plane: Tensor, x: Tensor,
                  y: Tensor, cams: Optional[Tensor] = None) -> KernelInputs:
    """The kernel's arguments from the plain twin's, on their device: the
    pixels (P,) repeat over K leading fields where x and y are the
    trailing shape of the broadcast leading shape, else K = 1 and every
    entry is a pixel. ``cams`` is the camera table of these cameras, built
    here when None."""
    dev = plane.device
    if plane.shape[-1:] != (4,):
        raise ValueError(f"plane must be (..., 4), got {tuple(plane.shape)}")
    if src_depths.ndim != 3:
        raise ValueError(f"src_depths must be (S, Hs, Ws), got "
                         f"{tuple(src_depths.shape)}")
    lead = tuple(torch.broadcast_shapes(plane.shape[:-1], x.shape, y.shape))
    planes = _f32_contig("plane", plane, None, dev).expand(
        lead + (4,)).contiguous()
    if planes.data_ptr() % 16:
        planes = planes.clone()
    x, y = _f32_contig("x", x, None, dev), _f32_contig("y", y, None, dev)
    n = math.prod(lead)
    if not (x.shape == y.shape and lead[len(lead) - x.ndim:] == x.shape):
        x, y = x.expand(lead).contiguous(), y.expand(lead).contiguous()
    P = x.numel()
    S = src_depths.shape[0]
    if cams is None:
        cams = camera_table(S, K_ref, R_ref, C_ref, t_ref, K_src, R_src,
                            t_src, C_src, src_widths, src_heights)
    elif (cams.device != dev or cams.dtype != torch.float32
          or cams.shape != (24 + 26 * S,) or not cams.is_contiguous()):
        raise ValueError(f"cams must be the contiguous float32 camera table "
                         f"of {S} sources on {dev}, got {cams.dtype} "
                         f"{tuple(cams.shape)} on {cams.device}")
    depths = _f32_contig("src_depths", src_depths, None, dev)
    return KernelInputs(planes, x.reshape(-1), y.reshape(-1), depths, cams,
                        n // max(P, 1), P, lead)


def geom_consistency_cost_kernel(
        src_depths: Tensor, src_widths: Tensor, src_heights: Tensor,
        K_ref: Tensor, R_ref: Tensor, C_ref: Tensor, t_ref: Tensor,
        K_src: Tensor, R_src: Tensor, t_src: Tensor, C_src: Tensor,
        plane: Tensor, x: Tensor, y: Tensor, max_cost: float = 3.0,
        cams: Optional[Tensor] = None) -> Tensor:
    """Launch ``csrc/geom_cost.cu`` on CUDA tensors: (S, ...) costs of the
    plane field (..., 4) at the pixels (x, y), which broadcast against the
    plane's leading shape. ``cams``: the camera table (``camera_table``)
    of these cameras, or None to build it."""
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"the geometric-cost kernel needs CUDA tensors, got "
                         f"{dev}")
    a = kernel_inputs(src_depths, src_widths, src_heights, K_ref, R_ref,
                      C_ref, t_ref, K_src, R_src, t_src, C_src, plane, x, y,
                      cams)
    S, Hs, Ws = a.depths.shape
    lib = _library()
    if S > lib.max_sources:
        raise ValueError(f"{S} sources; the kernel takes at most "
                         f"{lib.max_sources}")
    out = torch.empty((S,) + a.lead, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = lib.geom_cost_launch(
        a.planes.data_ptr(), a.x.data_ptr(), a.y.data_ptr(),
        a.depths.data_ptr(), a.cams.data_ptr(), a.K, S, a.P, Hs, Ws,
        float(max_cost), int(wide_index(S, Hs, Ws)), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"geom_consistency_cost_kernel launch failed: "
                           f"CUDA error {err}")
    COUNTS.launched()
    return out
