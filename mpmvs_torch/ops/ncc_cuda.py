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

The kernel reads the sources through texture objects over CUDA arrays
made for texture gather (:class:`SourceTextures`), which hold a copy of
the stack; the copy is made at the kernel's first call on a stack and
lives as long as the stack's tensor. ``scattered`` picks the kernel's launch:
False (tile launch) for fields whose neighbouring pixels project close
together, True (view-major launch) for full-range random fields. It
changes no result.

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
AXIS = 6  # taps per window axis (NCC_AXIS in the source)

COUNTS = nvcc.LaunchCounts()


class _Axis(ctypes.Structure):
    _fields_ = [("v", ctypes.c_float * AXIS)]


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(nvcc.build(SOURCE, NVCC_FLAGS))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ncc_eval_multi_launch.argtypes = (
        [vp] * 12 + [_Axis] + [i] * 5 + [f, f, i, vp, vp])
    lib.ncc_eval_multi_launch.restype = i
    lib.ncc_eval_max_k.restype = i
    lib.ncc_make_textures.argtypes = [vp, i, i, i, vp, vp, vp]
    lib.ncc_free_textures.argtypes = [vp, vp, i]
    lib.max_k = lib.ncc_eval_max_k()
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class SourceTextures:
    """The kernel's copy of a source stack (S, H, W): one CUDA array made
    for texture gather per view, and a texture object over each (point
    filtering, clamp addressing; ``handles`` is the (S,) int64 tensor of
    the objects on the stack's device). Freed when it is collected, after a
    device synchronise, since a launch may still read it."""

    def __init__(self, lib, src: Tensor):
        S, H, W = src.shape
        arrays, handles = (ctypes.c_void_p * S)(), (ctypes.c_ulonglong * S)()
        _check(lib.ncc_make_textures(
            src.data_ptr(), S, H, W,
            torch.cuda.current_stream(src.device).cuda_stream, arrays,
            handles), "texture objects of the source stack")
        self._lib, self._arrays, self._objects = lib, arrays, handles
        self.device, self.version = src.device, src._version
        self.handles = torch.tensor(list(handles), dtype=torch.int64,
                                    device=src.device)

    def __del__(self):
        torch.cuda.synchronize(self.device)
        self._lib.ncc_free_textures(self._arrays, self._objects,
                                    len(self._objects))


def _textures(lib, src: Tensor) -> Tensor:
    """The texture objects of ``src``'s views. They are kept on the stack's
    tensor, so they live as long as it, and made again if the stack was
    written in place since (its version counter moved)."""
    tex = getattr(src, "_ncc_textures", None)
    if tex is None or tex.version != src._version:
        tex = src._ncc_textures = SourceTextures(lib, src)
    return tex.handles


def _axis(offsets) -> _Axis:
    """The window axis of ``offsets``, which must be the 6 x 6 grid
    [(dx, dy) for dx in axis for dy in axis] of ``tap_offsets``, with
    integer, evenly spaced axis offsets."""
    offsets = [tuple(o) for o in offsets]
    axis = [dx for dx, _ in offsets[::AXIS]]
    step = axis[1] - axis[0] if len(axis) > 1 else 0
    if offsets != [(dx, dy) for dx in axis for dy in axis] or \
            len(axis) != AXIS or \
            axis != [int(axis[0]) + i * int(step) for i in range(AXIS)]:
        raise ValueError(f"the kernel takes the {AXIS}x{AXIS} window grid of "
                         f"PatchMatchParams.tap_offsets, got {len(offsets)} "
                         f"other offsets")
    a = _Axis()
    for i, v in enumerate(axis):
        a.v[i] = float(v)
    return a


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
                          cost_max: float = 2.0, cap_radius: float = 0.0,
                          scattered: bool = False) -> Tensor:
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
    axis = _axis(offsets)
    lib = _library()
    if not 1 <= Kh <= lib.max_k:
        raise ValueError(f"{Kh} stacked fields; the kernel takes 1.."
                         f"{lib.max_k}")
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
    texs = _textures(lib, src)
    out = torch.empty((Kh, S, R, C), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(lib.ncc_eval_multi_launch(
        w.data_ptr(), wr.data_ptr(), inv_w.data_ptr(), m_ref.data_ptr(),
        var_ref.data_ptr(), planes.data_ptr(), xc.data_ptr(), yc.data_ptr(),
        texs.data_ptr(), wh.data_ptr(), ab.data_ptr(), kinvt.data_ptr(),
        axis, Kh, S, P, Hp, Wp, float(cost_max), float(cap_radius),
        int(bool(scattered)), out.data_ptr(), stream),
        "ncc_eval_multi_kernel launch failed")
    COUNTS.kernel += 1
    return out


def ncc_eval_multi_plain(refside: NCCRefSide, src_imgs: Tensor,
                         src_widths: Tensor, src_heights: Tensor, A: Tensor,
                         b: Tensor, K_ref: Tensor, planes: Tensor, x: Tensor,
                         y: Tensor, offsets: Sequence[Tuple[int, int]],
                         cost_max: float = 2.0, cap_radius: float = 0.0,
                         scattered: bool = False) -> Tensor:
    """The plain version of the kernel: ``ops.ncc.ncc_eval`` per field
    (``scattered``, a launch choice of the kernel, does not apply)."""
    COUNTS.plain += 1
    return torch.stack([
        ncc_eval(refside, src_imgs, src_widths, src_heights, A, b, K_ref,
                 planes[k], x, y, offsets, cost_max, cap_radius)
        for k in range(planes.shape[0])])


def ncc_eval_multi(refside: NCCRefSide, src_imgs: Tensor, src_widths: Tensor,
                   src_heights: Tensor, A: Tensor, b: Tensor, K_ref: Tensor,
                   planes: Tensor, x: Tensor, y: Tensor,
                   offsets: Sequence[Tuple[int, int]], cost_max: float = 2.0,
                   cap_radius: float = 0.0,
                   scattered: bool = False) -> Tensor:
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
              planes, x, y, offsets, cost_max, cap_radius, scattered)


def ncc_eval_one(refside: NCCRefSide, src_imgs: Tensor, src_widths: Tensor,
                 src_heights: Tensor, A: Tensor, b: Tensor, K_ref: Tensor,
                 plane: Tensor, x: Tensor, y: Tensor,
                 offsets: Sequence[Tuple[int, int]], cost_max: float = 2.0,
                 cap_radius: float = 0.0, scattered: bool = False) -> Tensor:
    """One plane field (R, C, 4) -> (S, R, C): the K = 1 case."""
    return ncc_eval_multi(refside, src_imgs, src_widths, src_heights, A, b,
                          K_ref, plane[None], x, y, offsets, cost_max,
                          cap_radius, scattered)[0]
