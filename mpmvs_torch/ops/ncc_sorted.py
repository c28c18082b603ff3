"""Bilateral-ZNCC of incoherent plane fields through a bucket-sorted pixel
stream: the sample kernel, its plain twin, and the path around them.

Counterpart of ``mpmvs_tpu.ops.pallas_ncc`` lines 716-894
(``_zncc_from_samples``, ``_sample_view_vals``, ``ncc_eval_pallas_sorted``).
It serves fields whose depths are random per pixel (the init field and the
random-depth refinement trials under ``sampler="sorted"``): their 36-tap
windows land anywhere along each pixel's epipolar line, so
:func:`ncc_eval_sorted` works one source view at a time:

  1. bucket keys from the centre projection into the view (``BUCKET_ROWS``
     x ``BUCKET_COLS`` texel buckets; the JAX package's 8 x 128 served its
     TPU sweep, the bucket shape changes no value) and a stable
     ``torch.sort`` of them;
  2. :func:`sample_view_vals`, the raw tap samples and the off-view/capped
     flag of every pixel in sorted order: the CUDA kernel
     ``csrc/ncc_samples.cu`` for CUDA tensors (built with ``nvcc`` for
     sm_90a at first use, bound with ctypes; a build or launch failure
     raises), :func:`sample_view_vals_plain` for CPU tensors, any other
     device raises;
  3. back to pixel order with one ``index_copy_`` (a scatter);
  4. :func:`zncc_from_samples`, the ZNCC against the reference side in
     pixel order, so the (T, ...) weight stacks never ride the permutation.

The samples equal what ``ops.ncc_cuda``'s kernel reads (the tap arithmetic
is shared, ``csrc/ncc_tap.cuh``), and the ZNCC sums them in the kernel's
order, so the costs equal the kernel's. The extra memory is one view's
(T + 1, N) samples twice (sorted and pixel order). ``COUNTS`` records
kernel launches and plain calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops import nvcc
from mpmvs_torch.ops.ncc import NCCRefSide, _finite_or_zero, zncc_from_sums
from mpmvs_torch.ops.ncc_cuda import _f32_contig
from mpmvs_torch.ops.sampling import bilinear_sample_batched

Tensor = torch.Tensor

SOURCE = "ncc_samples.cu"
# -fmad=false: the plain version's eager ops round every multiply and add
NVCC_FLAGS = ("-fmad=false",)
# A bucket is 8 rows of 32 texels: eight 128-byte lines of the source.
BUCKET_ROWS, BUCKET_COLS = 8, 32

MAX_TAPS = 64  # NCC_MAX_TAPS in csrc/ncc_tap.cuh

COUNTS = nvcc.LaunchCounts()


class _Taps(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("dx", ctypes.c_int * MAX_TAPS),
                ("dy", ctypes.c_int * MAX_TAPS)]


def _taps(offsets) -> _Taps:
    if not 0 < len(offsets) <= MAX_TAPS:
        raise ValueError(f"{len(offsets)} taps; the kernel takes 1..{MAX_TAPS}")
    t = _Taps()
    t.n = len(offsets)
    for i, (dx, dy) in enumerate(offsets):
        t.dx[i] = int(dx)
        t.dy[i] = int(dy)
    return t


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(nvcc.build(SOURCE, NVCC_FLAGS))
    fn = lib.ncc_samples_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [_Taps]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_perm(perm: Tensor, N: int, device) -> Tensor:
    if perm.device != device:
        raise ValueError(f"perm is on {perm.device}, expected {device}")
    if perm.dtype != torch.int64:
        raise TypeError(f"perm must be int64, got {perm.dtype}")
    if tuple(perm.shape) != (N,):
        raise ValueError(f"perm has shape {tuple(perm.shape)}, expected "
                         f"({N},)")
    return perm.contiguous()


def sample_view_vals_kernel(src_img: Tensor, src_width: Tensor,
                            src_height: Tensor, A: Tensor, b: Tensor,
                            K_ref: Tensor, plane: Tensor, x: Tensor,
                            y: Tensor, perm: Tensor,
                            offsets: Sequence[Tuple[int, int]],
                            cap_radius: float = 0.0) -> Tensor:
    """Launch ``csrc/ncc_samples.cu`` on CUDA tensors: (T + 1, N)."""
    dev = plane.device
    if dev.type != "cuda":
        raise ValueError(f"the sample kernel needs CUDA tensors, got {dev}")
    if plane.ndim != 2 or plane.shape[1] != 4:
        raise ValueError(f"plane must be (N, 4), got {tuple(plane.shape)}")
    N = plane.shape[0]
    if src_img.ndim != 2:
        raise ValueError(f"src_img must be (Hp, Wp), got "
                         f"{tuple(src_img.shape)}")
    Hp, Wp = src_img.shape
    T = len(offsets)
    taps = _taps(offsets)
    plane = _f32_contig("plane", plane, (N, 4), dev)
    if plane.data_ptr() % 16:
        plane = plane.clone()
    xc = _f32_contig("x", x, (N,), dev)
    yc = _f32_contig("y", y, (N,), dev)
    perm = _check_perm(perm, N, dev)
    img = _f32_contig("src_img", src_img, (Hp, Wp), dev)
    wh = torch.stack([_f32_contig("src_width", src_width, (), dev),
                      _f32_contig("src_height", src_height, (), dev)])
    ab = torch.cat([_f32_contig("A", A, (3, 3), dev).reshape(9),
                    _f32_contig("b", b, (3,), dev)]).contiguous()
    kinvt = geo.K_inv_pinhole(
        _f32_contig("K_ref", K_ref, (3, 3), dev)).T.contiguous()
    out = torch.empty((T + 1, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library()(
        perm.data_ptr(), xc.data_ptr(), yc.data_ptr(), plane.data_ptr(),
        img.data_ptr(), wh.data_ptr(), ab.data_ptr(), kinvt.data_ptr(), taps,
        N, Hp, Wp, float(cap_radius), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sample_view_vals_kernel launch failed: CUDA "
                           f"error {err}")
    COUNTS.kernel += 1
    return out


def sample_view_vals_plain(src_img: Tensor, src_width: Tensor,
                           src_height: Tensor, A: Tensor, b: Tensor,
                           K_ref: Tensor, plane: Tensor, x: Tensor,
                           y: Tensor, perm: Tensor,
                           offsets: Sequence[Tuple[int, int]],
                           cap_radius: float = 0.0) -> Tensor:
    """The plain version of the kernel: ``ops.ncc.ncc_eval``'s homography,
    tap coordinates and footprint cap for one view, sampled with
    ``ops/sampling.py``'s clamped bilinear."""
    COUNTS.plain += 1
    perm = _check_perm(perm, plane.shape[0], plane.device)
    xs_p, ys_p, pl = x[perm], y[perm], plane[perm]
    pt, col_x, col_y, h_p = geo.homography_apply(A, b, K_ref, pl, xs_p, ys_p)
    oob = ((pt[..., 0] < 0.0) | (pt[..., 0] >= src_width)
           | (pt[..., 1] < 0.0) | (pt[..., 1] >= src_height)
           | ~torch.isfinite(pt[..., 0]) | ~torch.isfinite(pt[..., 1]))
    cap = cap_radius > 0.0
    if cap:
        inv_zc = 1.0 / h_p[..., 2]
        ccx = _finite_or_zero(h_p[..., 0] * inv_zc)
        ccy = _finite_or_zero(h_p[..., 1] * inv_zc)
        bx_lo, bx_hi = ccx - cap_radius, ccx + cap_radius
        by_lo, by_hi = ccy - cap_radius, ccy + cap_radius
    view = torch.zeros((), dtype=torch.int64, device=plane.device)
    imgs = src_img[None]
    widths, heights = src_width.reshape(1), src_height.reshape(1)
    rows = []
    for dx, dy in offsets:
        h = h_p + dx * col_x + dy * col_y
        inv_z = 1.0 / h[..., 2]
        xs = h[..., 0] * inv_z
        ys = h[..., 1] * inv_z
        if cap:
            xf = _finite_or_zero(xs)
            yf = _finite_or_zero(ys)
            oob = (oob | (xf < bx_lo) | (xf > bx_hi) | (yf < by_lo)
                   | (yf > by_hi))
        rows.append(bilinear_sample_batched(imgs, view, xs, ys, widths,
                                            heights))
    rows.append(oob.to(torch.float32))
    return torch.stack(rows)


def sample_view_vals(src_img: Tensor, src_width: Tensor, src_height: Tensor,
                     A: Tensor, b: Tensor, K_ref: Tensor, plane: Tensor,
                     x: Tensor, y: Tensor, perm: Tensor,
                     offsets: Sequence[Tuple[int, int]],
                     cap_radius: float = 0.0) -> Tensor:
    """Raw tap samples of one source view ``src_img`` (Hp, Wp) with valid
    extent (``src_width``, ``src_height``: 0-d) and homography terms ``A``
    (3, 3), ``b`` (3,), for the pixel stream (x, y, plane) (N,)/(N, 4) read
    in the order of ``perm`` (N,) int64. Returns (T + 1, N): T tap samples
    and a row of 1.0 where the centre is off the view or a tap leaves the
    ±cap_radius box, else 0.0; column i holds pixel perm[i]. The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    dev = plane.device.type
    if dev == "cuda":
        fn = sample_view_vals_kernel
    elif dev == "cpu":
        fn = sample_view_vals_plain
    else:
        raise ValueError(f"no sample implementation for device "
                         f"{plane.device}")
    return fn(src_img, src_width, src_height, A, b, K_ref, plane, x, y, perm,
              offsets, cap_radius)


def sort_view(A: Tensor, b: Tensor, K_ref: Tensor, plane: Tensor, x: Tensor,
              y: Tensor, Hp: int, Wp: int) -> Tensor:
    """The permutation (N,) int64 that orders the pixels (x, y, plane) by the
    bucket of their centre projection into one view, stably
    (pallas_ncc.py:867-881: non-finite projections go to 0 or the float
    range's ends, then clip to the buckets of an (Hp, Wp) source)."""
    pt, _, _, _ = geo.homography_apply(A, b, K_ref, plane, x, y)
    cx = torch.nan_to_num(pt[..., 0])
    cy = torch.nan_to_num(pt[..., 1])
    n_rows = -(-Hp // BUCKET_ROWS)
    n_cols = -(-Wp // BUCKET_COLS)
    row = torch.clamp(torch.floor(cy / BUCKET_ROWS), 0, n_rows - 1)
    col = torch.clamp(torch.floor(cx / BUCKET_COLS), 0, n_cols - 1)
    keys = row.to(torch.int64) * n_cols + col.to(torch.int64)
    return torch.sort(keys, stable=True).indices


def unpermute(vals: Tensor, perm: Tensor) -> Tensor:
    """Columns of ``vals`` (…, N) in sorted order -> pixel order: column i
    goes to column perm[i] (one scatter, no inverse permutation)."""
    out = torch.empty_like(vals)
    return out.index_copy_(vals.ndim - 1, perm, vals)


def zncc_from_samples(refside: NCCRefSide, vals: Tensor, oob: Tensor,
                      cost_max: float) -> Tensor:
    """ZNCC cost from raw tap samples (pallas_ncc.py:716-730). ``vals``
    (T, ...) samples in the refside's pixel order; ``oob`` (...) bool. The
    taps are summed in sequence, in the NCC kernel's order (ops/ncc.py::
    ncc_eval), not in a reduction's: the variance is a difference of large
    sums, and another order moves a quarter of the costs by more than 1e-4
    at the init field on the card."""
    sum_src = torch.zeros_like(refside.m_ref)
    sum_src2 = torch.zeros_like(sum_src)
    sum_rs = torch.zeros_like(sum_src)
    for t in range(vals.shape[0]):
        ws = refside.w[t] * vals[t]
        sum_src = sum_src + ws
        sum_src2 = sum_src2 + ws * vals[t]
        sum_rs = sum_rs + refside.wr[t] * vals[t]
    return zncc_from_sums(refside, sum_src, sum_src2, sum_rs, oob, cost_max)


def ncc_eval_sorted(refside: NCCRefSide, src_imgs: Tensor,
                    src_widths: Tensor, src_heights: Tensor, A: Tensor,
                    b: Tensor, K_ref: Tensor, plane: Tensor, x: Tensor,
                    y: Tensor, offsets: Sequence[Tuple[int, int]],
                    cost_max: float = 2.0, cap_radius: float = 0.0) -> Tensor:
    """Costs (S, R, C) of one plane field (R, C, 4) at the pixels (x, y)
    (R, C) against every source view, through the sorted stream (module
    docstring); the function of ``ops.ncc.ncc_eval``."""
    S, Hp, Wp = src_imgs.shape
    R, C = x.shape
    T = len(offsets)
    N = R * C
    xf = x.reshape(N)
    yf = y.reshape(N)
    pf = plane.reshape(N, 4)
    costs = []
    for s in range(S):
        perm = sort_view(A[s], b[s], K_ref, pf, xf, yf, Hp, Wp)
        vals = unpermute(sample_view_vals(
            src_imgs[s], src_widths[s], src_heights[s], A[s], b[s], K_ref,
            pf, xf, yf, perm, offsets, cap_radius), perm)
        costs.append(zncc_from_samples(refside, vals[:T].reshape(T, R, C),
                                       vals[T].reshape(R, C) > 0.5,
                                       cost_max))
    return torch.stack(costs)
