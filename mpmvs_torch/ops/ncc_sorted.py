"""Bilateral-ZNCC of incoherent plane fields through a bucket-sorted pixel
stream: the fused kernel, the raw-samples kernel, the key kernel, their
plain twins, and the path around them.

Counterpart of ``mpmvs_tpu.ops.pallas_ncc`` lines 716-894
(``_zncc_from_samples``, ``_sample_view_vals``, ``ncc_eval_pallas_sorted``).
It serves fields whose depths are random per pixel (the init field and the
random-depth refinement trials under ``sampler="sorted"``): their 36-tap
windows land anywhere along each pixel's epipolar line, so
:func:`ncc_eval_sorted` works one source view at a time, in an order that
keeps a warp's taps close together:

  1. the int32 key of each pixel's bucket (``BUCKET_ROWS`` x
     ``BUCKET_COLS`` texels; the JAX package's 8 x 128 served its TPU
     sweep, the bucket shape changes no value) from its centre projection
     into the view, and a stable ``torch.sort`` of them: the key kernel
     (:func:`view_keys_kernel`) on CUDA tensors, :func:`sort_view` (with
     :func:`bucket_keys_plain`) on CPU tensors;
  2. on CUDA tensors, one launch of the fused kernel
     (``csrc/ncc_samples.cu``, :func:`view_costs_kernel`): for every
     sorted position it samples the taps, sums them in
     :func:`zncc_from_samples`' order and writes the pixel's cost. It reads
     the reference side from :func:`pixel_record`, built once per call;
  3. on CPU tensors, the plain chain (:func:`ncc_eval_sorted_plain`): the
     raw samples in sorted order (:func:`sample_view_vals_plain`), back to
     pixel order with one ``index_copy_`` (:func:`unpermute`), and
     :func:`zncc_from_samples`.

The raw-samples form stays as a compile-time mode of the same kernel
(:func:`sample_view_vals_kernel`), the direct counterpart of
``_sample_view_vals``, held against :func:`sample_view_vals_plain`. The
kernels are built with ``nvcc`` for sm_90a at first use and bound with
ctypes; a build or launch failure raises, and any device other than CUDA
and the CPU raises. Both forms read the source through ``__ldg``; the tap
arithmetic and the ZNCC tail are ``ops.ncc_cuda``'s kernel's
(``csrc/ncc_tap.cuh``), so the costs equal that kernel's. ``COUNTS`` records the launches of the cost kernel
per form (``fused``, ``samples``) and the plain sample calls (one a view);
``KEY_COUNTS`` the key kernel and its plain twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops import nvcc
from mpmvs_torch.ops.ncc import NCCRefSide, _finite_or_zero, zncc_from_sums
from mpmvs_torch.ops.ncc_cuda import _check, _f32_contig
from mpmvs_torch.ops.sampling import bilinear_sample_batched

Tensor = torch.Tensor

SOURCE = "ncc_samples.cu"
# -fmad=false: the plain version's eager ops round every multiply and add
NVCC_FLAGS = ("-fmad=false",)
# A bucket is 8 rows of 32 texels: eight 128-byte lines of the source.
BUCKET_ROWS, BUCKET_COLS = 8, 32

MAX_TAPS = 64  # NCC_MAX_TAPS in csrc/ncc_tap.cuh
COUNTS = nvcc.LaunchCounts()
KEY_COUNTS = nvcc.LaunchCounts()


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
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ncc_keys_launch.argtypes = [vp] * 5 + [i] * 5 + [vp, vp]
    lib.ncc_keys_launch.restype = i
    lib.ncc_sorted_launch.argtypes = (
        [vp] * 5 + [i] + [vp] * 4 + [_Taps]
        + [i] * 3 + [f, f, i, vp, vp])
    lib.ncc_sorted_launch.restype = i
    return lib


def _check_perm(perm: Tensor, N: int, device) -> Tensor:
    if perm.device != device:
        raise ValueError(f"perm is on {perm.device}, expected {device}")
    if perm.dtype != torch.int64:
        raise TypeError(f"perm must be int64, got {perm.dtype}")
    if tuple(perm.shape) != (N,):
        raise ValueError(f"perm has shape {tuple(perm.shape)}, expected "
                         f"({N},)")
    return perm.contiguous()


class ViewTerms(NamedTuple):
    """What the kernels read of a stack's views, made once per call."""

    wh: Tensor     # (S, 2) valid (width, height)
    ab: Tensor     # (S, 12) A (row-major) then b
    kinvt: Tensor  # (9,) K_ref^-T


def view_terms(src_widths: Tensor, src_heights: Tensor, A: Tensor,
               b: Tensor, K_ref: Tensor, dev) -> ViewTerms:
    """The views' terms (S views: ``A`` (S, 3, 3), ``b`` (S, 3)) as
    contiguous float32 on ``dev``, where they must lie."""
    S = A.shape[0]
    wh = torch.stack([_f32_contig("src_widths", src_widths, (S,), dev),
                      _f32_contig("src_heights", src_heights, (S,), dev)],
                     1).contiguous()
    ab = torch.cat([_f32_contig("A", A, (S, 3, 3), dev).reshape(S, 9),
                    _f32_contig("b", b, (S, 3), dev)], 1).contiguous()
    kinvt = geo.K_inv_pinhole(
        _f32_contig("K_ref", K_ref, (3, 3), dev)).T.reshape(9).contiguous()
    return ViewTerms(wh, ab, kinvt)


def _pixels(plane: Tensor, x: Tensor, y: Tensor, dev):
    """The pixel stream (N, 4), (N,), (N,) as the kernels read it."""
    if dev.type != "cuda":
        raise ValueError(f"the sorted kernels need CUDA tensors, got {dev}")
    if plane.ndim != 2 or plane.shape[1] != 4:
        raise ValueError(f"plane must be (N, 4), got {tuple(plane.shape)}")
    N = plane.shape[0]
    plane = _f32_contig("plane", plane, (N, 4), dev)
    if plane.data_ptr() % 16:
        plane = plane.clone()
    return (plane, _f32_contig("x", x, (N,), dev),
            _f32_contig("y", y, (N,), dev))


def _grid(Hp: int, Wp: int):
    return -(-Hp // BUCKET_ROWS), -(-Wp // BUCKET_COLS)


def view_keys_kernel(terms: ViewTerms, view: int, plane: Tensor,
                     x: Tensor, y: Tensor, Hp: int, Wp: int) -> Tensor:
    """Launch the key kernel for view ``view`` of the call's ``terms``
    (:func:`view_terms`) on CUDA tensors: (N,) int32."""
    dev = plane.device
    plane, x, y = _pixels(plane, x, y, dev)
    if terms.ab.device != dev or not 0 <= view < terms.ab.shape[0]:
        raise ValueError(f"view {view} of terms on {terms.ab.device}, "
                         f"pixels on {dev}")
    keys = torch.empty(plane.shape[0], dtype=torch.int32, device=dev)
    _check(_library().ncc_keys_launch(
        x.data_ptr(), y.data_ptr(), plane.data_ptr(),
        terms.ab[view].data_ptr(), terms.kinvt.data_ptr(), plane.shape[0],
        Hp, Wp, BUCKET_ROWS, BUCKET_COLS, keys.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream),
        "the key kernel launch failed")
    KEY_COUNTS.launched()
    return keys


def bucket_keys_plain(A: Tensor, b: Tensor, K_ref: Tensor, plane: Tensor,
                      x: Tensor, y: Tensor, Hp: int, Wp: int) -> Tensor:
    """The plain version of the key kernel (pallas_ncc.py:867-874): the
    bucket of each pixel's centre projection, non-finite coordinates sent
    to 0 or the float range's ends, then clipped to the buckets of an
    (Hp, Wp) source. (N,) int32."""
    KEY_COUNTS.plain += 1
    pt, _, _, _ = geo.homography_apply(A, b, K_ref, plane, x, y)
    cx = torch.nan_to_num(pt[..., 0])
    cy = torch.nan_to_num(pt[..., 1])
    n_rows, n_cols = _grid(Hp, Wp)
    row = torch.clamp(torch.floor(cy / BUCKET_ROWS), 0, n_rows - 1)
    col = torch.clamp(torch.floor(cx / BUCKET_COLS), 0, n_cols - 1)
    return row.to(torch.int32) * n_cols + col.to(torch.int32)


def sort_view(A: Tensor, b: Tensor, K_ref: Tensor, plane: Tensor, x: Tensor,
              y: Tensor, Hp: int, Wp: int) -> Tensor:
    """The permutation (N,) int64 that orders the pixels (x, y, plane) by
    their bucket in one view (:func:`bucket_keys_plain`), stably
    (pallas_ncc.py:876-881): the plain chain's sort."""
    keys = bucket_keys_plain(A, b, K_ref, plane, x, y, Hp, Wp)
    return torch.sort(keys, stable=True).indices


def record_stride(T: int) -> int:
    """Floats in a row of :func:`pixel_record` for T taps."""
    return -(-(8 + 2 * (-(-T // 4) * 4) + 1) // 4) * 4


def pixel_record(refside: NCCRefSide, plane: Tensor, x: Tensor,
                 y: Tensor) -> Tensor:
    """The fused kernel's per-pixel input, pixel-major, so that a pixel
    read at a scattered position costs 11 sectors where the (T, ...)
    refside would cost one a value. Row p: plane, x, y, inv_w, m_ref; then
    for each block of four taps their w_t and their wr_t (T rounded up to
    Tp, a multiple of 4, with zero weights); then var_ref; padded to a
    multiple of 4 floats: (N, 84) float32 at T = 36."""
    T = refside.w.shape[0]
    N = plane.numel() // 4
    Tp = -(-T // 4) * 4
    rec = torch.empty((N, record_stride(T)), dtype=torch.float32,
                      device=plane.device)
    rec[:, :8] = torch.cat([plane.reshape(N, 4), torch.stack(
        [x.reshape(N), y.reshape(N), refside.inv_w.reshape(N),
         refside.m_ref.reshape(N)], -1)], 1)
    blocks = rec[:, 8:8 + 2 * Tp].view(N, Tp // 4, 2, 4)
    for half, a in enumerate((refside.w, refside.wr)):
        a = a.reshape(T, N)
        if Tp != T:
            a = torch.cat([a, a.new_zeros((Tp - T, N))])
        blocks[:, :, half, :] = a.reshape(Tp // 4, 4, N).permute(2, 0, 1)
    rec[:, 8 + 2 * Tp] = refside.var_ref.reshape(N)
    rec[:, 8 + 2 * Tp + 1:] = 0.0
    return rec


def view_costs_kernel(record: Tensor, src_imgs: Tensor, view: int,
                      terms: ViewTerms, perm: Tensor,
                      offsets: Sequence[Tuple[int, int]],
                      cost_max: float = 2.0, cap_radius: float = 0.0,
                      out: Tensor = None) -> Tensor:
    """Launch the fused form of ``csrc/ncc_samples.cu`` for source view
    ``view`` of ``src_imgs`` (S, Hp, Wp) with
    the views' ``terms`` (:func:`view_terms`): the costs (N,) in pixel
    order of the pixels of ``record`` (:func:`pixel_record`) visited in
    the order of ``perm``, written into ``out`` (N,) if given."""
    dev = record.device
    if dev.type != "cuda":
        raise ValueError(f"the sorted kernels need CUDA tensors, got {dev}")
    T = len(offsets)
    taps = _taps(offsets)
    N = record.shape[0]
    if record.dtype != torch.float32 or record.ndim != 2 or \
            record.shape[1] != record_stride(T) or \
            not record.is_contiguous() or record.data_ptr() % 16:
        raise ValueError(f"record must be pixel_record's (N, "
                         f"{record_stride(T)}) float32 rows, got "
                         f"{record.dtype} {tuple(record.shape)}")
    perm = _check_perm(perm, N, dev)
    if src_imgs.ndim != 3:
        raise ValueError(f"src_imgs must be (S, Hp, Wp), got "
                         f"{tuple(src_imgs.shape)}")
    src = _f32_contig("src_imgs", src_imgs, src_imgs.shape, dev)
    if not 0 <= view < src.shape[0]:
        raise ValueError(f"view {view} outside 0..{src.shape[0] - 1}")
    _, Hp, Wp = src.shape
    if tuple(terms.ab.shape) != (src.shape[0], 12) or terms.ab.device != dev:
        raise ValueError(f"terms must be view_terms of the {src.shape[0]} "
                         f"views on {dev}")
    if out is None:
        out = torch.empty(N, dtype=torch.float32, device=dev)
    elif out.dtype != torch.float32 or tuple(out.shape) != (N,) or \
            out.device != dev or not out.is_contiguous():
        raise ValueError(f"out must be ({N},) contiguous float32 on {dev}")
    _check(_library().ncc_sorted_launch(
        perm.data_ptr(), None, None, None, record.data_ptr(),
        record.shape[1], src[view].data_ptr(), terms.wh[view].data_ptr(),
        terms.ab[view].data_ptr(), terms.kinvt.data_ptr(), taps, N, Hp, Wp,
        float(cap_radius),
        float(cost_max), 1, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream),
        "view_costs_kernel launch failed")
    COUNTS.launched("fused")
    return out


def sample_view_vals_kernel(src_img: Tensor, src_width: Tensor,
                            src_height: Tensor, A: Tensor, b: Tensor,
                            K_ref: Tensor, plane: Tensor, x: Tensor,
                            y: Tensor, perm: Tensor,
                            offsets: Sequence[Tuple[int, int]],
                            cap_radius: float = 0.0) -> Tensor:
    """Launch the raw-samples form of ``csrc/ncc_samples.cu`` on CUDA
    tensors: the raw tap samples of one source view ``src_img`` (Hp, Wp)
    with valid extent (``src_width``, ``src_height``: 0-d) and homography
    terms ``A`` (3, 3), ``b`` (3,), for the pixel stream (x, y, plane)
    (N,)/(N, 4) read in the order of ``perm`` (N,) int64. Returns (T + 1,
    N): T tap samples and a row of 1.0 where the centre is off the view or
    a tap leaves the ±cap_radius box, else 0.0; column i holds pixel
    perm[i]."""
    dev = plane.device
    plane, xc, yc = _pixels(plane, x, y, dev)
    N = plane.shape[0]
    if src_img.ndim != 2:
        raise ValueError(f"src_img must be (Hp, Wp), got "
                         f"{tuple(src_img.shape)}")
    Hp, Wp = src_img.shape
    T = len(offsets)
    taps = _taps(offsets)
    perm = _check_perm(perm, N, dev)
    img = _f32_contig("src_img", src_img, (Hp, Wp), dev)
    terms = view_terms(src_width[None], src_height[None], A[None], b[None],
                       K_ref, dev)
    out = torch.empty((T + 1, N), dtype=torch.float32, device=dev)
    _check(_library().ncc_sorted_launch(
        perm.data_ptr(), xc.data_ptr(), yc.data_ptr(), plane.data_ptr(),
        None, 0, img.data_ptr(), terms.wh.data_ptr(), terms.ab.data_ptr(),
        terms.kinvt.data_ptr(), taps, N, Hp, Wp, float(cap_radius), 0.0, 0,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "sample_view_vals_kernel launch failed")
    COUNTS.launched("samples")
    return out


def sample_view_vals_plain(src_img: Tensor, src_width: Tensor,
                           src_height: Tensor, A: Tensor, b: Tensor,
                           K_ref: Tensor, plane: Tensor, x: Tensor,
                           y: Tensor, perm: Tensor,
                           offsets: Sequence[Tuple[int, int]],
                           cap_radius: float = 0.0) -> Tensor:
    """The plain version of the raw-samples form: ``ops.ncc.ncc_eval``'s
    homography, tap coordinates and footprint cap for one view, sampled
    with ``ops/sampling.py``'s clamped bilinear."""
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


def _flat(plane: Tensor, x: Tensor, y: Tensor):
    N = x.numel()
    return plane.reshape(N, 4), x.reshape(N), y.reshape(N)


def ncc_eval_sorted_kernel(refside: NCCRefSide, src_imgs: Tensor,
                           src_widths: Tensor, src_heights: Tensor,
                           A: Tensor, b: Tensor, K_ref: Tensor, plane: Tensor,
                           x: Tensor, y: Tensor,
                           offsets: Sequence[Tuple[int, int]],
                           cost_max: float = 2.0,
                           cap_radius: float = 0.0) -> Tensor:
    """The sorted path on CUDA tensors: one :func:`pixel_record` for the
    call, then per view the key kernel, a stable sort and one launch of the
    fused kernel. (S, R, C) costs."""
    S, Hp, Wp = src_imgs.shape
    R, C = x.shape
    dev = plane.device
    # contiguous once for the call, not once a view
    src = _f32_contig("src_imgs", src_imgs, (S, Hp, Wp), dev)
    pf, xf, yf = _pixels(*_flat(plane, x, y), dev)
    terms = view_terms(src_widths, src_heights, A, b, K_ref, dev)
    record = pixel_record(refside, pf, xf, yf)
    out = torch.empty((S, R * C), dtype=torch.float32, device=dev)
    for s in range(S):
        perm = torch.sort(view_keys_kernel(terms, s, pf, xf, yf, Hp, Wp),
                          stable=True).indices
        view_costs_kernel(record, src, s, terms, perm, offsets, cost_max,
                          cap_radius, out[s])
    return out.reshape(S, R, C)


def ncc_eval_sorted_plain(refside: NCCRefSide, src_imgs: Tensor,
                          src_widths: Tensor, src_heights: Tensor, A: Tensor,
                          b: Tensor, K_ref: Tensor, plane: Tensor, x: Tensor,
                          y: Tensor, offsets: Sequence[Tuple[int, int]],
                          cost_max: float = 2.0,
                          cap_radius: float = 0.0) -> Tensor:
    """The plain version of the fused path: per view, the plain keys and
    sort, the raw samples, the un-permute and the ZNCC. (S, R, C)."""
    S, Hp, Wp = src_imgs.shape
    R, C = x.shape
    T = len(offsets)
    pf, xf, yf = _flat(plane, x, y)
    costs = []
    for s in range(S):
        perm = sort_view(A[s], b[s], K_ref, pf, xf, yf, Hp, Wp)
        vals = unpermute(sample_view_vals_plain(
            src_imgs[s], src_widths[s], src_heights[s], A[s], b[s], K_ref,
            pf, xf, yf, perm, offsets, cap_radius), perm)
        costs.append(zncc_from_samples(refside, vals[:T].reshape(T, R, C),
                                       vals[T].reshape(R, C) > 0.5,
                                       cost_max))
    return torch.stack(costs)


def ncc_eval_sorted(refside: NCCRefSide, src_imgs: Tensor,
                    src_widths: Tensor, src_heights: Tensor, A: Tensor,
                    b: Tensor, K_ref: Tensor, plane: Tensor, x: Tensor,
                    y: Tensor, offsets: Sequence[Tuple[int, int]],
                    cost_max: float = 2.0, cap_radius: float = 0.0) -> Tensor:
    """Costs (S, R, C) of one plane field (R, C, 4) at the pixels (x, y)
    (R, C) against every source view, through the sorted stream (module
    docstring); the function of ``ops.ncc.ncc_eval``. The fused kernel for
    CUDA tensors, the plain chain for CPU tensors."""
    dev = plane.device.type
    if dev == "cuda":
        fn = ncc_eval_sorted_kernel
    elif dev == "cpu":
        fn = ncc_eval_sorted_plain
    else:
        raise ValueError(f"no sorted-path implementation for device "
                         f"{plane.device}")
    return fn(refside, src_imgs, src_widths, src_heights, A, b, K_ref, plane,
              x, y, offsets, cost_max, cap_radius)
