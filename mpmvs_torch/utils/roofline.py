"""Bounds of the port's kernels: the least time an H100 could take for a
kernel's work, the larger of its f32 operations over 67 TFLOP/s and its
bytes over 3.35 TB/s (H100 SXM data sheet), each input read once and each
output written once. ``chip_smoke.py`` and ``tools.kernel_bench`` print
them beside the measured times.

Each function returns (bound in ms, what sets it: "bytes" or
"operations"). The operation counts are read from the kernels' code; with
``-fmad=false`` every multiply and add is its own instruction, so an
operation bound is half what the FMA pipe could reach.
"""

from __future__ import annotations

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def bound(flops: float, nbytes: float):
    """The larger of ``flops`` over the peak rate and ``nbytes`` over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def ncc_bound(K: int, S: int, P: int, T: int, src_bytes: int, cap: bool):
    """One call of the NCC kernel (``csrc/ncc_eval.cu``): K fields, S
    views, P pixels, T taps. Per (hypothesis, view, pixel) ~61 operations
    for the homography and the ZNCC tail, +7 with the cap box, and 34 per
    tap (projection 17, floors and fractions 4, bilinear lerp 9, weighted
    sums 6 with 2 of them folded). Bytes: the reference side (2 T + 5
    floats a pixel), the planes, the source stack, the costs."""
    flops = K * S * P * (61 + (7 if cap else 0) + 34 * T)
    nbytes = 4 * P * (2 * T + 5) + 16 * K * P + src_bytes + 4 * K * S * P
    return bound(flops, nbytes)


def samples_bound(N: int, T: int, view_bytes: int, cap: bool):
    """One call of the sample kernel (``csrc/ncc_samples.cu``) over N
    pixels of one view: 50 operations a pixel (+7 with the cap) and 28 a
    tap. Bytes: plane, x, y and the permutation, the view, the T + 1
    output rows."""
    flops = N * (50 + (7 if cap else 0) + 28 * T)
    nbytes = N * (16 + 4 + 4 + 8) + view_bytes + 4 * (T + 1) * N
    return bound(flops, nbytes)


def bilateral_bound(H: int, W: int, radius: int):
    """One call of the bilateral kernel (``csrc/bilateral_refine.cu``) on
    an H x W image: 15 operations per in-image tap (colour difference and
    norm 9, sqrt, exp, the weight 2, the sums 3). Bytes: the BGR guide, the
    probability, the refined map."""
    def in_image(L: int) -> int:
        return sum(min(i + radius, L - 1) - max(i - radius, 0) + 1
                   for i in range(L))

    return bound(15 * in_image(H) * in_image(W), H * W * (12 + 4 + 4))
