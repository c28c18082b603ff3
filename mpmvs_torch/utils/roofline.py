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


def sorted_bound(N: int, T: int, view_bytes: int, cap: bool):
    """One launch of the fused sorted kernel (``csrc/ncc_samples.cu``) over
    N pixels of one view: as the NCC kernel at K = 1 for one view, 61
    operations a pixel (+7 with the cap) and 34 a tap. Bytes: the
    permutation, the pixel's plane, x, y and reference side (2 T + 3
    floats), the view, the cost."""
    flops = N * (61 + (7 if cap else 0) + 34 * T)
    nbytes = N * (8 + 16 + 8 + 4 * (2 * T + 3) + 4) + view_bytes
    return bound(flops, nbytes)


def keys_bound(N: int):
    """One launch of the key kernel over N pixels: 64 operations a pixel
    (m / w 18, the centre's homogeneous image 30, its projection and
    bucket 16). Bytes: plane, x and y in, the int32 key out."""
    return bound(64 * N, N * (16 + 8 + 4))


def geom_bound(K: int, S: int, N: int, depth_bytes: int):
    """One call of the geometric-cost kernel (``csrc/geom_cost.cu``): K
    fields at N pixels against S sources. Operations: 36 a (field, pixel)
    for the plane's depth and world point, 130 a (field, source, pixel)
    (projection 35, the two truncating indices and the extent 22, the flat
    index 5, back-projection 24, re-projection 35, error and tail 9).
    Bytes: the planes, x and y, the source depth maps, the costs."""
    flops = K * N * (36 + 130 * S)
    nbytes = 16 * K * N + 8 * N + depth_bytes + 4 * K * S * N
    return bound(flops, nbytes)


def geom_issue_floor_ms(K: int, S: int, N: int,
                        instructions_per_entry: float, clock_mhz: float,
                        sms: int = 132):
    """The least time the card's schedulers take to issue the
    geometric-cost kernel's source loop over K fields, S sources and N
    pixels, ``instructions_per_entry`` an entry (field, source, pixel), as
    counted in its SASS (``tools.kernel_bench --kernel geom --sass``).
    With -fmad=false and IEEE division and square root, these exceed the
    operations that ``geom_bound`` counts: the kernel is issue-bound."""
    return issue_floor_ms(instructions_per_entry, K * S * N, clock_mhz, sms)


def table_bound(n: int):
    """The bilateral table builder: n entries of sqrt, multiply and exp,
    written once."""
    return bound(3 * n, 4 * n)


def issue_floor_ms(instructions_per_tap: float, taps: float,
                   clock_mhz: float, sms: int = 132):
    """The least time the card's schedulers take to issue a kernel's
    instructions: ``taps`` threads' taps of ``instructions_per_tap`` each,
    32 threads a warp instruction, 4 warp instructions a clock on each of
    ``sms`` SMs at ``clock_mhz``."""
    return 1e3 * taps * instructions_per_tap / 32 / (4 * sms) / (
        clock_mhz * 1e6)


def bilateral_bound(H: int, W: int, radius: int):
    """One call of the bilateral kernel (``csrc/bilateral_refine.cu``) on
    an H x W image: 15 operations per in-image tap (colour difference and
    norm 9, sqrt, exp, the weight 2, the sums 3). Bytes: the BGR guide, the
    probability, the refined map."""
    def in_image(L: int) -> int:
        return sum(min(i + radius, L - 1) - max(i - radius, 0) + 1
                   for i in range(L))

    return bound(15 * in_image(H) * in_image(W), H * W * (12 + 4 + 4))


def bgr_to_ycc_bound(H: int, W: int, channels: int):
    """One launch of the encoder's colour kernel (``csrc/jpeg_codec.cu``)
    on an (H, W) image: the image read once, the Y plane (whole blocks)
    and, for colour, the two chroma planes written. Integer work has no
    peak in the data sheet's table, so the bytes alone set the bound."""
    yb = 64 * -(-H // 8) * -(-W // 8)
    cb = 2 * 64 * -(-H // 16) * -(-W // 16) if channels == 3 else 0
    return bound(0, H * W * channels + yb + cb)


def fdct_bound(blocks: int):
    """One launch of the forward DCT kernel over ``blocks`` 8x8 blocks: 64
    samples read and 64 int16 coefficients written a block (and the
    table). Bytes alone, as for the colour kernel."""
    return bound(0, blocks * (64 + 128) + 128)


def raster_bound(form, table_bytes: int):
    """One launch of the raster kernel (``csrc/jpeg_codec.cu``) on a PNG's,
    a TIFF's, a BMP's or a PNM's samples (an ``io.images.RasterForm``; a
    BMP's B, G, R order and 16-bit fields move the same bytes): the
    samples read once (every plane), the tables, the BGR image and the
    grey image written (4 bytes a pixel). Bytes alone, as for the codec's
    other kernels."""
    planes = form.channels if form.planar else 1
    return bound(0, planes * form.plane_bytes + table_bytes
                 + 4 * form.width * form.height)


def colour_bound(planes, H: int, W: int, grey: bool = True):
    """One launch of a JPEG colour kernel (``ycc_to_bgr_kernel``,
    ``cmyk_to_bgr_kernel``) on component planes (tensors, each at its
    sampled size) of an (H, W) image: every plane's samples read once, the
    BGR image written and, with ``grey``, the grey image (the
    four-component kernel always writes it). Bytes alone, as for the
    codec's other kernels."""
    return bound(0, sum(p.numel() for p in planes)
                 + (4 if grey else 3) * H * W)


def idct_bound(coefs, planes):
    """The IDCT launches of a JPEG's or a JPEG-compressed TIFF's components
    (``idct_islow_kernel``, one a component; a TIFF's every chunk at once):
    2 bytes a coefficient read, 1 a sample written. Bytes alone: the int32
    work has no peak in the table."""
    return bound(0, sum(2 * c.numel() for c in coefs)
                 + sum(p.numel() for p in planes))


def chunk_samples_read(chunks, factors, H: int, W: int) -> int:
    """The component samples that ``ycc_to_bgr_kernel``'s chunked form
    reads (``csrc/jpeg_colour.h`` upsampled()) of a JPEG-compressed TIFF
    cut into ``chunks`` (an ``io.images.Chunks``) at ``factors`` ((rh, rv)
    a component): in each chunk, cropped to the image, the sample rows
    and columns that its pixels and their fancy neighbours touch. The
    padding of the IDCT's blocks, a tile's overhang and the last strip's
    rows past the image are not read and not counted."""
    from mpmvs_torch.io.images import _fancy

    def touched(n: int, r: int, fancy: bool, have: int) -> int:
        # samples along one axis that n pixels at ratio r read, of `have`
        # in the chunk: each pixel's own, and under fancy 2x upsampling
        # the one past the last when n is even and the chunk has it
        if r == 1:
            return n
        own = -(-n // r)
        return own + int(fancy and n % 2 == 0 and n // 2 < have)

    k = chunks
    down = -(-H // k.height)
    rows = [min(k.height, H - t * k.height) for t in range(down)]
    cols = [min(k.width, W - t * k.width) for t in range(k.across)] \
        if k.tiled else [W]
    total = 0
    for rh, rv in factors:
        w = -(-k.width // rh)
        fancy = _fancy(w, rh, rv)
        for t, ch in enumerate(rows):
            for x, c in enumerate(cols):
                stream = k.rows[t * len(cols) + x]
                total += touched(c, rh, fancy and rh == 2, w) * touched(
                    ch, rv, fancy and rv == 2, -(-stream // rv))
    return total


def chunked_colour_bound(chunks, factors, H: int, W: int):
    """One launch of ``ycc_to_bgr_kernel``'s chunked form (a JPEG-compressed
    TIFF): the samples it reads (:func:`chunk_samples_read`) read once,
    BGR and grey written."""
    return bound(0, chunk_samples_read(chunks, factors, H, W) + 4 * H * W)


def ycbcr_raster_bound(form):
    """One launch of the raster kernel's YCbCr form (a TIFF's data units):
    the units read once, libtiff's five int32 tables (5 KiB), BGR and grey
    written."""
    return raster_bound(form, 5 * 1024)


def vp8_reconstruct_bound(records):
    """One launch of ``vp8_reconstruct_kernel`` on a frame whose records
    (an int32 (macroblocks, 4) array) say which blocks hold coefficients: the records read, the coefficients of those blocks
    (and the Y2 of each 16x16 MB) read at 32 bytes a block, the unfiltered
    planes written (384 bytes an MB). Bytes alone (integer work), as for
    the codec's other kernels; the blocks counted are what this frame
    needs, not the 25 an MB the host sends."""
    import numpy as np

    r = np.asarray(records)
    blocks = int(np.unpackbits(np.ascontiguousarray(
        r[:, 3]).view(np.uint8)).sum()) + int(((r[:, 0] & 1) == 0).sum())
    return bound(0, (16 + 384) * len(r) + 32 * blocks)


def vp8_filter_bound(mbs: int):
    """One launch of ``vp8_loop_filter_kernel`` on ``mbs`` macroblocks: the
    records read and the planes read and written once each (384 bytes an
    MB each way)."""
    return bound(0, 16 * mbs + 2 * 384 * mbs)


def webp_colour_bound(H: int, W: int):
    """One launch of ``webp_yuv_to_bgr_kernel`` on an (H, W) image: its Y
    samples and the chroma samples that cover it read once, the BGR and
    grey images written."""
    return bound(0, H * W + 2 * ((H + 1) // 2) * ((W + 1) // 2) + 4 * H * W)


def vp8l_predictor_bound(H: int, W: int, modes: int):
    """One launch of ``vp8l_predictor_kernel`` on an (H, W) ARGB image: its
    residuals and the ``modes`` words of its sub-image read once, the
    rebuilt image written (4 bytes a pixel each way). Bytes alone (integer
    work), as for the codec's other kernels."""
    return bound(0, 8 * H * W + 4 * modes)


def vp8l_colour_bound(H: int, in_w: int, out_w: int, data_words: int):
    """One launch of ``vp8l_colour_kernel``: the (H, in_w) ARGB image and
    the run's multipliers and palette read once, the (H, out_w) image
    written."""
    return bound(0, 4 * H * (in_w + out_w) + 4 * data_words)


def webp_argb_bound(h: int, w: int, cw: int, ch: int):
    """One launch of ``webp_argb_to_bgr_kernel``: the (h, w) ARGB frame
    read, the (ch, cw) canvas's BGR and grey written."""
    return bound(0, 4 * h * w + 4 * cw * ch)


def ljpeg_bound(planes):
    """One undifferencing of a lossless JPEG's planes ((h, w) each), by
    either form (``ljpeg_scan_kernel``, ``ljpeg_wavefront_kernel``): each
    plane's int16 differences read once and its uint8 samples written, 3
    bytes a sample. Bytes alone (integer work, mod 2^16)."""
    return bound(0, 3 * sum(h * w for h, w in planes))



def smooth_bound(coefs):
    """The smoothing launches of a progressive JPEG's components
    (``jpeg_smooth_kernel``, one a component): each int16 coefficient read
    once and written once into the new array, 4 bytes a coefficient. Bytes
    alone: the integer work has no peak in the table."""
    return bound(0, sum(4 * c.numel() for c in coefs))


# the float operations of raster_bgr.h's cielab_rgb a pixel: L* (2), Y and
# cby (5 on the larger path), X and Z (6 each), the matrix (15) and the
# three channels' index (2 each)
CIELAB_OPS = 2 + 5 + 2 * 6 + 15 + 3 * 2


def cielab_bound(form):
    """One launch of the raster kernel's CIELab form: its samples read
    once, the Yr2r table and the reference white (6,020 bytes), BGR and grey
    written, against CIELAB_OPS float operations a pixel."""
    return max(raster_bound(form, 4 * 1505),
               bound(CIELAB_OPS * form.width * form.height, 0))
