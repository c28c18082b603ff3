"""Vectorized camera / plane geometry.

Counterpart of ``mpmvs_tpu.geometry`` (the device math of the reference,
src/PatchMatch.cu:84-97, 163-195, 228-316, 582-640) on torch tensors. Every
function operates on whole pixel grids at once and broadcasts over leading
axes where noted.

Plane parametrization: a hypothesis is ``(n, w)`` with the plane equation
``n . X + w = 0`` in *reference-camera* coordinates, packed as the last axis
of size 4 (PatchMatch.cu:171-176, 221-226).

Rounding: per-pixel 3-vector products are written out as ``(a0 b0 + a1 b1)
+ a2 b2`` so their summation order is fixed; the NCC kernel
(csrc/ncc_eval.cu) repeats the same order for ``m = K_ref^-T n``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _matvec(M: Tensor, v: Tensor) -> Tensor:
    """out_i = sum_j M[..., i, j] v[..., j], summed in order j = 0, 1, 2."""
    return torch.stack([M[..., i, 0] * v[..., 0] + M[..., i, 1] * v[..., 1]
                        + M[..., i, 2] * v[..., 2] for i in range(3)], -1)


def _matTvec(M: Tensor, v: Tensor) -> Tensor:
    """out_i = sum_j M[..., j, i] v[..., j], summed in order j = 0, 1, 2."""
    return torch.stack([M[..., 0, i] * v[..., 0] + M[..., 1, i] * v[..., 1]
                        + M[..., 2, i] * v[..., 2] for i in range(3)], -1)


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """Sum over the last axis (size 3) of a * b, in order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def intrinsics_parts(K: Tensor):
    """fx, fy, cx, cy from a (…, 3, 3) intrinsic matrix."""
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def pixel_grid(height: int, width: int, device=None):
    """Integer pixel coordinate grids x (H, W), y (H, W), float32."""
    y = torch.arange(height, dtype=torch.float32, device=device)
    x = torch.arange(width, dtype=torch.float32, device=device)
    return (x[None, :].expand(height, width).contiguous(),
            y[:, None].expand(height, width).contiguous())


def view_direction(K: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Unnormalized ray direction K^-1 (x, y, 1) — (…, 3).
    Reference: GetViewDirection (PatchMatch.cu:179-186)."""
    fx, fy, cx, cy = intrinsics_parts(K)
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(x)], -1)


def backproject_cam(K: Tensor, x: Tensor, y: Tensor, depth: Tensor) -> Tensor:
    """Pixel + depth -> 3D point in the same camera's frame (…, 3).
    Reference: GetPointI2C (PatchMatch.cu:163-168)."""
    return depth[..., None] * view_direction(K, x, y)


def plane_to_origin(K: Tensor, x: Tensor, y: Tensor, depth: Tensor,
                    normal: Tensor) -> Tensor:
    """Signed plane-to-origin distance w = -(n . X) for X on the viewing ray.
    Reference: GetPlane2Origin (PatchMatch.cu:171-176)."""
    X = backproject_cam(K, x, y, depth)
    return -dot3(normal, X)


def depth_from_plane(K: Tensor, plane: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Depth of the plane (n, w) along the ray through pixel (x, y):
    -w fx / ((x-cx) nx + (fx/fy)(y-cy) ny + fx nz)
    (ComputeDepthfromPlaneHypothesis, PatchMatch.cu:84-87)."""
    fx, fy, cx, cy = intrinsics_parts(K)
    n0, n1, n2, w = plane[..., 0], plane[..., 1], plane[..., 2], plane[..., 3]
    denom = (x - cx) * n0 + (fx / fy) * (y - cy) * n1 + fx * n2
    return -w * fx / denom


def plane_from_depth_normal(K: Tensor, x: Tensor, y: Tensor, depth: Tensor,
                            normal: Tensor) -> Tensor:
    """(n, w) hypothesis from per-pixel depth + camera-frame normal (…, 4)."""
    w = plane_to_origin(K, x, y, depth, normal)
    return torch.cat([normal, w[..., None]], -1)


def normal_cam_to_world(R: Tensor, normal: Tensor) -> Tensor:
    """n_world = R^T n_cam. Reference: TransformNormal (PatchMatch.cu:89-97)."""
    return _matTvec(R, normal)


def normal_world_to_cam(R: Tensor, normal: Tensor) -> Tensor:
    """n_cam = R n_world. Reference: TransformNormal2RefCam (PatchMatch.cu:308-316)."""
    return _matvec(R, normal)


def relative_pose(R_ref: Tensor, C_ref: Tensor, R_src: Tensor, C_src: Tensor):
    """R_rel = R_src R_ref^T ; t_rel = R_src (C_ref - C_src). Broadcasts over
    leading (view) axes of the src arguments (PatchMatch.cu:230-247)."""
    R_rel = torch.einsum("...ik,jk->...ij", R_src, R_ref)
    t_rel = _matvec(R_src, C_ref - C_src)
    return R_rel, t_rel


def K_inv_pinhole(K: Tensor) -> Tensor:
    """Closed-form inverse of a no-skew pinhole K (…, 3, 3)."""
    fx, fy, cx, cy = intrinsics_parts(K)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    rows = [torch.stack([1.0 / fx, z, -cx / fx], -1),
            torch.stack([z, 1.0 / fy, -cy / fy], -1),
            torch.stack([z, z, o], -1)]
    return torch.stack(rows, -2)


def homography_terms(K_ref: Tensor, R_ref: Tensor, C_ref: Tensor,
                     K_src: Tensor, R_src: Tensor, C_src: Tensor):
    """Per-view constants (A, b) of the plane-induced homography
    H(plane) = A - outer(b, m) / w with m = K_ref^-T n, A = K_src R_rel
    K_ref^-1, b = K_src t_rel (the factorization of ComputeHomography,
    PatchMatch.cu:228-279). Broadcasts over leading view axes."""
    R_rel, t_rel = relative_pose(R_ref, C_ref, R_src, C_src)
    Kri = K_inv_pinhole(K_ref)
    A = torch.einsum("...ij,...jk,kl->...il", K_src, R_rel, Kri)
    b = _matvec(K_src, t_rel)
    return A, b


def homography_apply(A: Tensor, b: Tensor, K_ref: Tensor, plane: Tensor,
                     x: Tensor, y: Tensor):
    """Project ref pixel (x, y) through the plane homography into src.

    Returns (pt (…, 2), col_x (…, 3), col_y (…, 3), h_p (…, 3)): ``h_p`` is
    the homogeneous image of (x, y, 1), ``col_x``/``col_y`` the first two
    columns of H, so the image of (x+i, y+j, 1) is h_p + i col_x + j col_y.
    Operation order as in mpmvs_tpu/geometry.py:139-162: ``m / w`` and
    ``h_p[:2] / h_p[2]`` are divisions."""
    n, w = plane[..., :3], plane[..., 3:4]
    m = _matTvec(K_inv_pinhole(K_ref), n)
    scale = m / w
    col_x = A[..., :, 0] - b * scale[..., 0:1]
    col_y = A[..., :, 1] - b * scale[..., 1:2]
    col_1 = A[..., :, 2] - b * scale[..., 2:3]
    h_p = col_x * x[..., None] + col_y * y[..., None] + col_1
    pt = h_p[..., :2] / h_p[..., 2:3]
    return pt, col_x, col_y, h_p


def backproject_world(K: Tensor, R: Tensor, C: Tensor, x: Tensor, y: Tensor,
                      depth: Tensor) -> Tensor:
    """Pixel + depth -> world point: R^T (depth K^-1 p) + C
    (BackProjectPoint2W, PatchMatch.cu:582-602)."""
    Xc = backproject_cam(K, x, y, depth)
    return _matTvec(R, Xc) + C


def project_camera(K: Tensor, R: Tensor, t: Tensor, X: Tensor):
    """World point -> (pixel (…, 2), depth), with the full K rows like the
    reference (ProjectPoint, PatchMatch.cu:605-615)."""
    Xc = _matvec(R, X) + t
    h = _matvec(K, Xc)
    depth = h[..., 2]
    return h[..., :2] / depth[..., None], depth
