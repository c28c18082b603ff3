"""Reproducible per-pixel random hypothesis generation.

Counterpart of ``mpmvs_tpu.ops.random``. Every draw is a pure function of an
explicit threefry key (ops/threefry.py), so the port draws the same numbers
as the JAX package from the same key. Distributions as in the reference
(GenerateRandomNormal, PatchMatch.cu:197-219; GeneratePerturbedNormal,
PatchMatch.cu:460-495; depth U(depth_min, depth_max)), with the JAX
package's documented deviations (cone init normals, smooth tile-banded
depth draws).
"""

from __future__ import annotations

import math

import torch

from mpmvs_torch import geometry as geo
from mpmvs_torch.ops import threefry as tf

Tensor = torch.Tensor
M32 = tf.M32


def _norm3(v: Tensor) -> Tensor:
    return torch.sqrt(geo.dot3(v, v))[..., None]


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def random_unit_sphere(key: Tensor, shape) -> Tensor:
    v = tf.normal(key, tuple(shape) + (3,))
    return v / _norm3(v).clamp(min=1e-12)


def face_camera(normal: Tensor, K: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Flip normals pointing away from the camera, then renormalize
    (PatchMatch.cu:210-217)."""
    view = geo.view_direction(K, x, y)
    dot = geo.dot3(normal, view)[..., None]
    flipped = torch.where(dot > 0.0, -normal, normal)
    return flipped / _norm3(flipped).clamp(min=1e-12)


def random_normal_field(key: Tensor, K: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """(H, W, 3) random unit normals facing the camera."""
    return face_camera(random_unit_sphere(key, x.shape), K, x, y)


def cone_normal_field(key: Tensor, K: Tensor, x: Tensor, y: Tensor,
                      max_angle_rad: float) -> Tensor:
    """(H, W, 3) random unit normals within ``max_angle_rad`` of the
    anti-viewing direction, uniform in cos over the cone (the JAX package's
    init deviation, ``PatchMatchParams.init_normal_cone_deg``)."""
    view = geo.view_direction(K, x, y)
    axis = -view / _norm3(view).clamp(min=1e-12)
    k_c, k_p = tf.split(key)
    cos_t = tf.uniform(k_c, x.shape, math.cos(max_angle_rad), 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = tf.uniform(k_p, x.shape, 0.0, 2.0 * math.pi)
    ex = torch.tensor([1.0, 0.0, 0.0], device=x.device)
    ey = torch.tensor([0.0, 1.0, 0.0], device=x.device)
    h = torch.where(torch.abs(axis[..., 0:1]) < 0.9, ex, ey)
    u = _cross(axis, h.expand(axis.shape))
    u = u / _norm3(u).clamp(min=1e-12)
    v = _cross(axis, u)
    n = (axis * cos_t[..., None]
         + (u * torch.cos(phi)[..., None] + v * torch.sin(phi)[..., None])
         * sin_t[..., None])
    return n / _norm3(n).clamp(min=1e-12)


def random_plane_field(key: Tensor, K: Tensor, x: Tensor, y: Tensor,
                       depth_min, depth_max) -> Tensor:
    """(H, W, 4) random plane hypotheses (GenerateRandomPlaneHypothesis,
    PatchMatch.cu:221-226)."""
    k_n, k_d = tf.split(key)
    normal = random_normal_field(k_n, K, x, y)
    depth = tf.uniform(k_d, x.shape, depth_min, depth_max)
    return geo.plane_from_depth_normal(K, x, y, depth, normal)


def _mul32(a: Tensor, c: int) -> Tensor:
    """(a * c) mod 2^32 for uint32 ``a`` held in int64 and a uint32 const."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _hash_u01(a: Tensor, b: Tensor, seed: Tensor) -> Tensor:
    """Stateless integer hash of global tile coordinates -> float in [0, 1),
    bit-identical to mpmvs_tpu/ops/random.py:93-103."""
    a = a.to(torch.int64) & M32
    b = b.to(torch.int64) & M32
    x = (_mul32(a, 0x9E3779B1) ^ _mul32(b, 0x85EBCA77)) ^ seed
    x = _mul32(x ^ (x >> 15), 0x2C1B3C6D)
    x = _mul32(x ^ (x >> 12), 0x297A2D39)
    x = x ^ (x >> 15)
    return (x >> 8).to(torch.float32) / float(1 << 24)


def smooth_banded_uniform(seed_key: Tensor, jitter_key: Tensor, x: Tensor,
                          y: Tensor, minval, maxval, frac: float,
                          tile=(8, 256), knot_tiles=(32, 8),
                          tile_noise: float = 2.0) -> Tensor:
    """Spatially-smooth tile-banded uniform draw over [minval, maxval]
    (mpmvs_tpu/ops/random.py:106-156): band centres bilinearly interpolate
    hashed knots every ``knot_tiles`` tiles, plus a hashed per-tile offset
    and a per-pixel jitter of ±half a band. ``frac >= 1`` is the plain
    full-range uniform draw."""
    if frac >= 1.0:
        return tf.uniform(jitter_key, x.shape, minval, maxval)
    seeds = tf.bits(seed_key, (2,))
    th, tw = tile
    kty, ktx = knot_tiles
    ty = torch.div(y.to(torch.int32), th, rounding_mode="floor").to(torch.float32)
    tx = torch.div(x.to(torch.int32), tw, rounding_mode="floor").to(torch.float32)
    gy = ty / kty
    gx = tx / ktx
    i0 = torch.floor(gy)
    j0 = torch.floor(gx)
    fy = gy - i0
    fx = gx - j0
    u = lambda di, dj: _hash_u01(i0 + di, j0 + dj, seeds[0])
    c = ((1 - fy) * ((1 - fx) * u(0, 0) + fx * u(0, 1))
         + fy * ((1 - fx) * u(1, 0) + fx * u(1, 1)))
    minval = tf._as_f32(minval, x.device)
    maxval = tf._as_f32(maxval, x.device)
    rng = maxval - minval
    half = 0.5 * frac * rng
    center = minval + half + c * (rng - 2.0 * half)
    noise = (_hash_u01(ty, tx, seeds[1]) * 2.0 - 1.0) * tile_noise * half
    jitter = tf.uniform(jitter_key, x.shape, -half, half)
    return torch.minimum(torch.maximum(center + noise + jitter, minval), maxval)


def euler_xyz(a1: Tensor, a2: Tensor, a3: Tensor) -> Tensor:
    """(…, 3, 3) rotation from XYZ Euler angles, the matrix of
    GeneratePerturbedNormal (PatchMatch.cu:475-484)."""
    s1, s2, s3 = torch.sin(a1), torch.sin(a2), torch.sin(a3)
    c1, c2, c3 = torch.cos(a1), torch.cos(a2), torch.cos(a3)
    row0 = torch.stack([c2 * c3, c3 * s1 * s2 - c1 * s3, s1 * s3 + c1 * c3 * s2], -1)
    row1 = torch.stack([c2 * s3, c1 * c3 + s1 * s2 * s3, c1 * s2 * s3 - c3 * s1], -1)
    row2 = torch.stack([-s2, c2 * s1, c1 * c2], -1)
    return torch.stack([row0, row1, row2], -2)


def perturbed_normal_field(key: Tensor, K: Tensor, x: Tensor, y: Tensor,
                           normal: Tensor, perturbation) -> Tensor:
    """Randomly rotated normals; draws that would face away from the camera
    keep the original normal (PatchMatch.cu:489-491)."""
    ang = (tf.uniform(key, tuple(x.shape) + (3,)) - 0.5) * perturbation
    R = euler_xyz(ang[..., 0], ang[..., 1], ang[..., 2])
    rotated = geo._matvec(R, normal)
    view = geo.view_direction(K, x, y)
    away = geo.dot3(rotated, view)[..., None] >= 0.0
    rotated = rotated / _norm3(rotated).clamp(min=1e-12)
    return torch.where(away, normal, rotated)
