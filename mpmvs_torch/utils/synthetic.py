"""Synthetic multi-view scenes with exact ground truth.

The reference repo ships no test data and no tests (SURVEY.md §4); this
module provides deterministic, analytically-correct scenes — textured planes
observed by a ring of pinhole cameras — used by the unit/e2e tests and by
``bench.py``. Depth and normals are exact, so solver output can be scored
without external datasets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from mpmvs_torch.camera import Camera, CameraStack


def _smooth_noise(height: int, width: int, rng: np.random.Generator,
                  octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise in [0, 255] — textured enough for NCC."""
    out = np.zeros((height, width), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh = max(2, height // (2 ** (octaves - o + 1)))
        gw = max(2, width // (2 ** (octaves - o + 1)))
        grid = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, height, dtype=np.float32)
        xs = np.linspace(0, gw - 1, width, dtype=np.float32)
        y0 = np.floor(ys).astype(np.int32).clip(0, gh - 2)
        x0 = np.floor(xs).astype(np.int32).clip(0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        g = (grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
             + grid[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
             + grid[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
             + grid[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
        out += amp * g
        amp *= 0.6
    out -= out.min()
    out *= 255.0 / max(out.max(), 1e-6)
    return out


def _bilinear_np(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(x - np.floor(x), 0, 1)
    fy = np.clip(y - np.floor(y), 0, 1)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _look_at(C: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """World->camera rotation for a camera at C looking at target (+z forward)."""
    fwd = target - C
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    return R


@dataclasses.dataclass
class SyntheticScene:
    images: np.ndarray        # (V, H, W) float32 grayscale 0..255
    cameras: CameraStack      # stacked; index order matches images
    gt_depth: np.ndarray      # (V, H, W) exact depth per view
    gt_normal_world: np.ndarray  # (3,) world plane normal (unit, toward cameras)
    colors: np.ndarray        # (V, H, W, 3) float32 BGR (grayscale replicated)
    # multi-object scenes only: per-pixel world normals (V, H, W, 3)
    gt_normal_maps: Optional[np.ndarray] = None


def make_plane_scene(
    num_views: int = 3,
    height: int = 96,
    width: int = 128,
    focal: float = 0.0,   # 0 = auto: max(160, 1.25 * max(width, height))
    plane_normal: Tuple[float, float, float] = (0.0, 0.0, -1.0),
    plane_point: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    camera_distance: float = 4.0,
    baseline: float = 0.5,
    seed: int = 0,
    texture_scale: float = 200.0,
) -> SyntheticScene:
    """Cameras on a ring at z≈-camera_distance looking at a textured plane.

    The plane carries a smooth random texture parameterized by two in-plane
    axes; every rendered pixel and its depth are exact, making this a
    closed-form oracle for homography/NCC/solver tests.
    """
    # A fixed focal at large resolutions means an absurd FOV whose border
    # rays run parallel to the plane (denom->0 below): NaN depths poisoned
    # the 3200x2130 bench scene. Scale with resolution, but never below the
    # historical 160 the small test oracles were tuned against (<=128 px
    # scenes keep their exact pre-change geometry).
    if not focal:
        focal = max(160.0, 1.25 * max(width, height))
    rng = np.random.default_rng(seed)
    n = np.asarray(plane_normal, np.float64)
    n /= np.linalg.norm(n)
    p0 = np.asarray(plane_point, np.float64)
    # in-plane texture axes
    a = np.cross(n, [1.0, 0.0, 0.0])
    if np.linalg.norm(a) < 1e-6:
        a = np.cross(n, [0.0, 1.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(n, a)

    tex = _smooth_noise(1024, 1024, rng)

    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]], np.float64)

    images, cams, depths = [], [], []
    for v in range(num_views):
        if v == 0:
            offset = np.zeros(3)
        else:
            ang = 2 * np.pi * (v - 1) / max(num_views - 1, 1)
            offset = baseline * np.array([np.cos(ang), np.sin(ang), 0.12 * np.sin(2 * ang)])
        C = p0 - camera_distance * n + offset
        R = _look_at(C, p0)
        t = -R @ C

        xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                             np.arange(height, dtype=np.float64), indexing="xy")
        d_cam = np.stack([(xs - K[0, 2]) / K[0, 0],
                          (ys - K[1, 2]) / K[1, 1],
                          np.ones_like(xs)], axis=-1)
        d_world = d_cam @ R  # R^T applied to each ray
        denom = d_world @ n
        tparam = ((p0 - C) @ n) / denom
        X = C[None, None] + tparam[..., None] * d_world
        # depth along camera z: X_cam = R(X - C) = tparam * R d_world,
        # and R d_world = d_cam, whose z component is 1 -> depth == tparam.
        depth = tparam * (d_world @ R[2])
        u = (X - p0) @ a * texture_scale + tex.shape[1] / 2.0
        w_ = (X - p0) @ b * texture_scale + tex.shape[0] / 2.0
        img = _bilinear_np(tex, u, w_).astype(np.float32)

        z_min, z_max = float(depth.min()), float(depth.max())
        cams.append(Camera.create(K=K, R=R, t=t, width=width, height=height,
                                  depth_min=max(0.2 * z_min, 1e-3) ,
                                  depth_max=1.3 * z_max))
        images.append(img)
        depths.append(depth.astype(np.float32))

    # plane normal oriented toward the cameras (cameras sit at -n side)
    n_vis = -n
    colors = np.repeat(np.stack(images)[..., None], 3, axis=-1)
    return SyntheticScene(
        images=np.stack(images),
        cameras=CameraStack.stack(cams),
        gt_depth=np.stack(depths),
        gt_normal_world=n_vis.astype(np.float32),
        colors=colors,
    )


# ---------------------------------------------------------------------------
# Multi-object raytraced scene: depth discontinuities, occlusion, slanted and
# curved surfaces — the situations a fronto-parallel plane oracle cannot test
# (VERDICT r2 weak #8) and the input class the planar prior exists for.
# ---------------------------------------------------------------------------


def _ray_plane(C, d, p0, n):
    """t of ray C + t d hitting plane (p0, n); +inf if parallel/behind."""
    denom = d @ n
    t = ((p0 - C) @ n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    return np.where((np.abs(denom) > 1e-12) & (t > 1e-6), t, np.inf)


def _ray_sphere(C, d, center, radius):
    """Nearest positive t of ray-sphere intersection; +inf if missed."""
    oc = C - center
    a = np.sum(d * d, axis=-1)
    b = 2.0 * (d @ oc)
    c = oc @ oc - radius * radius
    disc = b * b - 4 * a * c
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = (-b - sq) / (2 * a)
    t1 = (-b + sq) / (2 * a)
    t = np.where(t0 > 1e-6, t0, t1)
    return np.where((disc > 0) & (t > 1e-6), t, np.inf)


def _ray_box(C, d, lo, hi):
    """Slab-method AABB intersection. Returns (t, axis, sign) of the entry
    face; t=+inf if missed."""
    safe_d = np.where(np.abs(d) < 1e-12, 1e-12, d)
    t_lo = (lo - C) / safe_d
    t_hi = (hi - C) / safe_d
    t1 = np.minimum(t_lo, t_hi)
    t2 = np.maximum(t_lo, t_hi)
    t_near = t1.max(axis=-1)
    t_far = t2.min(axis=-1)
    hit = (t_near < t_far) & (t_near > 1e-6)
    axis = t1.argmax(axis=-1)
    sign = -np.sign(np.take_along_axis(safe_d, axis[..., None], -1)[..., 0])
    return np.where(hit, t_near, np.inf), axis, sign


def make_shapes_scene(
    num_views: int = 7,
    height: int = 480,
    width: int = 640,
    focal: float = 0.0,
    camera_distance: float = 4.0,
    baseline: float = 0.7,
    seed: int = 7,
) -> SyntheticScene:
    """Raytraced scene: back wall + floor + tilted slab + box + sphere.

    Every pixel's depth and world normal are exact. Surfaces carry
    independent multi-octave textures plus fixed-light Lambertian shading
    (view-independent, so photo-consistency holds across views). Geometry
    spans roughly [-2, 2] in x/y with the wall at z=0 and cameras near
    z=-camera_distance; units are "meters" so eval thresholds like F1@2cm
    are meaningful.
    """
    if not focal:
        focal = max(160.0, 1.1 * max(width, height))
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]], np.float64)

    # Object table. Planes: (p0, n, tex axes auto). Box faces get their own
    # textures by axis; the sphere is textured by spherical angles.
    wall_n = np.array([0.0, 0.0, -1.0])
    floor_p0 = np.array([0.0, 1.2, 0.0])
    floor_n = np.array([0.0, -1.0, 0.0])
    # slanted slab leaning against the wall (tests slanted-plane bias)
    slab_n = np.array([0.25, 0.0, -1.0]); slab_n /= np.linalg.norm(slab_n)
    slab_p0 = np.array([-1.1, 0.0, -0.55])
    box_lo = np.array([0.25, 0.25, -0.85])
    box_hi = np.array([1.15, 1.2, -0.15])
    sph_c = np.array([-0.25, 0.55, -0.95])
    sph_r = 0.42

    n_objects = 6  # wall, floor, slab, box, sphere (+1 spare channel)
    textures = [_smooth_noise(768, 768, rng) for _ in range(n_objects)]
    # distinct mid-gray offsets so object borders are hard edges
    gains = [0.75, 0.6, 0.85, 0.7, 0.9, 0.8]
    light = np.array([0.35, -0.5, -0.77]); light /= np.linalg.norm(light)

    target = np.array([0.0, 0.45, -0.4])
    images, cams, depths, normals, colors = [], [], [], [], []
    for v in range(num_views):
        if v == 0:
            offset = np.zeros(3)
        else:
            ang = 2 * np.pi * (v - 1) / max(num_views - 1, 1)
            offset = baseline * np.array([np.cos(ang), 0.55 * np.sin(ang),
                                          0.1 * np.sin(2 * ang)])
        C = target + np.array([0.0, -0.15, -camera_distance]) + offset
        R = _look_at(C, target)
        t = -R @ C

        xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                             np.arange(height, dtype=np.float64), indexing="xy")
        d_cam = np.stack([(xs - K[0, 2]) / K[0, 0],
                          (ys - K[1, 2]) / K[1, 1],
                          np.ones_like(xs)], axis=-1)
        d = d_cam @ R  # world ray directions; t == camera-z depth

        t_wall = _ray_plane(C, d, np.zeros(3), wall_n)
        t_floor = _ray_plane(C, d, floor_p0, floor_n)
        # slab: bounded plane rectangle
        t_slab = _ray_plane(C, d, slab_p0, slab_n)
        X_slab = C + t_slab[..., None] * d
        sa = np.cross(slab_n, [0.0, 1.0, 0.0]); sa /= np.linalg.norm(sa)
        sb = np.cross(slab_n, sa)
        in_slab = ((np.abs((X_slab - slab_p0) @ sa) < 0.55)
                   & (np.abs((X_slab - slab_p0) @ sb) < 0.8))
        t_slab = np.where(in_slab, t_slab, np.inf)
        t_box, box_axis, box_sign = _ray_box(C, d, box_lo, box_hi)
        t_sph = _ray_sphere(C, d, sph_c, sph_r)

        ts = np.stack([t_wall, t_floor, t_slab, t_box, t_sph])
        obj = ts.argmin(axis=0)
        t_hit = ts.min(axis=0)
        # every ray hits wall or floor; guard regardless
        t_hit = np.where(np.isfinite(t_hit), t_hit, camera_distance * 4)
        X = C + t_hit[..., None] * d

        # world normals (toward the cameras, i.e. -z side)
        N = np.empty_like(X)
        N[obj == 0] = -wall_n
        N[obj == 1] = floor_n
        N[obj == 2] = -slab_n
        m = obj == 3
        if m.any():
            bn = np.zeros((int(m.sum()), 3))
            bn[np.arange(len(bn)), box_axis[m]] = box_sign[m]
            N[m] = bn
        m = obj == 4
        if m.any():
            sn = X[m] - sph_c
            N[m] = sn / np.linalg.norm(sn, axis=-1, keepdims=True)

        # texture coordinates per object
        uv = np.zeros(X.shape[:2] + (2,))
        for oid, (p0_o, ax_o) in enumerate([
                (np.zeros(3), (np.array([1.0, 0, 0]), np.array([0, 1.0, 0]))),
                (floor_p0, (np.array([1.0, 0, 0]), np.array([0, 0, 1.0]))),
                (slab_p0, (sa, sb))]):
            m = obj == oid
            if m.any():
                uv[m, 0] = (X[m] - p0_o) @ ax_o[0]
                uv[m, 1] = (X[m] - p0_o) @ ax_o[1]
        m = obj == 3
        if m.any():
            # project out the face-normal axis
            keep = np.stack([np.delete(np.arange(3), a) for a in box_axis[m]])
            Xm = X[m]
            uv[m, 0] = np.take_along_axis(Xm, keep[:, :1], -1)[:, 0]
            uv[m, 1] = np.take_along_axis(Xm, keep[:, 1:], -1)[:, 0]
        m = obj == 4
        if m.any():
            sn = (X[m] - sph_c) / sph_r
            uv[m, 0] = np.arctan2(sn[:, 0], sn[:, 2]) * 0.6
            uv[m, 1] = np.arcsin(np.clip(sn[:, 1], -1, 1)) * 0.6

        img = np.zeros(X.shape[:2], np.float32)
        tex_scale = 140.0
        for oid in range(5):
            m = obj == oid
            if not m.any():
                continue
            tex = textures[oid]
            u = uv[m, 0] * tex_scale + tex.shape[1] / 2.0
            w_ = uv[m, 1] * tex_scale + tex.shape[0] / 2.0
            u = np.mod(u, tex.shape[1] - 1)
            w_ = np.mod(w_, tex.shape[0] - 1)
            img[m] = _bilinear_np(tex, u, w_) * gains[oid]
        shade = 0.55 + 0.45 * np.clip((N * (-light)).sum(-1), 0.0, 1.0)
        img = np.clip(img * shade, 0.0, 255.0).astype(np.float32)

        depth = t_hit.astype(np.float32)
        z_min, z_max = float(depth.min()), float(depth.max())
        cams.append(Camera.create(K=K, R=R, t=t, width=width, height=height,
                                  depth_min=max(0.5 * z_min, 1e-3),
                                  depth_max=1.5 * z_max))
        images.append(img)
        depths.append(depth)
        normals.append(N.astype(np.float32))
        colors.append(np.repeat(img[..., None], 3, axis=-1))

    return SyntheticScene(
        images=np.stack(images),
        cameras=CameraStack.stack(cams),
        gt_depth=np.stack(depths),
        gt_normal_world=(-wall_n).astype(np.float32),
        colors=np.stack(colors),
        gt_normal_maps=np.stack(normals),
    )


def gt_point_cloud(scene: SyntheticScene, stride: int = 2) -> np.ndarray:
    """World-space GT cloud from every view's exact depth map (subsampled).

    Used as the reference cloud for eval_point_cloud (F1@tau) on synthetic
    scenes, standing in for a laser-scan GT."""
    pts = []
    V, H, W = scene.gt_depth.shape
    for v in range(V):
        cam = scene.cameras.view(v)
        K = np.asarray(cam.K, np.float64)
        R = np.asarray(cam.R, np.float64)
        C = np.asarray(cam.C, np.float64)
        ys, xs = np.mgrid[0:H:stride, 0:W:stride]
        d = scene.gt_depth[v, ::stride, ::stride]
        rays = np.stack([(xs - K[0, 2]) / K[0, 0],
                         (ys - K[1, 2]) / K[1, 1],
                         np.ones_like(xs, np.float64)], axis=-1)
        pts.append((C + (rays @ R) * d[..., None]).reshape(-1, 3))
    return np.concatenate(pts).astype(np.float32)
