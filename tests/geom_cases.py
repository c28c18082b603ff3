"""Inputs that hold the geometric-cost kernel (``csrc/geom_cost.cu``) to its
plain twin, shared by test_torch_geom_cost.py (the kernel's arithmetic
compiled for the host) and test_torch_kernel_cuda.py (the kernel on the
card). Imports only the port, so the card's tests can use it without JAX.

Each case is (cameras, planes, x, y, max_cost): the twin's arguments
after ``CAM_FIELDS`` order, on the device of the scene's data."""

from __future__ import annotations

import numpy as np
import torch

from mpmvs_torch.solver import build_solve_data
from mpmvs_torch.utils.synthetic import make_plane_scene

H, W = 40, 56
CAM_FIELDS = ("src_depths", "src_widths", "src_heights", "K_ref", "R_ref",
              "C_ref", "t_ref", "K_src", "R_src", "t_src", "C_src")


def scene_data(device="cpu"):
    """A 1+3-view plane scene and its SolveData on ``device``, with the
    sources' true depths x (1 +- 1%), 5% of them zeroed."""
    scene = make_plane_scene(num_views=4, height=H, width=W, seed=6)
    rng = np.random.default_rng(3)
    src = (scene.gt_depth[1:] * rng.uniform(0.99, 1.01, (3, H, W))).astype(
        np.float32)
    src[rng.uniform(size=src.shape) < 0.05] = 0.0
    data = build_solve_data(torch.as_tensor(scene.images, device=device),
                            scene.cameras.to(device),
                            torch.as_tensor(src, device=device))
    return scene, data


def cams(data, S: int = 3) -> dict:
    """The twin's camera and depth arguments with S sources (the 3 of the
    scene repeated, each repeat narrower and shorter by 2 px)."""
    reps = -(-S // 3)
    args = {f: getattr(data, f) for f in CAM_FIELDS}
    for f in ("src_depths", "K_src", "R_src", "t_src", "C_src"):
        args[f] = torch.cat([args[f]] * reps)[:S].contiguous()
    shrink = torch.arange(reps, dtype=torch.float32, device=data.K_ref.device
                          ).repeat_interleave(3)[:S]
    for f in ("src_widths", "src_heights"):
        args[f] = (torch.cat([args[f]] * reps)[:S] - 2.0 * shrink).contiguous()
    return args


def packed(data, rows: int, cols: int, r0: int = 3, c0: int = 2):
    """Pixel coordinates of a rows x cols block, as the band step's packed
    x_p, y_p (float32 (rows, cols))."""
    y, x = np.mgrid[r0:r0 + rows, c0:c0 + cols].astype(np.float32)
    dev = data.K_ref.device
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


def planes(scene, data, K: int, seed: int, x, y, wild: bool = True):
    """K hypothesis fields (K, ..., 4) at the pixels (x, y): the true plane
    with depths x (1 +- 3%) and tilted normals; with ``wild`` and K > 1 the
    last one a full-range random field (normals anywhere on the sphere,
    depths 0.2-5x the true ones), whose points fall behind sources and off
    their edges."""
    rng = np.random.default_rng(seed)
    Kr = data.K_ref.cpu().numpy()
    xn, yn = x.cpu().numpy(), y.cpu().numpy()
    gt = scene.gt_depth[0][np.clip(yn.astype(int), 0, H - 1),
                           np.clip(xn.astype(int), 0, W - 1)]
    n_cam = data.R_ref.cpu().numpy() @ scene.gt_normal_world
    ray = np.stack([(xn - Kr[0, 2]) / Kr[0, 0], (yn - Kr[1, 2]) / Kr[1, 1],
                    np.ones_like(xn)], -1)
    out = []
    for k in range(K):
        if wild and k == K - 1 and K > 1:
            d = gt * rng.uniform(0.2, 5.0, gt.shape)
            nrm = rng.normal(size=gt.shape + (3,))
        else:
            d = gt * rng.uniform(0.97, 1.03, gt.shape)
            nrm = n_cam + rng.normal(0, 0.1, gt.shape + (3,))
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        w = -(nrm * ray * d[..., None]).sum(-1, keepdims=True)
        out.append(np.concatenate([nrm, w], -1))
    return torch.as_tensor(np.stack(out).astype(np.float32),
                           device=data.K_ref.device)


def call(fn, c: dict, plane, x, y, max_cost: float = 3.0):
    return fn(*(c[f] for f in CAM_FIELDS), plane, x, y, max_cost)


def stacked_case(scene, data, K: int, S: int):
    """K fields at 13 x 21 = 273 pixels (off a 256-thread block) against S
    sources."""
    x, y = packed(data, 13, 21)
    return [(cams(data, S), planes(scene, data, K, 10 * K + S, x, y), x, y,
             3.0)]


def layout_cases(scene, data):
    """One field (rows, cols, 4) as the band step passes the current
    plane; a non-contiguous slice of a field stack with pixels per entry
    (one field over every entry); a non-contiguous (K, P, 4) column with a
    max_cost other than 3; pixels (rows, 1) that broadcast along a field's
    columns (not its trailing shape: one field over every entry)."""
    c = cams(data, 10)
    x, y = packed(data, 9, 30)
    p = planes(scene, data, 4, 2, x, y)
    strided = p.permute(1, 0, 2, 3)[:, ::2]            # (9, 2, 30, 4)
    sx, sy = x[:, None].expand(9, 2, 30), y[:, None].expand(9, 2, 30)
    return [(c, p[1], x, y, 3.0), (c, strided, sx, sy, 3.0),
            (c, p[:, :, 3], x[:, 3], y[:, 3], 1.5),
            (c, p[2], x[:, 4:5], y[:, 4:5], 3.0)]


def degenerate_case(scene, data):
    """Five fields with degenerate entries on every fifth pixel in turn:
    zero denominators (n = 0), w = 0, NaN and infinite entries, a huge
    normal component; one normal at right angles to its pixel's ray (a
    denominator near 0)."""
    x, y = packed(data, 11, 27)
    p = planes(scene, data, 5, 7, x, y)
    flat = p.reshape(-1, 4)
    dev = p.device
    flat[0::35] = torch.tensor([0.0, 0.0, 0.0, -2.0], device=dev)
    flat[5::35, 3] = 0.0
    flat[10::35, 0] = float("nan")
    flat[15::35, 3] = float("inf")
    flat[20::35, 2] = float("-inf")
    flat[25::35] = torch.tensor([0.0, 0.0, 0.0, 0.0], device=dev)
    flat[30::35, 1] = 1e30
    Kr = data.K_ref
    rx = (x[5, 13] - Kr[0, 2]) / Kr[0, 0]
    ry = (y[5, 13] - Kr[1, 2]) / Kr[1, 1]
    p[0, 5, 13] = torch.stack([ry, -rx, torch.zeros_like(rx),
                               -torch.ones_like(rx)])
    return [(cams(data, 10), p, x, y, 3.0)]


def edge_cases(scene, data):
    """Zero, negative, NaN and infinite source depths; sources of zero
    extent (the sharded pipeline's padding source; as source 0 its flat
    index falls below the stack's start and counts from its end), of one
    row, narrower and shorter than the padded stack, and wider and taller
    (clamped to the stack); far planes and a shifted field, whose
    projections leave every edge of the sources. At the solver's cap and
    at a cap no error reaches, where every fetched depth shows."""
    c = cams(data, 6)
    dev = data.K_ref.device
    d = c["src_depths"].clone()
    d[0, ::3, ::4] = 0.0
    d[1, 1::5, ::3] = float("nan")
    d[2, ::4, 2::5] = float("inf")
    d[3, 2::7] = float("-inf")
    d[4, ::5, 1::4] = -1.5
    c["src_depths"] = d
    c["src_widths"] = torch.tensor([0, W - 9, W + 13, W, W - 30, W],
                                   dtype=torch.float32, device=dev)
    c["src_heights"] = torch.tensor([0, H + 7, H - 11, 1, H - 20, H],
                                    dtype=torch.float32, device=dev)
    x, y = packed(data, 17, 40, 1, 1)
    near = planes(scene, data, 3, 9, x, y)
    far = near.clone()
    far[..., 3] *= 40.0                           # depths x 40
    shifted = planes(scene, data, 3, 9, x - 60.0, y + 35.0)
    p = torch.cat([near, far, shifted])
    return [(c, p, x, y, cap) for cap in (3.0, 1e6)]


def axis_case(scene, data):
    """Cameras at the origin looking down z with principal points at 0, a
    fronto-parallel plane, pixels from (0, 0): on the image axes the
    projections' and back-projections' dividends are exactly 0 and at the
    origin the squared error too, so the kernel's fast paths are out of
    their range there and the IEEE operators give the entry (finite costs
    below the cap; every fifth column of the third source's depths 0)."""
    dev = data.K_ref.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    K = lambda f: [[f, 0.0, 0.0], [0.0, f, 0.0], [0.0, 0.0, 1.0]]
    rng = np.random.default_rng(8)
    depths = rng.uniform(1.9, 2.1, (3, 20, 24))
    depths[2, :, ::5] = 0.0  # capped entries
    c = {"src_depths": f32(depths),
         "src_widths": f32([24, 24, 20]), "src_heights": f32([20, 18, 20]),
         "K_ref": f32(K(100.0)), "R_ref": f32(np.eye(3)),
         "C_ref": f32(np.zeros(3)), "t_ref": f32(np.zeros(3)),
         "K_src": f32([K(100.0), K(80.0), K(120.0)]),
         "R_src": f32(np.stack([np.eye(3)] * 3)),
         "t_src": f32(np.zeros((3, 3))), "C_src": f32(np.zeros((3, 3)))}
    y, x = np.mgrid[0:12, 0:16].astype(np.float32)
    planes = f32([[[[0.0, 0.0, 1.0, -d]] * 16] * 12 for d in (2.0, 1.9,
                                                              2.05)])
    return [(c, planes, f32(x), f32(y), 3.0)]


def same(got, want) -> bool:
    """Equal shapes, equal entry for entry, NaN for NaN."""
    return got.shape == want.shape and bool(
        ((got == want) | (torch.isnan(got) & torch.isnan(want))).all())
