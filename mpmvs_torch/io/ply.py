"""Binary little-endian PLY point-cloud writer/reader.

Matches the reference's output layout — x y z nx ny nz red green blue with
colors stored in RGB order after a BGR swap at write time
(StoreColorPlyFileBinaryPointCloud, src/PatchMatch.cpp:145-198).
"""

from __future__ import annotations

import numpy as np

_DTYPE = np.dtype([
    ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
    ("red", "u1"), ("green", "u1"), ("blue", "u1"),
])


def write_ply_binary(path: str, points: np.ndarray, normals: np.ndarray,
                     colors_bgr: np.ndarray) -> None:
    """points/normals float32 (N, 3); colors_bgr float or uint8 (N, 3) in BGR
    order (as read from images); written to file as RGB."""
    n = points.shape[0]
    rec = np.empty(n, dtype=_DTYPE)
    pts = np.asarray(points, np.float32)
    # non-finite coordinates are zeroed like the reference (PatchMatch.cpp:178-182)
    bad = ~np.isfinite(pts).all(axis=1)
    pts = np.where(bad[:, None], 0.0, pts)
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    nrm = np.asarray(normals, np.float32)
    rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    col = np.asarray(colors_bgr).astype(np.int32).clip(-128, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = col[:, 2], col[:, 1], col[:, 0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply_binary(path: str):
    """Read a PLY written by :func:`write_ply_binary`. Returns (points,
    normals, colors_rgb_uint8)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            header += line
        n = 0
        for line in header.decode("ascii").splitlines():
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
        rec = np.fromfile(f, dtype=_DTYPE, count=n)
    points = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1)
    colors = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
    return points, normals, colors
