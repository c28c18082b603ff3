"""COLMAP sparse-model readers (.txt and .bin).

The port's own copy of ``mpmvs_tpu.preprocess.colmap`` (numpy only; the
JAX package's ``__init__`` imports jax, so the port does not import it):
the public COLMAP formats (capability parity with
colmap2mvsnet_acm.py:20-277). Binary layouts follow the COLMAP
documentation: cameras.bin / images.bin / points3D.bin little-endian.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}

# which parameter names each model carries, in order
MODEL_PARAM_NAMES = {
    "SIMPLE_PINHOLE": ["f", "cx", "cy"],
    "PINHOLE": ["fx", "fy", "cx", "cy"],
    "SIMPLE_RADIAL": ["f", "cx", "cy", "k"],
    "SIMPLE_RADIAL_FISHEYE": ["f", "cx", "cy", "k"],
    "RADIAL": ["f", "cx", "cy", "k1", "k2"],
    "RADIAL_FISHEYE": ["f", "cx", "cy", "k1", "k2"],
    "OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2"],
    "OPENCV_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4"],
    "FULL_OPENCV": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                    "k3", "k4", "k5", "k6"],
    "FOV": ["fx", "fy", "cx", "cy", "omega"],
    "THIN_PRISM_FISHEYE": ["fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2",
                           "k3", "k4", "sx1", "sy1"],
}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        names = MODEL_PARAM_NAMES[self.model]
        p = dict(zip(names, self.params))
        fx = p.get("fx", p.get("f"))
        fy = p.get("fy", p.get("f"))
        return np.array([[fx, 0, p["cx"]], [0, fy, p["cy"]], [0, 0, 1]],
                        np.float64)


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ----------------------------- text readers -----------------------------

def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    for line in _data_lines(path):
        parts = line.split()
        cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        out[cid] = ColmapCamera(cid, model, w, h,
                                np.array([float(v) for v in parts[4:]]))
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    lines = list(_data_lines(path))
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(v) for v in parts[1:5]])
        tvec = np.array([float(v) for v in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        feats = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([float(v) for v in feats]).reshape(-1, 3)
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                               xys[:, :2], xys[:, 2].astype(np.int64))
    return out


def read_points3d_text(path: str) -> Dict[int, ColmapPoint3D]:
    out = {}
    for line in _data_lines(path):
        parts = line.split()
        pid = int(parts[0])
        xyz = np.array([float(v) for v in parts[1:4]])
        rgb = np.array([int(v) for v in parts[4:7]])
        err = float(parts[7])
        track = np.array([int(v) for v in parts[8:]]).reshape(-1, 2)
        out[pid] = ColmapPoint3D(pid, xyz, rgb, err, track[:, 0], track[:, 1])
    return out


# ----------------------------- binary readers -----------------------------

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * num_pts),
                                 dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                   name.decode("utf-8"),
                                   np.stack([data["x"], data["y"]], -1),
                                   data["id"].copy())
    return out


def read_points3d_binary(path: str) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len),
                                  dtype=[("im", "<i4"), ("pt", "<i4")])
            out[pid] = ColmapPoint3D(int(pid), xyz, rgb, err,
                                     track["im"].copy(), track["pt"].copy())
    return out


def read_model(model_dir: str, ext: str = ".txt"):
    """(cameras, images, points3d) dicts from a COLMAP sparse directory."""
    if ext == ".txt":
        return (read_cameras_text(os.path.join(model_dir, "cameras.txt")),
                read_images_text(os.path.join(model_dir, "images.txt")),
                read_points3d_text(os.path.join(model_dir, "points3D.txt")))
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(model_dir, "cameras.bin")),
                read_images_binary(os.path.join(model_dir, "images.bin")),
                read_points3d_binary(os.path.join(model_dir, "points3D.bin")))
    raise ValueError(f"unknown model ext {ext!r}")
