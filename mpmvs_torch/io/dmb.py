"""`.dmb` binary map I/O — byte-compatible with the reference format.

Layout (reference: utility.cpp:193-308): four little-endian int32s
``type(=1), h, w, nb`` followed by ``h*w*nb`` float32s, row-major with the
channel fastest. Depth/cost maps use nb=1, normal maps nb=3.
"""

from __future__ import annotations

import numpy as np


def read_dmb(path: str) -> np.ndarray:
    """Read a .dmb file -> float32 array (h, w) if nb==1 else (h, w, nb)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype="<i4", count=4)
        if header.size != 4:
            raise ValueError(f"{path}: truncated .dmb header")
        dtype_tag, h, w, nb = (int(v) for v in header)
        if dtype_tag != 1:
            raise ValueError(f"{path}: unsupported .dmb type {dtype_tag} (expected 1=float32)")
        data = np.fromfile(f, dtype="<f4", count=h * w * nb)
    if data.size != h * w * nb:
        raise ValueError(f"{path}: truncated .dmb payload")
    return data.reshape(h, w) if nb == 1 else data.reshape(h, w, nb)


def write_dmb(path: str, array: np.ndarray) -> None:
    """Write a float32 array (h, w) or (h, w, nb) as a .dmb file."""
    array = np.asarray(array, dtype="<f4")
    if array.ndim == 2:
        h, w, nb = array.shape[0], array.shape[1], 1
    elif array.ndim == 3:
        h, w, nb = array.shape
    else:
        raise ValueError(f"expected 2D or 3D array, got shape {array.shape}")
    with open(path, "wb") as f:
        np.array([1, h, w, nb], dtype="<i4").tofile(f)
        array.tofile(f)


def read_eth3d_gt(path: str, height: int = 4032, width: int = 6048) -> np.ndarray:
    """Raw float32 ETH3D ground-truth depth (reference: readGT, utility.cpp:37-54)."""
    data = np.fromfile(path, dtype="<f4", count=height * width)
    return data.reshape(height, width)


def write_eth3d_gt(path: str, depth: np.ndarray) -> None:
    np.asarray(depth, dtype="<f4").tofile(path)


def read_colmap_dmap(path: str) -> np.ndarray:
    """COLMAP .dmap/.bin map: ASCII ``w&h&d&`` header then float32 payload
    (reference: readColmapDmap, utility.cpp:155-191, with its header-reparse
    bug fixed: the payload starts right after the ASCII header)."""
    with open(path, "rb") as f:
        blob = f.read()
    pos, fields = 0, []
    for _ in range(3):
        amp = blob.index(b"&", pos)
        fields.append(int(blob[pos:amp]))
        pos = amp + 1
    w, h, d = fields
    data = np.frombuffer(blob, dtype="<f4", offset=pos, count=h * w * d)
    return data.reshape(h, w) if d == 1 else data.reshape(h, w, d)
