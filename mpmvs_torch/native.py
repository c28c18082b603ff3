"""ctypes bindings of the native host library (``native/mpmvs_native.cpp``).

Counterpart of ``mpmvs_tpu.native``: the reference-ordered exact
sequential fusion (the reference's pixel-serial consumed-mask order,
RunFusion, PatchMatch.cpp:352-499) and a Bowyer-Watson Delaunay. The tests
hold the port's fusion (``fusion.run_fusion``) and its Delaunay users to
them. The C++ source is shared with the JAX package and has no JAX in it;
``build`` compiles it with ``g++ -O2 -shared -fPIC`` into
``mpmvs_torch/_build/`` (never into ``native/``). Inputs are numpy arrays
or torch tensors, moved to the host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "mpmvs_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_lib = None


class _CameraParams(ctypes.Structure):
    _fields_ = [("K", ctypes.c_float * 9), ("R", ctypes.c_float * 9),
                ("t", ctypes.c_float * 3)]


_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _lib_path() -> Optional[str]:
    """The library built from the current source (its hash in the name),
    or None without the source."""
    if not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libmpmvs_native_{digest}.so")


def build(force: bool = False) -> bool:
    """Compile the library into ``mpmvs_torch/_build/`` (idempotent; the
    file appears whole, so concurrent builds are safe). False without the
    source or ``g++``, or when the compile fails."""
    path = _lib_path()
    if path is None or shutil.which("g++") is None:
        return False
    if os.path.exists(path) and not force:
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                        "-o", tmp, SOURCE], check=True, capture_output=True)
        os.replace(tmp, path)
    except subprocess.CalledProcessError:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return True


def _load():
    global _lib
    path = _lib_path()
    if _lib is None and path is not None and os.path.exists(path):
        lib = ctypes.CDLL(path)
        lib.mpmvs_fuse_exact.restype = ctypes.c_int64
        lib.mpmvs_fuse_exact.argtypes = [
            _F32P, _F32P, _F32P, ctypes.POINTER(_CameraParams),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _I32P, _I32P,
            ctypes.c_int32, _I32P, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, _F32P, _F32P, _F32P, ctypes.c_int64]
        lib.mpmvs_delaunay.restype = ctypes.c_int64
        lib.mpmvs_delaunay.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, _I32P,
            ctypes.c_int64]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _host(a, dtype) -> np.ndarray:
    """A numpy array or torch tensor as a contiguous host array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype)


def _cams_array(cameras) -> ctypes.Array:
    K, R, t = (_host(getattr(cameras, f), np.float32) for f in "KRt")
    arr = (_CameraParams * K.shape[0])()
    for i in range(K.shape[0]):
        arr[i].K[:] = K[i].reshape(-1).tolist()
        arr[i].R[:] = R[i].reshape(-1).tolist()
        arr[i].t[:] = t[i].tolist()
    return arr


def fuse_exact(depths, normals, colors, cameras, scenes,
               use_dynamic: bool = True, sky_masks=None):
    """Reference-ordered sequential fusion with the interface and result
    contract of ``fusion.run_fusion`` (numpy points, normals, colours), but
    the reference's within-view pixel-serial mask order. ``cameras`` is a
    ``CameraStack`` (any object with K, R, t of V views)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (mpmvs_torch.native."
                           "build())")
    depths = _host(depths, np.float32)
    normals = _host(normals, np.float32)
    colors = _host(colors, np.float32)
    V, H, W = depths.shape
    if normals.shape != (V, H, W, 3) or colors.shape != (V, H, W, 3):
        raise ValueError(f"normals {normals.shape} and colors {colors.shape} "
                         f"must be {(V, H, W, 3)}")
    est = [s for s in scenes if s.estimate]
    refs = np.asarray([s.ref_id for s in est], np.int32)
    src_lists = [np.asarray(s.src_ids[1:], np.int32) for s in est]
    if any(not 0 <= v < V for v in refs.tolist()
           + [int(x) for s in src_lists for x in s]):
        raise ValueError(f"scene ids must index the {V} views")
    off = np.zeros(len(est) + 1, np.int32)
    off[1:] = np.cumsum([len(s) for s in src_lists])
    src_flat = (np.concatenate(src_lists) if src_lists
                else np.zeros(0, np.int32)).astype(np.int32)

    cap = V * H * W
    out_pts = np.empty((cap, 3), np.float32)
    out_nrm = np.empty((cap, 3), np.float32)
    out_col = np.empty((cap, 3), np.float32)
    sky_ptr = None
    if sky_masks is not None:
        sky = _host(sky_masks, np.uint8)
        if sky.shape != (V, H, W):
            raise ValueError(f"sky_masks {sky.shape} must be {(V, H, W)}")
        sky_ptr = sky.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    p = lambda a: a.ctypes.data_as(_F32P)
    pi = lambda a: a.ctypes.data_as(_I32P)
    n = lib.mpmvs_fuse_exact(
        p(depths), p(normals), p(colors), _cams_array(cameras), V, H, W,
        pi(src_flat), pi(off), len(est), pi(refs), sky_ptr,
        1 if use_dynamic else 0, p(out_pts), p(out_nrm), p(out_col), cap)
    if n < 0:
        raise RuntimeError("native fusion capacity exceeded")
    return out_pts[:n].copy(), out_nrm[:n].copy(), out_col[:n].copy()


def delaunay(points) -> np.ndarray:
    """(N, 2) -> (T, 3) triangle vertex indices (native Bowyer-Watson)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (mpmvs_torch.native."
                           "build())")
    pts = _host(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points must be (N, 2), got {pts.shape}")
    cap = max(4 * len(pts), 64)
    out = np.empty((cap, 3), np.int32)
    cnt = lib.mpmvs_delaunay(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts),
        out.ctypes.data_as(_I32P), cap)
    if cnt < 0:
        raise RuntimeError("native delaunay capacity exceeded")
    return out[:cnt].copy()
