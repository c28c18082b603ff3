"""Helpers for the tests that hold mpmvs_torch against mpmvs_tpu.

Data crosses between the packages as numpy arrays only. Tolerances are
stated where they are used; the common one for float fields is the
fraction of entries that differ by more than an absolute threshold, because
the two packages round differently (XLA's CPU backend fuses multiply-adds,
PyTorch's eager ops do not), and one ulp of a tap coordinate can move a tap
to another texel.
"""

from __future__ import annotations

import numpy as np
import torch

from mpmvs_torch import interop

CAMERA_FIELDS = ("K", "R", "t", "width", "height", "depth_min", "depth_max")


def t(a, dtype=None) -> torch.Tensor:
    """numpy/JAX array -> CPU torch tensor (copied)."""
    out = torch.as_tensor(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(a) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def cams(jax_cams):
    """A JAX CameraStack as the port's CameraStack."""
    return interop.camera_stack_from_numpy(
        {f: np.asarray(getattr(jax_cams, f)) for f in CAMERA_FIELDS})


def frac_beyond(a, b, tol: float) -> float:
    """Fraction of entries whose |a - b| exceeds ``tol``; entries NaN in both
    or equal (e.g. both +inf) count as agreeing."""
    a, b = n(a).astype(np.float64), n(b).astype(np.float64)
    with np.errstate(invalid="ignore"):
        same = (a == b) | (np.isnan(a) & np.isnan(b)) | (np.abs(a - b) <= tol)
    return float(1.0 - same.mean())
