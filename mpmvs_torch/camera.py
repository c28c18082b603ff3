"""Pinhole camera model.

Counterpart of ``mpmvs_tpu.camera`` (the reference's ``Camera`` struct and
``ReadCamera``, include/PatchMatch.h:35-46, src/PatchMatch.cpp:111-143) as
frozen dataclasses of float32 tensors with the same field names and layouts.
Cameras for one scene are kept *stacked* (leading view axis).

Conventions (identical to the reference):
  - ``R``/``t`` are world->camera: ``x_cam = R @ X_world + t``.
  - camera center ``C = -R^T @ t``.
  - ``K`` is the 3x3 pinhole intrinsic matrix (no skew in the homography).
  - the solver widens the depth range to ``[0.6*min, 1.2*max]``
    (src/PatchMatch.cpp:929-930).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

_FIELDS = ("K", "R", "t", "width", "height", "depth_min", "depth_max")


def _f32(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device if device is not None else a.device,
                    dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single pinhole camera. Tensors are float32."""

    K: torch.Tensor          # (3, 3)
    R: torch.Tensor          # (3, 3)
    t: torch.Tensor          # (3,)
    width: torch.Tensor      # ()
    height: torch.Tensor     # ()
    depth_min: torch.Tensor  # ()
    depth_max: torch.Tensor  # ()

    @property
    def C(self) -> torch.Tensor:
        """Camera center in world coordinates: -R^T t."""
        return -(self.R.T @ self.t)

    @staticmethod
    def create(K, R, t, width, height, depth_min=0.0, depth_max=1.0,
               device=None) -> "Camera":
        return Camera(
            K=_f32(K, device).reshape(3, 3),
            R=_f32(R, device).reshape(3, 3),
            t=_f32(t, device).reshape(3),
            width=_f32(width, device).reshape(()),
            height=_f32(height, device).reshape(()),
            depth_min=_f32(depth_min, device).reshape(()),
            depth_max=_f32(depth_max, device).reshape(()),
        )

    def rescale(self, scale_x: float, scale_y: float, new_width,
                new_height) -> "Camera":
        """Adjust intrinsics after an image resize (PatchMatch.cpp:919-924)."""
        K = self.K.detach().cpu().numpy().astype(np.float32).copy()
        K[0, 0] *= scale_x
        K[0, 2] *= scale_x
        K[1, 1] *= scale_y
        K[1, 2] *= scale_y
        dev = self.K.device
        return dataclasses.replace(
            self, K=torch.as_tensor(K, device=dev),
            width=_f32(new_width, dev).reshape(()),
            height=_f32(new_height, dev).reshape(()))


@dataclasses.dataclass(frozen=True)
class CameraStack:
    """V cameras stacked along a leading axis. Index 0 is the reference view."""

    K: torch.Tensor          # (V, 3, 3)
    R: torch.Tensor          # (V, 3, 3)
    t: torch.Tensor          # (V, 3)
    width: torch.Tensor      # (V,)
    height: torch.Tensor     # (V,)
    depth_min: torch.Tensor  # (V,)
    depth_max: torch.Tensor  # (V,)

    @property
    def C(self) -> torch.Tensor:  # (V, 3)
        return -torch.einsum("vji,vj->vi", self.R, self.t)

    @property
    def num_views(self) -> int:
        return self.K.shape[0]

    @property
    def device(self) -> torch.device:
        return self.K.device

    def view(self, i: int) -> Camera:
        return Camera(**{f: getattr(self, f)[i] for f in _FIELDS})

    def to(self, device) -> "CameraStack":
        return CameraStack(**{f: getattr(self, f).to(device) for f in _FIELDS})

    @staticmethod
    def stack(cams: Sequence[Camera]) -> "CameraStack":
        return CameraStack(**{f: torch.stack([getattr(c, f) for c in cams])
                              for f in _FIELDS})
