"""Carry state and parameters from the JAX package into the port.

numpy in, torch out: the JAX package's ``CameraStack``, ``PatchMatchState``,
``SolveResult``, ``PatchMatchParams`` fields and ``PRNGKey`` go through
``np.asarray`` (or ``dataclasses.asdict``) and come out as the port's types,
so both packages compute on the same state. This module never imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mpmvs_torch.camera import CameraStack
from mpmvs_torch.ops.propagation import PatchMatchState
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch.solver import SolveResult

# PatchMatchParams fields of the JAX package that select TPU execution
# paths and have no meaning here.
TPU_ONLY_FIELDS = ("dispatch", "sampler", "src_quant8", "debug_skip_ncc",
                   "debug_skip_gcost")


def _t(a, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def camera_stack_from_numpy(arrays: Mapping[str, np.ndarray],
                            device=None) -> CameraStack:
    """CameraStack from a mapping of its field names to arrays."""
    return CameraStack(**{f.name: _t(arrays[f.name], device=device)
                          for f in dataclasses.fields(CameraStack)})


def params_from_jax_fields(fields: Mapping[str, object]) -> PatchMatchParams:
    """PatchMatchParams from the JAX package's field values, dropping the
    TPU-only knobs. An unknown field raises."""
    own = {f.name for f in dataclasses.fields(PatchMatchParams)}
    kept = {k: v for k, v in fields.items() if k not in TPU_ONLY_FIELDS}
    unknown = set(kept) - own
    if unknown:
        raise ValueError(f"unknown PatchMatchParams fields: {sorted(unknown)}")
    return PatchMatchParams(**kept)


def state_from_numpy(plane, cost, geom_cost, sel, device=None) -> PatchMatchState:
    return PatchMatchState(plane=_t(plane, device=device),
                           cost=_t(cost, device=device),
                           geom_cost=_t(geom_cost, device=device),
                           sel=_t(sel, torch.int32, device))


def result_from_numpy(depth, normal, cost, geom_cost, device=None) -> SolveResult:
    return SolveResult(depth=_t(depth, device=device),
                       normal=_t(normal, device=device),
                       cost=_t(cost, device=device),
                       geom_cost=_t(geom_cost, device=device))


def key_from_numpy(key, device=None) -> torch.Tensor:
    """Threefry key tensor from a uint32[2] key (``jax.random.PRNGKey``)."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"expected a uint32[2] key, got {k.dtype}{k.shape}")
    return torch.as_tensor(k.astype(np.int64), device=device)
