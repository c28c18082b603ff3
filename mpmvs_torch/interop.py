"""Carry state and parameters from the JAX package into the port.

numpy in, torch out: the JAX package's ``CameraStack``, ``SolveData``,
``PatchMatchState``, ``SolveResult``, ``PatchMatchParams`` fields,
``PRNGKey``, planar prior and sky-net layer list go through ``np.asarray``
(or ``dataclasses.asdict``) and come out as the port's types, so both
packages compute on the same state. This module never imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mpmvs_torch.camera import CameraStack
from mpmvs_torch.models.ncnn import NcnnLayer, NcnnNet
from mpmvs_torch.ops.propagation import PatchMatchState, SolveData
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch.solver import SolveResult

# PatchMatchParams fields of the JAX package that select TPU execution
# paths and have no meaning here.
TPU_ONLY_FIELDS = ("dispatch", "src_quant8", "debug_skip_ncc",
                   "debug_skip_gcost")
# The JAX package's ``sampler`` values -> the port's. "auto", "pallas" and
# "xla" compute the same function through different TPU/XLA paths.
SAMPLER_FROM_JAX = {"auto": "auto", "pallas": "auto", "xla": "auto",
                    "pallas_sorted": "sorted"}


def _t(a, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def camera_stack_from_numpy(arrays: Mapping[str, np.ndarray],
                            device=None) -> CameraStack:
    """CameraStack from a mapping of its field names to arrays."""
    return CameraStack(**{f.name: _t(arrays[f.name], device=device)
                          for f in dataclasses.fields(CameraStack)})


def params_from_jax_fields(fields: Mapping[str, object]) -> PatchMatchParams:
    """PatchMatchParams from the JAX package's field values, dropping the
    TPU-only knobs and mapping ``sampler`` (``SAMPLER_FROM_JAX``). An
    unknown field or sampler value raises."""
    own = {f.name for f in dataclasses.fields(PatchMatchParams)}
    kept = {k: v for k, v in fields.items() if k not in TPU_ONLY_FIELDS}
    if "sampler" in kept:
        if kept["sampler"] not in SAMPLER_FROM_JAX:
            raise ValueError(f"unknown sampler {kept['sampler']!r}")
        kept["sampler"] = SAMPLER_FROM_JAX[kept["sampler"]]
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


def solve_data_from_numpy(arrays: Mapping[str, object],
                          device=None) -> SolveData:
    """SolveData from a mapping of its field names to arrays; ``None`` or
    missing optional fields (``src_depths``, ``prior_planes``,
    ``prior_mask``) stay None, and the JAX package's quad-texture fields are
    ignored. ``prior_mask`` becomes bool."""
    out = {}
    for f in SolveData._fields:
        a = arrays.get(f)
        if a is None:
            continue
        out[f] = _t(a, torch.bool if f == "prior_mask" else torch.float32,
                    device)
    return SolveData(**out)


def prior_from_numpy(planes, mask, device=None):
    """(prior_planes (H, W, 4) float32, prior_mask (H, W) bool) tensors of a
    planar prior (``PlanarPrior.planes`` / ``.mask`` of either package)."""
    return _t(planes, device=device), _t(mask, torch.bool, device)


def sky_net_from_layers(layers, input_blob: str = "input.1",
                        output_blob: str = "1959") -> NcnnNet:
    """The port's NcnnNet from the JAX package's ``NcnnLayer`` list (numpy
    weights), e.g. ``mpmvs_tpu.models.ncnn.load_npz(...)``."""
    own = [NcnnLayer(l.type, l.name, list(l.inputs), list(l.outputs),
                     dict(l.params),
                     {k: np.asarray(v, np.float32)
                      for k, v in l.weights.items()})
           for l in layers]
    return NcnnNet(own, input_blob, output_blob).eval()
