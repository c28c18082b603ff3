"""Row parallelism: one view's solve split over the ranks of a group.

Counterpart of ``mpmvs_tpu.parallel.tile_sharding`` (solve_view_spatial,
tile_sharding.py:27-37), where XLA's SPMD partitioner shards the state
maps by rows over a mesh axis and turns the propagation stencils into halo
exchanges. The port's half-iteration is already banded, and within one
checkerboard colour the bands are independent: each band reads the padded
state of the other colour (ops/propagation.py, ``checkerboard_step``). So
each rank computes its slot of the bands, with the band's global index in
its key, and the ranks all-gather the band outputs (plane, cost, geometric
cost, selection) before the merge; the banded initial scoring is split the
same way. The images, the finalize and its median filter stay whole on
every rank. The result equals a one-rank ``solve_view`` with the same
``band_rows`` bit for bit, as XLA's sharded solve equals its unsharded
one. Each half-iteration costs one all-gather of the active colour's state
(~28 B a pixel over two colours).

The bands differ from the JAX package's: its tile-sharded solve always
runs one band of all rows (mpmvs_tpu/solver.py:329-330, whatever
``band_rows`` says), while here the bands are the split. Band b draws with
the band's index, so the two packages draw the same numbers only where
the port also runs one band (``band_rows`` = H). With ``band_rows`` 0
(automatic) the port takes about H / R rows a band, within the band
height the memory budget allows, so that each rank gets a band.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mpmvs_torch.camera import CameraStack
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch.parallel.mesh import RankGroup
from mpmvs_torch.solver import SolveResult, solve_band_rows, solve_view


def split_band_rows(params: PatchMatchParams, shape, mode: str,
                    ranks: int) -> PatchMatchParams:
    """``params`` with ``band_rows`` 0 replaced by ceil(H / ranks) rows,
    rounded up to even, within the band height the memory budget allows
    (``solver.solve_band_rows``), for a (V, H, W) stack; an explicit
    ``band_rows`` is kept."""
    if params.band_rows:
        return params
    V, H, W = shape
    H, W = H + H % 2, W + W % 2
    rows = -(-H // ranks)
    rows += rows % 2
    budget = solve_band_rows(params, H, W, V - 1, mode != "photometric")
    return dataclasses.replace(params, band_rows=min(rows, budget))


def solve_view_spatial(images, cameras: CameraStack, key,
                       params: PatchMatchParams, mode: str,
                       group: RankGroup, warm: Optional[SolveResult] = None,
                       src_depths=None, prior_planes=None,
                       prior_mask=None) -> SolveResult:
    """``solver.solve_view`` on ``group.device`` with the row bands split
    over ``group``'s ranks; every rank returns the whole result. With
    ``params.band_rows`` 0 the bands are about H / R rows
    (``split_band_rows``)."""
    params = split_band_rows(params, tuple(images.shape), mode, group.size)
    return solve_view(images, cameras, key, params, mode,
                      device=group.device, warm=warm, src_depths=src_depths,
                      prior_planes=prior_planes, prior_mask=prior_mask,
                      group=group)
