"""Self-check of the scale-out over n ranks at tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip`` (its first two parts;
the tile-sharded stepped solve is not ported, as ``solve_view_stepped``
is not). Spawns n ranks (one per card over NCCL, or on the CPU over gloo
with ``--device cpu``) and runs, on each:

  1. a view-sharded photometric and geometric round
     (``view_sharding.ShardedPipeline`` on a 5-view scene, one view with a
     source fewer, so the split over 2 or 4 ranks is uneven and a dummy
     source pads its stack), then the same round on rank 0 alone (a
     one-rank subgroup): every depth, normal and cost map must be equal,
     bit for bit, and finite;
  2. a row-sharded solve (``tile_sharding.solve_view_spatial``, 3 row
     bands over the n ranks) against ``solver.solve_view`` without a group
     on rank 0: equal bit for bit, and finite.

    python -m mpmvs_torch.parallel.dryrun 4            # 4 cards
    python -m mpmvs_torch.parallel.dryrun 2 --device cpu --out r.npz

Exits non-zero if any check fails; ``--out`` keeps rank 0's row-sharded
result (depth, normal, cost).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from mpmvs_torch.parallel import mesh

VIEWS, HEIGHT, WIDTH = 5, 32, 64    # the view-sharded round
ROW_SCENE = dict(num_views=3, height=48, width=64, seed=11)
ROW_BANDS = 16                      # 3 bands of the 48-row view


def fast_params(band_rows: int):
    from mpmvs_torch.params import PatchMatchParams

    return PatchMatchParams(max_iterations=1, geom_iterations=1, max_scale=0,
                            band_rows=band_rows)


def _view_round(group: mesh.RankGroup, folder: str) -> Optional[dict]:
    """Photometric + geom_0 over ``group``; rank 0 returns every view's
    result."""
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.parallel.view_sharding import ShardedPipeline
    from mpmvs_torch.utils.synthetic import make_plane_scene

    scene = make_plane_scene(num_views=VIEWS, height=HEIGHT, width=WIDTH,
                             seed=3)
    view_sel = [[j for j in range(VIEWS) if j != i] for i in range(VIEWS)]
    view_sel[-1] = view_sel[-1][:2]
    cfg = ConfigParams(input_folder=folder, output_folder=folder,
                       geom_iterations=1, planar_prior=False, sky_seg=False)
    pipe = ShardedPipeline(cfg, fast_params(HEIGHT), group=group,
                           write_jpg=False)
    pipe.load_arrays(scene.images, scene.colors, scene.cameras, view_sel)
    pipe.run(log=lambda msg: None)
    if group.rank != 0:
        return None
    return {v: pipe.views[v].result for v in range(VIEWS)}


def _row_solve(group: Optional[mesh.RankGroup], device):
    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.parallel.tile_sharding import solve_view_spatial
    from mpmvs_torch.solver import solve_view
    from mpmvs_torch.utils.synthetic import make_plane_scene

    scene = make_plane_scene(**ROW_SCENE)
    args = (scene.images, scene.cameras, tf.PRNGKey(1),
            fast_params(ROW_BANDS), "photometric")
    if group is None:
        return solve_view(*args, device=device)
    return solve_view_spatial(*args, group=group)


def _equal(name: str, a, b) -> None:
    for leaf in ("depth", "normal", "cost"):
        x, y = getattr(a, leaf), getattr(b, leaf)
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: {leaf} not finite")
        if not torch.equal(x, y):
            raise AssertionError(
                f"{name}: {leaf} differs from the one-rank result on "
                f"{(x != y).float().mean().item():.2%} of entries")


def _rank(group: mesh.RankGroup, folders, out: Optional[str]) -> None:
    shared = _view_round(group, folders[0])
    solo = mesh.subgroup(group, [0])
    if solo is not None:
        alone = _view_round(solo, folders[1])
        for v in range(VIEWS):
            _equal(f"view-sharded round, view {v}", shared[v], alone[v])
    mesh.barrier(group)

    rows = _row_solve(group, group.device)
    if group.rank == 0:
        _equal("row-sharded solve", rows, _row_solve(None, group.device))
        if out:
            np.savez(out, **{k: getattr(rows, k).cpu().numpy()
                             for k in ("depth", "normal", "cost")})
        print(f"dryrun over {group.size} ranks ({group.backend}): "
              f"view-sharded photometric + geom round ({VIEWS} views) and "
              f"row-sharded solve ({ROW_SCENE['height'] // ROW_BANDS} bands) "
              f"equal the one-rank results, bit for bit", flush=True)
    mesh.barrier(group)


def run(n: int, device: str = "cuda", out: Optional[str] = None) -> None:
    with tempfile.TemporaryDirectory(prefix="mpmvs_dryrun_") as a, \
            tempfile.TemporaryDirectory(prefix="mpmvs_dryrun_") as b:
        mesh.spawn(_rank, ((a, b), out), n, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ranks", type=int, nargs="?", default=2)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None,
                    help="npz of rank 0's row-sharded result")
    args = ap.parse_args(argv)
    run(args.ranks, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
