"""Strong scaling of the view-sharded pipeline over 1, 2 and 4 cards,
measured.

Port of scaling_bench.py, which recorded a virtual CPU mesh and a modelled
TPU pod; this tool times the real thing. It writes one workspace
(``make_plane_scene``, ``--views`` estimated views of ``--height`` x
``--width``, each with ``--sources`` sources, plus the views that serve only
as sources), then runs the full default schedule (photometric, geom_0 with
its prior sub-run, geom_1, fusion; no sky) through
``view_sharding.launch`` over each rank count of ``--ranks``, one process
a card over NCCL, and gathers each rank's record (``MPMVS/rank_<r>.json``):

  * wall time per pass (the slowest rank), and of the whole launch (host
    clock, spawn and loading included);
  * prior-build seconds per rank;
  * bytes and milliseconds of each geom pass's depth all-gather and of
    the final gather to rank 0 (each after a control barrier; the wait at
    that barrier, the ranks' skew, beside it);
  * strong-scaling efficiency, T(1) / (R T(R)), of the passes' time and of
    the launch's;
  * a digest of every depth map: 1, 2 and 4 ranks must give the same maps
    (the tool exits 1 if they do not);
  * ``nvidia-smi``'s name and power limit of the cards.

    python -m mpmvs_torch.tools.scaling_bench --ranks 1,2,4 \\
        --out scaling.json

One JSON object, printed as the last line and written to ``--out``. It is a
tool, not the repository's benchmark. Without enough cards it exits
non-zero; ``--device cpu`` runs the ranks on the CPU over gloo (a
check of the tool at a tiny size; its times are host times).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0    # make_plane_scene's


def _smi() -> list:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def write_scene(folder: str, views: int, sources: int, height: int,
                width: int, seed: int, device) -> object:
    """The workspace: ``views`` estimated views, each with ``sources``
    sources among ``max(views, sources + 1)`` views; the views beyond the
    first ``views`` are sources only."""
    from mpmvs_torch.io.cams import write_pair_txt
    from mpmvs_torch.utils.synthetic import make_plane_scene
    from mpmvs_torch.utils.workspace import write_workspace

    total = max(views, sources + 1)
    scene = make_plane_scene(num_views=total, height=height, width=width,
                             seed=seed)
    write_workspace(scene, folder, device)
    sel = [[(j, 10.0) for j in range(total) if j != i][:sources]
           if i < views else [] for i in range(total)]
    write_pair_txt(os.path.join(folder, "pair.txt"), sel)
    return scene


def run_ranks(ws: str, out: str, ranks: int, device_type: str, params,
              scene, views: int) -> dict:
    """One launch over ``ranks`` ranks; its pass times, collectives,
    digests and accuracy."""
    from mpmvs_torch.io import read_dmb, read_ply_binary
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.parallel.view_sharding import launch

    cfg = ConfigParams(input_folder=ws, output_folder=out, sky_seg=False)
    t0 = time.perf_counter()
    ply = launch(cfg, params, world_size=ranks, device_type=device_type,
                 device_ids=range(ranks) if device_type == "cuda" else None,
                 write_jpg=False)
    wall = time.perf_counter() - t0
    recs = []
    for r in range(ranks):
        with open(os.path.join(out, "MPMVS", f"rank_{r}.json")) as f:
            recs.append(json.load(f))
    tags = [p["pass"] for p in recs[0]["passes"]]
    passes = {t: max(rec["passes"][k]["wall_s"] for rec in recs)
              for k, t in enumerate(tags)}
    collectives = []
    for k, c in enumerate(recs[0]["collectives"]):
        collectives.append({
            "op": c["op"], "pass": c["pass"], "bytes": c["bytes"],
            "ms_by_rank": [rec["collectives"][k]["ms"] for rec in recs],
            "wait_ms_by_rank": [rec["collectives"][k]["wait_ms"]
                                for rec in recs]})
    digests, rel = {}, {}
    for v in range(views):
        path = os.path.join(out, "MPMVS", f"2333_{v:08d}", "depths.dmb")
        digests[v] = _digest(path)
        d, gt = read_dmb(path), scene.gt_depth[v]
        rel[v] = float(np.median(np.abs(d - gt) / gt))
    return {"ranks": ranks, "wall_s": wall, "pass_wall_s": passes,
            "passes_s": sum(passes.values()),
            "pass_wall_s_by_rank": [{p["pass"]: p["wall_s"]
                                     for p in rec["passes"]}
                                    for rec in recs],
            "prior_build_s_by_rank": [
                sum(p["prior_build_s"] for p in rec["passes"])
                for rec in recs],
            "views_by_rank": [rec["views"] for rec in recs],
            "collectives": collectives,
            "launches_by_rank": [rec["launches"] for rec in recs],
            "depth_digests": digests, "median_rel_err": rel,
            "fused_points": int(len(read_ply_binary(ply)[0]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--views", type=int, default=8,
                    help="estimated views")
    ap.add_argument("--sources", type=int, default=10)
    ap.add_argument("--height", type=int, default=2130)
    ap.add_argument("--width", type=int, default=3200)
    ap.add_argument("--preset", choices=["full", "fast"], default="full",
                    help="'fast': one scale, one iteration (tool checks)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ranks = [int(r) for r in args.ranks.split(",")]
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.tools import build_kernels, device_record

    if args.device == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < max(ranks):
            print(f"scaling_bench needs {max(ranks)} CUDA devices, this host "
                  f"has {count}", file=sys.stderr)
            return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    build_kernels(dev)
    params = None
    if args.preset == "fast":
        params = PatchMatchParams(max_iterations=1, geom_iterations=1,
                                  max_scale=0)
    record = {"tool": "mpmvs_torch.tools.scaling_bench",
              "scene": {"height": args.height, "width": args.width,
                        "estimated_views": args.views,
                        "sources": args.sources, "seed": SEED,
                        "generator": "utils.synthetic.make_plane_scene"},
              "schedule": "photometric, geom_0 + prior sub-run, geom_1, "
                          "fusion (ConfigParams defaults, no sky)",
              "preset": args.preset, "device": device_record(dev),
              "nvidia_smi": _smi() if args.device == "cuda" else None,
              "runs": []}
    root = tempfile.mkdtemp(prefix="mpmvs_scaling_")
    try:
        t0 = time.perf_counter()
        ws = os.path.join(root, "ws")
        scene = write_scene(ws, args.views, args.sources, args.height,
                            args.width, SEED, dev)
        record["setup_s"] = time.perf_counter() - t0
        for r in ranks:
            run = run_ranks(ws, os.path.join(root, f"out_{r}"), r,
                            args.device, params, scene, args.views)
            record["runs"].append(run)
            print(json.dumps({k: run[k] for k in (
                "ranks", "wall_s", "pass_wall_s", "prior_build_s_by_rank",
                "median_rel_err")}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs = {run["ranks"]: run for run in record["runs"]}
    if 1 in runs:
        for run in record["runs"]:
            R = run["ranks"]
            run["efficiency"] = runs[1]["passes_s"] / (R * run["passes_s"])
            run["efficiency_wall"] = runs[1]["wall_s"] / (R * run["wall_s"])
    digests = [run["depth_digests"] for run in record["runs"]]
    record["digests_identical"] = all(d == digests[0] for d in digests)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0 if record["digests_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
