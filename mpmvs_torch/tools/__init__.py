"""Measurement tools of the port: ``ab_deviations`` (the search-semantics
A/B) and ``synthetic_eval`` (the shapes-scene accuracy run). Each runs the
port's pipeline on a device the caller names and writes one JSON file;
:func:`run_shapes_pipeline` is the run and evaluation both share."""

from __future__ import annotations

import os
import subprocess
import time

import torch


def build_kernels(device: torch.device, verbose: bool = False) -> None:
    """On a CUDA device, build every kernel of the port at once, one
    ``nvcc`` each (``ops.nvcc.build_all``), before anything is timed:
    otherwise the first arm or pass to reach a kernel pays its build.
    ``verbose`` prints each build's register report and time."""
    if device.type == "cuda":
        from mpmvs_torch.ops import bilateral_cuda, ncc_cuda, ncc_sorted, nvcc

        nvcc.build_all({m.SOURCE: m.NVCC_FLAGS
                        for m in (ncc_cuda, ncc_sorted, bilateral_cuda)},
                       verbose)


def device_record(device: torch.device) -> dict:
    """What a result was measured on: the platform, the card's name and,
    on a CUDA device, ``nvidia-smi``'s name and power limit."""
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[device.index or 0]}


def run_shapes_pipeline(scene, workdir: str, params, device,
                        geom_iterations: int, tau: float) -> dict:
    """Write ``scene`` (``utils.synthetic.make_shapes_scene``) under
    ``workdir`` as a workspace (``ws/``) and GT depth maps (``gt/``), run the
    full pipeline on it (photometric pass, planar prior, ``geom_iterations``
    geometric passes, fusion) with ``params`` (None: the defaults) on
    ``device``, and evaluate the .dmb outputs and the fused cloud (F1 at
    ``tau`` m). Returns ``setup_s`` (the writes and the GT cloud),
    ``wall_s`` (the pipeline), ``stage_s`` (its solve stages), ``launches``
    ({kernel: [launches, plain calls]}), ``depth``
    (``eval.eval_scene_depths`` at 1, 2 and 10 cm), ``cloud``
    (``eval.CloudMetrics``) and ``n_fused_points``."""
    from mpmvs_torch.eval import eval_point_cloud, eval_scene_depths
    from mpmvs_torch.io.dmb import write_dmb
    from mpmvs_torch.io.ply import read_ply_binary
    from mpmvs_torch.ops import ncc_cuda, ncc_sorted
    from mpmvs_torch.params import ConfigParams
    from mpmvs_torch.pipeline import Pipeline
    from mpmvs_torch.utils.synthetic import gt_point_cloud
    from mpmvs_torch.utils.trace import device_sync
    from mpmvs_torch.utils.workspace import write_workspace

    t0 = time.perf_counter()
    views = len(scene.images)
    ws = os.path.join(workdir, "ws")
    write_workspace(scene, ws)
    gt_dir = os.path.join(workdir, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    for v in range(views):
        write_dmb(os.path.join(gt_dir, f"{v:08d}.dmb"), scene.gt_depth[v])
    gt_cloud = gt_point_cloud(scene, stride=2)
    setup = time.perf_counter() - t0

    cfg = ConfigParams(input_folder=ws, output_folder=ws,
                       geom_iterations=geom_iterations, planar_prior=True,
                       geom_planar_prior=True, use_dynamic_consistency=True)
    ncc_cuda.COUNTS.reset()
    ncc_sorted.COUNTS.reset()
    t0 = time.perf_counter()
    pipe = Pipeline(cfg, params=params, device=device, write_jpg=False)
    ply = pipe.run(log=lambda *a: None)
    device_sync(pipe.device)
    wall = time.perf_counter() - t0
    launches = {"ncc_eval_multi": [ncc_cuda.COUNTS.kernel,
                                   ncc_cuda.COUNTS.plain],
                "ncc_samples": [ncc_sorted.COUNTS.kernel,
                                ncc_sorted.COUNTS.plain]}

    depth = eval_scene_depths(os.path.join(ws, "MPMVS"), gt_dir,
                              list(range(views)),
                              thresholds=(0.01, 0.02, 0.1))
    pts, _, _ = read_ply_binary(ply)
    cloud = eval_point_cloud(pts, gt_cloud, tau=tau)
    stages = {}
    for _, stage, sec in pipe.solve_log:
        stages[stage] = stages.get(stage, 0.0) + sec
    del pipe
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"setup_s": setup, "wall_s": wall, "stage_s": stages,
            "launches": launches, "depth": depth, "cloud": cloud,
            "n_fused_points": int(len(pts))}
