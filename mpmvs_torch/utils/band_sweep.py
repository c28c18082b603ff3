"""Band-height sweep of one photometric half-iteration on a CUDA card.

    python -m mpmvs_torch.utils.band_sweep [--rows 266,534,1066,2130]

Builds the 3200x2130, 1+10-view synthetic plane scene, initializes a state
with the solver's own init, then times one ``checkerboard_step`` (scale 0,
CUDA events, mean of 3 after a warm-up) and records its peak extra device
memory at each band height. ``--profile`` adds a ``torch.profiler`` table of
device time by kernel for one half-iteration at the default band height.
The numbers set ``ops.propagation.H100_BAND_BUDGET_MB`` (see PERF.md).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.ops.propagation import checkerboard_step
from mpmvs_torch.params import PatchMatchParams
from mpmvs_torch.solver import build_solve_data, initial_state, solve_band_rows
from mpmvs_torch.utils.synthetic import make_plane_scene
from mpmvs_torch.utils.trace import cuda_time_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="266,534,1066,2130")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_sweep needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    params = PatchMatchParams()
    scene = make_plane_scene(num_views=11, height=2130, width=3200, seed=0)
    data = build_solve_data(torch.as_tensor(scene.images, device=dev),
                            scene.cameras.to(dev))
    H, W = data.ref_img.shape
    key = tf.PRNGKey(3, device=dev)
    br0 = solve_band_rows(params, H, W, data.src_imgs.shape[0])
    state = initial_state(data, params, key, br0)
    k_step = tf.fold_in(key, 1)
    rows_out = []
    for rows in (int(r) for r in args.rows.split(",")):
        step = lambda: checkerboard_step(state, data, params, 0, 0, 0, k_step,
                                         band_rows=rows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_time_ms(step, reps=3)
        peak = torch.cuda.max_memory_allocated() - base
        rec = {"band_rows": rows, "bands": -(-H // rows), "step_ms": ms,
               "peak_extra_gib": peak / 2**30}
        rows_out.append(rec)
        print(json.dumps(rec))
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        step = lambda: checkerboard_step(state, data, params, 0, 0, 0, k_step,
                                         band_rows=br0)
        step_ms = cuda_time_ms(step, reps=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        avgs = prof.key_averages()
        print(avgs.table(sort_by="self_device_time_total", row_limit=25))
        # device-side events (kernels, memcpy, memset) carry no CPU time;
        # the step's unprofiled event time spans the device's idle gaps too
        busy_ms = sum(e.self_device_time_total for e in avgs
                      if e.self_cpu_time_total == 0) / 1e3
        syncs = sum(e.count for e in avgs if e.key in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize"))
        print(json.dumps({"band_rows": br0, "step_ms": step_ms,
                          "device_busy_ms": busy_ms,
                          "idle_share": 1.0 - busy_ms / step_ms,
                          "host_syncs": syncs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
