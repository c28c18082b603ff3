"""Where a half-iteration's time goes: one photometric and one geom
checkerboard step, split.

Port of tools/solve_trace.py. The JAX tool subtracted runs with the NCC or
the geometric cost stubbed out (``debug_skip_*``, which the port does not
have); here one ``torch.profiler`` trace of each step attributes device
time directly, beside the step's CUDA-event time:

  * ``ncc_kernel``: the NCC kernel's launches (``csrc/ncc_eval.cu``, by
    kernel name);
  * ``geom_cost``: the kernels launched inside
    ``ops.geom_cost.geom_consistency_cost`` (geom mode);
  * ``threefry``: the kernels inside ``ops.threefry.threefry2x32``, the
    hash every random draw goes through;
  * ``other_glue``: the rest of the device time (harvest, view weights,
    adoption, the int-to-float of the draws, copies);
  * ``host_syncs``: calls that wait for the device (stream and device
    synchronisations, ``.item()``-style scalar reads), counted;
  * ``idle_share``: 1 - device busy time / the step's CUDA-event time.

The scene is ``make_plane_scene`` at ``--height`` x ``--width`` with
``--views`` - 1 sources; the state is the solver's own initial state, the
geom step reads the sources' GT depths. One JSON line a step, then a
summary line::

    python -m mpmvs_torch.tools.solve_trace              # 3200x2130, S=10

Without a card it exits non-zero unless ``--device cpu`` is given; there
the split is of host time and no idle share is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

NCC_KERNELS = ("ncc_tile_kernel", "ncc_view_major_kernel")
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "aten::_local_scalar_dense")
RANGES = {"geom_cost": "solve_trace::geom_cost",
          "threefry": "solve_trace::threefry"}


@contextlib.contextmanager
def _ranges():
    """Wrap geom_consistency_cost (as propagation calls it) and
    threefry2x32 in profiler ranges while tracing."""
    from torch.profiler import record_function

    from mpmvs_torch.ops import propagation
    from mpmvs_torch.ops import threefry as tf

    def wrap(fn, name):
        def inner(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return inner

    saved = (propagation.geom_consistency_cost, tf.threefry2x32)
    propagation.geom_consistency_cost = wrap(saved[0], RANGES["geom_cost"])
    tf.threefry2x32 = wrap(saved[1], RANGES["threefry"])
    try:
        yield
    finally:
        propagation.geom_consistency_cost, tf.threefry2x32 = saved


def _time_ms(fn, device, reps: int) -> float:
    """Mean ms of ``fn()`` after a warm-up: CUDA events on a card, the host
    clock on the CPU."""
    import time

    from mpmvs_torch.utils.trace import cuda_time_ms

    if device.type == "cuda":
        return cuda_time_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def trace_step(step, device, reps: int) -> dict:
    """Time ``step()`` and split one profiled run of it (module doc)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_ms = _time_ms(step, device, reps)
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with _ranges(), profile(activities=acts) as prof:
        step()
        if cuda:
            torch.cuda.synchronize(device)
    avgs = prof.key_averages()
    out = {"step_ms": step_ms, "clock": "device" if cuda else "host"}
    ours = set(RANGES.values()) | {"solve_trace::ncc"}
    host = [e for e in avgs if e.device_type == DeviceType.CPU]
    if cuda:
        # device-side events: kernels, copies and sets (the ranges' device
        # spans, the profiler's own user annotations, are not work)
        kernels = [e for e in avgs if e.device_type != DeviceType.CPU
                   and e.key not in ours and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        ncc = sum(e.self_device_time_total for e in kernels
                  if any(k in e.key for k in NCC_KERNELS)) / 1e3
        # a host range's device time: the kernels launched inside it
        ranged = {name: sum(e.device_time_total for e in host
                            if e.key == key) / 1e3
                  for name, key in RANGES.items()}
        out.update(device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
                   launches=sum(e.count for e in kernels))
    else:
        busy = sum(e.self_cpu_time_total for e in host) / 1e3
        ncc = sum(e.cpu_time_total for e in host
                  if e.key == "solve_trace::ncc") / 1e3
        ranged = {name: sum(e.cpu_time_total for e in host if e.key == key)
                  / 1e3 for name, key in RANGES.items()}
        out.update(host_busy_ms=busy, idle_share=None)
    split = {"ncc_kernel": ncc, **ranged}
    split["other_glue"] = busy - sum(split.values())
    out["split_ms"] = split
    syncs = {e.key: e.count for e in host if e.key in SYNC_EVENTS}
    out["host_syncs"] = {"count": sum(syncs.values()), "by_call": syncs}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=2130)
    ap.add_argument("--width", type=int, default=3200)
    ap.add_argument("--views", type=int, default=11)
    ap.add_argument("--scale", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import record_function

    from mpmvs_torch.ops import threefry as tf
    from mpmvs_torch.ops.ncc_cuda import ncc_eval_multi
    from mpmvs_torch.ops.propagation import checkerboard_step
    from mpmvs_torch.params import PatchMatchParams
    from mpmvs_torch.solver import (build_solve_data, initial_state,
                                    resolve_device, solve_band_rows)
    from mpmvs_torch.tools import build_kernels, device_record
    from mpmvs_torch.utils.synthetic import make_plane_scene

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    build_kernels(dev)
    record = device_record(dev)
    H, W, S = args.height, args.width, args.views - 1
    params = PatchMatchParams()
    scene = make_plane_scene(num_views=args.views, height=H, width=W, seed=0)
    images = torch.as_tensor(scene.images, device=dev)
    key = tf.PRNGKey(3, device=dev)

    def ncc(*a, **k):  # the NCC's host range (its device time is by name)
        with record_function("solve_trace::ncc"):
            return ncc_eval_multi(*a, **k)

    rows = []
    for mode in ("photometric", "geom"):
        geom = mode == "geom"
        data = build_solve_data(
            images, scene.cameras.to(dev),
            torch.as_tensor(scene.gt_depth[1:], device=dev) if geom else None)
        band_rows = solve_band_rows(params, H, W, S, geom)
        state = initial_state(data, params, key, band_rows)
        k_step = tf.fold_in(key, 1)
        step = lambda: checkerboard_step(state, data, params, args.scale, 0,
                                         0, k_step, geom=geom,
                                         band_rows=band_rows, ncc_multi=ncc)
        row = {"case": f"half-iteration:{mode}", "height": H, "width": W,
               "sources": S, "scale": args.scale, "band_rows": band_rows,
               **trace_step(step, dev, args.reps), "device": record}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del data, state
    print(json.dumps({"case": "summary", "device": record, "rows": [
        {k: r[k] for k in ("case", "step_ms", "idle_share", "split_ms")}
        for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
