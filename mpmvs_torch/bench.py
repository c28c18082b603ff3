"""The port's headline benchmark: whole schedules on one card or four.

    python -m mpmvs_torch.bench              # every cell this host can run
    python -m mpmvs_torch.bench --cell view_s10_photo_geom2 --repeats 5
    python -m mpmvs_torch.bench --cell views8_s10_default_4card   # 4 cards

Port of the root ``bench.py`` (the JAX package's TPU bench), whose operating
point it keeps. The cells are ``BENCHMARK.json``'s ``workloads``, and
those of ``BENCHMARK_PENDING.json``, which run only when named; each names
a configuration file (``configs/``) that gives the scene (its generator and
arguments), the reference view and its sources, the solver's
``PatchMatchParams`` and the pipeline's ``ConfigParams`` (whose
``pass_schedule`` is the cell's schedule), the error limit of each pass kind
and the tests' CPU rehearsal. A new cell is a configuration file and an
entry in ``BENCHMARK.json`` (or, until its gate is shown to catch its
controls, in ``BENCHMARK_PENDING.json``).

A run of a cell is the per-view entry of the pipeline: a fresh
``pipeline.Pipeline`` filled in memory (``load_arrays``; no disk I/O), the
sources' results set to the scene's ground-truth depths (the neighbours'
maps of the geometric passes, as in the root bench), then
``Pipeline.process_view`` on the reference view once per pass of the
schedule. The pipeline's key chain starts from the configuration's seed in
every run, so every run does the same work. Per cell: one untimed warm-up
run, ``repeats`` timed runs, then one run under ``torch.profiler``. Every run
runs the whole schedule; nothing is estimated.

Each run is held to the outputs' correctness after every pass
(:func:`check_runs`): finite depths and normals, median |d-gt|/gt over the
view below the pass kind's limit, every solve and prior build of the
schedule run, the NCC kernel launched exactly as often as the schedule
implies (:func:`expected_ncc_calls`) with no plain call, and the same depth
digests in every run. After its runs, no module of JAX or of the JAX
package may be in ``sys.modules`` (:data:`FOREIGN`). A cell that fails any
of them is not correct, and the command exits 1. ``--control NAME`` plants
a known fault (:data:`CONTROLS`) to read what the gate sees of it.

Printed: a JSON line per cell with the end-to-end metrics (the timed runs'
schedules over their summed seconds; peak device memory), the per-layer
metrics (seconds of each pass and of each solve and prior build from
``Pipeline.solve_log``, NCC launches and taps per second, set-up seconds,
the spread of the runs within the process, and the host readings of every
timed run, :func:`host_window` and :func:`prior_build_clock`: GC, context
switches, CPU against wall seconds, the prior build's CPU seconds) and the
traced run's split (device busy and idle share, the device operations that take
most time, the longest idle gaps named by the step the host was in, the
tracing overhead); then ``nvidia-smi``'s name and power limit of the card;
last, one JSON object with each cell's metrics under the names
``BENCHMARK.json`` declares.

A configuration with ``ranks`` is a sharded cell (:func:`run_sharded_cell`):
its scene is written once as a workspace and the program's own view-sharded
path runs over that many cards, one process a card, one untimed warm-up
launch (traced on rank 0) and ``repeats`` timed launches, each pass timed
at its slowest rank. Each launch is also held to what its exchanges
carried (:func:`exchange_log`, :func:`exchange_faults`): every rank must
receive the bytes that each view's owner sent, in every depth all-gather
and in the final gather to rank 0. Run without ``--cell``, the command
skips a cell this host lacks the cards for; named, such a cell exits 2.

Without a CUDA device the command exits 2. ``--device cpu`` runs the same
code on each configuration's tiny ``rehearsal`` scene, for the tests (a
sharded cell's ranks over gloo); its output says ``"device": "cpu"`` and
``"rehearsal": true``, and its times are host times.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import importlib
import json
import os
import resource
import shutil
import statistics
import sys
import tempfile
import time
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

BENCHMARK = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BENCHMARK.json")
# cells the bench runs only by name, not yet BENCHMARK.json's workloads
PENDING = os.path.join(os.path.dirname(BENCHMARK), "BENCHMARK_PENDING.json")
HYPOTHESES = 14           # NCC'd per active pixel a half-iteration: 8 + 1 + 5
PASS_SPAN = "bench::"     # profiler ranges of the passes (the bench's own)
STAGE_SPAN = "pipeline::"  # and of the pipeline's solves and prior builds
# one OpenMP and BLAS thread in the bench's process: with their pools the
# host prior build's time spread twice as wide in a paired run (PERF.md
# section 2); set before numpy loads, hence a fresh process
PINNED = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
          "MKL_NUM_THREADS": "1"}
# known faults, planted for a control run (:func:`planted`)
CONTROLS = {
    "ncc_bf16": "every NCC cost rounded to bfloat16 after the kernel",
    "ncc_fp8": "every NCC cost rounded to float8 (e4m3) after the kernel",
    "geom_cost_zero": "the geometric cost returns zeros",
    "prior_off": "the planar prior's mask cleared after its build",
    "exchange_drop": "a sharded cell's depth all-gathers keep each rank's "
                     "own maps only, the other ranks' rows zero",
    "final_gather_drop": "a sharded cell's final gather keeps rank 0's "
                         "results only, the other ranks' zero",
    "foreign_module": "a module named mpmvs_tpu put in sys.modules",
}
# what the port must never import: JAX and the JAX package
FOREIGN = ("jax", "jaxlib", "flax", "mpmvs_tpu")


@dataclasses.dataclass(frozen=True)
class Cell:
    """A workload of ``BENCHMARK.json`` (or of ``BENCHMARK_PENDING.json``)
    with its configuration file."""

    name: str
    config: dict
    repeats: int


@dataclasses.dataclass
class Setup:
    """A cell's configuration resolved for one device: the scene's
    generator and arguments, the reference view and its sources, the
    solver's and the pipeline's parameters and the error limits."""

    generator: str
    scene_args: dict
    ref: int
    sources: int
    params: object
    pipeline: object
    limits: Dict[str, float]
    ranks: int = 0      # a sharded cell's ranks (0: one view on one card)
    views: int = 1      # the views it estimates


def load_cells(path: str = BENCHMARK) -> Dict[str, Cell]:
    """The workloads of ``path``, each with its configuration file (a path
    relative to ``path``'s directory)."""
    with open(path) as f:
        bench = json.load(f)
    cells = {}
    for w in bench["workloads"]:
        with open(os.path.join(os.path.dirname(path), w["config"])) as f:
            cells[w["name"]] = Cell(w["name"], json.load(f), w["repeats"])
    return cells


def setup_of(config: dict, rehearsal: bool,
             seed: Optional[int] = None) -> Setup:
    """``config`` resolved, with its ``rehearsal`` block laid over it when
    ``rehearsal``; ``seed`` (when given) replaces the scene's seed."""
    from mpmvs_torch.params import ConfigParams, PatchMatchParams

    over = config["rehearsal"] if rehearsal else {}
    args = {**config["scene"]["args"], **over.get("scene_args", {})}
    if seed is not None:
        args["seed"] = seed
    ranks = over.get("ranks", config.get("ranks", 0))
    if ranks and config["pipeline"]:
        # the sharded runs take tools.scaling_bench's ConfigParams
        raise ValueError("a sharded cell runs the default ConfigParams; "
                         f"its configuration sets {config['pipeline']}")
    return Setup(
        generator=config["scene"]["generator"], scene_args=args,
        ref=config.get("reference_view", 0),
        sources=over.get("sources", config["sources"]),
        params=PatchMatchParams(**{**config["solver"],
                                   **over.get("solver", {})}),
        pipeline=ConfigParams(**config["pipeline"]),
        limits=over.get("median_rel_err_limit",
                        config["median_rel_err_limit"]),
        ranks=ranks,
        views=over.get("estimated_views", config.get("estimated_views", 1)))


def schedule(cfg) -> List[Tuple[str, str, Optional[str]]]:
    """The steps ``Pipeline.process_view`` takes for one view through the
    passes of ``Pipeline.pass_schedule`` under ``cfg``, in call order:
    (step name, pass tag, solve mode; None for a prior build)."""
    from mpmvs_torch.pipeline import Pipeline

    steps = []
    for tag, geom, prior in Pipeline(cfg, device="cpu").pass_schedule():
        steps.append((tag, tag, "geom" if geom else "photometric"))
        if prior:
            sub = "geom_prior" if geom and cfg.geom_prior_consistency \
                else "prior"
            steps += [(f"{tag}_prior_build", tag, None),
                      (f"{tag}_prior", tag, sub)]
    return steps


# ---------------------------------------------------------------------------
# Accounting: the root bench's units and taps, and the NCC calls
# ---------------------------------------------------------------------------


def schedule_units(mode: str, params) -> List[str]:
    """Labels of one solve's units, in order: ``init`` and every
    half-iteration ``half:scale:iteration:colour`` (root bench.py:120-131)."""
    geom = mode in ("geom", "geom_prior")
    n_iter = params.geom_iterations if geom else params.max_iterations
    scales = (list(range(params.max_scale, -1, -1))
              if mode == "photometric" else [0])
    return ["init"] + [f"half:{s}:{i}:{c}" for s in scales
                       for i in range(n_iter) for c in (0, 1)]


def unit_taps(label: str, pixels: int, sources: int, taps: int) -> int:
    """NCC taps of one unit (root bench.py:192-199): the init scores every
    pixel against every source, a half-iteration its active colour's
    pixels for 14 hypotheses."""
    if label == "init":
        return pixels * sources * taps
    return (pixels // 2) * HYPOTHESES * sources * taps


def solve_taps(mode: str, params, H: int, W: int, S: int) -> int:
    return sum(unit_taps(u, H * W, S, params.ncc_taps)
               for u in schedule_units(mode, params))


def expected_ncc_calls(mode: str, params, H: int, W: int, S: int) -> int:
    """NCC calls of one solve: one per init band and two per band of
    every half-iteration (the candidates, then the trials), with the band
    heights ``solve_view`` uses."""
    from mpmvs_torch.ops.propagation import _band_geometry
    from mpmvs_torch.solver import init_band_count, solve_band_rows

    He, We = H + H % 2, W + W % 2
    geom = mode in ("geom", "geom_prior")
    br = solve_band_rows(params, He, We, S, mode != "photometric")
    n_half = len(schedule_units(mode, params)) - 1
    step_bands = _band_geometry(He, We, S, 0, geom, br)[2]
    return init_band_count(br, He) + 2 * step_bands * n_half


# ---------------------------------------------------------------------------
# One run of a schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Inputs:
    """A cell's scene: the images, colours and cameras as
    ``Pipeline.load_arrays`` takes them, the reference's ground-truth depth
    on the device, and each source's result (its ground-truth depth, zero
    normals and costs) on the device."""

    images: np.ndarray
    colors: np.ndarray
    cameras: object
    gt: torch.Tensor
    src_results: Dict[int, object]


def load_inputs(setup: Setup, dev: torch.device) -> Inputs:
    from mpmvs_torch.solver import SolveResult

    mod, fn = setup.generator.rsplit(".", 1)
    scene = getattr(importlib.import_module(mod), fn)(**setup.scene_args)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    srcs = [v for v in range(len(scene.images)) if v != setup.ref]
    src_results = {}
    for v in srcs[:setup.sources]:
        depth = t(scene.gt_depth[v])
        zero = torch.zeros_like(depth)
        src_results[v] = SolveResult(
            depth=depth, normal=torch.zeros(depth.shape + (3,), device=dev),
            cost=zero, geom_cost=zero)
    return Inputs(images=scene.images, colors=scene.colors,
                  cameras=scene.cameras, gt=t(scene.gt_depth[setup.ref]),
                  src_results=src_results)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _digest(*arrays: np.ndarray) -> str:
    """The first 16 hex digits of the SHA-256 of the arrays' bytes."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).data)
    return h.hexdigest()[:16]


def pass_check(res, gt: torch.Tensor, kind: str) -> dict:
    """Finite depths and normals, median |d-gt|/gt over the view, and a
    digest of the depth map's bytes, for a pass of ``kind``."""
    depth = res.depth
    return {"kind": kind,
            "finite": bool(torch.isfinite(depth).all()
                           and torch.isfinite(res.normal).all()),
            "median_rel_err": float(((depth - gt).abs() / gt).median()),
            "digest": _digest(_np(depth))}


class _TracedTimer:
    """A stand-in for the pipeline's ``StageTimer`` in the traced run: each
    of its spans (a solve, a prior build) also opens a profiler range."""

    def __init__(self, timer):
        self.timer = timer

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        with record_function(STAGE_SPAN + name), self.timer.span(name):
            yield


def run_schedule(setup: Setup, inputs: Inputs, dev: torch.device,
                 traced: bool = False) -> dict:
    """One run of the schedule: ``Pipeline.process_view`` on the reference
    view for each pass, timed on the host clock around work that ends in a
    device synchronisation (``Pipeline._solve`` syncs after each solve).
    Each pass's result is checked (:func:`pass_check`) after its time is
    taken. ``traced``: each pass, solve and prior build is a profiler range.
    Returns the pass seconds, the step seconds (``Pipeline.solve_log``), the
    checks and the NCC counts."""
    from torch.profiler import record_function

    from mpmvs_torch.ops import ncc_cuda, ncc_sorted
    from mpmvs_torch.pipeline import Pipeline
    from mpmvs_torch.utils.trace import device_sync

    cfg = setup.pipeline
    srcs = list(inputs.src_results)
    view_sel = [srcs if v == setup.ref else []
                for v in range(len(inputs.images))]
    pipe = Pipeline(cfg, setup.params, dev, write_jpg=False).load_arrays(
        inputs.images, inputs.colors, inputs.cameras, view_sel)
    for v, res in inputs.src_results.items():
        pipe.views[v].result = res
    if traced:
        pipe.timer = _TracedTimer(pipe.timer)
    scene = pipe.scenes[setup.ref]
    names = {"prior_build": "_prior_build", "prior": "_prior"}
    ncc_cuda.COUNTS.reset()
    ncc_sorted.COUNTS.reset()
    pass_s, step_s, checks = {}, {}, {}
    for tag, geom, prior in pipe.pass_schedule():
        n_log = len(pipe.solve_log)
        span = record_function(PASS_SPAN + tag) if traced \
            else contextlib.nullcontext()
        with span:
            t0 = time.perf_counter()
            res = pipe.process_view(scene, geom, prior, log=lambda *a: None)
            device_sync(dev)
            pass_s[tag] = time.perf_counter() - t0
        for _, stage, s in pipe.solve_log[n_log:]:
            step_s[tag + names.get(stage, "")] = s
        kind = "prior" if prior else "geom" if geom else "photometric"
        checks[tag] = pass_check(res, inputs.gt, kind)
    return {"pass_s": pass_s, "step_s": step_s,
            "schedule_s": sum(pass_s.values()), "checks": checks,
            "ncc": {"kernel": ncc_cuda.COUNTS.kernel,
                    "plain": ncc_cuda.COUNTS.plain,
                    "sorted_kernel": ncc_sorted.COUNTS.kernel,
                    "sorted_plain": ncc_sorted.COUNTS.plain}}


def check_runs(runs: List[dict], expected_calls: int, steps: List[str],
               limits: Dict[str, float], device_type: str) -> List[str]:
    """What is wrong with a cell's runs; empty when every run ran the
    ``steps`` (solves and prior builds, in order), every pass of every run
    has finite depths and normals and median |d-gt|/gt below its kind's
    entry of ``limits``, the NCC went ``expected_calls`` times through the
    device's implementation (the kernel on a card, the plain version on the
    CPU) and never through the other or the sorted path, and every run gave
    the same depth digests."""
    fails = []
    on, off = ("kernel", "plain") if device_type == "cuda" else \
        ("plain", "kernel")
    for i, run in enumerate(runs):
        if list(run["step_s"]) != steps:
            fails.append(f"run {i}: steps {list(run['step_s'])}, the "
                         f"schedule has {steps}")
        for name, c in run["checks"].items():
            if not c["finite"]:
                fails.append(f"run {i} {name}: non-finite depth or normal")
            limit = limits[c["kind"]]
            if not c["median_rel_err"] < limit:
                fails.append(f"run {i} {name}: median |d-gt|/gt "
                             f"{c['median_rel_err']} >= {limit}")
        n = run["ncc"]
        if n[on] != expected_calls:
            fails.append(f"run {i}: {n[on]} NCC {on} calls, the schedule "
                         f"implies {expected_calls}")
        for k in (off, "sorted_kernel", "sorted_plain"):
            if n[k]:
                fails.append(f"run {i}: {n[k]} NCC {k} calls, expected 0")
    digests = [{k: c["digest"] for k, c in r["checks"].items()}
               for r in runs]
    if any(d != digests[0] for d in digests):
        fails.append(f"depth digests differ between runs: {digests}")
    return fails


@contextlib.contextmanager
def planted(control: Optional[str]):
    """Plant the fault ``control`` names (:data:`CONTROLS`; None plants
    nothing) for a control run, by wrapping or replacing the function the
    path looks up at call time; the kernels and their counts still run.
    The exchange controls replace a collective by a local stand-in on every
    rank alike, so no rank waits for another."""
    from mpmvs_torch.ops import ncc_cuda, propagation
    from mpmvs_torch.parallel import mesh, view_sharding

    saved, stub = [], False

    def swap(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def wrap(mod, name, after):
        fn = getattr(mod, name)
        swap(mod, name, lambda *a, **k: after(fn(*a, **k)))

    def mask_off(pr):
        if pr is not None:
            pr.mask[:] = False
        return pr

    def own_rows(group, depths, slots, shape):
        n = sum(map(len, slots))
        table = torch.zeros((n + 1,) + tuple(shape), device=group.device)
        for i, d in zip(slots[group.rank], depths):
            table[i] = d
        return table

    def own_items(group, slots, local, spec):
        if group.rank:
            return None
        mine = dict(zip(slots[0], local))
        zero = tuple(torch.zeros(shape, dtype=dtype, device=group.device)
                     for shape, dtype in spec)
        return [tuple(mine.get(i, zero)) for i in range(sum(map(len, slots)))]

    if control in ("ncc_bf16", "ncc_fp8"):
        low = torch.bfloat16 if control == "ncc_bf16" else \
            torch.float8_e4m3fn
        for name in ("ncc_eval_multi_kernel", "ncc_eval_multi_plain"):
            wrap(ncc_cuda, name, lambda c: c.to(low).to(c.dtype))
    elif control == "geom_cost_zero":
        wrap(propagation, "geom_consistency_cost", torch.zeros_like)
    elif control == "prior_off":
        for mod in _prior_modules():
            wrap(mod, "build_planar_prior", mask_off)
    elif control == "exchange_drop":
        swap(view_sharding, "gather_depth_table", own_rows)
    elif control == "final_gather_drop":
        swap(mesh, "gather_items_to_root", own_items)
    elif control == "foreign_module":
        stub = "mpmvs_tpu" not in sys.modules
        sys.modules.setdefault("mpmvs_tpu", types.ModuleType("mpmvs_tpu"))
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)
        if stub:
            del sys.modules["mpmvs_tpu"]


def foreign_modules() -> List[str]:
    """The modules of :data:`FOREIGN` that this process has imported."""
    return [m for m in FOREIGN if m in sys.modules]


def _prior_modules():
    """The modules whose ``build_planar_prior`` the passes look up: the
    serial pipeline's and a rank's."""
    from mpmvs_torch import pipeline
    from mpmvs_torch.parallel import view_sharding

    return pipeline, view_sharding


# ---------------------------------------------------------------------------
# Host readings: what could explain a stall
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def host_window():
    """Readings of this process over the ``with`` body, in the yielded dict
    once the body ends: cyclic-GC collections by generation with their
    summed and longest seconds (timed around each collection through
    ``gc.callbacks``), voluntary and involuntary context switches
    (``resource.getrusage`` deltas over every thread of the process), and
    its CPU seconds against the wall seconds."""
    n, secs, longest, start = [0, 0, 0], [0.0] * 3, [0.0] * 3, [None]

    def clock(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        elif start[0] is not None:
            g, dt = info["generation"], time.perf_counter() - start[0]
            n[g] += 1
            secs[g] += dt
            longest[g] = max(longest[g], dt)
            start[0] = None

    out: dict = {}
    r0, t0 = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
    gc.callbacks.append(clock)
    try:
        yield out
    finally:
        gc.callbacks.remove(clock)
        t1, r1 = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
        d = lambda k: getattr(r1, k) - getattr(r0, k)
        cpu = d("ru_utime") + d("ru_stime")
        out.update(gc={"collections": n, "s": secs, "longest_s": longest},
                   switches={"voluntary": d("ru_nvcsw"),
                             "involuntary": d("ru_nivcsw")},
                   cpu_s=cpu, wall_s=t1 - t0)


@contextlib.contextmanager
def prior_build_clock(log: List[dict]):
    """Log each prior build's wall and process CPU seconds (``time
    .process_time``: every thread) into ``log``, by wrapping
    ``build_planar_prior`` where the passes look it up."""
    mods = _prior_modules()
    saved = [m.build_planar_prior for m in mods]

    def clocked(build):
        def inner(*a, **k):
            c0, t0 = time.process_time(), time.perf_counter()
            try:
                return build(*a, **k)
            finally:
                log.append({"wall_s": time.perf_counter() - t0,
                            "cpu_s": time.process_time() - c0})
        return inner

    for m, build in zip(mods, saved):
        m.build_planar_prior = clocked(build)
    try:
        yield log
    finally:
        for m, build in zip(mods, saved):
            m.build_planar_prior = build


def host_layer(windows: List[dict],
               builds: Optional[List[List[dict]]]) -> dict:
    """The ``layers.host`` readings of a cell: one entry a timed run in
    each list (``windows`` from :func:`host_window`; ``builds``, each run's
    prior builds from :func:`prior_build_clock`, or None where the
    schedule builds no prior)."""
    per = lambda f: [f(w) for w in windows]
    out = {"gc": {k: per(lambda w: w["gc"][k])
                  for k in ("collections", "s", "longest_s")},
           "switches": {k: per(lambda w: w["switches"][k])
                        for k in ("voluntary", "involuntary")},
           "cpu_s": per(lambda w: w["cpu_s"]),
           "wall_s": per(lambda w: w["wall_s"])}
    if builds is not None:
        out["prior_build"] = {k: [sum(b[k] for b in run) for run in builds]
                              for k in ("wall_s", "cpu_s")}
    return out


# ---------------------------------------------------------------------------
# The traced run
# ---------------------------------------------------------------------------


def _merge(intervals) -> List[List[int]]:
    """Sorted disjoint union of (start, end) intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(merged, a: int, b: int) -> int:
    """Length of [a, b] that the merged intervals cover."""
    i = max(bisect.bisect_right([s for s, _ in merged], a) - 1, 0)
    total = 0
    for s, e in merged[i:]:
        if s >= b:
            break
        total += max(0, min(e, b) - max(s, a))
    return total


@dataclasses.dataclass
class _Trace:
    """A trace's raw events sorted out (:func:`_read_trace`)."""

    passes: Dict[str, Tuple[int, int]]   # the bench's ranges, by name
    stages: List[Tuple[int, int]]         # the pipeline's ranges
    ranges: Dict[str, List[Tuple[int, int]]]  # solve_trace's, by kind
    launch_at: Dict[int, int]             # host op start by correlation id
    device: List[tuple]                   # (start, end, name, linked id)
    syncs: int


def _read_trace(events) -> _Trace:
    from torch.autograd import DeviceType

    from mpmvs_torch.tools.solve_trace import RANGES, SYNC_EVENTS

    t = _Trace({}, [], {}, {}, [], 0)
    range_of = {v: k for k, v in RANGES.items()}
    ours = (PASS_SPAN, STAGE_SPAN)
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PASS_SPAN):
                t.passes[name[len(PASS_SPAN):]] = (e.start_ns(), e.end_ns())
            elif name.startswith(STAGE_SPAN):
                t.stages.append((e.start_ns(), e.end_ns()))
            elif name in range_of:
                t.ranges.setdefault(range_of[name], []).append(
                    (e.start_ns(), e.end_ns()))
            elif name in SYNC_EVENTS:
                t.syncs += 1
            if not e.linked_correlation_id():
                t.launch_at[e.correlation_id()] = e.start_ns()
        elif not name.startswith(ours) and name not in range_of \
                and e.end_ns() > e.start_ns():
            t.device.append((e.start_ns(), e.end_ns(), name,
                             e.linked_correlation_id()))
    t.passes = dict(sorted(t.passes.items(), key=lambda kv: kv[1]))
    t.stages.sort()
    for iv in t.ranges.values():
        iv.sort()
    return t


def _device_split(t: _Trace, named) -> Tuple[Dict[str, int], dict]:
    """Device nanoseconds split as ``tools.solve_trace`` splits a
    half-iteration: the kernels of ``named`` (kind -> kernel names) by
    name, then by the ``solve_trace`` range their launching operation ran
    in, the rest as other glue; and (ns, count) by operation name."""
    from mpmvs_torch.tools.solve_trace import RANGES, named_kind

    starts = {k: [a for a, _ in iv] for k, iv in t.ranges.items()}

    def range_at(at):
        for k, iv in t.ranges.items():
            i = bisect.bisect_right(starts[k], at) - 1
            if i >= 0 and at <= iv[i][1]:
                return k
        return "other_glue"

    split = {**{k: 0 for k in named}, **{k: 0 for k in RANGES},
             "other_glue": 0}
    by_name: Dict[str, List[int]] = {}
    for a, b, name, corr in t.device:
        kind = named_kind(name, named) or range_at(t.launch_at.get(corr, -1))
        split[kind] += b - a
        agg = by_name.setdefault(name, [0, 0])
        agg[0] += b - a
        agg[1] += 1
    return split, by_name


def _top_ops(by_name, total: int, top: int) -> List[dict]:
    return [{"name": name[:120], "ms": ns / 1e6, "count": n,
             "share": ns / max(total, 1)}
            for name, (ns, n) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:top]]


def trace_split(events, steps: List[str], device_type: str,
                top: int = 8) -> dict:
    """The traced run, read from the profiler's raw events (objects with
    ``name``, ``device_type``, ``start_ns``, ``end_ns``, ``correlation_id``
    and ``linked_correlation_id``; ``profile().profiler.kineto_results
    .events()``, read directly because building function events over a
    whole schedule's events is slow). The passes are the ``bench::`` ranges;
    the pipeline's ``pipeline::`` ranges, in time order, are ``steps``.

      * per pass and per step, host seconds, and on a card the device's
        busy share inside each;
      * the device's busy and idle share over the passes (the checks
        between passes left out);
      * device time split as ``tools.solve_trace`` splits a half-iteration:
        the NCC and geometric-cost kernels by name, the rest of the
        geometric cost and the threefry hash by the host range their
        launching operation ran in, the rest as other glue;
      * the ``top`` device operations by time, and the ``top`` longest
        device idle gaps inside the passes, each named by the step the host
        was in (or ``<pass> glue`` between steps);
      * host synchronisations (calls that wait for the device), counted.
    """
    from mpmvs_torch.tools.solve_trace import NAMED_KERNELS

    t = _read_trace(events)
    passes = t.passes
    if len(t.stages) != len(steps):
        raise ValueError(f"{len(t.stages)} pipeline ranges traced for the "
                         f"steps {steps}")
    spans = dict(zip(steps, t.stages))
    t0 = min(a for a, _ in passes.values())
    out = {"passes_s": sum(b - a for a, b in passes.values()) / 1e9,
           "pass_host_s": {k: (b - a) / 1e9 for k, (a, b) in passes.items()},
           "step_host_s": {k: (b - a) / 1e9 for k, (a, b) in spans.items()},
           "host_syncs": t.syncs}
    if device_type != "cuda":
        out.update(clock="host", device_busy_share=None,
                   device_idle_share=None, split_ms=None, top_device_ops=None,
                   longest_idle_gaps=None)
        return out

    def host_in(tag, at):
        for k, (a, b) in spans.items():
            if a <= at < b:
                return k
        return f"{tag} glue"

    split, by_name = _device_split(t, NAMED_KERNELS)
    busy = _merge((a, b) for a, b, _, _ in t.device)
    share = lambda sp: {k: _covered(busy, a, b) / max(b - a, 1)
                        for k, (a, b) in sp.items()}
    passes_ns = sum(b - a for a, b in passes.values())
    busy_ns = sum(_covered(busy, a, b) for a, b in passes.values())
    total = sum(split.values())
    gaps = []
    for tag, (s, e) in passes.items():
        edges = [s] + [x for iv in busy if iv[1] > s and iv[0] < e
                       for x in iv] + [e]
        gaps += [(max(a, s), min(b, e), tag) for a, b in
                 zip(edges[::2], edges[1::2]) if min(b, e) > max(a, s)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    out.update(
        clock="device",
        device_busy_share=busy_ns / passes_ns,
        device_idle_share=1.0 - busy_ns / passes_ns,
        device_busy_ms=total / 1e6,
        split_ms={k: v / 1e6 for k, v in split.items()},
        pass_device_busy_share=share(passes),
        step_device_busy_share=share(spans),
        top_device_ops=_top_ops(by_name, total, top),
        longest_idle_gaps=[{"ms": (b - a) / 1e6, "at_s": (a - t0) / 1e9,
                            "host_in": host_in(tag, a)}
                           for a, b, tag in gaps])
    return out


def traced_run(setup: Setup, inputs: Inputs, dev: torch.device,
               steps: List[str]):
    """One whole schedule under ``torch.profiler`` (CPU and, on a card,
    CUDA activities), with ``tools.solve_trace``'s ranges around the
    geometric cost and the threefry hash. Returns the run and its split
    (:func:`trace_split`)."""
    from torch.profiler import ProfilerActivity, profile

    from mpmvs_torch.tools.solve_trace import profiler_ranges

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profiler_ranges(), profile(activities=acts) as prof:
        run = run_schedule(setup, inputs, dev, traced=True)
    t0 = time.perf_counter()
    split = trace_split(prof.profiler.kineto_results.events(), steps,
                        dev.type)
    split["analysis_s"] = time.perf_counter() - t0
    del prof
    release_host_memory()
    return run, split


def release_host_memory():
    """Free what reference cycles hold and give the C heap's free pages
    back to the system. A traced schedule's profiler events (gigabytes on
    the CPU rehearsal, 3.2 GiB a cell at 64x80) sit in cycles until a
    collection, and glibc keeps what is freed: without this, a
    two-cell rehearsal process held 6.4 GiB at its end."""
    gc.collect()
    try:
        ctypes.CDLL(None).malloc_trim(0)
    except (AttributeError, OSError):  # not glibc
        pass


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------


def _stats(values: List[float]) -> dict:
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "n": len(values), "runs": values}


def spread(values: List[float]) -> float:
    """(max - min) / median: the spread that ``BENCHMARK.json``'s
    ``bound_rule`` reads."""
    return (max(values) - min(values)) / statistics.median(values)


def run_cell(cell: Cell, setup: Setup, inputs: Inputs, dev: torch.device,
             repeats: int, device: dict) -> dict:
    """Warm-up, ``repeats`` timed runs and one traced run of ``cell``; its
    metrics, checks and trace (module doc)."""
    H, W = inputs.gt.shape
    S = len(inputs.src_results)
    cuda = dev.type == "cuda"
    plan = schedule(setup.pipeline)
    steps = [name for name, _, _ in plan]
    solves = [(name, mode) for name, _, mode in plan if mode]

    t0 = time.perf_counter()
    warm = run_schedule(setup, inputs, dev)
    warmup_s = time.perf_counter() - t0
    timed, peaks, windows, builds = [], [], [], []
    for _ in range(repeats):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        with host_window() as window, prior_build_clock([]) as build:
            timed.append(run_schedule(setup, inputs, dev))
        windows.append(window)
        builds.append(build)
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated(dev))
    traced, trace = traced_run(setup, inputs, dev, steps)

    params = setup.params
    calls = sum(expected_ncc_calls(m, params, H, W, S) for _, m in solves)
    taps = {n: solve_taps(m, params, H, W, S) for n, m in solves}
    fails = check_runs([warm] + timed + [traced], calls, steps,
                       setup.limits, dev.type)
    sched = [r["schedule_s"] for r in timed]
    solve_s = [sum(r["step_s"][n] for n, _ in solves) for r in timed]
    # the traced run minus the timed runs' median: of the whole schedule,
    # and of its solves alone (the host prior build varies more than that)
    trace["overhead_s"] = traced["schedule_s"] - statistics.median(sched)
    trace["overhead_solves_s"] = sum(
        traced["step_s"][n] for n, _ in solves) - statistics.median(solve_s)
    gib = [p / 2 ** 30 for p in peaks]
    has_prior = any(m is None for _, _, m in plan)
    return {
        "cell": cell.name, "device": device, "correct": not fails,
        "failures": fails, "repeats": repeats,
        "scene": {"height": H, "width": W, "sources": S,
                  **{k: v for k, v in setup.scene_args.items()
                     if k not in ("height", "width")}},
        "steps": [{"name": n, "pass": t, "mode": m} for n, t, m in plan],
        "limits": setup.limits,
        "metrics": {
            "depth_maps_per_s": {
                "value": repeats / sum(sched), "unit": "depth maps/s",
                "clock": "host, each solve ending in a device sync" if cuda
                else "host", "schedules": repeats, "window_s": sum(sched)},
            "peak_device_memory_gib": {
                "value": max(gib) if gib else None, "unit": "GiB",
                "runs": gib, "bytes": max(peaks) if peaks else None,
                **({} if cuda else {"note": "not measured on the CPU"})}},
        "layers": {
            "schedule_s": _stats(sched),
            "spread_within_process": spread([1 / x for x in sched]),
            "pass_s": {t: _stats([r["pass_s"][t] for r in timed])
                       for t in timed[0]["pass_s"]},
            "step_s": {n: _stats([r["step_s"][n] for r in timed])
                       for n in steps},
            "ncc": {"launches_per_depth_map": timed[0]["ncc"]["kernel"],
                    "plain_calls_per_depth_map": timed[0]["ncc"]["plain"],
                    "expected_calls_per_depth_map": calls,
                    "taps_per_depth_map": sum(taps.values()),
                    "taps_per_s": {"value": sum(taps.values())
                                   / statistics.median(solve_s),
                                   "unit": "taps/s",
                                   "over": "the solves' seconds"},
                    "taps_per_s_by_solve": {
                        n: taps[n] / statistics.median(
                            [r["step_s"][n] for r in timed])
                        for n, _ in solves}},
            "setup_s": {"warmup_run": warmup_s},
            "host": host_layer(windows, builds if has_prior else None)},
        "checks": {"per_pass_last_run": timed[-1]["checks"],
                   "median_rel_err_max": {
                       t: max(r["checks"][t]["median_rel_err"]
                              for r in [warm] + timed + [traced])
                       for t in timed[0]["checks"]},
                   "ncc_per_run": [r["ncc"] for r in [warm] + timed
                                   + [traced]]},
        "trace": trace,
    }


# ---------------------------------------------------------------------------
# A sharded cell: the view-sharded pipeline over several cards
# ---------------------------------------------------------------------------


def launch_trace(fn, dev: torch.device, top: int = 8) -> dict:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities) with
    ``tools.solve_trace``'s ranges, as one ``bench::launch`` range; its
    device busy share over that range, its device time split as
    :func:`trace_split` splits it (NCCL's kernels named as ``collective``)
    and its ``top`` device operations."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mpmvs_torch.tools.solve_trace import NAMED_KERNELS, profiler_ranges

    with profiler_ranges(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(PASS_SPAN + "launch"):
            fn()
    t0 = time.perf_counter()
    t = _read_trace(prof.profiler.kineto_results.events())
    a, b = t.passes["launch"]
    split, by_name = _device_split(
        t, {**NAMED_KERNELS, "collective": ("nccl",)})
    total = sum(split.values())
    return {"clock": "device", "window_s": (b - a) / 1e9,
            "device_busy_ms": total / 1e6,
            "device_busy_share": _covered(
                _merge((x, y) for x, y, _, _ in t.device), a, b) / (b - a),
            "split_ms": {k: v / 1e6 for k, v in split.items()},
            "top_device_ops": _top_ops(by_name, total, top),
            "host_syncs": t.syncs,
            "analysis_s": time.perf_counter() - t0}


@contextlib.contextmanager
def exchange_log(log: List[dict]):
    """While open, each collective of a rank's launch that carries depth
    maps (``view_sharding.gather_depth_table``, ``mesh
    .gather_items_to_root``) is recorded into ``log``: its name, and host
    copies of what this rank sent (its views' items, by batch index) and of
    what it received (every view's item; None on the ranks that receive
    nothing). The copies are made once ``ShardedPipeline._collective`` has
    closed its timing of the collective, so its milliseconds stay the
    collective's own; the maps stay referenced only until then.
    :func:`exchange_digests` turns the log into digests."""
    from mpmvs_torch.parallel import mesh, view_sharding

    pending: list = []
    table_fn, root_fn = view_sharding.gather_depth_table, \
        mesh.gather_items_to_root
    collective = view_sharding.ShardedPipeline._collective

    def table(group, depths, slots, shape):
        out = table_fn(group, depths, slots, shape)
        pending.append(("depth_all_gather",
                        list(zip(slots[group.rank], [(d,) for d in depths])),
                        [(i, (out[i],)) for i in range(len(out) - 1)]))
        return out

    def root(group, slots, local, spec):
        out = root_fn(group, slots, local, spec)
        pending.append(("result_gather", list(zip(slots[group.rank], local)),
                        None if out is None else list(enumerate(out))))
        return out

    def timed(self, op, tag, fn, nbytes):
        out = collective(self, op, tag, fn, nbytes)
        host = lambda items: {i: [_np(t) for t in item] for i, item in items}
        for name, sent, got in pending:
            log.append({"op": name, "sent": host(sent),
                        "got": None if got is None else host(got)})
        pending.clear()
        return out

    view_sharding.gather_depth_table = table
    mesh.gather_items_to_root = root
    view_sharding.ShardedPipeline._collective = timed
    try:
        yield log
    finally:
        view_sharding.gather_depth_table = table_fn
        mesh.gather_items_to_root = root_fn
        view_sharding.ShardedPipeline._collective = collective


def exchange_digests(log: List[dict]) -> List[dict]:
    """:func:`exchange_log`'s record with each item's arrays as one digest,
    keyed by the view's batch index."""
    digests = lambda items: {str(i): _digest(*a) for i, a in items.items()}
    return [{"op": e["op"], "sent": digests(e["sent"]),
             "got": None if e["got"] is None else digests(e["got"])}
            for e in log]


def exchange_faults(by_rank: List[List[dict]], ops: List[str]) -> List[str]:
    """What is wrong with one launch's exchanges (``by_rank``, each rank's
    :func:`exchange_digests`); empty when every rank ran the collectives
    ``ops`` in order, the ranks together sent every view once, and every
    rank that received a collective's items received, for every view, the
    bytes its owner sent."""
    fails = []
    for r, log in enumerate(by_rank):
        if [e["op"] for e in log] != ops:
            fails.append(f"rank {r} exchanged {[e['op'] for e in log]}, the "
                         f"schedule has {ops}")
    if fails:
        return fails
    for c, op in enumerate(ops):
        sent: Dict[str, str] = {}
        for log in by_rank:
            if set(sent) & set(log[c]["sent"]):
                fails.append(f"{op} {c}: a view sent by two ranks")
            sent.update(log[c]["sent"])
        got = [log[c]["got"] for log in by_rank]
        if op == "result_gather" and got[0] is None:
            fails.append(f"{op} {c}: rank 0 received nothing")
        for r, g in enumerate(got):
            if g is None:
                continue
            wrong = sorted((v for v in set(sent) | set(g)
                            if g.get(v) != sent.get(v)), key=int)
            if wrong:
                fails.append(f"{op} {c}: rank {r} received other bytes than "
                             f"their owners sent for views {wrong}")
    return fails


def _bench_rank(group, config, params, control: Optional[str],
                traced: bool):
    """One rank of a sharded cell's launch: the program's own rank entry,
    ``view_sharding._run_rank``, unchanged, under the planted ``control``,
    with this process's host readings (:func:`host_window`,
    :func:`prior_build_clock`), its exchanges (:func:`exchange_log`), its
    peak device memory, the modules of :data:`FOREIGN` it holds at its end
    and, on rank 0 of a ``traced`` launch on a card, its trace
    (:func:`launch_trace`); written to ``MPMVS/bench_rank_<r>.json`` beside
    the rank's own record."""
    from mpmvs_torch.parallel import view_sharding

    dev = group.device
    cuda = dev.type == "cuda"
    run = lambda: view_sharding._run_rank(group, config, params, False,
                                          False)
    trace = None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with planted(control), exchange_log([]) as exchanges, host_window() \
            as window, prior_build_clock([]) as builds:
        if traced and cuda and group.rank == 0:
            trace = launch_trace(run, dev)
        else:
            run()
        leaked = foreign_modules()
    path = os.path.join(config.output_folder, "MPMVS",
                        f"bench_rank_{group.rank}.json")
    with open(path, "w") as f:
        json.dump({"host": window, "prior_builds": builds,
                   "exchanges": exchange_digests(exchanges),
                   "foreign_modules": leaked, "trace": trace,
                   "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if cuda else None)}, f)


@contextlib.contextmanager
def bench_launches(control: Optional[str], traced: bool):
    """While open, ``view_sharding.launch`` makes the launch's two calls
    (spawn the ranks, check the PLY) with :func:`_bench_rank` as the ranks'
    entry, so that ``tools.scaling_bench.run_ranks`` times and reads a
    launch of the bench's."""
    from mpmvs_torch.bench import _bench_rank as entry   # picklable by name
    from mpmvs_torch.parallel import mesh, view_sharding

    def launch(config, params=None, world_size=None, device_type="cuda",
               device_ids=None, resume=False, write_jpg=True):
        mesh.spawn(entry, (config, params, control, traced), world_size,
                   device_type, device_ids)
        ply = os.path.join(config.output_folder, "MPMVS", "MPMVS_model.ply")
        if not os.path.exists(ply):
            raise RuntimeError(f"the sharded run wrote no {ply}")
        return ply

    saved = view_sharding.launch
    view_sharding.launch = launch
    try:
        yield
    finally:
        view_sharding.launch = saved


def check_launches(runs: List[dict], calls_per_view: int, limit: float,
                   ops: List[str], device_type: str) -> List[str]:
    """What is wrong with a sharded cell's launches; empty when every
    launch wrote the PLY with the same point count, gave the same depth
    digests, launched the NCC on each rank ``calls_per_view`` times for
    each of its views through the device's implementation (never the
    other, never the sorted path), carried in its collectives ``ops`` what
    each view's owner sent (:func:`exchange_faults`), left every view's
    median |d-gt|/gt below ``limit``, and no rank held a module of
    :data:`FOREIGN`."""
    fails = []
    on, off = ("ncc_eval", "ncc_eval_plain") if device_type == "cuda" else \
        ("ncc_eval_plain", "ncc_eval")
    for i, run in enumerate(runs):
        ranks = run["bench_ranks"]
        fails += [f"launch {i}: {f}" for f in exchange_faults(
            [b["exchanges"] for b in ranks], ops)]
        for r, b in enumerate(ranks):
            if b["foreign_modules"]:
                fails.append(f"launch {i} rank {r}: imported "
                             f"{b['foreign_modules']}")
        for r, (views, n) in enumerate(zip(run["views_by_rank"],
                                           run["launches_by_rank"])):
            want = calls_per_view * len(views)
            if n[on] != want:
                fails.append(f"launch {i} rank {r}: {n[on]} NCC {on} calls, "
                             f"the schedule implies {want}")
            for k in (off, "ncc_sorted", "ncc_sorted_plain", "ncc_keys"):
                if n[k]:
                    fails.append(f"launch {i} rank {r}: {n[k]} {k} calls, "
                                 "expected 0")
        for v, err in run["median_rel_err"].items():
            if not err < limit:
                fails.append(f"launch {i} view {v}: median |d-gt|/gt "
                             f"{err} >= {limit}")
    for key in ("fused_points", "depth_digests"):
        if any(r[key] != runs[0][key] for r in runs):
            fails.append(f"{key} differ between launches: "
                         f"{[r[key] for r in runs]}")
    return fails


def run_sharded_cell(cell: Cell, setup: Setup, dev: torch.device,
                     repeats: int, device: dict,
                     control: Optional[str]) -> dict:
    """A sharded cell: its scene written once as a workspace
    (``tools.scaling_bench.write_scene``), one untimed warm-up launch
    (traced on rank 0 on a card) and ``repeats`` timed launches of the
    view-sharded pipeline over ``setup.ranks`` ranks, each read by
    ``scaling_bench.run_ranks``; its metrics, checks and trace."""
    from mpmvs_torch.tools import scaling_bench

    R, V = setup.ranks, setup.views
    cuda = dev.type == "cuda"
    args = setup.scene_args
    root = tempfile.mkdtemp(prefix="mpmvs_bench_")
    launches = []
    try:
        t0 = time.perf_counter()
        ws = os.path.join(root, "ws")
        scene = scaling_bench.write_scene(ws, V, setup.sources,
                                          args["height"], args["width"],
                                          args["seed"], dev)
        scene_s = time.perf_counter() - t0
        for k in range(repeats + 1):
            out = os.path.join(root, f"out_{k}")
            with bench_launches(control, traced=k == 0):
                run = scaling_bench.run_ranks(ws, out, R, dev.type,
                                              setup.params, scene, V)
            run["bench_ranks"], stages = [], []
            for r in range(R):
                mp = os.path.join(out, "MPMVS")
                with open(os.path.join(mp, f"bench_rank_{r}.json")) as f:
                    run["bench_ranks"].append(json.load(f))
                with open(os.path.join(mp, f"rank_{r}.json")) as f:
                    stages.append(json.load(f)["stages"])
            run["fusion_s"] = stages[0]["fusion"]["total_s"]
            launches.append(run)
            shutil.rmtree(out, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    warm, timed = launches[0], launches[1:]
    H, W = args["height"], args["width"]
    plan = schedule(setup.pipeline)
    calls = sum(expected_ncc_calls(m, setup.params, H, W, setup.sources)
                for _, _, m in plan if m)
    # one depth all-gather a geometric pass, then the gather to rank 0
    ops = ["depth_all_gather" for n, t, m in plan if n == t and m == "geom"]
    ops.append("result_gather")
    fails = check_launches(launches, calls, setup.limits["final"], ops,
                           dev.type)
    passes = [r["passes_s"] for r in timed]
    walls = [r["wall_s"] for r in timed]
    peaks = [b["peak_bytes"] for r in timed for b in r["bench_ranks"]]
    # each reading as the one-card cells record it, one entry a rank
    by_rank = [host_layer([r["bench_ranks"][k]["host"] for r in timed],
                          [r["bench_ranks"][k]["prior_builds"]
                           for r in timed])
               for k in range(R)]
    host = {key: [h[key] for h in by_rank] for key in by_rank[0]}
    keep = ("pass_wall_s_by_rank", "prior_build_s_by_rank", "collectives",
            "launches_by_rank")
    return {
        "cell": cell.name, "device": device, "correct": not fails,
        "failures": fails, "repeats": repeats,
        "scene": {"height": H, "width": W, "sources": setup.sources,
                  "estimated_views": V, "ranks": R,
                  "views": max(V, setup.sources + 1), "seed": args["seed"]},
        "steps": [{"name": n, "pass": t, "mode": m} for n, t, m in plan],
        "limits": setup.limits,
        "metrics": {
            "depth_maps_per_s": {
                "value": V * repeats / sum(passes), "unit": "depth maps/s",
                "clock": "host; each pass at its slowest rank's wall, each "
                         "ending in a device sync and a barrier",
                "launches": repeats, "window_s": sum(passes)},
            "peak_device_memory_gib": {
                "value": max(peaks) / 2 ** 30 if cuda else None,
                "unit": "GiB", "bytes_by_rank": [
                    [b["peak_bytes"] for b in r["bench_ranks"]]
                    for r in timed],
                **({} if cuda else {"note": "not measured on the CPU"})}},
        "layers": {
            "passes_s": _stats(passes),
            "spread_within_process": spread([V / x for x in passes]),
            "pass_wall_s": {t: _stats([r["pass_wall_s"][t] for r in timed])
                            for t in timed[0]["pass_wall_s"]},
            **{k: [r[k] for r in timed] for k in keep},
            "views_by_rank": timed[0]["views_by_rank"],
            "launch_s": _stats(walls),
            "outside_passes_s": _stats([w - p for w, p in zip(walls,
                                                               passes)]),
            "fusion_s": _stats([r["fusion_s"] for r in timed]),
            "setup_s": {"scene": scene_s, "warmup_launch": warm["wall_s"]},
            "host": host},
        "checks": {"median_rel_err_max": {
                       str(v): max(r["median_rel_err"][v] for r in launches)
                       for v in warm["median_rel_err"]},
                   "fused_points": [r["fused_points"] for r in launches],
                   "ncc_per_view": calls,
                   "depth_digests": warm["depth_digests"],
                   "exchanges": {"ops": ops, "launches": len(launches)}},
        "trace": warm["bench_ranks"][0]["trace"] if cuda else
        {"clock": "host", "device_busy_share": None, "split_ms": None,
         "top_device_ops": None},
    }


def main(argv=None) -> int:
    cells = load_cells()
    named = {**cells, **load_cells(PENDING)}
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", action="append", choices=sorted(named),
                    help="a cell to run (repeatable; default: every cell "
                         "of BENCHMARK.json; a pending cell runs only when "
                         "named)")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed runs per cell (default: the cell's own)")
    ap.add_argument("--seed", type=int, default=None,
                    help="the scene's seed (default: the configuration's)")
    ap.add_argument("--control", choices=sorted(CONTROLS), default=None,
                    help="plant a known fault for a control run: " + "; "
                    .join(f"{k}: {v}" for k, v in CONTROLS.items()))
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="'cpu': the tiny rehearsal of the tests")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    if args.repeats is not None and args.repeats < 1:
        # the warm-up's digests are compared with the timed runs' too
        ap.error("--repeats must be at least 1")

    from mpmvs_torch.tools import build_kernels, device_record

    if args.device == "cuda" and not torch.cuda.is_available():
        print("mpmvs_torch.bench needs a CUDA device; none is available "
              "(--device cpu is the tests' rehearsal, not the benchmark)",
              file=sys.stderr)
        return 2
    rehearsal = args.device == "cpu"
    dev = torch.device("cuda", 0) if not rehearsal else torch.device("cpu")
    if not rehearsal:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = device_record(dev)
    if not rehearsal:
        device["count"] = torch.cuda.device_count()

    t0 = time.perf_counter()
    build_kernels(dev)
    build_s = time.perf_counter() - t0
    threads = {"torch": torch.get_num_threads(),
               **{k: os.environ.get(k) for k in PINNED}}
    print(json.dumps({"setup_s": {"build_kernels": build_s},
                      "control": args.control, "host_threads": threads,
                      "device": device}), flush=True)

    # every cell this host has the cards for, unless cells are named
    setups = {n: setup_of(named[n].config, rehearsal, args.seed)
              for n in args.cell or list(cells)}
    cards = torch.cuda.device_count() if not rehearsal else 0
    short = {n: f"needs {s.ranks} CUDA devices, this host has {cards}"
             for n, s in setups.items() if not rehearsal and s.ranks > cards}
    if args.cell and short:
        print("; ".join(f"{n} {why}" for n, why in short.items()),
              file=sys.stderr)
        return 2
    results, scenes = [], {}
    with planted(args.control):
        for name, setup in setups.items():
            if name in short:
                continue
            cell = named[name]
            repeats = args.repeats or cell.repeats
            if setup.ranks:
                res = run_sharded_cell(cell, setup, dev, repeats, device,
                                       args.control)
                res["layers"]["setup_s"]["build_kernels"] = build_s
            else:
                key = json.dumps([setup.generator, setup.scene_args,
                                  setup.ref, setup.sources], sort_keys=True)
                if key not in scenes:       # cells of one scene share it
                    t0 = time.perf_counter()
                    scenes = {key: (load_inputs(setup, dev),
                                    time.perf_counter() - t0)}
                inputs, scene_s = scenes[key]
                res = run_cell(cell, setup, inputs, dev, repeats, device)
                res["layers"]["setup_s"].update(build_kernels=build_s,
                                                scene=scene_s)
            res["foreign_modules"] = foreign_modules()
            if res["foreign_modules"]:
                res["failures"].append(f"imported {res['foreign_modules']}")
                res["correct"] = False
            res.update(rehearsal=rehearsal, control=args.control,
                       host_threads=threads)
            results.append(res)
            print(json.dumps(res), flush=True)
    summary = {
        "ok": all(r["correct"] for r in results), "rehearsal": rehearsal,
        "control": args.control, "device": device, "skipped": short,
        "cells": {r["cell"]: {"correct": r["correct"],
                              **{k: m["value"]
                                 for k, m in r["metrics"].items()}}
                  for r in results}}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "cells": results}, f, indent=1)
    print(device.get("nvidia_smi", device["kind"]), flush=True)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    if any(os.environ.get(k) != v for k, v in PINNED.items()):
        os.execvpe(sys.executable, [sys.executable, "-m", __spec__.name]
                   + sys.argv[1:], {**os.environ, **PINNED})
    sys.exit(main())
