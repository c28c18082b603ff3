"""``mpmvs_torch.bench``, the port's headline benchmark, on the CPU.

* Its accounting equals the root ``bench.py``'s (the JAX package's TPU
  bench, imported from its file; the port does not import it): the unit
  labels of every mode (``_schedule``, bench.py:120-131) and the NCC tap
  counts (bench.py:192-199), for the default ``PatchMatchParams`` and
  another ``max_scale`` / ``max_iterations`` / ``geom_iterations``.
* The NCC calls it expects are ``chip_smoke.py``'s counts at the full
  size (55 per depth map in the first cell, 68 in the second) and what a
  CPU run of each cell counts through ``ops.ncc_cuda.COUNTS`` (plain calls)
  with several row bands.
* The cells come from ``BENCHMARK.json`` and their configuration files:
  the schedule is ``Pipeline.pass_schedule``'s under the configuration's
  ``ConfigParams``.
* A ``--device cpu`` rehearsal of the command, a fresh process, emits
  every metric that ``BENCHMARK.json`` declares for each cell, with its
  unit, labelled ``cpu``, ``correct`` true, and the summary as its last
  line; so does the pending 4-card cell's, named, on 2 gloo ranks. A
  rehearsal or control process that leaves no record fails the fixture
  with its name, exit code and the end of its stderr (kept in a file).
  ``tools.tree_memory``, which read those processes' memory, sees a
  child's.
* The correctness gate trips on a depth map scaled by 1.05, on a NaN, on
  one plain NCC call, on a missing launch, on a skipped step, on a pass
  over its kind's limit and on differing digests; the sharded gate on
  what a collective carried that its owner did not send, and on a module
  of JAX or of the JAX package in a rank.
* Each control (``--control``) plants its fault in the solve and only
  while it is on; the control runs of the exchanges and of an import come
  out not correct.
* Without a card (``CUDA_VISIBLE_DEVICES`` empty) the benchmark's own
  command exits non-zero and prints no result.
* ``BENCHMARK.json`` is well formed: two cells, each naming an existing
  configuration with a limit for every pass kind, one chip, every
  end-to-end metric with a unit, a direction and a bound; the 4-card cell
  waits in ``BENCHMARK_PENDING.json`` with the same fields.
* The traced run's reading of the profiler's events (busy and idle share,
  split, gaps named by the step) on a hand-made event list.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.autograd import DeviceType

from mpmvs_tpu.params import PatchMatchParams as JaxParams
from mpmvs_torch import bench, interop
from mpmvs_torch.params import ConfigParams, PatchMatchParams
from mpmvs_torch.solver import SolveResult
from mpmvs_torch.tools import bench_spread, tree_memory
from mpmvs_torch.tools.solve_trace import NAMED_KERNELS, RANGES, named_kind

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_BENCH = _load("jax_root_bench", os.path.join(REPO, "bench.py"))
CHIP_SMOKE = _load("chip_smoke_consts", os.path.join(REPO, "chip_smoke.py"))
with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCHMARK = json.load(_f)
with open(os.path.join(REPO, "BENCHMARK_PENDING.json")) as _f:
    PENDING = json.load(_f)


@pytest.mark.parametrize("fields", [
    {}, {"max_scale": 1, "max_iterations": 2, "geom_iterations": 3}])
def test_schedule_and_taps_match_the_jax_bench(fields):
    jp = JaxParams(**fields)
    tp = interop.params_from_jax_fields(dataclasses.asdict(jp))
    for mode in ("photometric", "geom", "prior", "geom_prior"):
        assert bench.schedule_units(mode, tp) == JAX_BENCH._schedule(mode, jp)
    # bench.py:192-199, at its operating point
    H, W, S, T = JAX_BENCH.HEIGHT, JAX_BENCH.WIDTH, 10, jp.ncc_taps
    taps_init = H * W * S * T
    taps_half = (H * W // 2) * 14 * S * T
    n_half_photo = (jp.max_scale + 1) * jp.max_iterations * 2
    n_half_geom = jp.geom_iterations * 2
    assert bench.solve_taps("photometric", tp, H, W, S) == \
        taps_init + n_half_photo * taps_half
    assert bench.solve_taps("geom", tp, H, W, S) == \
        taps_init + n_half_geom * taps_half


CELLS = bench.load_cells()
# the cells that solve one view on one card (the sharded cell, pending, has
# its own tests below)
VIEW_CELLS = {n: c for n, c in CELLS.items() if not c.config.get("ranks")}
SHARDED = "views8_s10_default_4card"
PENDING_CELLS = bench.load_cells(bench.PENDING)
# the layers.host readings every cell records (and the prior build's where
# its schedule builds a prior)
HOST_READINGS = ("gc", "switches", "cpu_s", "wall_s")
SETUPS = {n: bench.setup_of(c.config, rehearsal=False)
          for n, c in VIEW_CELLS.items()}
REHEARSALS = {n: bench.setup_of(c.config, rehearsal=True)
              for n, c in VIEW_CELLS.items()}


def test_full_size_ncc_calls_are_chip_smokes():
    p = PatchMatchParams()
    setup = SETUPS["view_s10_default_prior"]
    H, W = setup.scene_args["height"], setup.scene_args["width"]
    assert (H, W) == (JAX_BENCH.HEIGHT, JAX_BENCH.WIDTH)
    assert setup.sources == 10
    calls = lambda mode: bench.expected_ncc_calls(mode, p, H, W, 10)
    assert calls("photometric") == CHIP_SMOKE.NCC_PHOTOMETRIC == 37
    assert calls("geom") == CHIP_SMOKE.NCC_GEOM == 9
    assert calls("prior") == CHIP_SMOKE.NCC_PRIOR == 13
    per_cell = {name: sum(calls(m) for _, _, m in bench.schedule(s.pipeline)
                          if m) for name, s in SETUPS.items()}
    assert per_cell == {"view_s10_photo_geom2": 55,
                        "view_s10_default_prior": 68}
    assert all(s.params == p for s in SETUPS.values())


def test_default_schedule_is_the_pipelines():
    got = bench.schedule(SETUPS["view_s10_default_prior"].pipeline)
    assert got == bench.schedule(ConfigParams()) == [
        ("photometric", "photometric", "photometric"),
        ("geom_0", "geom_0", "geom"),
        ("geom_0_prior_build", "geom_0", None),
        ("geom_0_prior", "geom_0", "prior"),
        ("geom_1", "geom_1", "geom")]
    keep = bench.schedule(ConfigParams(geom_prior_consistency=True))
    assert [m for n, _, m in keep if n == "geom_0_prior"] == ["geom_prior"]
    assert [m for _, _, m in bench.schedule(
        SETUPS["view_s10_photo_geom2"].pipeline)] == \
        ["photometric", "geom", "geom"]


def test_setup_reads_the_configuration_and_its_rehearsal():
    cfg = CELLS["view_s10_default_prior"].config
    full, tiny = SETUPS["view_s10_default_prior"], \
        REHEARSALS["view_s10_default_prior"]
    assert full.scene_args == cfg["scene"]["args"]
    assert full.limits == cfg["median_rel_err_limit"]
    assert tiny.scene_args == {**cfg["scene"]["args"],
                               **cfg["rehearsal"]["scene_args"]}
    assert tiny.params == PatchMatchParams(**cfg["rehearsal"]["solver"])
    assert (tiny.sources, tiny.limits) == (
        cfg["rehearsal"]["sources"], cfg["rehearsal"]["median_rel_err_limit"])
    assert bench.setup_of(cfg, False, seed=7).scene_args == \
        {**cfg["scene"]["args"], "seed": 7}


@pytest.fixture(scope="module")
def tiny_inputs():
    return bench.load_inputs(REHEARSALS["view_s10_default_prior"],
                             torch.device("cpu"))


@pytest.mark.parametrize("cell", sorted(VIEW_CELLS))
def test_ncc_calls_equal_a_cpu_run_with_bands(tiny_inputs, cell):
    setup = REHEARSALS[cell]
    banded = dataclasses.replace(
        setup, params=dataclasses.replace(setup.params, band_rows=32))
    H, W = tiny_inputs.gt.shape
    S = len(tiny_inputs.src_results)
    plan = bench.schedule(setup.pipeline)
    run = bench.run_schedule(banded, tiny_inputs, torch.device("cpu"))
    calls = lambda params: sum(bench.expected_ncc_calls(m, params, H, W, S)
                               for _, _, m in plan if m)
    want = calls(banded.params)
    assert want > calls(setup.params)      # two bands, more calls than one
    assert run["ncc"] == {"kernel": 0, "plain": want, "sorted_kernel": 0,
                          "sorted_plain": 0}
    steps = [n for n, _, _ in plan]
    assert list(run["step_s"]) == steps
    assert list(run["pass_s"]) == list(run["checks"]) == \
        list(dict.fromkeys(t for _, t, _ in plan))
    assert bench.check_runs([run], want, steps, setup.limits, "cpu") == []


# the controls that reach a one-view solve; the others, of the sharded
# path and of an import, come out in their control runs below
SOLVE_CONTROLS = ("geom_cost_zero", "ncc_bf16", "ncc_fp8", "prior_off")


@pytest.mark.parametrize("control", SOLVE_CONTROLS)
def test_controls_plant_their_fault(tiny_inputs, control):
    cell = ("view_s10_default_prior" if control == "prior_off"
            else "view_s10_photo_geom2")
    setup, cpu = REHEARSALS[cell], torch.device("cpu")
    sound = bench.run_schedule(setup, tiny_inputs, cpu)
    with bench.planted(control):
        bad = bench.run_schedule(setup, tiny_inputs, cpu)
    again = bench.run_schedule(setup, tiny_inputs, cpu)
    digest = lambda r: {t: c["digest"] for t, c in r["checks"].items()}
    assert digest(again) == digest(sound)           # removed on exit
    changed = {t for t in digest(sound) if digest(bad)[t] != digest(sound)[t]}
    # the NCC controls reach every pass, the geometric cost the geometric
    # passes, the prior the pass that runs the prior sub-run and after
    assert changed == {"ncc_bf16": {"photometric", "geom_0", "geom_1"},
                       "ncc_fp8": {"photometric", "geom_0", "geom_1"},
                       "geom_cost_zero": {"geom_0", "geom_1"},
                       "prior_off": {"geom_0", "geom_1"}}[control]
    assert bad["ncc"] == sound["ncc"]


# the command's rehearsal and its control runs, each a fresh process (this
# one holds JAX, which the bench refuses), started together:
# name -> the bench's arguments
BENCH_RUNS = {
    "sound": ["--repeats", "2"],
    "sharded": ["--cell", SHARDED, "--repeats", "2"],
    "foreign_module": ["--cell", "view_s10_photo_geom2", "--cell", SHARDED,
                       "--repeats", "1", "--control", "foreign_module"],
    "exchange_drop": ["--cell", SHARDED, "--repeats", "1", "--control",
                      "exchange_drop"],
    "final_gather_drop": ["--cell", SHARDED, "--repeats", "1", "--control",
                          "final_gather_drop"],
}


@pytest.fixture(scope="module")
def bench_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    for name, argv in BENCH_RUNS.items():
        with open(tmp / f"{name}.err", "w") as err:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "mpmvs_torch.bench", "--device", "cpu",
                 "--out", str(tmp / f"{name}.json")] + argv, cwd=REPO,
                env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    out, missing = {}, []
    for name, proc in procs.items():
        try:
            stdout, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, _ = proc.communicate()
        path = tmp / f"{name}.json"
        if not path.exists():
            tail = (tmp / f"{name}.err").read_text()[-4000:]
            missing.append(f"{name}: exit {proc.returncode}, no record; "
                           f"stderr ends:\n{tail}")
            continue
        out[name] = proc.returncode, json.loads(path.read_text()), \
            stdout.splitlines()
    if missing:
        pytest.fail("bench rehearsal processes left no record:\n"
                    + "\n".join(missing), pytrace=False)
    return out


def test_tree_memory_sees_a_child_process():
    """tools.tree_memory, which read the rehearsal's processes' memory:
    a grandchild holding 64 MiB shows in the tree's total and by its own
    command line, and the command's exit code comes back."""
    child = ("import time; b = b'x' * (64 << 20); time.sleep(1.5); "
             "print(len(b))")
    code = (f"import subprocess, sys; subprocess.run([sys.executable, '-c', "
            f"{child!r}], check=True); sys.exit(3)")
    rec = tree_memory.sample_tree([sys.executable, "-c", code], every=0.1)
    assert rec["rc"] == 3
    assert rec["peak_total_gib"] >= 64 / 1024
    assert any(r["peak_gib"] >= 64 / 1024 and "time.sleep" in r["cmd"]
               for r in rec["top"])


@pytest.fixture(scope="module")
def rehearsal(bench_runs):
    return bench_runs["sound"]


def _path(record, dotted):
    for part in dotted.split("."):
        record = record[part]
    return record


def test_rehearsal_summary_is_the_last_line(rehearsal):
    rc, record, lines = rehearsal
    assert rc == 0
    summary = json.loads(lines[-1])
    assert summary == record["summary"]
    assert summary["ok"] is True and summary["rehearsal"] is True
    assert summary["device"] == {"platform": "cpu", "kind": "cpu"}
    assert lines[-2] == "cpu"
    assert set(summary["cells"]) == set(CELLS)
    assert summary["control"] is None
    for cell in BENCHMARK["workloads"]:
        got = summary["cells"][cell["name"]]
        assert got["correct"] is True
        assert set(got) == {"correct"} | set(cell["metrics"])


@pytest.mark.parametrize("cell", sorted(VIEW_CELLS))
def test_rehearsal_emits_every_declared_metric(rehearsal, cell):
    _, record, _ = rehearsal
    res = next(r for r in record["cells"] if r["cell"] == cell)
    decl = next(w for w in BENCHMARK["workloads"] if w["name"] == cell)
    assert res["correct"] is True and res["failures"] == []
    assert res["device"] == {"platform": "cpu", "kind": "cpu"}
    assert res["rehearsal"] is True and res["repeats"] == 2
    assert res["limits"] == REHEARSALS[cell].limits
    for name, spec in decl["metrics"].items():
        assert res["metrics"][name]["unit"] == spec["unit"]
    assert res["metrics"]["depth_maps_per_s"]["value"] > 0
    assert res["metrics"]["depth_maps_per_s"]["clock"] == "host"
    sched = res["layers"]["schedule_s"]["runs"]
    assert res["metrics"]["depth_maps_per_s"]["value"] == \
        pytest.approx(2 / sum(sched))      # all the work over all the time
    assert res["metrics"]["peak_device_memory_gib"]["value"] is None
    device_only = {"trace.device_idle_share", "trace.device_busy_share",
                   "trace.split_ms", "trace.top_device_ops",
                   "trace.longest_idle_gaps"}
    for dotted in decl["layer_metrics"]:
        value = _path(res, dotted)
        assert (value is None) == (dotted in device_only), dotted
    ncc = res["layers"]["ncc"]
    assert ncc["launches_per_depth_map"] == 0
    assert ncc["plain_calls_per_depth_map"] == \
        ncc["expected_calls_per_depth_map"]
    steps = [s["name"] for s in res["steps"]]
    assert list(res["layers"]["step_s"]) == steps
    assert list(res["trace"]["step_host_s"]) == steps
    assert res["trace"]["clock"] == "host"
    assert res["trace"]["device_idle_share"] is None
    assert list(res["trace"]["pass_host_s"]) == list(res["layers"]["pass_s"])
    for c in res["checks"]["per_pass_last_run"].values():
        assert c["finite"]
        assert c["median_rel_err"] < REHEARSALS[cell].limits[c["kind"]]


def _result(depth):
    H, W = depth.shape
    return SolveResult(depth=depth, normal=torch.zeros(H, W, 3),
                       cost=torch.zeros(H, W), geom_cost=torch.zeros(H, W))


LIMITS = {"photometric": 1e-3, "geom": 1e-4, "prior": 1e-4}
STEPS = ["photometric", "geom_0"]


def _runs(breaks):
    gt = torch.linspace(4.0, 6.0, 48).reshape(6, 8)
    depth = gt.clone()
    ncc = {"kernel": 55, "plain": 0, "sorted_kernel": 0, "sorted_plain": 0}
    steps = {"photometric": 1.0, "geom_0": 1.0}
    kind = "geom"
    if breaks == "scaled":
        depth = gt * 1.05
    elif breaks == "nan":
        depth[2, 3] = float("nan")
    elif breaks == "plain_call":
        ncc["plain"] = 1
    elif breaks == "missing_launch":
        ncc["kernel"] = 54
    elif breaks == "missing_step":
        del steps["geom_0"]
    elif breaks in ("under_photometric_limit", "over_geom_limit"):
        depth = gt * (1 + 5e-4)
        kind = "photometric" if breaks.startswith("under") else "geom"
    check = lambda d: {"photometric": bench.pass_check(_result(gt), gt,
                                                       "photometric"),
                       "geom_0": bench.pass_check(_result(d), gt, kind)}
    good = {"checks": check(gt), "step_s": dict.fromkeys(STEPS, 1.0),
            "ncc": dict(ncc, plain=0, kernel=55)}
    run = {"checks": check(depth), "step_s": steps, "ncc": ncc}
    if breaks == "digest":
        depth[0, 0] += 1e-6
        run["checks"] = check(depth)
    if breaks == "under_photometric_limit":
        good["checks"] = run["checks"]
    return [good, run]


@pytest.mark.parametrize("breaks", ["none", "scaled", "nan", "plain_call",
                                    "missing_launch", "digest",
                                    "missing_step", "under_photometric_limit",
                                    "over_geom_limit"])
def test_the_gate_trips(breaks):
    fails = bench.check_runs(_runs(breaks), 55, STEPS, LIMITS, "cuda")
    ok = breaks in ("none", "under_photometric_limit")
    assert (fails == []) == ok, fails


def test_no_card_no_run():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "mpmvs_torch.bench"],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs a CUDA device" in out.stderr


def test_benchmark_json_is_well_formed():
    cells = BENCHMARK["workloads"]
    assert [c["name"] for c in cells] == list(CELLS) == \
        ["view_s10_photo_geom2", "view_s10_default_prior"]
    # the 4-card cell waits in BENCHMARK_PENDING.json, run only by name
    assert [c["name"] for c in PENDING["workloads"]] == \
        list(PENDING_CELLS) == [SHARDED]
    assert PENDING["pending"]
    assert BENCHMARK["command"] == "python -m mpmvs_torch.bench"
    assert "between 6 or more separate processes" in BENCHMARK["bound_rule"]
    every = cells + PENDING["workloads"]
    # at most one cell asks for four chips, and it is the sharded one
    assert [c["name"] for c in every if c["chips"] != 1] == [SHARDED]
    assert all(c["chips"] == 1 for c in cells)
    for c in every:
        assert c["command"] == \
            f"python -m mpmvs_torch.bench --cell {c['name']}"
        cell = {**CELLS, **PENDING_CELLS}[c["name"]]
        assert c["repeats"] == cell.repeats >= 2
        with open(os.path.join(REPO, c["config"])) as f:
            cfg = json.load(f)
        assert cfg == cell.config
        kinds = ({"final"} if c["name"] == SHARDED
                 else {"photometric", "geom", "prior"})
        assert set(cfg["median_rel_err_limit"]) == \
            set(cfg["rehearsal"]["median_rel_err_limit"]) == kinds
        assert len(cfg["source"]) <= 200 and cfg["reduced"]
        assert c["why"] and c["traffic"]
        assert c["chips"] == cfg.get("ranks", 1)
        assert set(c["metrics"]) == {"depth_maps_per_s",
                                     "peak_device_memory_gib"}
        for spec in c["metrics"].values():
            assert spec["unit"]
            assert spec["direction"] in ("higher", "lower")
            assert 0 < spec["bound"] < 1
        assert c["layer_metrics"]
        assert "layers.spread_within_process" in c["layer_metrics"]
        assert {f"layers.host.{k}" for k in HOST_READINGS} <= \
            set(c["layer_metrics"])
    # the sharded cell: scaling_bench's workspace, its views and ranks
    cfg = PENDING_CELLS[SHARDED].config
    args = cfg["scene"]["args"]
    assert (cfg["estimated_views"], cfg["sources"], cfg["ranks"]) == (8, 10, 4)
    assert args["num_views"] == max(cfg["estimated_views"],
                                    cfg["sources"] + 1) == 11
    assert (args["height"], args["width"]) == (2130, 3200)
    tiny = bench.setup_of(cfg, rehearsal=True)
    assert tiny.scene_args["num_views"] == max(tiny.views, tiny.sources + 1)
    assert tiny.ranks == 2 and tiny.views == 2
    # three deployments of one source, a file each, their sources differing
    assert len({c["config"] for c in every}) == 3
    assert len({{**CELLS, **PENDING_CELLS}[c["name"]].config["source"]
                for c in every}) == 3


@dataclasses.dataclass
class _Ev:
    """A stand-in for the profiler's raw event."""

    n: str
    dev: object
    t0: int
    t1: int
    corr: int = 0
    linked: int = 0

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def start_ns(self):
        return self.t0

    def end_ns(self):
        return self.t1

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def test_trace_split_reads_gaps_and_split():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ms = 1_000_000
    steps = ["photometric", "geom_0", "geom_0_prior_build"]
    events = [
        _Ev("bench::geom_0", cpu, 100 * ms, 400 * ms),
        _Ev("bench::photometric", cpu, 0, 100 * ms),
        _Ev("pipeline::prior_build", cpu, 105 * ms, 395 * ms),
        _Ev("pipeline::solve_photometric", cpu, 0, 98 * ms),
        _Ev("pipeline::solve_geom", cpu, 101 * ms, 105 * ms),
        _Ev(RANGES["threefry"], cpu, 10 * ms, 20 * ms),
        _Ev("aten::add", cpu, 12 * ms, 13 * ms, corr=1),
        _Ev("aten::mul", cpu, 29 * ms, 30 * ms, corr=2),
        _Ev("cudaStreamSynchronize", cpu, 95 * ms, 96 * ms, corr=3),
        _Ev("ncc_tile_kernel", gpu, 40 * ms, 90 * ms, linked=4),
        _Ev("add_kernel", gpu, 13 * ms, 23 * ms, linked=1),
        _Ev("mul_kernel", gpu, 30 * ms, 40 * ms, linked=2),
        _Ev("fill_kernel", gpu, 390 * ms, 400 * ms, linked=9),
        _Ev("bench::photometric", gpu, 0, 100 * ms),     # an annotation
    ]
    out = bench.trace_split(events, steps, "cuda", top=2)
    assert out["passes_s"] == 0.4
    assert list(out["pass_host_s"]) == ["photometric", "geom_0"]
    assert out["host_syncs"] == 1
    assert out["device_busy_share"] == pytest.approx(0.2)
    assert out["device_idle_share"] == pytest.approx(0.8)
    assert out["split_ms"] == {"ncc_kernel": 50.0, "geom_cost": 0.0,
                               "threefry": 10.0, "other_glue": 20.0}
    assert out["pass_device_busy_share"] == {
        "photometric": pytest.approx(0.7), "geom_0": pytest.approx(1 / 30)}
    assert out["step_device_busy_share"] == {
        "photometric": pytest.approx(70 / 98), "geom_0": 0.0,
        "geom_0_prior_build": pytest.approx(5 / 290)}
    assert out["top_device_ops"][0]["name"] == "ncc_tile_kernel"
    assert [g["host_in"] for g in out["longest_idle_gaps"]] == \
        ["geom_0 glue", "photometric"]
    assert out["longest_idle_gaps"][0]["ms"] == 290.0
    cpu_out = bench.trace_split(events, steps, "cpu")
    assert cpu_out["device_busy_share"] is None
    assert cpu_out["step_host_s"] == {"photometric": 0.098,
                                      "geom_0": 0.004,
                                      "geom_0_prior_build": 0.29}
    with pytest.raises(ValueError):
        bench.trace_split(events, steps[:2], "cpu")


def test_trace_split_names_the_geometric_cost_kernel():
    """A kernel launched through ctypes has no host event: the geometric
    cost's kernel is split by its name, not lost to other glue."""
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ms = 1_000_000
    events = [
        _Ev("bench::geom_0", cpu, 0, 100 * ms),
        _Ev("pipeline::solve_geom", cpu, 0, 100 * ms),
        _Ev(RANGES["geom_cost"], cpu, 10 * ms, 20 * ms),
        _Ev("aten::cat", cpu, 11 * ms, 12 * ms, corr=1),
        _Ev("cat_kernel", gpu, 12 * ms, 13 * ms, linked=1),
        # no host event carries correlation 7: the ctypes launch
        _Ev("geom_cost_kernel", gpu, 14 * ms, 18 * ms, linked=7),
        _Ev("void geom_cost_kernel<(bool)1>(float const*)", gpu, 30 * ms,
            35 * ms),
        _Ev("ncc_view_major_kernel", gpu, 40 * ms, 50 * ms, linked=8),
        _Ev("fill_kernel", gpu, 60 * ms, 62 * ms, linked=9),
    ]
    out = bench.trace_split(events, ["geom_0"], "cuda")
    assert out["split_ms"] == {"ncc_kernel": 10.0, "geom_cost": 10.0,
                               "threefry": 0.0, "other_glue": 2.0}
    assert named_kind("geom_cost_kernel") == "geom_cost"
    assert named_kind("ncc_tile_kernel") == "ncc_kernel"
    assert named_kind("fill_kernel") is None
    assert set(NAMED_KERNELS) <= set(out["split_ms"])


@pytest.mark.parametrize("rates, between, bound", [
    # three processes of one call, 0.28% apart -> the 1% floor
    ([0.115028, 0.115224, 0.114904], 0.0027819, 0.01),
    # two processes 5.7% apart -> 12%
    ([0.112561, 0.106306], 0.0571566, 0.12),
    # exactly 1.5%: 3%, not 4% from the float's last digit
    ([1.0, 1.015, 1.0075], 0.0148883, 0.03),
    ([2.0, 2.0, 2.0, 2.0, 2.0, 2.0], 0.0, 0.01),
])
def test_bench_spread_bound_rule(rates, between, bound):
    procs = [{"values": {"depth_maps_per_s": r,
                         "peak_device_memory_gib": None},
              "spread_within": 0.001 * k, "correct": True}
             for k, r in enumerate(rates)]
    out = bench_spread.summarize("view_s10_photo_geom2", 1, procs)
    assert out["spread_between"]["depth_maps_per_s"] == \
        pytest.approx(between, rel=1e-4)
    assert out["bound"] == {"depth_maps_per_s": bound}
    assert out["spread_within"] == [0.001 * k for k in range(len(rates))]
    assert out["enough_for_rule"] is (len(rates) >= 6)
    assert out["values"]["depth_maps_per_s"] == rates
    assert bench_spread.bound_of(0.015) == 0.03
    assert bench_spread.bound_of(0.0150001) == 0.04
    four = bench_spread.summarize(SHARDED, 4, procs[:1] * 4)
    assert four["enough_for_rule"] and four["bound"] == \
        {"depth_maps_per_s": 0.01}


@pytest.mark.parametrize("cell", sorted(VIEW_CELLS))
def test_rehearsal_records_the_host_readings(rehearsal, cell):
    _, record, _ = rehearsal
    res = next(r for r in record["cells"] if r["cell"] == cell)
    host = res["layers"]["host"]
    n = res["repeats"]
    assert set(HOST_READINGS) <= set(host)
    for k in ("collections", "s", "longest_s"):
        assert len(host["gc"][k]) == n and all(len(g) == 3
                                               for g in host["gc"][k])
    assert all(len(host["switches"][k]) == n
               for k in ("voluntary", "involuntary"))
    assert len(host["cpu_s"]) == len(host["wall_s"]) == n
    assert all(w >= s for w, s in zip(host["wall_s"],
                                      res["layers"]["schedule_s"]["runs"]))
    assert res["layers"]["spread_within_process"] >= 0
    assert res["foreign_modules"] == []
    if cell == "view_s10_default_prior":
        builds = host["prior_build"]
        assert len(builds["wall_s"]) == len(builds["cpu_s"]) == n
        assert all(w > 0 for w in builds["wall_s"])
    else:
        assert "prior_build" not in host


def test_sharded_rehearsal_emits_its_metrics(bench_runs):
    """The 4-card cell's rehearsal, 2 ranks over gloo, runs end to end and
    prints its metrics under the names its entry declares."""
    _, record, lines = bench_runs["sharded"]
    res = next(r for r in record["cells"] if r["cell"] == SHARDED)
    decl = next(w for w in PENDING["workloads"] if w["name"] == SHARDED)
    assert res["correct"] is True and res["failures"] == []
    assert json.loads(lines[-1])["cells"][SHARDED]["correct"] is True
    for name, spec in decl["metrics"].items():
        assert res["metrics"][name]["unit"] == spec["unit"]
    passes = res["layers"]["passes_s"]["runs"]
    assert len(passes) == res["repeats"] == 2
    assert res["metrics"]["depth_maps_per_s"]["value"] == \
        pytest.approx(2 * 2 / sum(passes))     # 2 views x 2 launches
    assert res["metrics"]["peak_device_memory_gib"]["value"] is None
    device_only = {"trace.device_busy_share", "trace.split_ms",
                   "trace.top_device_ops"}
    for dotted in decl["layer_metrics"]:
        assert (_path(res, dotted) is None) == (dotted in device_only), dotted
    assert res["layers"]["views_by_rank"] == [[0], [1]]
    assert [c["op"] for c in res["layers"]["collectives"][0]] == [
        "depth_all_gather", "depth_all_gather", "result_gather"]
    per_rank = res["layers"]["launches_by_rank"][0]
    assert [r["ncc_eval_plain"] for r in per_rank] == \
        [res["checks"]["ncc_per_view"]] * 2
    assert all(r["ncc_eval"] == 0 for r in per_rank)
    host = res["layers"]["host"]      # each reading, one entry a rank
    assert set(HOST_READINGS) | {"prior_build"} == set(host)
    assert [len(g["s"]) for g in host["gc"]] == [2, 2]    # 2 launches
    assert all(len(c) == 2 for c in host["cpu_s"])
    assert all(w > 0 for rank in host["prior_build"]
               for w in rank["wall_s"])
    assert len(set(res["checks"]["fused_points"])) == 1
    assert set(res["checks"]["median_rel_err_max"]) == {"0", "1"}
    assert res["checks"]["exchanges"] == {
        "ops": ["depth_all_gather", "depth_all_gather", "result_gather"],
        "launches": 3}
    assert res["foreign_modules"] == []


OPS = ["depth_all_gather", "depth_all_gather", "result_gather"]


def _exchanges(rank, got=None):
    """One rank's sound exchanges of a 2-rank launch of views 0 and 1."""
    own = {str(rank): "ab"[rank]}
    every = {"0": "a", "1": "b"}
    last = (got or every) if rank == 0 else None
    return [{"op": op, "sent": own, "got": got or every}
            for op in OPS[:2]] + [{"op": OPS[2], "sent": own, "got": last}]


def test_sharded_gate_trips():
    rank = {"exchanges": None, "foreign_modules": []}
    ok = {"views_by_rank": [[0], [1]],
          "launches_by_rank": [{"ncc_eval": 36, "ncc_eval_plain": 0,
                                "ncc_sorted": 0, "ncc_sorted_plain": 0,
                                "ncc_keys": 0}] * 2,
          "median_rel_err": {0: 1e-5, 1: 2e-5}, "fused_points": 100,
          "depth_digests": {0: "a", 1: "b"},
          "bench_ranks": [dict(rank, exchanges=_exchanges(r))
                          for r in (0, 1)]}
    check = lambda runs, device="cuda": bench.check_launches(
        runs, 36, 1e-4, OPS, device)
    assert check([ok, ok]) == []
    bad = [dict(ok, fused_points=99),
           dict(ok, depth_digests={0: "a", 1: "c"}),
           dict(ok, median_rel_err={0: 1e-5, 1: 2e-4}),
           dict(ok, launches_by_rank=[dict(ok["launches_by_rank"][0],
                                           ncc_eval_plain=1)] * 2),
           dict(ok, views_by_rank=[[0, 1], []]),
           dict(ok, bench_ranks=[ok["bench_ranks"][0],
                                 dict(rank, exchanges=_exchanges(1),
                                      foreign_modules=["jax"])])]
    for b in bad:
        assert check([ok, b]), b
    assert check([ok], "cpu")   # plain expected


@pytest.mark.parametrize("fault, wants", [
    ("none", []),
    # rank 1's table holds zeros where rank 0's view 0 should be
    ("row_zeroed", ["depth_all_gather 0: rank 1",
                    "depth_all_gather 1: rank 1"]),
    # rank 0 fused from its own results only
    ("root_kept_own", ["result_gather 2: rank 0"]),
    ("root_got_nothing", ["result_gather 2: rank 0 received nothing"]),
    ("gather_skipped", ["rank 1 exchanged"]),
    # both ranks' tables short of view 0's row
    ("row_missing", ["depth_all_gather 0: rank 0", "depth_all_gather 0: "
                     "rank 1", "depth_all_gather 1: rank 0",
                     "depth_all_gather 1: rank 1"]),
])
def test_exchange_faults_name_the_views(fault, wants):
    by_rank = [_exchanges(0), _exchanges(1)]
    if fault == "row_zeroed":
        by_rank[1] = [dict(e, got={"0": "z", "1": "b"}) if e["got"] else e
                      for e in by_rank[1]]
    elif fault == "root_kept_own":
        by_rank[0][2]["got"] = {"0": "a", "1": "z"}
    elif fault == "root_got_nothing":
        by_rank[0][2]["got"] = None
    elif fault == "gather_skipped":
        del by_rank[1][0]
    elif fault == "row_missing":
        for log in by_rank:
            log[0]["got"] = log[1]["got"] = {"1": "b"}
    fails = bench.exchange_faults(by_rank, OPS)
    assert len(fails) == len(wants), fails
    for f, want in zip(fails, wants):
        assert f.startswith(want), (f, want)
    if fault in ("row_zeroed", "root_kept_own"):
        assert all(f.endswith("views ['0']") or f.endswith("views ['1']")
                   for f in fails)


@pytest.mark.parametrize("control", ["exchange_drop", "final_gather_drop",
                                     "foreign_module"])
def test_control_runs_are_not_correct(bench_runs, control):
    """A control run of the command's rehearsal: each cell it runs comes
    out not correct, for the fault planted, and the command exits 1."""
    rc, record, lines = bench_runs[control]
    assert rc == 1
    summary = json.loads(lines[-1])
    assert summary["ok"] is False and summary["control"] == control
    cells = {r["cell"]: r for r in record["cells"]}
    assert set(cells) == ({"view_s10_photo_geom2", SHARDED}
                          if control == "foreign_module" else {SHARDED})
    for name, res in cells.items():
        assert res["correct"] is False
        assert summary["cells"][name]["correct"] is False
        fails = res["failures"]
        if control == "foreign_module":
            assert res["foreign_modules"] == ["mpmvs_tpu"]
            assert f"imported {['mpmvs_tpu']}" in fails
            if name == SHARDED:         # and in every rank of every launch
                assert sum("imported" in f for f in fails) == 1 + 2 * 2
        else:
            assert res["foreign_modules"] == []
            op = ("depth_all_gather" if control == "exchange_drop"
                  else "result_gather")
            caught = [f for f in fails if f"{op} " in f and
                      "received other bytes than their owners sent" in f]
            # in both launches; the all-gathers on both ranks, twice each
            assert len(caught) == (8 if control == "exchange_drop" else 2)


def test_every_control_is_tested():
    assert set(bench.CONTROLS) == set(SOLVE_CONTROLS) | {
        "exchange_drop", "final_gather_drop", "foreign_module"}


@pytest.mark.parametrize("control, mod, name", [
    ("exchange_drop", "view_sharding", "gather_depth_table"),
    ("final_gather_drop", "mesh", "gather_items_to_root"),
])
def test_exchange_controls_swap_and_restore(control, mod, name):
    from mpmvs_torch.parallel import mesh, view_sharding

    mod = {"mesh": mesh, "view_sharding": view_sharding}[mod]
    before = getattr(mod, name)
    with bench.planted(control):
        assert getattr(mod, name) is not before
    assert getattr(mod, name) is before


def test_prior_off_reaches_a_ranks_prior_build():
    from mpmvs_torch import pipeline
    from mpmvs_torch.parallel import view_sharding

    before = (pipeline.build_planar_prior, view_sharding.build_planar_prior)
    with bench.planted("prior_off"):
        assert pipeline.build_planar_prior is not before[0]
        assert view_sharding.build_planar_prior is not before[1]
    assert (pipeline.build_planar_prior,
            view_sharding.build_planar_prior) == before
