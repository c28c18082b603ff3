"""The port's scale-out (``mpmvs_torch.parallel``) on the CPU: ranks are
spawned processes over gloo, at 48x64 with FAST parameters and an
explicit ``band_rows`` (band b draws with the band's global index, so
parity needs the same bands on both sides).

* (a) ``ShardedPipeline`` over 2 ranks against JAX's ``ShardedPipeline`` on
  4 virtual CPU devices, on a 3-view workspace where view 2 has one source
  fewer (a dummy source pads its stack): photometric with a planar-prior
  sub-run, then geom_0. The bar of test_torch_pipeline.py's CLI test: depth
  beyond 0.1% relative on at most 5% of each view's pixels (the packages
  draw the same numbers and part on float-tie adoptions, which the prior's
  plane fits spread; measured 1.5-4.7% over two seeds).
* (b) 1 and 2 ranks write the same .dmb files and PLY, byte for byte.
* (c) ``resume`` skips the completed photometric pass.
* (d) a source that is not estimated reads an all-zero depth map.
* (e) ``solve_view_spatial`` over 2 ranks (3 bands) equals the one-rank
  ``solve_view`` bit for bit. JAX's ``solve_view_spatial`` on 4 virtual
  devices runs one band of all rows whatever ``band_rows`` says
  (mpmvs_tpu/solver.py:329-330), so it is held, within
  test_torch_solver.py's per-pixel bar, to the port's solve with one band
  of 48 rows (which the split over ranks equals bit for bit, as above).
* (f) ``mpmvs-torch-multihost`` as 2 localhost processes (``--device
  cpu``) writes the same files as (b).
* (g) ``--devices`` naming cards that are not there raises, and a rank
  that fails makes the launch raise.

The JAX references compile for minutes; they run in processes of their
own (tests/jax_parallel_ref.py, no persistent cache), started by a
module fixture before the port's runs and read at the end.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpmvs_tpu.parallel import view_sharding as jax_vs
from mpmvs_tpu.params import ConfigParams as JaxConfig
from mpmvs_tpu.pipeline import Pipeline as JaxPipeline
from mpmvs_torch import cli
from mpmvs_torch.io import read_dmb, read_ply_binary
from mpmvs_torch.io.cams import write_pair_txt
from mpmvs_torch.ops import threefry as tf
from mpmvs_torch.parallel import dryrun, mesh, view_sharding
from mpmvs_torch.params import ConfigParams, PatchMatchParams
from mpmvs_torch.pipeline import Pipeline
from mpmvs_torch.solver import solve_view
from mpmvs_torch.utils.synthetic import make_plane_scene
from mpmvs_torch.utils.workspace import write_workspace

from torch_parity import n

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, SEED = 48, 64, 21
BAND_ROWS = 48
FAST = PatchMatchParams(max_iterations=1, geom_iterations=1, max_scale=0,
                        band_rows=BAND_ROWS)
PAIRS = [[1, 2], [0, 2], [0]]       # view 2: one source fewer
FILES = ("depths.dmb", "normals.dmb", "costs.dmb")
JAX_TIMEOUT = 900


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _write_ws(folder, scene, pairs):
    write_workspace(scene, folder, device="cpu")
    write_pair_txt(os.path.join(folder, "pair.txt"),
                   [[(j, 10.0) for j in p] for p in pairs])
    return folder


def _cfg(ws, out, **kw):
    base = dict(input_folder=ws, output_folder=out, geom_iterations=1,
                planar_prior=True, geom_planar_prior=False, sky_seg=False)
    base.update(kw)
    return ConfigParams(**base)


def _dmb(out, v, name="depths.dmb"):
    return read_dmb(os.path.join(out, "MPMVS", f"2333_{v:08d}", name))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The workspace of (a), and the two JAX reference processes, started
    at once: the sharded pipeline on it, and the row-sharded solve of
    dryrun's scene."""
    root = tmp_path_factory.mktemp("parallel")
    scene = make_plane_scene(num_views=3, height=H, width=W, seed=SEED)
    ws = _write_ws(str(root / "ws"), scene, PAIRS)
    out_j, spatial = str(root / "out_jax"), str(root / "spatial.npz")
    script = os.path.join(REPO, "tests", "jax_parallel_ref.py")
    s = dryrun.ROW_SCENE
    procs = {
        "sharded": subprocess.Popen(
            [sys.executable, script, "sharded", ws, out_j, str(BAND_ROWS)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "spatial": subprocess.Popen(
            [sys.executable, script, "spatial", spatial, str(s["height"]),
             str(s["width"]), str(s["seed"]), str(dryrun.ROW_BANDS)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    refs = dict(root=root, scene=scene, ws=ws, out_jax=out_j,
                spatial=spatial, procs=procs)
    yield refs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _wait(refs, name):
    p = refs["procs"][name]
    out, _ = p.communicate(timeout=JAX_TIMEOUT)
    assert p.returncode == 0, f"JAX reference {name} failed:\n{out[-3000:]}"


@pytest.fixture(scope="module")
def runs(jax_refs):
    """The port's sharded pipeline on (a)'s workspace over 1 and 2 CPU
    ranks."""
    outs = {}
    for ranks in (1, 2):
        out = str(jax_refs["root"] / f"out_{ranks}")
        ply = view_sharding.launch(_cfg(jax_refs["ws"], out), FAST,
                                   world_size=ranks, device_type="cpu")
        assert ply == os.path.join(out, "MPMVS", "MPMVS_model.ply")
        outs[ranks] = out
    return outs


def test_scene_batch_matches_jax(jax_refs):
    """The padded batch: shape, source indices, each view's image stack
    and cameras (the dummy of view 2 included) equal the JAX package's."""
    ws = jax_refs["ws"]
    pipe = Pipeline(_cfg(ws, ws), FAST, device="cpu").load()
    jpipe = JaxPipeline(JaxConfig(input_folder=ws, output_folder=ws))
    jpipe.load()
    batch = view_sharding.build_scene_batch(pipe)
    jbatch = jax_vs.build_scene_batch(jpipe)
    assert batch.shape == jbatch.images.shape[1:] == (3, H, W)
    assert batch.ref_ids == jbatch.ref_ids
    np.testing.assert_array_equal(batch.src_indices, jbatch.src_indices)
    assert batch.src_indices.tolist() == [[1, 2], [0, 2], [0, 2]]
    for i in range(3):
        images, cams = batch.scene_inputs(pipe, i, "cpu")
        np.testing.assert_array_equal(n(images), np.asarray(jbatch.images[i]))
        for f in ("K", "R", "t", "width", "height", "depth_min",
                  "depth_max"):
            np.testing.assert_allclose(
                n(getattr(cams, f)),
                np.asarray(getattr(jbatch.cameras, f)[i]), rtol=1e-6)


def test_one_and_two_ranks_write_the_same_files(runs):
    for v in range(3):
        for name in FILES:
            a, b = (os.path.join(runs[r], "MPMVS", f"2333_{v:08d}", name)
                    for r in (1, 2))
            assert filecmp.cmp(a, b, shallow=False), (v, name)
    assert filecmp.cmp(*(os.path.join(runs[r], "MPMVS", "MPMVS_model.ply")
                         for r in (1, 2)), shallow=False)
    records = [json.load(open(os.path.join(runs[2], "MPMVS",
                                           f"rank_{r}.json")))
               for r in range(2)]
    assert [rec["views"] for rec in records] == [[0, 1], [2]]
    # one depth all-gather (geom_0) and the final gather, on every rank
    assert [[c["op"] for c in rec["collectives"]] for rec in records] == \
        [["depth_all_gather", "result_gather"]] * 2


def test_resume_skips_photometric(jax_refs, runs, tmp_path):
    out = str(tmp_path / "resume")
    shutil.copytree(runs[2], out)
    with open(os.path.join(out, "MPMVS", "progress.json"), "w") as f:
        json.dump({"completed": ["photometric"]}, f)
    view_sharding.launch(_cfg(jax_refs["ws"], out), FAST, world_size=2,
                         device_type="cpu", resume=True)
    for r in range(2):
        with open(os.path.join(out, "MPMVS", f"rank_{r}.json")) as f:
            rec = json.load(f)
        assert {stage for _, stage, _ in rec["solve_log"]} == {"geom"}
        assert [p["pass"] for p in rec["passes"]] == ["geom_0"]
    with open(os.path.join(out, "MPMVS", "progress.json")) as f:
        assert json.load(f)["completed"] == ["photometric", "geom_0"]


def test_unestimated_source_reads_zero_depth(tmp_path):
    """View 3 is a source of views 0-2 but is not estimated (no sources of
    its own): its batch index is N, the all-zero map of the depth table
    (the reference reads a missing .dmb as an empty map), where the JAX
    package reads the reference's own map; the run over 2 ranks
    completes with no depth map for view 3."""
    scene = make_plane_scene(num_views=4, height=H, width=W, seed=23)
    ws = _write_ws(str(tmp_path / "ws"), scene,
                   [[1, 2, 3], [0, 2, 3], [0, 1, 3], []])
    pipe = Pipeline(_cfg(ws, ws), FAST, device="cpu").load()
    batch = view_sharding.build_scene_batch(pipe)
    assert batch.ref_ids == [0, 1, 2]
    assert batch.src_indices.tolist() == [[1, 2, 3], [0, 2, 3], [0, 1, 3]]
    table = torch.cat([torch.as_tensor(scene.gt_depth[:3]),
                       torch.zeros((1, H, W))])
    src = view_sharding.gather_src_depths(table, batch.src_indices)
    assert src.shape == (3, 3, H, W)
    assert torch.equal(src[:, 2], torch.zeros((3, H, W)))
    assert torch.equal(src[0, 0], table[1])

    out = str(tmp_path / "out")
    view_sharding.launch(_cfg(ws, out, planar_prior=False), FAST,
                         world_size=2, device_type="cpu")
    for v in range(3):
        rel = np.abs(_dmb(out, v) - scene.gt_depth[v]) / scene.gt_depth[v]
        assert np.median(rel) < 0.02
    assert not os.path.exists(os.path.join(out, "MPMVS", "2333_00000003",
                                           "depths.dmb"))


def test_split_band_rows():
    """With automatic band rows, the row split gives each rank a band of
    ceil(H / R) rows (even); explicit band rows are kept."""
    from mpmvs_torch.parallel.tile_sharding import split_band_rows

    auto = PatchMatchParams(max_iterations=1, max_scale=0)
    shape = (3, 47, 64)   # solved as 48 rows
    assert [split_band_rows(auto, shape, "photometric", r).band_rows
            for r in (1, 2, 3, 4, 5)] == [48, 24, 16, 12, 10]
    assert split_band_rows(FAST, shape, "geom", 4) is FAST


def test_multihost_two_processes(jax_refs, runs, tmp_path):
    """Two localhost processes of the multi-host runner, the JAX runner's
    flags (``--preset fast``: band rows automatic, one band of 48 rows as
    FAST's explicit 48): the same .dmb files as the spawned ranks."""
    out = str(tmp_path / "mh")
    port = mesh.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpmvs_torch.parallel.multihost",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(pid), "--device", "cpu",
         "--input", jax_refs["ws"], "--output", out, "--preset", "fast",
         "--geom-iterations", "1", "--planar-prior"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=REPO) for pid in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid}:\n{log[-3000:]}"
    assert "point cloud:" in logs[0] and "prior sub-run: 3/3" in logs[0]
    for v in range(3):
        for name in FILES:
            assert filecmp.cmp(
                os.path.join(out, "MPMVS", f"2333_{v:08d}", name),
                os.path.join(runs[2], "MPMVS", f"2333_{v:08d}", name),
                shallow=False), (v, name)
    pts = read_ply_binary(os.path.join(out, "MPMVS", "MPMVS_model.ply"))[0]
    assert len(pts) > 100


def test_devices_and_failed_ranks_raise(jax_refs, tmp_path):
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA device"):
        cli.main(["--input", jax_refs["ws"], "--devices",
                  ",".join(str(i) for i in range(count + 1))])
    with pytest.raises(ValueError, match="named once"):
        cli.device_list("0,0")
    if count == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--input", jax_refs["ws"], "--devices", "all"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        mesh.rank_device(count, "cuda")
    # a rank that raises (no workspace there) fails the whole launch
    missing = str(tmp_path / "missing")
    with pytest.raises(Exception, match="FileNotFoundError"):
        view_sharding.launch(_cfg(missing, missing), FAST, world_size=2,
                             device_type="cpu")


def test_row_sharded_solve(jax_refs, tmp_path):
    """dryrun over 2 ranks (it checks both of its rounds against one rank
    bit for bit and raises otherwise); its row-sharded result against the
    one-rank solve_view here; the one-band solve against JAX's
    solve_view_spatial (module docstring, (e))."""
    out = str(tmp_path / "rows.npz")
    dryrun.run(2, "cpu", out)
    got = np.load(out)
    scene = make_plane_scene(**dryrun.ROW_SCENE)
    one = solve_view(scene.images, scene.cameras, tf.PRNGKey(1),
                     dryrun.fast_params(dryrun.ROW_BANDS), "photometric",
                     device="cpu")
    for k in ("depth", "normal", "cost"):
        np.testing.assert_array_equal(got[k], n(getattr(one, k)))
    assert np.median(np.abs(got["depth"] - scene.gt_depth[0])
                     / scene.gt_depth[0]) < 0.02
    whole = solve_view(scene.images, scene.cameras, tf.PRNGKey(1),
                       dryrun.fast_params(scene.images.shape[1]),
                       "photometric", device="cpu")
    _wait(jax_refs, "spatial")
    ref = np.load(jax_refs["spatial"])
    dj, dt = ref["depth"], n(whole.depth)
    assert (np.abs(dt - dj) / dj > 1e-3).mean() <= 0.05
    assert (np.abs(n(whole.normal) - ref["normal"]).max(-1) > 0.02).mean() \
        <= 0.05
    assert (np.abs(n(whole.cost) - ref["cost"]) > 0.01).mean() <= 0.05


def test_two_ranks_match_jax_sharded_pipeline(jax_refs, runs):
    _wait(jax_refs, "sharded")
    scene, out_j, out_t = jax_refs["scene"], jax_refs["out_jax"], runs[2]
    for v in range(3):
        dt, dj = _dmb(out_t, v), _dmb(out_j, v)
        assert dt.shape == dj.shape == (H, W)
        off = (np.abs(dt - dj) / dj > 1e-3).mean()
        assert off <= 0.05, (v, off)
        rel = np.abs(dt - scene.gt_depth[v]) / scene.gt_depth[v]
        assert np.median(rel) < 0.02
        assert os.path.exists(os.path.join(out_t, "MPMVS", f"2333_{v:08d}",
                                           "triangulation.png"))
    with open(os.path.join(out_t, "MPMVS", "progress.json")) as f:
        assert json.load(f)["completed"] == ["photometric", "geom_0"]
    pt = read_ply_binary(os.path.join(out_t, "MPMVS", "MPMVS_model.ply"))[0]
    pj = read_ply_binary(os.path.join(out_j, "MPMVS", "MPMVS_model.ply"))[0]
    assert len(pj) > 100
    assert abs(len(pt) - len(pj)) <= 0.05 * len(pj), (len(pt), len(pj))


def test_zero_extent_source_scores_cost_max():
    """On the CPU the plain NCC versions score the sharded pipeline's dummy
    source cost_max at every pixel (the card's kernels are held to them in
    test_torch_kernel_cuda.py::test_zero_extent_source_equals_plain)."""
    from mpmvs_torch.ops import ncc_cuda, ncc_sorted
    from test_torch_kernel_cuda import (PARAMS, _random_planes, _rows_args,
                                        _sorted_call, zero_extent_data)

    d = zero_extent_data("cpu")
    multi = ncc_cuda.ncc_eval_multi(*_rows_args(d, _random_planes(d, 60), 9,
                                                0, 7, 18, True))
    assert bool((multi[:, -1] == PARAMS.cost_max).all())
    assert bool((multi[:, :-1] < PARAMS.cost_max).any())
    srt = ncc_sorted.ncc_eval_sorted(*_sorted_call(d, _random_planes(d, 61),
                                                   0, 7, 18, True))
    assert bool((srt[-1] == PARAMS.cost_max).all())
