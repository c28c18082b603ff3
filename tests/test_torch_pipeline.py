"""The port's pipeline, CLI and fusion against mpmvs_tpu.

* Both CLIs (``--preset fast --geom-iterations 0 --planar-prior 0``) on one
  workspace written by the port's ``write_workspace``: the .dmb files agree
  per pixel within the whole-solve tolerance of test_torch_solver.py (depth
  beyond 0.1% relative on at most 5% of pixels; the packages draw the same
  numbers and part only on float-tie adoptions), and the fused PLY point
  counts within 5% of each other (fusion's thresholds turn those pixels
  into a few points more or less).
* ``run_fusion`` / ``fuse_one_view`` of both packages on the same numpy
  stacks: accept masks equal and points within 1e-5 (the consistency tests
  sit far from their thresholds on these inputs).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import cli as jax_cli
from mpmvs_tpu import fusion as jfus
from mpmvs_tpu.io import read_dmb, read_ply_binary
from mpmvs_tpu.io.cams import Scene as JaxScene
from mpmvs_torch import cli as torch_cli
from mpmvs_torch import fusion as tfus
from mpmvs_torch.io.cams import Scene
from mpmvs_torch.params import ConfigParams, PatchMatchParams
from mpmvs_torch.pipeline import Pipeline
from mpmvs_torch.utils.synthetic import make_plane_scene
from mpmvs_torch.utils.workspace import write_workspace

from torch_parity import n, t

torch.set_num_threads(1)

FLAGS = ["--preset", "fast", "--geom-iterations", "0", "--planar-prior", "0"]
V = 5  # views of the CLI workspace: enough sources for fusion to keep points


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    scene = make_plane_scene(num_views=V, height=64, width=96, seed=9)
    folder = str(tmp_path_factory.mktemp("ws"))
    write_workspace(scene, folder)
    return folder, scene


@pytest.fixture(scope="module")
def cli_outputs(workspace, tmp_path_factory):
    folder, _ = workspace
    out_t = str(tmp_path_factory.mktemp("out_torch"))
    out_j = str(tmp_path_factory.mktemp("out_jax"))
    assert torch_cli.main(["--input", folder, "--output", out_t,
                           "--device", "cpu"] + FLAGS) == 0
    assert jax_cli.main(["--input", folder, "--output", out_j] + FLAGS) == 0
    return out_t, out_j


def test_cli_dmb_files_match(workspace, cli_outputs):
    _, scene = workspace
    out_t, out_j = cli_outputs
    for v in range(V):
        sub = os.path.join("MPMVS", f"2333_{v:08d}")
        dt, dj = (read_dmb(os.path.join(o, sub, "depths.dmb"))
                  for o in (out_t, out_j))
        assert dt.shape == dj.shape == (64, 96)
        assert (np.abs(dt - dj) / dj > 1e-3).mean() <= 0.05
        nt, nj = (read_dmb(os.path.join(o, sub, "normals.dmb"))
                  for o in (out_t, out_j))
        assert nt.shape == nj.shape == (64, 96, 3)
        assert (np.abs(nt - nj).max(-1) > 0.02).mean() <= 0.05
        ct, cj = (read_dmb(os.path.join(o, sub, "costs.dmb"))
                  for o in (out_t, out_j))
        assert (np.abs(ct - cj) > 0.01).mean() <= 0.05
        rel = np.abs(dt - scene.gt_depth[v]) / scene.gt_depth[v]
        assert np.median(rel) < 0.02
        assert os.path.exists(os.path.join(out_t, sub, "costs.jpg"))


def test_cli_ply_point_counts(cli_outputs):
    out_t, out_j = cli_outputs
    pt, _, _ = read_ply_binary(os.path.join(out_t, "MPMVS", "MPMVS_model.ply"))
    pj, _, _ = read_ply_binary(os.path.join(out_j, "MPMVS", "MPMVS_model.ply"))
    assert len(pj) > 100
    assert abs(len(pt) - len(pj)) <= 0.05 * len(pj), (len(pt), len(pj))
    with open(os.path.join(out_t, "MPMVS", "progress.json")) as f:
        assert "photometric" in f.read()


@pytest.fixture(scope="module")
def fusion_inputs():
    """GT depth/normal/colour stacks of 4 views; a random 15% of the
    pixels of each view get their depth moved by +-5% (clearly
    inconsistent), the rest are exact."""
    scene = make_plane_scene(num_views=4, height=40, width=56, seed=2)
    rng = np.random.default_rng(0)
    depths = scene.gt_depth.copy()
    bump = rng.uniform(size=depths.shape) < 0.15
    depths[bump] *= rng.choice([0.95, 1.05], size=int(bump.sum()))
    normals = np.broadcast_to(scene.gt_normal_world,
                              depths.shape + (3,)).astype(np.float32).copy()
    return scene, depths.astype(np.float32), normals, scene.colors


def _jax_cams(scene):
    from mpmvs_tpu.camera import CameraStack as JaxCameraStack

    return JaxCameraStack(**{f: jnp.asarray(n(getattr(scene.cameras, f)))
                             for f in ("K", "R", "t", "width", "height",
                                       "depth_min", "depth_max")})


def test_fuse_one_view_matches(fusion_inputs):
    scene, depths, normals, colors = fusion_inputs
    jc = _jax_cams(scene)
    V, H, W = depths.shape
    src = np.array([1, 2, 3], np.int32)
    valid = np.ones(3, bool)
    jin = jfus.FusionInput(jnp.asarray(depths), jnp.asarray(normals),
                           jnp.asarray(colors), jc)
    jout = jfus.fuse_one_view(jin, jnp.zeros((V, H, W), bool), jnp.int32(0),
                              jnp.asarray(src), jnp.asarray(valid))
    tin = tfus.FusionInput(t(depths), t(normals), t(colors), scene.cameras)
    tout = tfus.fuse_one_view(tin, torch.zeros((V, H, W), dtype=torch.bool),
                              0, t(src), t(valid))
    acc = np.asarray(jout.accept)
    np.testing.assert_array_equal(n(tout.accept), acc)
    assert 0.3 < acc.mean() < 1.0
    np.testing.assert_allclose(n(tout.points)[acc], np.asarray(jout.points)[acc],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(tout.used), np.asarray(jout.used))
    np.testing.assert_array_equal(n(tout.src_r), np.asarray(jout.src_r))


def test_run_fusion_matches(fusion_inputs):
    scene, depths, normals, colors = fusion_inputs
    ids = range(4)
    tscenes = [Scene(i, [i] + [j for j in ids if j != i]) for i in ids]
    jscenes = [JaxScene(s.ref_id, s.src_ids) for s in tscenes]
    pj, nj, cj = jfus.run_fusion(depths, normals, colors, _jax_cams(scene),
                                 jscenes)
    pt, nt, ct = tfus.run_fusion(depths, normals, colors, scene.cameras,
                                 tscenes)
    assert len(pj) > 500 and pt.shape == pj.shape
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(nt, nj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ct, cj, atol=1e-4, rtol=0)


def test_load_arrays_fills_the_same_records(workspace, tmp_path):
    folder, _ = workspace
    cfg = ConfigParams(input_folder=folder, output_folder=str(tmp_path),
                       geom_iterations=0, planar_prior=False)
    disk = Pipeline(cfg, device="cpu").load()
    views = [disk.views[i] for i in range(V)]
    from mpmvs_torch.camera import CameraStack

    mem = Pipeline(cfg, device="cpu").load_arrays(
        np.stack([v.image for v in views]), np.stack([v.color for v in views]),
        CameraStack.stack([v.camera for v in views]),
        [[j for j in range(V) if j != i] for i in range(V)])
    assert [(s.ref_id, s.src_ids, s.estimate) for s in mem.scenes] == \
        [(s.ref_id, s.src_ids, s.estimate) for s in disk.scenes]
    for i in range(V):
        np.testing.assert_array_equal(mem.views[i].image, disk.views[i].image)
        np.testing.assert_array_equal(n(mem.views[i].camera.K),
                                      n(disk.views[i].camera.K))
        assert float(mem.views[i].camera.width) == 96


def test_pad_and_crop_result_match():
    """Zero padding of a smaller view's result to the stack shape, and the
    crop back: exact in both packages."""
    from mpmvs_tpu import pipeline as jpipe
    from mpmvs_tpu.solver import SolveResult as JaxResult
    from mpmvs_torch import interop
    from mpmvs_torch import pipeline as tpipe

    rng = np.random.default_rng(1)
    arrays = (rng.uniform(1, 2, (5, 7)), rng.normal(size=(5, 7, 3)),
              rng.uniform(0, 2, (5, 7)), np.zeros((5, 7)))
    arrays = [a.astype(np.float32) for a in arrays]
    jres = jpipe._pad_result(JaxResult(*map(jnp.asarray, arrays)), 8, 9)
    tres = tpipe._pad_result(interop.result_from_numpy(*arrays), 8, 9)
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    for a, b in zip(tpipe._crop_result(tres, 5, 7), arrays):
        np.testing.assert_array_equal(n(a), b)


def test_resume_and_unported_passes(workspace, tmp_path):
    folder, _ = workspace
    fast = PatchMatchParams(max_iterations=1, max_scale=0)
    cfg = ConfigParams(input_folder=folder, output_folder=str(tmp_path),
                       geom_iterations=0, planar_prior=False)
    Pipeline(cfg, fast, device="cpu").run(log=lambda *a: None)
    pipe = Pipeline(cfg, fast, device="cpu")
    calls = []
    pipe.process_view = lambda *a, **k: calls.append(1)
    pipe.run(log=lambda *a: None, resume=True)
    assert calls == []
    for override in (dict(geom_iterations=1), dict(planar_prior=True),
                     dict(sky_seg=True)):
        bad = ConfigParams(input_folder=folder, output_folder=str(tmp_path),
                           **{"geom_iterations": 0, "planar_prior": False,
                              **override})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Pipeline(bad, fast, device="cpu").run(log=lambda *a: None)
    with pytest.raises(NotImplementedError, match="item 13"):
        torch_cli.main(["--input", folder, "--devices", "all", "--device",
                        "cpu"] + FLAGS)
