"""The port's pipeline, CLI and fusion against mpmvs_tpu.

* Both CLIs (``--preset fast --geom-iterations 0 --planar-prior 0``) on one
  workspace written by the port's ``write_workspace``: the .dmb files agree
  per pixel within the whole-solve tolerance of test_torch_solver.py (depth
  beyond 0.1% relative on at most 5% of pixels; the packages draw the same
  numbers and part only on float-tie adoptions), and the fused PLY point
  counts within 5% of each other (fusion's thresholds turn those pixels
  into a few points more or less).
* The default configuration (two geometric passes, the planar-prior sub-run
  in the first) with ``--sky-seg 1``, through both CLIs on a colour
  workspace whose top rows are painted sky blue, compared on the non-sky
  rows (sky rows are flat, so their depth is noise in both): at most 5% of
  pixels beyond 0.5% relative depth. Wider than the photometric bound: the
  prior sub-run fits planes by least squares to the previous pass's depths
  and re-draws +-2% depth trials around them, so the float-tie differences
  left after the first pass move the prior planes, and the final depths of
  the two packages spread up to 0.3% apart (measured: no pixel beyond 0.3%,
  6-15% of pixels beyond 0.1%). Both stay within 1% of the truth. Sky masks
  equal on all but 0.5% of pixels (the JPEGs of both; JPEG rounding), PLY
  point counts within 5%. ``Pipeline.run`` with the same
  configuration writes the same files as the port's CLI, bit for bit.
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


SKY_V, SKY_H, SKY_W, SKY_ROWS = 4, 48, 64, 12
SKY_BGR = (235, 180, 135)


@pytest.fixture(scope="module")
def sky_workspace(tmp_path_factory):
    """A 4-view colour workspace: the plane scene's texture (grey), its top
    SKY_ROWS painted sky blue in every view."""
    import cv2
    from mpmvs_torch.io.cams import write_cam_txt, write_pair_txt

    scene = make_plane_scene(num_views=SKY_V, height=SKY_H, width=SKY_W,
                             seed=21)
    folder = str(tmp_path_factory.mktemp("sky_ws"))
    os.makedirs(os.path.join(folder, "images"))
    os.makedirs(os.path.join(folder, "cams"))
    for v in range(SKY_V):
        bgr = np.repeat(scene.images[v][..., None], 3, -1)
        bgr[:SKY_ROWS] = SKY_BGR
        cv2.imwrite(os.path.join(folder, "images", f"{v:08d}.jpg"),
                    bgr.astype(np.uint8), [cv2.IMWRITE_JPEG_QUALITY, 100])
        write_cam_txt(os.path.join(folder, "cams", f"{v:08d}_cam.txt"),
                      scene.cameras.view(v))
    write_pair_txt(os.path.join(folder, "pair.txt"),
                   [[(j, 10.0) for j in range(SKY_V) if j != i]
                    for i in range(SKY_V)])
    return folder, scene


@pytest.fixture(scope="module")
def sky_outputs(sky_workspace, tmp_path_factory):
    folder, _ = sky_workspace
    out_t = str(tmp_path_factory.mktemp("sky_torch"))
    out_j = str(tmp_path_factory.mktemp("sky_jax"))
    flags = ["--preset", "fast", "--sky-seg", "1"]
    assert torch_cli.main(["--input", folder, "--output", out_t,
                           "--device", "cpu"] + flags) == 0
    assert jax_cli.main(["--input", folder, "--output", out_j] + flags) == 0
    return out_t, out_j


def _view_file(out, v, name):
    return os.path.join(out, "MPMVS", f"2333_{v:08d}", name)


def test_default_schedule_with_sky_matches_jax(sky_workspace, sky_outputs):
    import cv2

    _, scene = sky_workspace
    out_t, out_j = sky_outputs
    for out in (out_t, out_j):
        with open(os.path.join(out, "MPMVS", "progress.json")) as f:
            assert f.read().count("geom_") == 2
    ground = slice(SKY_ROWS + 4, SKY_H)
    for v in range(SKY_V):
        dt, dj = (read_dmb(_view_file(o, v, "depths.dmb"))[ground]
                  for o in (out_t, out_j))
        assert (np.abs(dt - dj) / dj > 5e-3).mean() <= 0.05
        gt = scene.gt_depth[v][ground]
        assert np.median(np.abs(dt - gt) / gt) < 0.01
        mt, mj = (cv2.imread(_view_file(o, v, "skymask_refine.jpg"),
                             cv2.IMREAD_GRAYSCALE) > 127
                  for o in (out_t, out_j))
        assert (mt != mj).mean() <= 0.005
        assert mt[:SKY_ROWS - 2].mean() > 0.9 and mt[ground].mean() < 0.05
        assert os.path.exists(_view_file(out_t, v, "skymask.jpg"))
    pt, _, _ = read_ply_binary(os.path.join(out_t, "MPMVS", "MPMVS_model.ply"))
    pj, _, _ = read_ply_binary(os.path.join(out_j, "MPMVS", "MPMVS_model.ply"))
    assert len(pj) > 100
    assert abs(len(pt) - len(pj)) <= 0.05 * len(pj), (len(pt), len(pj))


def test_pipeline_run_matches_cli(sky_workspace, sky_outputs, tmp_path):
    folder, _ = sky_workspace
    out_t, _ = sky_outputs
    cfg = ConfigParams(input_folder=folder, output_folder=str(tmp_path),
                       sky_seg=True)
    fast = PatchMatchParams(max_iterations=1, geom_iterations=1, max_scale=0)
    pipe = Pipeline(cfg, fast, device="cpu", write_jpg=False)
    pipe.run(log=lambda *a: None)
    for v in range(SKY_V):
        for name in ("depths.dmb", "normals.dmb", "costs.dmb"):
            np.testing.assert_array_equal(
                read_dmb(_view_file(str(tmp_path), v, name)),
                read_dmb(_view_file(out_t, v, name)))
        assert not os.path.exists(_view_file(str(tmp_path), v,
                                             "skymask.jpg"))
        assert pipe.views[v].sky_mask[:SKY_ROWS - 2].mean() > 0.9
    stages = [(stage, n) for n, stage, _ in pipe.solve_log]
    assert [s for s, _ in stages].count("photometric") == SKY_V
    assert [s for s, _ in stages].count("geom") == 2 * SKY_V
    assert [s for s, _ in stages].count("prior") == SKY_V
    pt, _, _ = read_ply_binary(os.path.join(str(tmp_path), "MPMVS",
                                            "MPMVS_model.ply"))
    ps, _, _ = read_ply_binary(os.path.join(out_t, "MPMVS",
                                            "MPMVS_model.ply"))
    np.testing.assert_array_equal(pt, ps)


def test_resume_into_geom_1(sky_workspace, sky_outputs, tmp_path):
    """A run killed after geom_0 resumes with geom_1 only (from the
    checkpoints) and then masks sky and fuses."""
    import json
    import shutil

    folder, _ = sky_workspace
    out_t, _ = sky_outputs
    shutil.copytree(os.path.join(out_t, "MPMVS"),
                    os.path.join(str(tmp_path), "MPMVS"))
    with open(os.path.join(str(tmp_path), "MPMVS", "progress.json"), "w") as f:
        json.dump({"completed": ["photometric", "geom_0"]}, f)
    os.remove(os.path.join(str(tmp_path), "MPMVS", "MPMVS_model.ply"))
    cfg = ConfigParams(input_folder=folder, output_folder=str(tmp_path),
                       sky_seg=True)
    fast = PatchMatchParams(max_iterations=1, geom_iterations=1, max_scale=0)
    pipe = Pipeline(cfg, fast, device="cpu", write_jpg=False)
    calls = []
    solve = pipe.process_view
    pipe.process_view = lambda s, geom, prior, log: calls.append(
        (s.ref_id, geom, prior)) or solve(s, geom, prior, log)
    ply = pipe.run(log=lambda *a: None, resume=True)
    assert calls == [(v, True, False) for v in range(SKY_V)]
    assert len(read_ply_binary(ply)[0]) > 100
    with open(os.path.join(str(tmp_path), "MPMVS", "progress.json")) as f:
        assert json.load(f)["completed"] == ["photometric", "geom_0",
                                             "geom_1"]


def test_fusion_honours_sky_masks(fusion_inputs):
    """A sky mask removes the reference pixels it covers from the cloud and
    nothing else: both packages, the same points."""
    scene, depths, normals, colors = fusion_inputs
    ids = range(4)
    tscenes = [Scene(i, [i] + [j for j in ids if j != i]) for i in ids]
    jscenes = [JaxScene(s.ref_id, s.src_ids) for s in tscenes]
    sky = np.zeros(depths.shape, bool)
    sky[:, :15] = True
    pj, _, _ = jfus.run_fusion(depths, normals, colors, _jax_cams(scene),
                               jscenes, sky_masks=sky)
    pt, _, _ = tfus.run_fusion(depths, normals, colors, scene.cameras,
                               tscenes, sky_masks=sky)
    full, _, _ = tfus.run_fusion(depths, normals, colors, scene.cameras,
                                 tscenes)
    assert 0 < len(pt) < len(full)
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)


def test_unestimated_sources_have_empty_depth_maps(tmp_path):
    """A view that is a source of others but is not estimated itself has no
    depth map in the geometric passes. The port reads it as zeros, which the
    geometric cost scores as the full 3.0 penalty (as the reference reads a
    missing .dmb); the JAX pipeline stops there with an AttributeError
    (mpmvs_tpu/pipeline.py:155-157)."""
    scene = make_plane_scene(num_views=4, height=32, width=48, seed=3)
    cfg = ConfigParams(input_folder=str(tmp_path),
                       output_folder=str(tmp_path))
    fast = PatchMatchParams(max_iterations=1, geom_iterations=1, max_scale=0)
    pipe = Pipeline(cfg, fast, device="cpu", write_jpg=False)
    pipe.load_arrays(scene.images, scene.colors, scene.cameras,
                     [[1, 2, 3], [0, 2, 3], [], []])
    pipe.run(log=lambda *a: None)
    assert [s for _, s, _ in pipe.solve_log].count("geom") == 4
    for v in (0, 1):
        res = pipe.views[v].result
        # two of three sources score the full penalty, so the geometric
        # share stays near 0.2 x 3 x their weight
        assert n(res.geom_cost).mean() > 0.2
        gt = scene.gt_depth[v]
        assert np.median(np.abs(n(res.depth) - gt) / gt) < 0.02
    assert pipe.views[2].result is None


def test_save_prior_writes_prior_maps(tmp_path):
    """``save_prior_dmb``: the rasterized prior's depth (zero off the mask)
    and normals, against the JAX package's plane -> depth on the same prior
    (within 1e-5 relative: float32 rounding of the two geometry ports)."""
    from mpmvs_tpu import geometry as jgeo
    from mpmvs_torch.prior import build_planar_prior

    scene = make_plane_scene(num_views=2, height=32, width=48, seed=5)
    cfg = ConfigParams(input_folder=str(tmp_path),
                       output_folder=str(tmp_path), save_prior_dmb=True)
    pipe = Pipeline(cfg, device="cpu", write_jpg=False)
    pipe.load_arrays(scene.images, scene.colors, scene.cameras, [[1], []])
    K = n(scene.cameras.K[0]).astype(np.float64)
    pr = build_planar_prior(scene.gt_depth[0],
                            np.full((32, 48), 0.05, np.float32), K, 0.1,
                            100.0, device="cpu")
    pipe._save_prior(0, pr, (32, 48))
    x, y = np.meshgrid(np.arange(48, dtype=np.float32),
                       np.arange(32, dtype=np.float32))
    want = np.where(pr.mask, np.asarray(jgeo.depth_from_plane(
        jnp.asarray(K, jnp.float32), jnp.asarray(pr.planes), jnp.asarray(x),
        jnp.asarray(y))), 0.0)
    d = read_dmb(_view_file(str(tmp_path), 0, "depths_prior.dmb"))
    nrm = read_dmb(_view_file(str(tmp_path), 0, "normal_prior.dmb"))
    assert pr.mask.mean() > 0.5 and (d[~pr.mask] == 0).all()
    np.testing.assert_allclose(d, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(nrm[pr.mask], pr.planes[pr.mask][:, :3])
    gt = scene.gt_depth[0][pr.mask]
    assert np.abs(d[pr.mask] - gt).max() / gt.min() < 1e-3


def test_resume_and_unported_passes(workspace, tmp_path):
    """A finished run resumes with nothing to do; ``--devices`` (multi-GPU
    view sharding) is the one part of the CLI still unported."""
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
    with pytest.raises(NotImplementedError, match="item 13"):
        torch_cli.main(["--input", folder, "--devices", "all", "--device",
                        "cpu"] + FLAGS)
