"""The port's diagnostics on the CPU: ``fusion.fusion_gate_funnel`` against
``mpmvs_tpu.fusion.fusion_gate_funnel``, and the tools
``mpmvs_torch.tools.fusion_diagnose`` and ``mpmvs_torch.tools.solve_trace``
at a tiny size with ``--device cpu`` (their JSON schema).

Tolerance: the funnel's counts are integers over the same consistency
chain on the same inputs, so they must be equal, count for count.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmvs_tpu import fusion as jfus
from mpmvs_tpu.camera import CameraStack as JaxCameraStack
from mpmvs_torch import fusion as tfus
from mpmvs_torch.tools import fusion_diagnose, solve_trace, synthetic_eval
from mpmvs_torch.utils.synthetic import make_plane_scene

from torch_parity import CAMERA_FIELDS, n, t

torch.set_num_threads(1)

FUNNEL_KEYS = {"candidates", "in_bounds", "src_not_consumed",
               "src_depth_pos", "reproj_lt2", "rel_dd_lt_0.01",
               "angle_lt_10deg", "px_valid_ref", "px_ncons_ge1",
               "px_ncons_ge2", "px_dynamic_accept", "px_static_accept",
               "only_reproj_fails", "only_rel_dd_fails", "only_angle_fails"}


@pytest.fixture(scope="module")
def scene_stacks():
    """5 views' GT stacks; 15% of the pixels' depths moved by +-0.5% or
    +-5%, 3% zeroed, normals tilted on 10% of the pixels."""
    scene = make_plane_scene(num_views=5, height=40, width=56, seed=3)
    rng = np.random.default_rng(1)
    depths = scene.gt_depth.copy()
    bump = rng.uniform(size=depths.shape) < 0.15
    depths[bump] *= rng.choice([0.95, 0.995, 1.005, 1.05],
                               size=int(bump.sum()))
    depths[rng.uniform(size=depths.shape) < 0.03] = 0.0
    normals = np.broadcast_to(scene.gt_normal_world,
                              depths.shape + (3,)).astype(np.float32).copy()
    tilt = rng.uniform(size=depths.shape) < 0.1
    normals[tilt] = np.array([0.0, 0.6, -0.8], np.float32)
    return scene, depths.astype(np.float32), normals


@pytest.mark.parametrize("ref,src,valid", [
    (0, [1, 2, 3, 4], [1, 1, 1, 1]),
    (2, [4, 0, 1, 0], [1, 1, 1, 0]),
    (4, [3, 0, 0, 0], [1, 0, 0, 0])])
def test_funnel_matches_jax(scene_stacks, ref, src, valid):
    scene, depths, normals = scene_stacks
    V, H, W = depths.shape
    colors = scene.colors
    masks = np.random.default_rng(ref).uniform(size=(V, H, W)) < 0.05
    src = np.array(src, np.int32)
    valid = np.array(valid, bool)
    jc = JaxCameraStack(**{f: jnp.asarray(n(getattr(scene.cameras, f)))
                           for f in CAMERA_FIELDS})
    jin = jfus.FusionInput(jnp.asarray(depths), jnp.asarray(normals),
                           jnp.asarray(colors), jc)
    want = {k: int(v) for k, v in jfus.fusion_gate_funnel(
        jin, jnp.asarray(masks), jnp.int32(ref), jnp.asarray(src),
        jnp.asarray(valid)).items()}
    tin = tfus.FusionInput(t(depths), t(normals), t(colors), scene.cameras)
    got = tfus.fusion_gate_funnel(tin, t(masks), ref, t(src).long(),
                                  t(valid))
    assert set(got) == FUNNEL_KEYS
    assert got == want
    assert want["angle_lt_10deg"] > 0 and want["only_rel_dd_fails"] > 0


def test_fusion_diagnose_on_cpu(tmp_path, capsys):
    work = str(tmp_path / "work")
    assert synthetic_eval.main(["--device", "cpu", "--fast", "--height",
                                "48", "--width", "64", "--views", "3",
                                "--workdir", work, "--out",
                                str(tmp_path / "eval.json")]) == 0
    out = tmp_path / "diag.json"
    assert fusion_diagnose.main(["--workdir", work, "--device", "cpu",
                                 "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert set(rep) == {"views", "totals", "bad_thresh_m", "device"}
    assert rep["device"] == {"platform": "cpu", "kind": "cpu"}
    assert list(rep["views"]) == ["0", "1", "2"]
    for v in rep["views"].values():
        assert set(v["funnel"]) == FUNNEL_KEYS
        assert v["funnel"]["candidates"] >= v["funnel"]["angle_lt_10deg"]
        assert np.isfinite(v["depth"]["mae"])
    assert set(rep["totals"]) == FUNNEL_KEYS | {"accepted_points"}
    assert rep["totals"]["accepted_points"] == sum(
        v["accepted_points"] for v in rep["views"].values())
    assert "totals" in json.loads(capsys.readouterr().out.splitlines()[-4])


def test_solve_trace_on_cpu(capsys):
    assert solve_trace.main(["--device", "cpu", "--height", "32", "--width",
                             "48", "--views", "3", "--reps", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["case"] for ln in lines] == ["half-iteration:photometric",
                                            "half-iteration:geom", "summary"]
    for row in lines[:2]:
        assert row["clock"] == "host" and row["idle_share"] is None
        assert set(row["split_ms"]) == {"ncc_kernel", "geom_cost",
                                        "threefry", "other_glue"}
        assert row["step_ms"] > 0 and row["split_ms"]["ncc_kernel"] > 0
        assert row["split_ms"]["threefry"] > 0
    assert lines[0]["split_ms"]["geom_cost"] == 0.0
    assert lines[1]["split_ms"]["geom_cost"] > 0


def test_tools_need_out_and_a_card():
    with pytest.raises(SystemExit):
        fusion_diagnose.main(["--workdir", "x"])
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_trace.main(["--height", "32", "--width", "48"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fusion_diagnose.main(["--workdir", "x", "--out", "y"])
