"""The port's ``eval`` module against ``mpmvs_tpu.eval`` on the same arrays
and files, and a ``--fast`` run of the port's two measurement tools
(``mpmvs_torch.tools.ab_deviations``, ``mpmvs_torch.tools.synthetic_eval``)
on the CPU at 48x64 with 3 views.

Tolerance: the two eval modules run the same numpy and scipy code on the
same inputs, so their results must be equal. The tool runs are plumbing
checks: every arm writes finite metrics, and each arm's NCC calls went
through the path its ``sampler`` names.
"""

import json
import os

import numpy as np
import pytest
import torch

from mpmvs_tpu import eval as jeval
from mpmvs_torch import eval as teval
from mpmvs_torch.io.dmb import write_dmb
from mpmvs_torch.io.ply import write_ply_binary
from mpmvs_torch.tools import ab_deviations, synthetic_eval

torch.set_num_threads(1)


def _depths(seed=0, shape=(24, 32)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1.0, 3.0, shape).astype(np.float32)
    gt[rng.random(shape) < 0.1] = 0.0          # invalid GT
    est = gt + rng.normal(0.0, 0.05, shape).astype(np.float32)
    est[rng.random(shape) < 0.05] = np.nan     # missing estimates
    return est, gt


def test_depth_map_metrics_match():
    est, gt = _depths()
    for thresholds in ((0.02, 0.1, 0.5), (0.01,)):
        assert (teval.eval_depth_map(est, gt, thresholds).to_dict()
                == jeval.eval_depth_map(est, gt, thresholds).to_dict())
    empty = np.full_like(est, np.nan)
    assert (teval.eval_depth_map(empty, gt).to_dict()
            == jeval.eval_depth_map(empty, gt).to_dict())
    with pytest.raises(ValueError, match="shape mismatch"):
        teval.eval_depth_map(est, gt[:-1])


def test_point_cloud_metrics_match():
    rng = np.random.default_rng(1)
    gt = rng.uniform(-1.0, 1.0, (3000, 3))
    pred = np.concatenate([gt[:2000] + rng.normal(0.0, 0.01, (2000, 3)),
                           rng.uniform(-1.0, 1.0, (500, 3))])
    for tau, max_points in ((0.02, 2_000_000), (0.05, 1000)):
        assert (teval.eval_point_cloud(pred, gt, tau, max_points).to_dict()
                == jeval.eval_point_cloud(pred, gt, tau,
                                          max_points).to_dict())
    assert teval.eval_point_cloud(pred[:0], gt).f1 == 0.0


def test_scene_depths_and_cli_match(tmp_path, capsys):
    res, gtd = tmp_path / "MPMVS", tmp_path / "gt"
    gtd.mkdir()
    for v in range(3):
        est, gt = _depths(seed=v)
        os.makedirs(res / f"2333_{v:08d}")
        write_dmb(str(res / f"2333_{v:08d}" / "depths.dmb"), est)
        # GT at twice the estimate's resolution: nearest resampling
        write_dmb(str(gtd / f"{v:08d}.dmb"), np.repeat(np.repeat(gt, 2, 0),
                                                       2, 1))
    got = teval.eval_scene_depths(str(res), str(gtd), [0, 1, 2, 7])
    assert got == jeval.eval_scene_depths(str(res), str(gtd), [0, 1, 2, 7])
    assert set(got) == {"0", "1", "2", "mean"}

    pts = np.random.default_rng(2).uniform(-1, 1, (500, 3)).astype(
        np.float32)
    write_ply_binary(str(tmp_path / "a.ply"), pts, np.zeros_like(pts),
                     np.zeros((500, 3), np.uint8))
    write_ply_binary(str(tmp_path / "b.ply"), pts[:400], np.zeros_like(
        pts[:400]), np.zeros((400, 3), np.uint8))
    for argv in (["scene", "--result-dir", str(res), "--gt-dir", str(gtd),
                  "--views", "0", "1", "2"],
                 ["dmap", "--est", str(res / "2333_00000001" / "depths.dmb"),
                  "--gt", str(res / "2333_00000002" / "depths.dmb")],
                 ["cloud", "--pred", str(tmp_path / "a.ply"), "--gt",
                  str(tmp_path / "b.ply")]):
        outs = []
        for mod in (teval, jeval):
            assert mod.main(argv) == 0
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1], argv[0]


def test_ab_deviations_fast_on_cpu(tmp_path):
    out = tmp_path / "ab.json"
    assert ab_deviations.main(["--device", "cpu", "--fast", "--height", "48",
                               "--width", "64", "--views", "3", "--out",
                               str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == {"platform": "cpu", "kind": "cpu"}
    arms = res["arms"]
    assert list(arms) == ["deviations_on", "reference_semantics",
                          "reference_semantics_kernel1"]
    for name, arm in arms.items():
        assert np.isfinite(arm["depth_mae"]) and arm["wall_s"] > 0, name
        assert 0.0 <= arm["cloud"]["f1"] <= 1.0, name
        multi, samples = (arm["launches_kernel_plain"][k]
                          for k in ("ncc_eval_multi", "ncc_samples"))
        assert multi[0] == samples[0] == 0 and multi[1] > 0, name
        assert (samples[1] > 0) == (name == "reference_semantics"), name
    assert arms["reference_semantics"]["params"]["sampler"] == "sorted"
    assert "f1_deviations_minus_reference" in res["delta"]


def test_synthetic_eval_fast_on_cpu(tmp_path):
    out = tmp_path / "eval.json"
    assert synthetic_eval.main(["--device", "cpu", "--fast", "--height",
                                "48", "--width", "64", "--views", "3",
                                "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["scene"]["resolution"] == [64, 48]
    assert set(res["depth"]) == {"0", "1", "2", "mean"}
    assert np.isfinite(res["depth"]["mean"]["mae"])
    assert 0.0 <= res["cloud_f1"]["f1"] <= 1.0
    assert res["n_fused_points"] == res["cloud_f1"]["n_pred"] > 0
