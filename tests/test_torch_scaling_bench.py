"""``mpmvs_torch.tools.scaling_bench`` on the CPU at a tiny size (ranks over
gloo, FAST parameters): the record's schema, one run per rank count, the
1- and 2-rank depth digests equal, and the efficiencies computed from the
measured pass times. Its times are host times; the card's numbers come
from its runs on the H100 (PERF.md)."""

import json

import torch

from mpmvs_torch.tools import scaling_bench

torch.set_num_threads(1)


def test_scaling_bench_record(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    rc = scaling_bench.main(["--device", "cpu", "--ranks", "1,2", "--views",
                             "3", "--sources", "2", "--height", "32",
                             "--width", "48", "--preset", "fast", "--out",
                             str(out)])
    assert rc == 0
    record = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        record
    assert record["device"] == {"platform": "cpu", "kind": "cpu"}
    assert record["digests_identical"] is True
    runs = record["runs"]
    assert [r["ranks"] for r in runs] == [1, 2]
    assert runs[0]["depth_digests"] == runs[1]["depth_digests"]
    assert runs[1]["views_by_rank"] == [[0, 1], [2]]
    for r in runs:
        assert list(r["pass_wall_s"]) == ["photometric", "geom_0", "geom_1"]
        assert len(r["prior_build_s_by_rank"]) == r["ranks"]
        assert [c["op"] for c in r["collectives"]] == [
            "depth_all_gather", "depth_all_gather", "result_gather"]
        assert r["collectives"][0]["bytes"] == 3 * 32 * 48 * 4
        assert all(e < 0.02 for e in r["median_rel_err"].values())
        assert r["fused_points"] > 0
    assert runs[0]["efficiency"] == 1.0
    assert runs[1]["efficiency"] == runs[0]["passes_s"] / (
        2 * runs[1]["passes_s"])
