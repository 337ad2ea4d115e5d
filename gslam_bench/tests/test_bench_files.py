"""Every file that BENCHMARK.json names, or that the harness finds by a
name in it, resolves; the entries keep to the benchmark's contract."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "gslam_bench")
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_paths_and_command():
    assert BENCH["paths"] == ["gslam_bench"]
    assert BENCH["command"] == ["python3", "-m", "gslam_bench.run"]
    assert os.path.isfile(os.path.join(HERE, "run.py"))
    assert 1 <= BENCH["run_seconds"] <= 51


def test_configs_resolve():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"])
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("gslam_bench/") and os.path.isfile(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert {"slam", "line_extractor"} <= set(cfg)


def test_cells_resolve():
    names = {c["name"] for c in BENCH["configs"]}
    seen = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in names
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.isfile(os.path.join(HERE, "worlds",
                                           traffic["world"] + ".json"))
        with open(os.path.join(HERE, "cells", w["name"] + ".json")) as f:
            cell = json.load(f)
        a, b = cell["trace_frames"]
        assert 0 <= a < b
        assert set(cell["limits"]) == {
            "closures", "lm_pose_gap", "pg_pose_gap", "refine_gap",
            "grid_cells"}
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_readers_resolve(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert os.path.isfile(os.path.join(HERE, "metrics", m["name"] + ".py"))
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells


def test_end_to_end_entries():
    names = [e["name"] for e in BENCH["end_to_end"]]
    assert "setup_s" in names
    for e in BENCH["end_to_end"]:
        assert UNIT.match(e["unit"]) and e["source"] == "host_clock"
        assert 0.01 <= e["bound"] <= 0.25
