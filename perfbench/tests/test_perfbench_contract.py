"""BENCHMARK.json holds to the benchmark's contract: its keys, names,
units and limits of length, every configuration used and filed under the
benchmark's paths, every metric with a reader, every cell with a traffic
file and a driver, and each cell reporting set-up, another end-to-end
metric and a per-layer metric."""

import json
import re

import pytest

from perfbench.harness import spec
from perfbench.tests.helpers import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    names = [c["name"] for c in BENCH["configs"]]
    assert set(names) == used and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        tr = json.loads((ROOT / "perfbench" / "traffic" /
                         f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "drivers" /
                f"{tr['driver']}.py").is_file()


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert spec.reader(m["name"]).read({}) is None
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for cell in cells:
        mine = [m for m in BENCH["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits_are_set(cell):
    c = spec.load_cell(ROOT, cell, 1, 1.0, False)
    assert c.traffic["limits"]
    assert all(0 < v < 1 for v in c.traffic["limits"].values())


def test_no_card_means_no_result():
    """Without a CUDA card a run exits non-zero and prints nothing on
    standard output: it never falls back to the CPU."""
    import subprocess
    import sys

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "serve_s2048_g8",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
