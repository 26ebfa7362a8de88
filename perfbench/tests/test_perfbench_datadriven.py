"""The harness is driven by data: a cell added to a copy of the benchmark
as a new traffic file and new entries in BENCHMARK.json, with no file
of the harness edited, runs and reports its metrics."""

import json
import os
import shutil
import subprocess
import sys

from perfbench.tests.helpers import ROOT

NEW = "serve_s6_g3"


def test_a_new_cell_needs_only_data(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    traffic = json.loads((tmp_path / "perfbench" / "traffic" /
                          "serve_s2048_g8.json").read_text())
    traffic.update(sessions=6, cohorts=3, pool_utterances=2,
                   pool_seconds=3.0, check_cohorts=1, check_lanes=1)
    (tmp_path / "perfbench" / "traffic" / f"{NEW}.json").write_text(
        json.dumps(traffic))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": NEW, "config": "dual_stream",
                               "traffic": NEW, "chips": 1,
                               "why": "a small added cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "serve_s2048_g8" in m.get("workloads", []):
            m["workloads"].append(NEW)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        "from pathlib import Path\n"
        "from perfbench.harness import runner, spec\n"
        f"cell = spec.load_cell(Path('.'), {NEW!r}, 2**31 + 9, 0.5, False)\n"
        "print(json.dumps(runner.execute(cell, time.perf_counter(), "
        "'cpu')))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert set(line["metrics"]) == {"session_frames_per_s", "step_ms_p95",
                                    "setup_s"}
    after = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())
    assert set(after) - set(before) == {
        tmp_path / "perfbench" / "traffic" / f"{NEW}.json"}
