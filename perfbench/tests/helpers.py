"""Small cells for the CPU tests: the committed traffic files with their
sizes cut, so that a run takes seconds on the CPU."""

from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL = {
    "serve": dict(sessions=4, cohorts=2, pool_utterances=2,
                  pool_seconds=3.0, check_cohorts=2, check_lanes=2),
    "decode": dict(batch=2, utterance_frames=None, pool_utterances=2,
                   pool_seconds=12.0, check_calls=2),
    "train": dict(files=2, file_seconds=11.0, batch=2, slice_steps=1),
}


def small_traffic(workload: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(c for c in bench["workloads"] if c["name"] == workload)
    tr = json.loads((ROOT / "perfbench" / "traffic" /
                     f"{w['traffic']}.json").read_text())
    cfg = json.loads((ROOT / next(c["file"] for c in bench["configs"]
                                  if c["name"] == w["config"])).read_text())
    small = dict(SMALL[tr["driver"]])
    if tr["driver"] == "decode":
        small["utterance_frames"] = cfg["mel_sequence_length"] + 40
    tr.update(small)
    return tr


def run_small(workload: str, seconds: float = 1.0, seed: int = 2 ** 31 + 5,
              root: Path = ROOT) -> dict:
    """One run of ``workload`` on the CPU at small sizes (the card check
    skipped); returns the result line."""
    import torch

    from perfbench.harness import runner, spec
    torch.manual_seed(0)
    cell = spec.load_cell(root, workload, seed, seconds, False,
                          traffic=small_traffic(workload))
    return runner.execute(cell, time.perf_counter(), "cpu")
