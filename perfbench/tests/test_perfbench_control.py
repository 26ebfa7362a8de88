"""The lower-precision control fails each cell's check: the plain
reference computed in TF32, put in the program's place, reads above the
committed limit of one of the cell's numbers. On the card only (TF32
exists there); at sizes a test run holds, on three seeds."""

import json

import pytest
import torch

from perfbench.harness import spec
from perfbench.tests.helpers import ROOT

#: (workload, what one run compares at a test's size)
CASES = [("serve_s2048_g8", 120), ("serve60_s768_g8", 240),
         ("decode60_b8_stride1", 2), ("train_b16_scan", 3)]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("workload,count", CASES)
def test_tf32_control_is_not_correct(workload, count):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert workload in {w["name"] for w in bench["workloads"]}
    for seed in SEEDS:
        cell = spec.load_cell(ROOT, workload, seed, 0.0, False)
        limits = cell.traffic["limits"]
        readings = spec.driver(cell).control(cell, "cuda", count)
        assert any(readings[k] > limits[k] for k in readings), readings
