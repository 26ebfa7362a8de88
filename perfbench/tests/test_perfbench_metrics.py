"""The metric arithmetic: rates over all the work and all the window, the
95th percentile over every step, medians outside the profiled slice, and
the idle share, roofline share and share of the float32 peak from a
trace, against hand counts."""

import math

import numpy as np
import pytest
import torch

from perfbench.harness import kernels, roofline, spec
from perfbench.harness.trace import TraceResult


def read(name, rec):
    return spec.reader(name).read(rec)


def test_rates_are_all_work_over_all_time():
    rec = {"window_s": 10.0, "session_frames": 2048 * 500,
           "decode_rows": 4120 * 230, "audio_s": 153.5 * 900,
           "load_s": 1.25}
    assert read("session_frames_per_s", rec) == 2048 * 500 / 10.0
    assert read("decode_frames_per_s", rec) == 4120 * 230 / 10.0
    assert read("train_audio_s_per_s", rec) == 153.5 * 900 / 10.0
    assert read("load_share.train", rec) == 12.5
    assert read("decode_frames_per_s", {"window_s": 1.0}) is None


def test_p95_is_over_every_step():
    lat = [0.010] * 90 + [0.030] * 10            # 100 steps, 10 slow
    got = read("step_ms_p95", {"latency_s": lat})
    assert got == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert 10.0 < got <= 30.0
    # a slow tail of 4 in 100 stays out of the 95th percentile
    assert read("step_ms_p95", {"latency_s": [0.01] * 96 + [1.0] * 4}) \
        == pytest.approx(10.0)


def test_step_medians_split_by_refresh_and_leave_out_the_slice():
    rec = {"latency_s": [0.020, 0.010, 0.021, 0.011, 0.5, 0.5],
           "dispatch_s": [0.001, 0.002, 0.003, 0.004, 0.9, 0.9],
           "refresh": [True, False, True, False, True, False],
           "in_slice": [False, False, False, False, True, True]}
    assert read("refresh_step_ms.serve", rec) == pytest.approx(20.5)
    assert read("frame_step_ms.serve", rec) == pytest.approx(10.5)
    assert read("dispatch_ms.serve", rec) == pytest.approx(2.5)


def _trace(acts, marker_end=1000.0):
    """A Chrome trace: the lead-in's kernels, its idle gap, ``acts``
    ``(start, end, name)`` in µs, and the end marker."""
    ev = [{"ph": "X", "cat": "kernel", "name": "fill_kernel", "ts": 0.0,
           "dur": 1.0},
          {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 2.0,
           "dur": 1.0}]
    base = 100000.0
    for a, b, name in acts:
        ev.append({"ph": "X", "cat": "kernel", "name": name,
                   "ts": base + a, "dur": b - a})
    ev.append({"ph": "X", "cat": "kernel", "name": "mul_kernel",
               "ts": base + marker_end, "dur": 1.0})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "perfbench.slice",
               "ts": base - 50.0, "dur": marker_end + 40.0})
    ev.append({"ph": "X", "cat": "user_annotation",
               "name": "perfbench.prepare", "ts": base + 550.0,
               "dur": 400.0})
    return TraceResult(ev)


def test_idle_share_and_breakdown():
    tr = _trace([(0, 100, "logmel_power<1>(float*)"), (50, 150, "gemm"),
                 (400, 600, "cycle_dsum_kernel<8>(x)"),
                 (900, 950, "dk_roots_kernel")])
    assert tr.window_s == pytest.approx(1000e-6)
    # busy: [0,150] + [400,600] + [900,950] = 400 µs of 1000
    assert tr.busy_s == pytest.approx(400e-6)
    assert spec.reader("device_idle.serve").read({"trace": tr}) \
        == pytest.approx(60.0)
    assert tr.kernel_us("logmel_") == (1, 100.0)
    ops = dict(tr.device_ops())
    assert ops["cycle_dsum_kernel<8>"] == pytest.approx(200e-6)
    gaps = dict(tr.idle_gaps())
    # 150..400 starts before the prepare range, 600..900 inside it
    assert gaps["perfbench.none"] == pytest.approx(250e-6 + 50e-6)
    assert gaps["perfbench.prepare"] == pytest.approx(300e-6)


def test_k2_k3_counts_by_hand():
    # K3 at T = 4, 3 live bins, 5 weights: frames, bases, weights, rows
    assert roofline.k3_bytes(4, 3, 5, n_fft=8, n_mels=2) == \
        4.0 * (4 * 8 + 2 * 8 * 3 + 5 + 4 * 2)
    assert roofline.k3_ops(4, 3, 5, n_fft=8) == 4 * (2 * 8 * 3 * 2 + 2 * 5)
    assert roofline.k2_bytes(7) == 7 * 44 + 7 * 80 + 80
    assert roofline.k2_ops(1, iters=1) == 10 * 224
    live, nnz = roofline.logmel_live()
    assert (live, nnz) == (506, 992)
    # below the wgmma threshold the product is float32 on the CUDA cores
    t = 1
    assert roofline.k3_bound_s(t, live, nnz) == max(
        roofline.k3_bytes(t, live, nnz) / 3.35e12,
        roofline.k3_ops(t, live, nnz) / 67e12)
    t = 2048
    assert roofline.k3_bound_s(t, live, nnz) == max(
        roofline.k3_bytes(t, live, nnz) / 3.35e12,
        roofline.k3_ops(t, live, nnz) / (495e12 / 3))


def test_k1_counts_by_hand():
    # one row, n 40, half_lag 2: the span is 36 samples (j <= 35 - start)
    start = torch.tensor([3])
    tau = torch.tensor([10.0])
    off = torch.tensor([2.5])
    # cycle k holds j in [2.5 + 10k, 12.5 + 10k), j <= 32: 3..12, 13..22,
    # 23..32, then nothing
    assert roofline.cycle_masked(40, start, tau, off, 4, 2) == 30.0
    assert roofline.k1_ops(30.0, 2) == 3 * 5 * 30
    lay = roofline.frame_layout(torch.zeros(100).unfold(0, 40, 10)[None])
    assert lay == roofline.Layout(frame_stride=10, frames=7, batches=1)
    # 7 overlapping frames of 40 at stride 10 cover 100 samples
    assert roofline.k1_bytes(lay, 40, 7, 4 * 5) == 4 * 100 + 7 * (80 + 12)
    nan = roofline.cycle_masked(40, start, torch.tensor([math.nan]), off,
                                4, 2)
    assert nan == 0.0


def test_k1_count_matches_the_reference_masks():
    from perfbench.reference.f0 import cycle_masks
    g = torch.Generator().manual_seed(3)
    for n, k, hl in ((512, 8, 8), (1024, 5, 16)):
        rows = 300
        tau = torch.rand(rows, generator=g) * 280 + 8
        tau[::7] = math.nan
        off = torch.rand(rows, generator=g) * tau.nan_to_num(1.0) * 0.5
        start = torch.randint(0, 300, (rows,), generator=g)
        want = float(cycle_masks(n, start, tau, off, n_cycles=k,
                                 half_lag=hl).sum())
        assert roofline.cycle_masked(n, start, tau, off, k, hl) == want


def test_roofline_share_and_mfu():
    tr = _trace([(0, 30, "logmel_power"), (30, 50, "logmel_mel"),
                 (60, 160, "gemm"), (200, 240, "dk_roots_kernel")])
    live, nnz = roofline.logmel_live()
    snaps = [[("logmel", {"t": 64}), ("dk_roots", {"rows": 300})]]
    kb = kernels.bounds(snaps, live, nnz)
    rec = {"trace": tr, "kernel_bounds": kb, "slice_flops": 3.35e7}
    bound = roofline.k3_bound_s(64, live, nnz) + roofline.k2_bound_s(300)
    got = spec.reader("kernel_roofline.serve").read(rec)
    assert got == pytest.approx(100 * bound / 90e-6)
    assert got < 100
    # 3.35e7 operations over the 1000 µs window at 67 TFLOP/s
    assert spec.reader("mfu.decode").read(rec) == pytest.approx(
        100 * 3.35e7 / 1e-3 / 67e12)
    # a launch whose kernels the trace lost reads nothing
    kb["dk_roots"]["launches"] = 2
    assert spec.reader("kernel_roofline.train").read(rec) is None
