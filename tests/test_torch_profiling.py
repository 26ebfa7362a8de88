"""PyTorch port: the profiling utilities and the profiling entry points.

Against the JAX package, on the same numpy inputs: ``rtf_report`` and
``FrameTimer.report`` (the same dict, the same keys and values) and
``summarize_ms``. Port only: ``parse_device_durations`` and the per-step
attribution on a small Chrome trace written by the test in
``torch.profiler``'s format (device events before the lead-in's idle gap
left out), the lead-in rule itself, ``benchmark``, ``scan_timed``,
``fetch_scalar`` and ``trace`` on the CPU, and the entry points' flags
and JSON lines on the CPU at a tiny width.
"""

import gzip
import json
import sys

import numpy as np
import pytest
import torch

from koemorph_tpu.utils import profiling as jprof
from koemorph_tpu.utils import trace_latency as jtl
from koemorph_tpu_torch import profile_multistream, profile_training
from koemorph_tpu_torch.utils import profiling, trace_latency

FRAME_TIMES = np.random.default_rng(3).uniform(0.004, 0.05, 97)


@pytest.mark.parametrize("fps", [30.0, 60.0])
def test_rtf_report_matches_jax(fps):
    got = profiling.rtf_report(FRAME_TIMES, fps)
    want = jprof.rtf_report(FRAME_TIMES, fps)
    assert got == want
    assert profiling.rtf_report(FRAME_TIMES[:0], fps) == {"frames": 0}
    assert profiling.rtf_report(FRAME_TIMES, fps, total_frames=500) == \
        jprof.rtf_report(FRAME_TIMES, fps, total_frames=500)


def test_frame_timer_matches_jax():
    got, want = profiling.FrameTimer(30.0, window=50), jprof.FrameTimer(
        30.0, window=50)
    for _ in range(60):
        with got:
            pass
    got.times.clear()
    for t in FRAME_TIMES[:50]:
        got.times.append(float(t))
        want.times.append(float(t))
    want.total_frames = got.total_frames
    assert got.total_frames == 60
    assert got.report() == want.report()


def test_summarize_ms_matches_jax():
    assert trace_latency.summarize_ms(FRAME_TIMES * 1e3) == \
        jtl.summarize_ms(FRAME_TIMES * 1e3)
    with pytest.raises(ValueError):
        trace_latency.summarize_ms([])


def _kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _trace_events():
    """A lead-in (fills and adds, then 20 ms of idle device), then two
    steps of a graph replay and a copy, their launches on the host inside
    the steps' ``record_function`` ranges."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "GPU 0"}}]
    ev += [_kernel("void at::native::vectorized_elementwise_kernel<4, "
                   "at::native::FillFunctor<float>>(int)", 10.0, 1.0, 1),
           _kernel("void at::native::vectorized_elementwise_kernel<4, "
                   "at::native::AddFunctor<float>>(int)", 12.0, 1.0, 2)]
    corr = 10
    for step, base in ((0, 30000.0), (1, 30100.0)):
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": f"{trace_latency.STEP_PREFIX}{step}", "pid": 1,
                   "tid": 1, "ts": base - 20000.0, "dur": 50.0})
        for j, (name, dur) in enumerate((("logmel_power(float*, int)", 4.0),
                                         ("cycle_dsum_kernel<8>(float*)",
                                          6.0))):
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaGraphLaunch", "pid": 1, "tid": 1,
                       "ts": base - 20000.0 + 1 + j, "dur": 1.0,
                       "args": {"correlation": corr}})
            ev.append(_kernel(name, base + 10.0 * j, dur, corr))
            corr += 1
    ev.append({"ph": "X", "cat": "gpu_memcpy",
               "name": "Memcpy DtoD (Device -> Device)", "pid": 0, "tid": 7,
               "ts": 30200.0, "dur": 2.0, "args": {"correlation": 99}})
    return ev


@pytest.mark.parametrize("gz", [False, True])
def test_parse_device_durations_from_a_chrome_trace(tmp_path, gz):
    path = tmp_path / ("trace.json.gz" if gz else "trace.json")
    opener = gzip.open if gz else open
    with opener(path, "wt") as fh:
        json.dump({"traceEvents": _trace_events()}, fh)
    got = trace_latency.parse_device_durations(str(tmp_path))
    # the lead-in's fill and add are left out; parameter lists stripped
    assert got == {"logmel_power": [0.004, 0.004],
                   "cycle_dsum_kernel<8>": [0.006, 0.006],
                   "Memcpy DtoD": [0.002]}
    assert trace_latency.parse_device_durations(
        str(path), name_prefix="cycle") == {"cycle_dsum_kernel<8>":
                                            [0.006, 0.006]}
    steps = trace_latency.step_durations(str(tmp_path))
    np.testing.assert_allclose(steps["step"], [0.016, 0.016])
    np.testing.assert_allclose(steps["step_busy"], [0.010, 0.010])
    with pytest.raises(FileNotFoundError):
        trace_latency.parse_device_durations(str(tmp_path / "none"))


def test_lead_in_rule():
    lead = [(0.0, 1.0, "fill"), (2.0, 3.0, "add")]
    assert trace_latency.lead_in_end(
        lead + [(20000.0, 20010.0, "gemm")]) == 20000.0
    # the lead-in's activities lost: no cut
    assert trace_latency.lead_in_end([(0.0, 1.0, "gemm"),
                                      (20000.0, 1.0, "gemm")]) is None
    # a gap after a window's own kernel is not the lead-in's
    assert trace_latency.lead_in_end(lead[:1] + [(5.0, 6.0, "gemm"),
                                                 (30000.0, 1.0, "x")]) is None


def test_timers_on_the_cpu(tmp_path):
    x = torch.ones(64)
    out = profiling.benchmark(lambda a: a * 2, (x,), warmup=1, iters=5,
                              reps=2, device="cpu")
    assert set(out) == {"latency_ms", "iters", "reps", "throughput_per_s"}
    assert out["latency_ms"] > 0
    rtt = profiling.measure_rtt("cpu")
    ms, flops = profiling.scan_timed(lambda: x.sum(), rtt=rtt, iters=4,
                                     reps=2, device="cpu")
    assert ms >= 0 and flops is None
    assert profiling.fetch_scalar(torch.tensor([2.5, 1.0])) == 2.5
    assert profiling.fetch_scalar({"loss": torch.tensor(3.0)}) == 3.0
    with profiling.trace(str(tmp_path / "t"), host=True) as d:
        (x * 3).sum()
    data = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert d == str(tmp_path / "t") and "traceEvents" in data
    # no device activity on the CPU: per-step durations are empty
    assert trace_latency.capture_step_trace(
        lambda c, a: c + a, torch.zeros(()), [torch.ones(())] * 3,
        log_dir=str(tmp_path / "steps"), warmup=1) == {}


def test_profile_training_entry_point(monkeypatch, capsys):
    """The CLI's flags and JSON on the CPU, at a tiny width (the flagship
    step takes minutes on a CPU)."""
    from koemorph_tpu_torch.models import dual_stream_model as dm
    real = dm.SequentialDualStreamModel

    def tiny(**kw):
        kw.update(d_model=32, num_heads=2, mel_sequence_length=16,
                  emotion_backend="basic", use_concatenation=False)
        return real(**kw)

    monkeypatch.setattr(dm, "SequentialDualStreamModel", tiny)
    assert profile_training.main(["--cpu", "--batches", "2", "3",
                                  "--span", "24", "--steps", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["span_frames"] == 24 and out["stride_frames"] == 4
    assert out["device"] == "cpu"
    assert [r["batch"] for r in out["results"]] == [2, 3]
    for r in out["results"]:
        assert set(r) == {"batch", "ms_per_step", "windows_per_s",
                          "audio_s_per_s", "compile_s"}
        assert r["ms_per_step"] > 0 and r["windows_per_s"] > 0


def test_profile_multistream_entry_point(monkeypatch, capsys):
    from koemorph_tpu_torch.runtime import engine
    real = engine.build_streaming_model
    monkeypatch.setattr(engine, "build_streaming_model",
                        lambda **kw: real(d_model=32, num_heads=2,
                                          emotion_backend="basic", **kw))
    assert profile_multistream.main(["--cpu", "--sessions", "1", "2",
                                     "--frames", "2"]) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["sessions"] for r in lines[:2]] == [1, 2]
    assert {"step_ms", "realtime", "compile_s", "scans_run"} <= set(lines[0])
    if any(r["realtime"] for r in lines[:2]):
        assert lines[-1]["summary"] == "max_realtime_sessions_measured"
        assert lines[-1]["budget_ms"] == 33.33


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (profile_training, profile_multistream):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(["--batches", "1"] if mod is profile_training
                     else ["--sessions", "1"])
    assert "koemorph_tpu_torch.utils.profiling" in sys.modules
