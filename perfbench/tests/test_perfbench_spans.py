"""The readers of the program's spans, stamps and counters
(:mod:`perfbench.harness.program`), on synthetic traces and exports: each
new metric's value against a hand count, the split of idle time by
program span (summing to the window's idle time), the host clock's
correction by the correlation check, the window of the host spans, the
traced-run switch, and None from a program without the registry."""

import json

import pytest

from perfbench.harness import program, spec
from perfbench.harness.trace import TraceResult, base_name

BASE = 100000.0
#: the host clock runs this far ahead of the device's in the traces below
AHEAD = 20.0
#: the tracks' slots in the traces below, as the registry gives them out
TRACKS = {"serve": ("begin", "ingest", "ring", "mel", "refresh", "model"),
          "decode": ("begin", "emotion", "frontend", "model"),
          "train": ("begin", "emotion", "frontend", "forward", "backward",
                    "optimizer")}
SLOTS = dict(enumerate((t, s) for t, stages in TRACKS.items()
                       for s in stages))
_IDS = {f"{t}.{s}": i for i, (t, s) in SLOTS.items()}


@pytest.fixture(autouse=True)
def slots(monkeypatch):
    monkeypatch.setattr(program, "slot_names", lambda: SLOTS)


def _stamp(slot, t, corr):
    return (t, t + 1.0, f"void koemorph_stamp<{_IDS[slot]}>(long long*, "
            "long long*, int, int, int, int)", corr)


def _events(acts, host, calls, marker=1000.0):
    """A Chrome trace: the lead-in, ``acts`` ``(start, end, name,
    correlation)`` on the device's clock, ``host`` ranges ``(start, end,
    name, tid)`` and runtime ``calls`` ``(ts, name, correlation)`` on the
    host's clock (µs from ``BASE``), and the end marker."""
    ev = [{"ph": "X", "cat": "kernel", "name": "fill_kernel", "ts": 0.0,
           "dur": 1.0},
          {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": 2.0,
           "dur": 1.0}]
    for a, b, name, corr in acts:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": BASE + a,
                   "dur": b - a, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "kernel", "name": "mul_kernel",
               "ts": BASE + marker, "dur": 1.0})
    ev.append({"ph": "X", "cat": "user_annotation", "name": "perfbench.slice",
               "ts": BASE - 50.0 + AHEAD, "dur": marker + 100.0, "tid": 1})
    for a, b, name, tid in host:
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": BASE + a, "dur": b - a, "tid": tid})
    for ts, name, corr in calls:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": name,
                   "ts": BASE + ts, "dur": 3.0, "tid": 1,
                   "args": {"correlation": corr}})
    return ev


def _serve_events():
    """Two replays of the serve graph: step 1 without a refresh, step 2
    with two cohorts' (a refresh stamp each); the host's ranges ``AHEAD``
    µs late."""
    acts = [_stamp("serve.begin", 0, 1), _stamp("serve.ingest", 5, 1),
            (6, 20, "CatArrayBatchedCopy<float>(x)", 1),
            _stamp("serve.ring", 20, 1), (21, 40, "logmel_power<1>(f)", 1),
            _stamp("serve.mel", 40, 1), (41, 100, "gemm", 1),
            _stamp("serve.model", 100, 1),
            _stamp("serve.begin", 300, 2), _stamp("serve.ingest", 305, 2),
            (306, 320, "CatArrayBatchedCopy<float>(x)", 2),
            _stamp("serve.ring", 320, 2), (321, 340, "logmel_power<1>(f)", 2),
            _stamp("serve.mel", 340, 2), (341, 420, "lld", 2),
            _stamp("serve.refresh", 420, 2), (421, 500, "lld", 2),
            _stamp("serve.refresh", 500, 2), (501, 560, "gemm", 2),
            _stamp("serve.model", 560, 2)]
    dev_host = [(-10, 105, "koemorph.serve.step"),
                (-2, 3, "koemorph.serve.launch"),
                (190, 600, "koemorph.serve.step"),
                (200, 310, "koemorph.serve.launch")]
    host = [(a + AHEAD, b + AHEAD, n, 1) for a, b, n in dev_host]
    host.append((0.0, 900.0, "koemorph.other", 2))   # another thread
    calls = [(-1 + AHEAD, "cudaGraphLaunch", 1),
             (300 + AHEAD, "cudaGraphLaunch", 2)]
    return _events(acts, host, calls)


@pytest.fixture()
def serve_trace(tmp_path, monkeypatch):
    events = _serve_events()
    path = tmp_path / "serve.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(program, "trace_file", lambda workload=None: path)
    return {"trace": TraceResult(events)}


def read(name, rec):
    return spec.reader(name).read(rec)


def test_serve_stage_metrics(serve_trace):
    rec = serve_trace
    assert read("ring_shift_ms.serve", rec) == pytest.approx(0.015)
    # ingest 5 + ring 15 + mel 20 + model 60 µs, on both steps
    assert read("frame_device_ms.serve", rec) == pytest.approx(0.100)
    # only the refreshing step: mel's end to the last refresh stamp's,
    # both cohorts
    assert read("refresh_device_ms.serve", rec) == pytest.approx(0.160)
    steps = program.traced_steps(rec, "serve")
    assert ["refresh" in s for s in steps] == [False, True]
    assert [s["_end"] - s["_start"] for s in steps] == [100.0, 260.0]


def test_idle_split_by_program_span_and_clock_offset(serve_trace):
    rec = serve_trace
    pt = program.program_trace(rec)
    assert pt.offset_us == pytest.approx(AHEAD)
    split = pt.idle_by_span()
    tr = rec["trace"]
    idle_us = (tr.window_s - tr.busy_s) * 1e6
    assert sum(split.values()) == pytest.approx(idle_us)
    assert idle_us == pytest.approx(646.0)
    # gaps [1, 5], [101, 300], [301, 305], [561, 1000] on the device clock
    assert split["koemorph.serve.launch"] == pytest.approx(2 + 100 + 4)
    assert split["koemorph.serve.step"] == pytest.approx(2 + 4 + 10 + 39)
    assert split[program.NONE] == pytest.approx(85 + 400)
    assert "koemorph.other" not in split     # not the slice's thread
    assert read("launch_idle_ms.serve", rec) == pytest.approx(0.106 / 2)
    assert pt.replays() == [(BASE, BASE + 101.0), (BASE + 300.0,
                                                    BASE + 561.0)]


def test_without_the_offset_the_split_would_differ(serve_trace):
    events = _serve_events()
    for e in events:
        if e.get("cat") == "cuda_runtime":
            e["ts"] -= 100.0                 # calls well before their work
    pt = program.ProgramTrace(events, serve_trace["trace"])
    assert pt.offset_us == 0.0
    # the ranges stay AHEAD µs late: launch 1 covers [18, 23], launch 2
    # [220, 330]
    assert pt.idle_by_span()["koemorph.serve.launch"] == pytest.approx(
        80 + 4)


def _device_track_events(track, stages, step_us, n=3):
    acts, t = [], 0.0
    for i in range(n):
        acts.append(_stamp(f"{track}.begin", t, i + 1))
        for stage, us in zip(stages, step_us):
            t += us
            acts.append(_stamp(f"{track}.{stage}", t, i + 1))
        t += 50.0
    return _events(acts, [], [])


@pytest.mark.parametrize("track,names", [
    ("decode", {"emotion_device_ms.decode": ("emotion",),
                "frontend_device_ms.decode": ("frontend",),
                "model_device_ms.decode": ("model",)}),
    ("train", {"features_device_ms.train": ("emotion", "frontend"),
               "forward_device_ms.train": ("forward",),
               "backward_device_ms.train": ("backward",),
               "optimizer_device_ms.train": ("optimizer",)})])
def test_device_stage_metrics(track, names):
    stages = TRACKS[track][1:]
    step_us = {s: 10.0 * (k + 2) for k, s in enumerate(stages)}
    rec = {"trace": TraceResult(_device_track_events(
        track, stages, list(step_us.values()))),
        "program": {"reported": True}}
    for name, summed in names.items():
        want = sum(step_us[s] for s in summed)
        assert read(name, rec) == pytest.approx(want / 1e3), name


def test_a_step_cut_by_the_slice_is_left_out():
    acts = [(a, b, base_name(n)) for a, b, n, _ in (
        _stamp("decode.emotion", 0, 1), _stamp("decode.model", 5, 1),
        _stamp("decode.begin", 10, 2), _stamp("decode.emotion", 20, 2),
        _stamp("decode.frontend", 30, 2), _stamp("decode.model", 45, 2),
        _stamp("decode.begin", 60, 3))]
    steps = program.stage_steps(acts, SLOTS, "decode")
    assert len(steps) == 1
    assert {k: v for k, v in steps[0].items() if not k.startswith("_")} \
        == {"emotion": 10.0, "frontend": 10.0, "model": 15.0}


def _export():
    """Host spans of a window of 1 s (ns), a set-up before it."""
    ms = 1_000_000
    rows = []

    def span(name, a, b, profiled=False):
        rows.append({"id": len(rows), "name": name, "start_ns": a,
                     "end_ns": b, "parent": -1, "step": len(rows),
                     "profiled": profiled})

    span("koemorph.train.stack", -500 * ms, -400 * ms)      # set-up
    span("koemorph.train.scan", -400 * ms, -300 * ms)
    for e in range(2):                                     # the window
        t = e * 500 * ms
        span("koemorph.data.wait", t, t + 50 * ms)
        span("koemorph.train.stack", t + 50 * ms, t + 150 * ms)
        span("koemorph.train.upload", t + 150 * ms, t + 175 * ms)
        span("koemorph.train.scan", t + 175 * ms, t + 490 * ms)
    for i, d in enumerate((2, 3, 4, 100)):
        span("koemorph.serve.step", 2000 * ms + i * ms,
             2000 * ms + i * ms + d * 1000, profiled=d == 100)
        span("koemorph.serve.launch", 2000 * ms + i * ms,
             2000 * ms + i * ms + d * 1000, profiled=d == 100)
    return {"host": rows, "stages": {}, "counters": {}}


def test_host_clock_metrics():
    # the last scan ends the window
    rec = {"window_s": 0.99, "program": {"export": _export()}}
    assert read("loader_wait_share.train", rec) == pytest.approx(
        100 * 0.1 / 0.99)
    assert read("stack_share.train", rec) == pytest.approx(100 * 0.2 / 0.99)
    assert read("upload_share.train", rec) == pytest.approx(
        100 * 0.05 / 0.99)
    # the profiled launch is left out: median of 2, 3 and 4 µs
    rec = {"window_s": 1.0, "program": {"export": _export()}}
    assert read("launch_ms.serve", rec) == pytest.approx(0.003)


def test_nothing_to_read_without_the_registry(monkeypatch, serve_trace):
    monkeypatch.setattr(program, "spans_module", lambda: None)
    monkeypatch.setattr(program, "slot_names", lambda: None)
    for name in ("launch_ms.serve", "ring_shift_ms.serve",
                 "frame_device_ms.serve", "refresh_device_ms.serve",
                 "frontend_device_ms.decode", "emotion_device_ms.decode",
                 "model_device_ms.decode", "loader_wait_share.train",
                 "stack_share.train", "upload_share.train",
                 "features_device_ms.train", "forward_device_ms.train",
                 "backward_device_ms.train", "optimizer_device_ms.train"):
        assert read(name, {"window_s": 1.0, **serve_trace}) is None, name
        serve_trace.pop("program", None)
    monkeypatch.setattr(program, "trace_file", lambda workload=None: None)
    assert read("launch_idle_ms.serve", serve_trace) is None


def test_the_traced_run_switches_the_registry_on(monkeypatch):
    from koemorph_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "_ON", False)
    assert program.run_args(["--workload", "w", "--seed", "3",
                             "--trace", "1"]) \
        == {"workload": "w", "trace": "1"}
    # another tool's command line (pytest's own --trace takes no value)
    assert program.run_args(["-q", "-m", "card", "--trace"]) == {}
    assert not program.enable_for_traced_run(
        ["--workload", "w", "--trace", "0"])
    assert not spans.enabled()
    monkeypatch.setattr(spans, "enable",
                        lambda: monkeypatch.setattr(spans, "_ON", True))
    assert program.enable_for_traced_run(["--workload=w", "--trace=1"])
    assert spans.enabled()
