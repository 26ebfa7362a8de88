"""PyTorch port: the span registry (``koemorph_tpu_torch/utils/spans.py``)
on the CPU, where a stage stamp writes the host clock.

- Off (the default), the paths read no clock, open no
  ``record_function`` and make no stamp (the three patched to raise over
  a server, a decode and a train step), and record nothing.
- On, the stage structure per step of the server (G = 2: a ``refresh``
  only on due steps, ``refreshed_lanes`` = due cohorts x S/G), the decode
  and the train step; the host spans of each path with their parents and
  shared step ids; the ``koemorph.data.wait`` span of
  ``prefetch_iterator``; the rings wrapping; the tracks' slot ids; the
  launch and collective counts through the registry; ``serve --spans``'
  stats line; an export tracing no stamp.
"""

import collections
import json
import logging
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from koemorph_tpu_torch.data.sequential import prefetch_iterator
from koemorph_tpu_torch.models.dual_stream_model import (
    DECODE_STAGES, SequentialDualStreamModel)
from koemorph_tpu_torch.ops import cuda as ck
from koemorph_tpu_torch.parallel import distributed
from koemorph_tpu_torch.parallel.batched_decode import (
    BatchedSequentialDecoder)
from koemorph_tpu_torch.runtime import MultiStreamInference, streaming
from koemorph_tpu_torch.train import trainer as trainer_mod
from koemorph_tpu_torch.train.trainer import SequentialTrainer
from koemorph_tpu_torch.utils import spans
from tests.test_torch_streaming import HOP, KW, _voice
from tests.test_torch_train import TRAIN_CFG, _batch

torch.set_num_threads(2)

S, G = 4, 2
K = KW["emotion_update_frames"]


@pytest.fixture()
def registry():
    """The registry reset around the test, the counters of other tests
    kept."""
    saved = collections.Counter(spans.COUNTERS)
    spans.reset()
    yield spans
    spans.reset()
    spans.COUNTERS.update(saved)


@pytest.fixture(scope="module")
def tcfg():
    return streaming.StreamingConfig(**KW)


@pytest.fixture(scope="module")
def model(tcfg):
    m = streaming.model_for_config(tcfg)
    m.init_random(torch.Generator().manual_seed(3))
    return m


def _pcm(n_frames: int) -> np.ndarray:
    x = np.stack([_voice(n_frames * HOP, seed=s) for s in range(S)])
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)


def _serve(model, tcfg, n_steps: int) -> MultiStreamInference:
    server = MultiStreamInference(model, tcfg, S, device="cpu",
                                  refresh_cohorts=G)
    pcm = _pcm(n_steps)
    for f in range(n_steps):
        server.step(pcm[:, f * HOP:(f + 1) * HOP])
    return server


def _decoder() -> BatchedSequentialDecoder:
    m = SequentialDualStreamModel(d_model=32, num_heads=2,
                                  mel_sequence_length=16, stride_frames=3)
    m.init_random(torch.Generator().manual_seed(1))
    return BatchedSequentialDecoder(m, device="cpu")


def _decode(dec: BatchedSequentialDecoder, calls: int = 1) -> None:
    audio = torch.from_numpy(np.stack([_voice(40 * HOP, seed=s)
                                       for s in (1, 2)]))
    for _ in range(calls):
        dec(audio)


def _trainer(tmp) -> SequentialTrainer:
    model = SequentialDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16, stride_frames=4,
        emotion_backend="basic", use_concatenation=False, dropout=0.0)
    return SequentialTrainer(model, {"training": TRAIN_CFG,
                                     "data": {"window_frames": 24}},
                             work_dir=tmp, steps_per_epoch=3, device="cpu")


def _raise(*a, **k):
    raise AssertionError("the registry is off")


@pytest.fixture()
def stamps(monkeypatch):
    """Every stamp's slot in its track, a list per step."""
    steps: list = []
    real = spans._stamp

    def stamp(rings, slot, flags):
        if flags & 1:
            steps.append([])
        steps[-1].append(slot)
        real(rings, slot, flags)

    monkeypatch.setattr(spans, "_stamp", stamp)
    return steps


#: the serve track's slot of the refresh (slot 0 is the step's begin)
REFRESH = 1 + streaming.STAGES.index("refresh")


def _names(rows) -> list:
    return [r["name"] for r in rows]


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_off_reads_no_clock_opens_no_range_and_stamps_nothing(
        registry, monkeypatch, model, tcfg, tmp_path):
    monkeypatch.setattr(spans, "_clock", _raise)
    monkeypatch.setattr(spans, "record_function", _raise)
    monkeypatch.setattr(spans, "_stamp", _raise)
    assert not spans.enabled()
    assert spans.host("koemorph.x") is spans.track("serve", "cpu",
                                                    streaming.STAGES)
    assert spans.mark("ring") is None
    _serve(model, tcfg, 4)
    _decode(_decoder())
    _trainer(tmp_path).train_epoch_scan(
        iter([_batch(4, 24, seed=s) for s in (0, 1)]))
    got = spans.export()
    assert got["host"] == [] and got["stages"] == {}
    # the counters count off too
    assert got["counters"]["koemorph.serve.steps"] == 4


def test_off_under_the_profiler_opens_no_range(registry):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.host("koemorph.off"):
            torch.ones(2).add_(1.0)
    assert "koemorph.off" not in {e.name for e in prof.events()}


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def test_serve_stage_structure_per_step(registry, model, tcfg, stamps):
    spans.enable()
    n = 6
    server = _serve(model, tcfg, n)
    got = spans.export()
    rows = got["stages"]["serve"][-n:]
    assert len(rows) == n
    phases = [c * K // G for c in range(G)]
    refreshed = 0
    for f, row in enumerate(rows):
        due = [c for c, p in enumerate(phases) if (p + f) % K == 0]
        want = {"ingest", "ring", "mel", "model"} | (
            {"refresh"} if due else set())
        assert set(row["ns"]) == want, (f, row)
        # one refresh stamp per due cohort
        assert stamps[-n + f].count(REFRESH) == len(due)
        assert all(v >= 0 for v in row["ns"].values())
        assert sum(row["ns"].values()) == row["end_ns"] - row["start_ns"]
        refreshed += len(due) * S // G
    assert refreshed == 4 * S // G
    c = got["counters"]
    assert c["koemorph.serve.steps"] == n
    assert c["koemorph.serve.refreshed_lanes"] == refreshed
    assert c["koemorph.serve.lld_rows"] == refreshed * tcfg.lld_block_rows
    assert server.frames_emitted == n * S


def test_serve_host_spans_share_the_step(registry, model, tcfg):
    spans.enable()
    _serve(model, tcfg, 3)
    host = spans.export()["host"]
    steps = [r for r in host if r["name"] == "koemorph.serve.step"]
    assert len(steps) == 3
    for st in steps:
        assert st["parent"] == -1 and st["step"] == st["id"]
        kids = [r for r in host if r["parent"] == st["id"]]
        # eager (no graphs): no copy of the outputs, so no .out
        assert _names(kids) == ["koemorph.serve.h2d",
                                "koemorph.serve.launch"]
        for k in kids:
            assert k["step"] == st["id"]
            assert st["start_ns"] <= k["start_ns"] <= k["end_ns"] \
                <= st["end_ns"]
        assert not st["profiled"]


@pytest.mark.parametrize("cohorts", [1, 3])
def test_serve_refreshed_lanes_by_cohorts(registry, model, tcfg, cohorts,
                                          stamps):
    spans.enable()
    server = MultiStreamInference(model, tcfg, 6, device="cpu",
                                  refresh_cohorts=cohorts)
    hops = np.zeros((6, HOP), np.float32)
    due = []
    for _ in range(2 * K):
        due.append(len(server.due_cohorts()))
        server.step(hops)
    c = spans.export()["counters"]
    assert c["koemorph.serve.refreshed_lanes"] == sum(due) * 6 // cohorts
    rows = spans.export()["stages"]["serve"][-2 * K:]
    assert [s.count(REFRESH) for s in stamps[-2 * K:]] == due
    assert ["refresh" in r["ns"] for r in rows] == [d > 0 for d in due]
    # float32 hops: the ingest stage is empty of work, but stamped
    assert all("ingest" in r["ns"] for r in rows)


# ---------------------------------------------------------------------------
# decode and train
# ---------------------------------------------------------------------------

def test_decode_stage_structure_per_call(registry):
    spans.enable()
    _decode(_decoder(), calls=2)
    got = spans.export()
    rows = got["stages"]["decode"]
    assert len(rows) == 2
    for row in rows:
        assert set(row["ns"]) == {"frontend", "emotion", "model"}
        assert sum(row["ns"].values()) == row["end_ns"] - row["start_ns"]
    names = _names(got["host"])
    assert names.count("koemorph.decode.h2d") == 2
    assert names.count("koemorph.decode.launch") == 2
    assert names.count("koemorph.decode.out") == 0      # eager: no copy


def test_train_stage_structure_and_epoch_spans(registry, tmp_path):
    spans.enable()
    trainer = _trainer(tmp_path)
    batches = [_batch(4, 24, seed=s) for s in (0, 1, 2)]
    trainer.train_epoch_scan(iter(batches))
    got = spans.export()
    rows = got["stages"]["train"]
    assert len(rows) == 3
    for row in rows:
        assert set(row["ns"]) == set(trainer_mod.STAGES)
    host = got["host"]
    top = [r["name"] for r in host if r["parent"] == -1]
    assert top[:3] == ["koemorph.train.stack", "koemorph.train.upload",
                       "koemorph.train.scan"]
    scan = next(r for r in host if r["name"] == "koemorph.train.scan")
    fetch = next(r for r in host if r["name"] == "koemorph.train.fetch")
    assert fetch["parent"] == scan["id"] and fetch["step"] == scan["step"]
    # the steps' stamps (the host clock on the CPU) inside the scan
    assert all(scan["start_ns"] <= r["start_ns"] <= r["end_ns"]
               <= fetch["start_ns"] for r in rows)
    stack, upload = (next(r for r in host if r["name"] == n) for n in
                     ("koemorph.train.stack", "koemorph.train.upload"))
    assert stack["end_ns"] <= upload["start_ns"] <= upload["end_ns"] \
        <= scan["start_ns"]


def test_a_track_keeps_the_stages_it_was_opened_with(registry):
    spans.enable()
    with spans.track("train", "cpu", trainer_mod.STAGES):
        spans.mark("emotion")         # the model's marks
        spans.mark("frontend")
        spans.mark("model")           # not a train stage: no stamp
        spans.mark("forward")
        spans.mark("backward")
    (row,) = spans.export()["stages"]["train"]
    assert set(row["ns"]) == set(trainer_mod.STAGES)
    with pytest.raises(ValueError, match="opened with stages"):
        spans.track("train", "cpu", ("forward", "optimizer"))


def test_data_spans_come_from_prefetch_iterator(registry):
    spans.enable()
    n = 4

    def batches():
        for i in range(n):
            time.sleep(0.002)
            yield {"audio": np.zeros((2, 8), np.float32), "i": np.int64(i)}

    out = []
    for b in prefetch_iterator(batches)():
        time.sleep(0.001)
        out.append(int(b["i"]))
    assert out == list(range(n))
    host = spans.export()["host"]
    wait = [r for r in host if r["name"] == "koemorph.data.wait"]
    assert len(wait) == n + 1           # the last takes the end marker
    assert all(r["parent"] == -1 for r in wait)
    # the producer thread's work is no span
    assert len(host) == len(wait)


# ---------------------------------------------------------------------------
# the registry itself
# ---------------------------------------------------------------------------

def test_parent_and_step_ids(registry):
    spans.enable()
    with spans.host("a"):
        with spans.host("a.b"):
            with spans.host("a.b.c"):
                pass
        with spans.host("a.d"):
            pass
    with spans.host("e"):
        pass
    rows = {r["name"]: r for r in spans.export()["host"]}
    a, b, c, d, e = (rows[k] for k in ("a", "a.b", "a.b.c", "a.d", "e"))
    assert a["parent"] == -1 and e["parent"] == -1
    assert b["parent"] == a["id"] and d["parent"] == a["id"]
    assert c["parent"] == b["id"]
    assert {a["step"], b["step"], c["step"], d["step"]} == {a["id"]}
    assert e["step"] == e["id"] != a["id"]
    assert a["start_ns"] <= b["start_ns"] <= c["end_ns"] <= a["end_ns"]


def test_rings_wrap(registry, monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 2)
    spans.enable()
    n_host = 2 * 16
    for i in range(n_host + 8):
        with spans.host(f"s{i}"):
            pass
    host = spans.export()["host"]
    assert len(host) == n_host
    assert _names(host) == [f"s{i}" for i in range(8, n_host + 8)]
    for _ in range(5):
        with spans.track("decode", "cpu", DECODE_STAGES):
            spans.mark("emotion")
    rows = spans.export()["stages"]["decode"]
    assert [r["step"] for r in rows] == [3, 4]
    assert all(set(r["ns"]) == {"emotion", "model"} for r in rows)


def test_slot_ids_end_at_stamp_cus_instantiations(registry):
    spans.enable()
    for i in range(5):                  # 5 x 6 slots: ids 0 .. 29
        spans.track(f"t{i}", "cpu", ("a", "b", "c", "d", "e"))
    with pytest.raises(ValueError, match="stamp.cu"):
        spans.track("t5", "cpu", ("a", "b"))
    spans.track("t5", "cpu", ("a",))   # ids 30, 31


def test_a_step_that_raises_leaves_no_row(registry):
    spans.enable()
    with pytest.raises(KeyError):
        with spans.track("decode", "cpu", DECODE_STAGES):
            spans.mark("emotion")
            raise KeyError("x")
    with spans.track("decode", "cpu", DECODE_STAGES):
        spans.mark("frontend")
    rows = spans.export()["stages"]["decode"]
    assert len(rows) == 1 and set(rows[0]["ns"]) == {"frontend", "model"}


def test_host_span_is_a_profiler_range_while_profiling(registry):
    from torch.profiler import ProfilerActivity, profile
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.host("koemorph.test.range"):
            torch.ones(2).add_(1.0)
    with spans.host("koemorph.test.plain"):
        pass
    assert "koemorph.test.range" in {e.name for e in prof.events()}
    rows = {r["name"]: r for r in spans.export()["host"]}
    assert rows["koemorph.test.range"]["profiled"]
    assert not rows["koemorph.test.plain"]["profiled"]


def test_enabling_after_a_capture_warns(registry, caplog):
    spans.note_capture(("serve", 0))
    with caplog.at_level(logging.WARNING, logger=spans.__name__):
        spans.enable()
    assert "without stage stamps" in caplog.text
    spans.note_capture(("serve", 1))
    assert spans.export()["graphs"] == {"stamped": ["('serve', 1)"],
                                        "unstamped": ["('serve', 0)"]}


def test_threads_lose_no_count_and_no_span(registry, monkeypatch):
    """Counters and host spans from more threads than cores, switching
    every microsecond: no update is lost and every span id is unique."""
    monkeypatch.setattr(spans, "CAPACITY", 64)   # 1,024 host spans kept
    spans.enable()
    n_threads, n = 16, 60
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with spans.host("koemorph.t"):
                    spans.count("koemorph.t.n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = spans.export()
    assert got["counters"]["koemorph.t.n"] == n_threads * n
    ids = [r["id"] for r in got["host"]]
    assert len(ids) == len(set(ids)) == n_threads * n
    assert all(r["parent"] == -1 and r["step"] == r["id"]
               for r in got["host"])


def test_the_data_package_and_registry_start_without_torch():
    """The feeder of ``serve --listen`` imports the data package, which
    counts through the registry: neither may bring torch in (its start
    would then lag the server's first ticks)."""
    code = ("import sys, koemorph_tpu_torch.data, "
            "koemorph_tpu_torch.utils.spans, koemorph_tpu_torch.feed_serve; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"


def test_slot_names_cover_every_track(registry):
    spans.enable()
    tracks = {"serve": streaming.STAGES, "decode": DECODE_STAGES,
              "train": trainer_mod.STAGES}
    for t, stages in tracks.items():
        with spans.track(t, "cpu", stages):
            pass
    names = spans.slot_names()
    assert sorted(names) == list(range(len(names)))
    assert len(names) <= 32             # stamp.cu's instantiations
    assert names[0] == ("serve", "begin")
    for t, stages in tracks.items():
        assert [s for tt, s in names.values() if tt == t] == \
            ["begin", *stages]


def test_summary_medians(registry):
    spans.enable()
    for _ in range(3):
        with spans.track("decode", "cpu", DECODE_STAGES):
            spans.mark("emotion")
        with spans.host("koemorph.x"):
            pass
    got = spans.summary()
    assert set(got["stage_ms"]["decode"]) == {"emotion", "model"}
    assert got["host_ms"]["koemorph.x"] >= 0.0


# ---------------------------------------------------------------------------
# counters folded into the registry
# ---------------------------------------------------------------------------

def test_launches_count_through_the_registry(registry):
    assert not hasattr(ck, "LAUNCHES")
    ck._launched("logmel", (4,), 0)
    ck._launched("dk_roots", (3,), 0)
    ck._launched("logmel", (4,), 0)
    assert spans.counters("koemorph.kernels.launches.") == {
        "koemorph.kernels.launches.logmel": 2,
        "koemorph.kernels.launches.dk_roots": 1}
    assert ck.launches() == {"cycle_dsum": 0, "dk_roots": 1, "logmel": 2}
    ck.reset_launch_counts()
    assert ck.launches() == dict.fromkeys(ck.KERNELS, 0)


def test_collectives_count_through_the_registry(registry, monkeypatch):
    assert not hasattr(distributed, "COLLECTIVES")
    monkeypatch.setattr(distributed.dist, "all_reduce",
                        lambda x, group=None: None)
    distributed.all_reduce_(torch.ones(2))
    distributed.all_reduce_(torch.ones(2))
    assert spans.counters("koemorph.dist.") == {
        "koemorph.dist.collectives.all_reduce": 2}
    assert distributed.collectives() == {"all_reduce": 2}


def test_graph_runs_are_launch_spans(registry):
    from koemorph_tpu_torch.runtime.graphs import StepGraphs
    graphs = StepGraphs(torch.device("cpu"), span="koemorph.t")
    spans.enable()
    assert graphs.run(("k",), lambda: 3) == 3
    # an eager run is a launch span, but no replay
    assert _names(spans.export()["host"]) == ["koemorph.t.launch"]
    assert not graphs.replays
    assert spans.export()["counters"] == {}


# ---------------------------------------------------------------------------
# operator use and export
# ---------------------------------------------------------------------------

def test_serve_cli_spans_stats(registry, tmp_path, capsys, caplog):
    from koemorph_tpu_torch import serve
    from koemorph_tpu_torch.data.wav import write_wav
    wav = tmp_path / "a.wav"
    write_wav(wav, _voice(16000), 16000)
    caplog.set_level(logging.INFO, logger="serve")
    rc = serve.main(["--replay", str(wav), "--sessions", "2",
                     "--refresh-cohorts", "2", "--output", "none",
                     "--no-realtime", "--max-frames", "6",
                     "--stats-every", "3", "--device", "cpu",
                     "--d-model", "32", "--num-heads", "2", "--spans"])
    assert rc == 0
    lines = [json.loads(ln)["performance_stats"] for ln in
             capsys.readouterr().out.splitlines()
             if ln.startswith('{"performance_stats"')]
    assert lines
    got = lines[-1]["spans"]
    assert {"ingest", "ring", "mel", "model", "refresh"} <= set(
        got["stage_ms"])
    assert got["launch_ms"] is not None and got["launch_ms"] > 0
    assert got["counters"]["koemorph.serve.steps"] == 6
    # every --stats-every line is followed by the span figures
    logged = [json.loads(r.getMessage()[len("spans "):])
              for r in caplog.records if r.getMessage().startswith("spans ")]
    assert [g["counters"]["koemorph.serve.steps"] for g in logged] == [3, 6]


class _Stamped(nn.Module):
    def forward(self, x):
        with spans.track("decode", x.device, DECODE_STAGES):
            spans.mark("emotion")
            return x * 2.0


def test_export_runs_with_the_registry_off(registry, tmp_path, monkeypatch):
    from koemorph_tpu_torch.export.exporter import export_program
    spans.enable()
    stamped = []
    real = spans._stamp
    monkeypatch.setattr(spans, "_stamp",
                        lambda *a: (stamped.append(a), real(*a)))
    report = export_program(_Stamped(), (torch.ones(3),),
                            tmp_path / "m.pt2")
    assert report.passed
    # the example run and the gate's live call stamp; the trace does not
    n_live = len(stamped)
    assert spans.enabled()
    from koemorph_tpu_torch.export.exporter import load_program
    load_program(tmp_path / "m.pt2").module()(torch.ones(3))
    assert len(stamped) == n_live
