"""The program's stage stamps on the card (marked ``card``; they skip
without a CUDA card), at the configurations' widths with fewer lanes:

- the stages account for the replay: each step's (or call's) stage
  durations sum to within 3% of its graph replay's device span, from its
  first to its last activity in the profiled slice, for the server, the
  decode and the train step;
- the program's own numbers agree with the trace: per stage, the median
  ms of the stamp ring (``spans.export()``) lies within 5% of the slice's
  over the same steps;
- graphs captured with the registry off hold no stamp: their slice holds
  no stamp kernel, and every graph's launch record equals that of the
  same graph captured with the registry on.

Run on the card: ``python -m pytest perfbench/tests -m card -q``.
"""

import json
import statistics

import numpy as np
import pytest
import torch

from perfbench.harness import model_cfg, program
from perfbench.harness.trace import Slice, warm_profiler
from perfbench.tests.helpers import ROOT

pytestmark = pytest.mark.card

OUT = ROOT / "build" / "perfbench" / "card_tests"


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from koemorph_tpu_torch.utils import spans
    spans.reset()
    yield torch.device("cuda")
    spans.reset()


def _config(name: str) -> dict:
    return json.loads((ROOT / "perfbench" / "configs" /
                       f"{name}.json").read_text())


def _profiled(name: str, fn):
    """``fn()`` inside a profiled slice: the slice's TraceResult and its
    :class:`ProgramTrace`."""
    warm_profiler()
    sl = Slice(OUT / f"{name}.trace.json")
    with sl:
        fn()
    with open(sl.path) as fh:
        events = json.load(fh)["traceEvents"]
    return sl.result, program.ProgramTrace(events, sl.result)


def _check(track: str, n: int, result, pt) -> dict:
    """The slice's ``n`` steps of ``track``: each step's stage sum within
    3% of its replay's span; the ring's per-stage medians over its last
    ``n`` steps within 5% of the slice's."""
    from koemorph_tpu_torch.utils import spans
    steps = program.stage_steps(result.activities, spans.slot_names(),
                                track)
    assert len(steps) == n, (track, len(steps))
    replays = pt.replays()
    assert len(replays) >= n
    for st in steps:
        a, b = next((a, b) for a, b in replays
                    if a <= st["_start"] < b)
        total = sum(v for k, v in st.items() if not k.startswith("_"))
        assert abs(total - (b - a)) <= 0.03 * (b - a), (track, total, a, b)
    rows = spans.export()["stages"][track][-n:]
    stages = {k for st in steps for k in st if not k.startswith("_")}
    out = {}
    for stage in sorted(stages):
        sl = statistics.median(st[stage] for st in steps if stage in st)
        ring = statistics.median(r["ns"][stage] / 1e3 for r in rows
                                 if stage in r["ns"])
        out[stage] = (sl, ring)
    print(json.dumps({"track": track, "stage_us_slice_ring": out,
                      "replay_us": [b - a for a, b in replays[:n]]}))
    for stage, (sl, ring) in out.items():
        assert abs(ring - sl) <= 0.05 * sl, (track, stage, sl, ring)
    return out


def _server(dev, sessions: int = 512, cohorts: int = 8):
    from perfbench.drivers import serve as drv
    cfg = _config("dual_stream")
    tr = {"sessions": sessions, "cohorts": cohorts}
    server, scfg = drv.build_server(cfg, tr, drv.seeded_state(cfg, 7, dev),
                                    dev)
    server.warmup(torch.int16)
    hops = torch.randint(-3000, 3000, (sessions, scfg.hop_length),
                         dtype=torch.int16).pin_memory()
    return server, scfg, hops


def test_serve_stages_account_for_the_replay(card):
    from koemorph_tpu_torch.utils import spans
    spans.enable()
    server, scfg, hops = _server(card)
    k = scfg.emotion_update_frames
    for _ in range(2 * k):
        server.step(hops)
    torch.cuda.synchronize()
    result, pt = _profiled("serve", lambda: [server.step(hops)
                                             for _ in range(k)])
    got = _check("serve", k, result, pt)
    assert {"ingest", "ring", "mel", "refresh", "model"} <= set(got)
    assert spans.export()["graphs"]["unstamped"] == []


def test_decode_stages_account_for_the_replay(card):
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel)
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    from koemorph_tpu_torch.utils import spans
    spans.enable()
    cfg = _config("dual_stream_60fps")
    model = SequentialDualStreamModel(
        **model_cfg.sequential_kwargs(cfg)).to(card).eval()
    dec = BatchedSequentialDecoder(model, device=card)
    length = 1026 * model_cfg.hop(cfg)
    audio = torch.randn((2, length), generator=torch.Generator()
                        .manual_seed(1)).mul_(0.1).to(card)
    for _ in range(3):
        dec(audio)
    torch.cuda.synchronize()
    n = 3
    result, pt = _profiled("decode", lambda: [dec(audio) for _ in range(n)])
    got = _check("decode", n, result, pt)
    assert set(got) == {"frontend", "emotion", "model"}


def test_train_stages_account_for_the_replay(card, tmp_path, monkeypatch):
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel)
    from koemorph_tpu_torch.train.trainer import STAGES, SequentialTrainer
    from koemorph_tpu_torch.utils import spans
    # the trainer refuses TF32 convolutions, PyTorch's default
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    spans.enable()
    cfg = _config("dual_stream")
    span, b = 288, 4
    model = SequentialDualStreamModel(**model_cfg.sequential_kwargs(cfg))
    trainer = SequentialTrainer(
        model, {"training": cfg["training"], "data": cfg["data"]},
        span_frames=span, work_dir=tmp_path, steps_per_epoch=8,
        device=card)
    rng = np.random.default_rng(0)
    batches = [{"audio": rng.standard_normal(
                    (b, span * model_cfg.hop(cfg))).astype(np.float32) * 0.1,
                "blendshapes": rng.uniform(0, 1, (b, span, 52)).astype(
                    np.float32)} for _ in range(4)]
    trainer.train_epoch_scan(batches)
    torch.cuda.synchronize()
    result, pt = _profiled("train",
                           lambda: trainer.train_epoch_scan(batches))
    got = _check("train", len(batches), result, pt)
    assert set(got) == set(STAGES)


def test_graphs_captured_off_hold_no_stamp(card):
    from koemorph_tpu_torch.utils import spans
    off, scfg, hops = _server(card, sessions=64)
    spans.enable()
    on, _, _ = _server(card, sessions=64)
    assert off.step_graphs.keys() == on.step_graphs.keys()
    for key in off.step_graphs.keys():
        assert off.step_graphs.launches(key) == on.step_graphs.launches(key)
    got = spans.export()["graphs"]
    assert len(got["unstamped"]) == len(got["stamped"]) \
        == len(off.step_graphs)
    for _ in range(3):
        off.step(hops)
    torch.cuda.synchronize()
    result, _ = _profiled("serve_off", lambda: [
        off.step(hops) for _ in range(scfg.emotion_update_frames)])
    names = {name for _, _, name in result.activities}
    assert not any(program.STAMP.match(n) for n in names), sorted(names)
    assert result.activities
