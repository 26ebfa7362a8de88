"""The ``serve_e2v_s8_g8`` cell on the CPU at small sizes (4 sessions, an
encoder 64 wide over a 1 s context, the card check skipped): a sound run
comes out correct, and a fault planted in the program's encoder or in
its refresh turns ``correct`` false: one transformer layer skipped, the
positional convolution left out, the fusion replaced by the last layer, a
refresh's write-back dropped. Also: the driver's draw of the conv kernels
has LeCun statistics, the cell's files load by name, and the new readers
read nothing from a program that stamps and counts nothing."""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import time

import pytest
import torch

from perfbench.harness import spec
from perfbench.tests.helpers import ROOT

CELL = "serve_e2v_s8_g8"
NEW_METRICS = ("e2v_front_device_ms.serve", "e2v_layers_device_ms.serve",
               "e2v_front_fp32_share.serve", "e2v_layers_fp32_share.serve")
#: a small encoder with every kind of part the published one has
SMALL_ENCODER = dict(hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     conv_dim=[32] * 7, num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=4)
SMALL_TRAFFIC = dict(sessions=4, cohorts=2, pool_utterances=2,
                     pool_seconds=3.0, check_cohorts=2, check_lanes=1)


def small_cell(seconds: float, seed: int = 2 ** 31 + 5):
    """The cell with its sizes cut: 4 sessions in 2 cohorts, one checked
    lane of each, the small encoder over 0.4 s of context (1 s with the
    margin)."""
    cell = spec.load_cell(ROOT, CELL, seed, seconds, False)
    cfg = copy.deepcopy(cell.config)
    cfg["emotion2vec"].update(SMALL_ENCODER)
    cfg["emotion_config"]["context_window"] = 0.4
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, **SMALL_TRAFFIC))


def run_small(seconds: float = 2.0) -> dict:
    from perfbench.harness import runner
    torch.manual_seed(0)
    return runner.execute(small_cell(seconds), time.perf_counter(), "cpu")


def test_sound_run_is_correct():
    line = run_small()
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["compared"]) == {"serve_mouth_err", "serve_blend_err",
                                     "serve_e2v_err", "serve_head_err"}
    assert set(line["metrics"]) == {"session_frames_per_s", "step_ms_p95",
                                    "setup_s"}


def _fault(kind) -> list:
    """The (target, attribute, replacement) patches of a fault planted in
    the program."""
    from koemorph_tpu_torch.features import wav2vec2 as w2v
    from koemorph_tpu_torch.runtime import streaming
    enc_forward = w2v.Wav2Vec2Encoder.forward
    if kind == "layer":
        layer_forward = w2v._EncoderLayer.forward

        def skip(self, x):
            return x if getattr(self, "skipped", False) \
                else layer_forward(self, x)

        def forward(self, audio):
            self.encoder.layers[-1].skipped = True
            return enc_forward(self, audio)

        return [(w2v._EncoderLayer, "forward", skip),
                (w2v.Wav2Vec2Encoder, "forward", forward)]
    if kind == "positional":
        return [(w2v._PositionalConvEmbedding, "forward",
                 lambda self, x: torch.zeros_like(x))]
    if kind == "fusion":
        def last(self, audio):
            self.use_layer_fusion = False
            try:
                return enc_forward(self, audio)
            finally:
                self.use_layer_fusion = True

        return [(w2v.Wav2Vec2Encoder, "forward", last)]
    real = streaming._stream_refresh
    calls = [0]

    def refresh(state, ring, cfg, do_refresh, model=None):
        out = real(state, ring, cfg, do_refresh, model)
        if do_refresh:
            calls[0] += 1
            # the warm-up refreshes each of the 2 cohorts once first; the
            # window's third refresh writes nothing
            if calls[0] == 5:
                return (state.emotion_raw,) + tuple(out[1:])
        return out

    return [(streaming, "_stream_refresh", refresh)]


@pytest.mark.parametrize("kind", ["layer", "positional", "fusion",
                                  "writeback"])
def test_fault_is_not_correct(monkeypatch, kind):
    for target, name, fn in _fault(kind):
        monkeypatch.setattr(target, name, fn)
    line = run_small()
    assert not line["correct"], line["compared"]


def test_conv_kernels_have_lecun_statistics():
    """Every conv kernel: mean 0, std 1/sqrt(fan-in) (fan-in = input
    channels of a group x kernel), cut at 2 std of the untruncated
    normal; the other leaves as the shared draw gives them."""
    from perfbench.drivers import serve_e2v
    from perfbench.harness import weights
    from perfbench.reference.stream_e2v import StreamingE2VModel
    cfg = small_cell(1.0).config
    cfg["emotion2vec"]["num_conv_pos_embeddings"] = 128
    seed = 2 ** 31 + 77
    state = serve_e2v.seeded_state(cfg, seed, "cpu")
    template = StreamingE2VModel(serve_e2v.reference_config(cfg))
    shared = weights.seeded_state(template, seed, "cpu")
    keys = serve_e2v.conv_kernels(template)
    assert len(keys) == 8          # 7 in the ladder, the positional one
    for k in keys:
        w = state[k].double()
        fan_in = w.shape[1] * w.shape[2]
        std = 1.0 / math.sqrt(fan_in)
        assert abs(float(w.mean())) < 0.1 * std, k
        assert abs(float(w.std()) / std - 1.0) < 0.15, k
        assert float(w.abs().max()) <= 2.0 * std / weights.TRUNC_STD + 1e-9
    for k, v in shared.items():
        if k not in keys:
            assert torch.equal(state[k], v), k
    assert not torch.equal(serve_e2v.seeded_state(cfg, seed + 1, "cpu")[
        keys[0]], state[keys[0]])


def test_files_load_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.load_cell(ROOT, CELL, 1, 1.0, True)
    assert cell.config_name == "dual_stream_e2v_large"
    assert spec.driver(cell).__name__ == "perfbench.drivers.serve_e2v"
    conf = next(c for c in bench["configs"] if c["name"] == cell.config_name)
    assert conf["reduced"] == []
    assert cell.config["emotion_config"]["backend"] == "emotion2vec"
    assert cell.config["dual_stream_attention"]["emotion_dim"] == 1024
    layer = {m.name for m in cell.per_layer}
    assert set(NEW_METRICS) <= layer
    assert "refresh_device_ms.serve" not in layer
    for name in NEW_METRICS:
        assert spec.reader(name).read({}) is None
    assert {m.name for m in cell.end_to_end} == {
        "session_frames_per_s", "step_ms_p95", "setup_s"}


def test_readers_read_nothing_without_stamps_or_counter():
    """A program that stamps no e2v stage and counts no encoder frame (the
    eGeMAPS path, or an older program): the new readers give None."""
    from perfbench.harness import e2v_flops
    rec = {"e2v": {"frames_per_lane": 1029, "stage_flops": {
        "e2v_front": 1.0, "e2v_layers": 1.0}, "slice_encoder_frames": 0,
        "slice_refresh_steps": 8}}
    for stage in e2v_flops.STAGES:
        assert e2v_flops.fp32_share(rec, stage) is None


@pytest.mark.card
def test_tf32_control_is_not_correct():
    """The reference in TF32 in the program's place reads above a limit
    of the committed cell, on three seeds, over 120 steps (13 refreshes
    of each checked lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        cell = spec.load_cell(ROOT, CELL, seed, 0.0, False)
        limits = cell.traffic["limits"]
        readings = spec.driver(cell).control(cell, "cuda", 120)
        assert any(readings[k] > limits[k] for k in readings), readings


@pytest.mark.card
def test_e2v_stages_account_for_the_replay():
    """At the published widths, 8 sessions in 8 cohorts: each step's
    stages sum to within 3% of its replay's device span, the refreshing
    steps hold the encoder's three stages, and the server counts 1,029
    encoder frames per refreshed lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from koemorph_tpu_torch.utils import spans
    from perfbench.drivers import serve_e2v as drv
    from perfbench.harness import program
    from perfbench.tests.test_perfbench_spans_card import _profiled
    spans.reset()
    try:
        spans.enable()
        dev = torch.device("cuda")
        cell = spec.load_cell(ROOT, CELL, 7, 0.0, False)
        server, scfg = drv.build_server(
            cell.config, cell.traffic,
            drv.seeded_state(cell.config, 7, dev), dev)
        server.warmup(torch.int16)
        hops = torch.randint(-3000, 3000, (8, scfg.hop_length),
                             dtype=torch.int16).pin_memory()
        k = scfg.emotion_update_frames
        for _ in range(k):
            server.step(hops)
        torch.cuda.synchronize()
        result, pt = _profiled("serve_e2v", lambda: [server.step(hops)
                                                     for _ in range(k)])
        steps = program.stage_steps(result.activities, spans.slot_names(),
                                    "serve")
        assert len(steps) == k
        replays = pt.replays()
        e2v = {"e2v_front", "e2v_layers", "e2v_pool", "refresh"}
        for st in steps:
            a, b = next((a, b) for a, b in replays if a <= st["_start"] < b)
            total = sum(v for n, v in st.items() if not n.startswith("_"))
            assert abs(total - (b - a)) <= 0.03 * (b - a), (st, a, b)
            assert e2v <= set(st) or not e2v & set(st), st
        assert sum(e2v <= set(st) for st in steps) == k - 1
        frames = spans.counters("koemorph.serve.encoder_frames")
        assert frames["koemorph.serve.encoder_frames"] == 2 * (k - 1) * 1029
    finally:
        spans.reset()
