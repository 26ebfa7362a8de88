"""PyTorch port: the ``emotion2vec`` variant held against the benchmark's
plain reference (``perfbench/reference/wav2vec2.py``,
``perfbench/reference/stream_e2v.py``) on seeded weights, on the CPU.

- The encoder at a small width (hidden 64, 2 layers, 4 heads, a conv
  ladder of 7 x 32 channels, a positional kernel of 16 in 4 groups) over
  1 s of audio: its fused output.
- ``MultiStreamInference`` (4 sessions, 2 cohorts, two refresh cadences)
  with that encoder over a 1 s context: every step's blendshapes and the
  emotion vectors, int16 hops in.
- The published configuration (wav2vec2-large) on the meta device: its
  parameter count and its 1,029 frames over 329,600 samples; the
  benchmark's closed-form operation counts against ``FlopCounterMode`` on
  the reference, at the small width on real tensors and at the published
  widths on meta tensors.
- The span registry: a refreshing step stamps ``e2v_front``,
  ``e2v_layers`` and ``e2v_pool`` before its ``refresh``, other steps
  none of them, and the server counts lanes x encoder frames.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from koemorph_tpu_torch.features.wav2vec2 import (Wav2Vec2Config,
                                                  Wav2Vec2Encoder)
from koemorph_tpu_torch.runtime import MultiStreamInference, streaming
from koemorph_tpu_torch.utils import spans
from perfbench.harness import e2v_flops
from perfbench.reference import stream_e2v
from perfbench.reference.wav2vec2 import Encoder, EncoderConfig

torch.set_num_threads(2)

SR, HOP = 16000, 533
SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, conv_dim=(32,) * 7,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
S, G, K = 4, 2, 9
#: the stream's settings: a small head, 0.4 s of context (1.0 s with the
#: 0.6 s margin of the emotion windows' offsets)
HEAD = dict(window_frames=16, d_model=32, num_heads=2, emotion_context_s=0.4,
            emotion_update_frames=K)


def _pcm(n: int, lanes: int, seed: int) -> np.ndarray:
    """Voiced-like int16 audio: a gliding harmonic tone with noise, a
    pause in the middle."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    out = []
    for i in range(lanes):
        f0 = 110.0 + 40.0 * i + 20.0 * np.sin(2 * np.pi * 0.7 * t)
        phase = np.cumsum(2 * np.pi * f0 / SR)
        x = sum(np.cos(h * phase) / h for h in range(1, 12))
        x *= (np.abs(t - t[-1] / 2) > 0.1)
        x = 0.2 * x / np.abs(x).max() + 0.01 * rng.standard_normal(n)
        out.append(x)
    return np.round(np.stack(out) * 32767.0).astype(np.int16)


@pytest.fixture(scope="module")
def small():
    return Wav2Vec2Config(**SMALL)


def test_encoder_matches_reference(small):
    """Fused output at the small width; the reference's state-dict keys
    are the program's. The gap, 8e-7 of the output's largest magnitude
    here, comes from float32 rounding in other orders (the fusion as an
    einsum against a running sum, the attention's head reshapes): 1e-5
    leaves 12x room and fails any missing part by orders of magnitude."""
    prog = Wav2Vec2Encoder(small)
    prog.init_random(torch.Generator().manual_seed(5))
    with torch.no_grad():
        prog.layer_fusion_weights.copy_(torch.linspace(-1.0, 1.0, 3))
    ref = Encoder(EncoderConfig(**SMALL))
    assert list(ref.state_dict()) == list(prog.state_dict())
    ref.load_state_dict(prog.state_dict())
    audio = torch.from_numpy(_pcm(SR, 2, seed=1)).float() / 32768.0
    with torch.no_grad():
        got, want = prog(audio), ref(audio)
        pooled = ref.pooled(audio)
    assert got.shape == (2, small.frames(SR), 64)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(got.mean(-2), pooled, rtol=0,
                               atol=1e-5 * scale)


def _configs(small):
    tcfg = streaming.StreamingConfig(emotion_backend="emotion2vec",
                                     emotion2vec_config=small, **HEAD)
    rcfg = stream_e2v.E2VStreamConfig(encoder=EncoderConfig(**SMALL),
                                      **HEAD)
    assert rcfg.context_samples == tcfg.emotion_context_samples == SR
    return tcfg, rcfg


def test_server_matches_reference(small):
    """4 sessions in 2 cohorts over two cadences (18 steps, 4 refreshes
    of each lane's 1 s ring), int16 hops: every step's 52 blendshapes of
    every lane at 1e-6 and each lane's emotion vector at 1e-5 of the
    vectors' largest magnitude. The encoder's rounding in another order
    reaches the vectors at 4e-7 and the blendshapes at 4e-9 here; a
    skipped part moves the vectors by 1e-1 and more."""
    tcfg, rcfg = _configs(small)
    model = streaming.model_for_config(tcfg)
    model.init_random(torch.Generator().manual_seed(7))
    ref_model = stream_e2v.StreamingE2VModel(rcfg)
    assert set(ref_model.state_dict()) == set(model.state_dict())
    ref_model.load_state_dict(model.state_dict())
    server = MultiStreamInference(model, tcfg, S, device="cpu",
                                  refresh_cohorts=G)
    n = 2 * K
    pcm = _pcm(n * HOP, S, seed=3)
    st = stream_e2v.init_state(rcfg, "cpu", S)
    phases = [(lane % G) * K // G for lane in range(S)]
    with torch.no_grad():
        for f in range(n):
            hop = pcm[:, f * HOP:(f + 1) * HOP]
            got = server.step(hop)
            due = [i for i in range(S) if (phases[i] + f) % K == 0]
            want, st = stream_e2v.stream_frame_lanes(
                ref_model, st, torch.from_numpy(hop).float() * 2.0 ** -15,
                rcfg, due)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    vec, vec_ref = server.states.emotion_raw, st.emotion_raw
    assert float(vec_ref.abs().min(-1).values.max()) > 0
    scale = float(vec_ref.abs().max())
    assert float((vec - vec_ref).abs().max()) <= 1e-5 * scale


def test_published_config_on_meta():
    cfg = Wav2Vec2Config()
    with torch.device("meta"):
        prog = Wav2Vec2Encoder(cfg)
        ref = Encoder(EncoderConfig())
    count = sum(p.numel() for p in prog.parameters())
    assert count == 315_437_593
    assert sum(p.numel() for p in ref.parameters()) == count
    assert cfg.frames(329_600) == EncoderConfig().frames(329_600) == 1_029


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@pytest.mark.parametrize("width", ["small", "published"])
def test_closed_form_flops(width):
    """The benchmark's closed-form counts by stage equal
    ``FlopCounterMode``'s on the reference: the front alone, and the
    whole pooled vector (front + layers; the fusion and mean count
    nothing)."""
    if width == "small":
        cfg, samples, device = EncoderConfig(**SMALL), SR, "cpu"
    else:
        cfg, samples, device = EncoderConfig(), 329_600, "meta"
    with torch.device(device):
        ref = Encoder(cfg)
        audio = torch.zeros((1, samples))
    closed = e2v_flops.stage_flops(dataclasses.asdict(cfg), samples)
    with torch.no_grad():
        assert _counted(lambda: ref.front(audio)) == closed["e2v_front"]
        assert _counted(lambda: ref.pooled(audio)) == \
            closed["e2v_front"] + closed["e2v_layers"]
    if width == "published":             # ~845 GFLOP a refresh
        assert 844e9 < sum(closed.values()) < 846e9


@pytest.fixture()
def registry():
    saved = collections.Counter(spans.COUNTERS)
    spans.reset()
    yield spans
    spans.reset()
    spans.COUNTERS.update(saved)


def test_stamps_and_counter(registry, small):
    tcfg, _ = _configs(small)
    model = streaming.model_for_config(tcfg)
    model.init_random(torch.Generator().manual_seed(2))
    spans.enable()
    server = MultiStreamInference(model, tcfg, S, device="cpu",
                                  refresh_cohorts=G)
    pcm = _pcm(K * HOP, S, seed=4)
    due = []
    for f in range(K):
        due.append(len(server.due_cohorts()))
        server.step(pcm[:, f * HOP:(f + 1) * HOP])
    got = spans.export()
    rows = got["stages"]["serve"][-K:]
    e2v = {"e2v_front", "e2v_layers", "e2v_pool"}
    for d, row in zip(due, rows):
        want = {"ingest", "ring", "mel", "model"} | (
            e2v | {"refresh"} if d else set())
        assert set(row["ns"]) == want
    assert sum(due) == G
    frames = small.frames(tcfg.emotion_context_samples)
    assert got["counters"]["koemorph.serve.encoder_frames"] == \
        sum(due) * (S // G) * frames
    assert streaming.STAGES.index("e2v_pool") < \
        streaming.STAGES.index("refresh") < streaming.STAGES.index("model")
