"""PyTorch port: the audio ring holds the samples its readers read.

With the incremental eGeMAPS refresh (the LLD ring) the stream reads the
audio ring only at its end: the newest mel row's frame and the refresh's
LLD chunk (its left context comes from the LLD carry), and the 20 s of
history live in the LLD ring. So the ring is ``audio_ring_len`` samples,
not the emotion context's ``emotion_ring_len``. A stream stepped from a
state with the full-context ring gives bitwise the same frames, emotion
vectors and LLD state, and its ring ends with the short one; the
full-context refreshes (``basic``, ``emotion2vec``, ``incremental_lld=
False``) keep the full ring.
"""

import dataclasses

import numpy as np
import pytest
import torch

from koemorph_tpu_torch.runtime import MultiStreamInference, streaming

torch.set_num_threads(2)

#: the flagship eGeMAPS (20 s context, 3 windows, per-period voice
#: quality) under a tiny model
TINY = dict(d_model=32, num_heads=4, window_frames=24)
RATES = {30: dict(target_fps=30, emotion_update_frames=9),
         60: dict(target_fps=60, emotion_update_frames=18)}


def _cfg(fps: int, **kw) -> streaming.StreamingConfig:
    return streaming.StreamingConfig(**TINY, **RATES[fps], **kw)


def _model(cfg: streaming.StreamingConfig):
    model = streaming.model_for_config(cfg)
    model.init_random(torch.Generator().manual_seed(0))
    return model.eval()


def _voice(n: int, seed: int = 0) -> torch.Tensor:
    """A gliding harmonic voice (110-220 Hz) with a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    phase = np.cumsum(2 * np.pi * (110 + 110 * t / max(t[-1], 1e-9))
                      / 16000)
    x = sum(np.cos(h * phase) / h for h in range(1, 20))
    x = 0.3 * x / np.abs(x).max() + 0.003 * rng.standard_normal(n)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("fps, length, rows",
                         [(30, 5330, 2062), (60, 5320, 2061)])
def test_ring_holds_the_readers_tail(fps, length, rows):
    cfg = _cfg(fps)
    assert cfg.use_lld_ring
    assert cfg.audio_ring_len == length
    assert cfg.audio_ring_len % cfg.hop_length == 0
    assert cfg.audio_ring_len >= streaming._refresh_tail_len(cfg) == 5152
    # the LLD ring still spans the emotion context
    assert cfg.lld_ring_rows == rows == \
        cfg.emotion_ring_len // cfg.egemaps_config.hop_length
    st = streaming.init_stream_state(cfg, "cpu", lanes=2)
    assert st.audio_ring.shape == (2, length)
    assert st.lld_ring["loudness"].shape[:2] == (2, rows)


@pytest.mark.parametrize("kw", [dict(emotion_backend="basic"),
                                dict(emotion_backend="emotion2vec"),
                                dict(incremental_lld=False)],
                         ids=["basic", "emotion2vec", "full_lld"])
@pytest.mark.parametrize("fps", [30, 60])
def test_full_context_refresh_keeps_the_full_ring(fps, kw):
    cfg = _cfg(fps, **kw)
    assert not cfg.use_lld_ring
    assert cfg.audio_ring_len == cfg.emotion_ring_len
    assert cfg.emotion_ring_len >= streaming._refresh_tail_len(cfg) \
        == cfg.emotion_context_samples
    st = streaming.init_stream_state(cfg, "cpu")
    assert st.audio_ring.shape == (cfg.emotion_ring_len,)


@pytest.mark.parametrize("fps", [30, 60])
def test_short_ring_steps_as_the_full_ring(fps):
    cfg = _cfg(fps)
    model = _model(cfg)
    k = cfg.emotion_update_frames
    n = 2 * k + 3                           # three refreshes
    audio = _voice(n * cfg.hop_length, seed=fps)
    short = streaming.init_stream_state(cfg, "cpu")
    full = dataclasses.replace(
        streaming.init_stream_state(cfg, "cpu"),
        audio_ring=torch.zeros(cfg.emotion_ring_len))
    with torch.inference_mode():
        for i in range(n):
            hop = audio[i * cfg.hop_length:(i + 1) * cfg.hop_length]
            out_s, short = streaming.stream_frame(model, short, hop, cfg)
            out_f, full = streaming.stream_frame(model, full, hop, cfg)
            assert short.audio_ring.shape == (cfg.audio_ring_len,)
            assert full.audio_ring.shape == (cfg.emotion_ring_len,)
            assert torch.equal(out_s["blendshapes"], out_f["blendshapes"]), i
            assert torch.equal(short.emotion_raw, full.emotion_raw), i
            assert torch.equal(short.mel_db, full.mel_db), i
            for key, v in short.lld_ring.items():
                assert torch.equal(v, full.lld_ring[key]), (i, key)
            for a, b in zip(short.lld_carry, full.lld_carry):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b), i
            assert torch.equal(full.audio_ring[-cfg.audio_ring_len:],
                               short.audio_ring), i
    # the refreshes read voiced audio
    assert float(short.emotion_raw.abs().max()) > 0
    assert bool(short.lld_ring["voiced"].any())


def test_server_lanes_hold_short_rings():
    cfg = _cfg(30)
    server = MultiStreamInference(_model(cfg), cfg, 8, device="cpu",
                                  refresh_cohorts=2, graphs=False)
    assert server.states.audio_ring.shape == (8, cfg.audio_ring_len)
    audio = _voice(3 * cfg.hop_length).reshape(3, 1, cfg.hop_length)
    for hop in audio:
        server.step(hop.expand(8, -1))
    assert server.states.audio_ring.shape == (8, cfg.audio_ring_len)
    assert bool((server.states.audio_ring != 0).any(-1).all())
    server.reset_sessions([3])
    rings = server.states.audio_ring
    assert rings.shape == (8, cfg.audio_ring_len)
    assert not rings[3].any()
    assert bool((rings[[0, 1, 2, 4, 5, 6, 7]] != 0).any(-1).all())
    # a step after the reset shifts the silent ring like any other
    server.step(audio[0].expand(8, -1))
    assert torch.equal(server.states.audio_ring[3, -cfg.hop_length:],
                       audio[0, 0])
    assert not server.states.audio_ring[3, :-cfg.hop_length].any()
