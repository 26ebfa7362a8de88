"""PyTorch port: multi-session serving (``MultiStreamInference``).

The JAX ``MultiStreamInference`` and the port's run the same converted
params and the same seeded audio at a tiny eGeMAPS configuration (window
16, d_model 32, 2 heads, 3-window concatenation, a 2 s ring, a refresh
every 3 frames). Lanes are held to the JAX server at 1e-5 on blendshapes
(as the single-session stream test), the cached emotion vectors at that
test's tolerances, and to the port's own dedicated single-session engines
(with their clocks started at each cohort's phase) at 1e-5: a lane is a
layout change, not a different computation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import egemaps as jeg
from koemorph_tpu.runtime import MultiStreamInference as JaxMultiStream
from koemorph_tpu.runtime import streaming as jax_streaming
from koemorph_tpu_torch.ops import egemaps as eg
from koemorph_tpu_torch.runtime import (MultiStreamInference,
                                        StreamingInference, streaming)
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from tests.test_torch_streaming import EMOTION_RTOL, HOP, KW, _params, _voice

torch.set_num_threads(2)

K = KW["emotion_update_frames"]
# lane gains: a loud lane beside quiet ones (the window max is per lane).
# The formants are the three lowest valid LPC roots, a choice that can flip
# between two implementations on a root at a validity bound; these inputs
# have none (gain 0.4 on the fourth lane flips the JAX and the port's
# single-session streams alike at phase 1: F2 bandwidth moves 81 Hz)
GAINS = (1.0, 0.05, 3.0, 0.5)


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def tcfg():
    return streaming.StreamingConfig(**KW)


@pytest.fixture(scope="module")
def model(params, tcfg):
    m = streaming.model_for_config(tcfg)
    m.load_state_dict(state_dict_from_flax(params))
    return m


def _lanes(n_lanes: int, n_frames: int, seed: int = 0) -> np.ndarray:
    """(S, T*hop) voiced audio, a different seed and gain per lane."""
    return np.stack([
        np.clip(_voice(n_frames * HOP, seed=seed + s + 1)
                * GAINS[s % len(GAINS)], -1.0, 1.0)
        for s in range(n_lanes)]).astype(np.float32)


def _steps(server, audio: np.ndarray) -> np.ndarray:
    """(T, S, 52) from one ``step`` per hop."""
    n = audio.shape[1] // HOP
    return np.stack([np.asarray(server.step(audio[:, i * HOP:(i + 1) * HOP]))
                     for i in range(n)])


def _engine_frames(model, tcfg, audio: np.ndarray, phase: int) -> np.ndarray:
    eng = StreamingInference(model, tcfg, device="cpu")
    eng.state.frame_count = phase
    return np.stack(eng.process_audio(audio))


@pytest.mark.parametrize("cohorts", [1, 2])
def test_lanes_match_jax(params, tcfg, model, cohorts):
    audio = _lanes(4, 2 * K + 1)
    jserver = JaxMultiStream(params, jax_streaming.StreamingConfig(**KW), 4,
                             refresh_cohorts=cohorts)
    server = MultiStreamInference(model, tcfg, 4, device="cpu",
                                  refresh_cohorts=cohorts)
    assert server.clocks == np.atleast_1d(
        np.asarray(jserver.states.frame_count)).tolist()
    for i in range(2 * K + 1):
        hop = audio[:, i * HOP:(i + 1) * HOP]
        want = np.asarray(jserver.step(hop))
        got = server.step(hop).numpy()
        assert got.shape == (4, 52)
        assert np.abs(got - want).max() <= 1e-5, i
        jemo = np.asarray(jserver.states.emotion_raw)
        err = np.abs(server.states.emotion_raw.numpy() - jemo)
        assert (err <= 1e-4 + EMOTION_RTOL * np.abs(jemo)).all(), i
    assert server.clocks == np.atleast_1d(
        np.asarray(jserver.states.frame_count)).tolist()
    assert (server.states.emotion_raw.abs().amax(-1) > 0).all()


@pytest.mark.parametrize("cohorts", [1, 2])
def test_lanes_match_dedicated_engines(tcfg, model, cohorts):
    n_frames = 2 * K + 1
    audio = _lanes(4, n_frames, seed=10)
    server = MultiStreamInference(model, tcfg, 4, device="cpu",
                                  refresh_cohorts=cohorts)
    phases = server.phases
    assert len(phases) == cohorts and len(set(phases)) == cohorts
    batched = _steps(server, audio)
    for s in range(4):
        want = _engine_frames(model, tcfg, audio[s], phases[s % cohorts])
        np.testing.assert_allclose(batched[:, s], want, atol=1e-5, rtol=0,
                                   err_msg=f"lane {s}")


def test_equal_phases_equal_one_clock(tcfg, model):
    """Two cohorts forced to one phase refresh together: the cohort
    views and the in-place write-back give the single-clock server."""
    audio = _lanes(4, K + 1, seed=20)
    one = MultiStreamInference(model, tcfg, 4, device="cpu")
    two = MultiStreamInference(model, tcfg, 4, device="cpu",
                               refresh_cohorts=2)
    two.phases = (0, 0)
    np.testing.assert_allclose(_steps(two, audio), _steps(one, audio),
                               atol=1e-6, rtol=0)


def test_window_max_is_per_lane(tcfg, model):
    """A loud session beside a quiet one does not rescale the quiet one's
    mel: each lane's window is normalized to its own max."""
    quiet = _lanes(1, 4, seed=30)[0] * 0.01
    loud = np.clip(_voice(4 * HOP, seed=31) * 20.0, -1, 1).astype(np.float32)
    alone = MultiStreamInference(model, tcfg, 2, device="cpu")
    mixed = MultiStreamInference(model, tcfg, 2, device="cpu")
    a = _steps(alone, np.stack([quiet, quiet]))
    b = _steps(mixed, np.stack([quiet, loud]))
    np.testing.assert_allclose(b[:, 0], a[:, 0], atol=1e-6, rtol=0)
    st = streaming.init_stream_state(tcfg, "cpu", 2)
    hops = torch.from_numpy(np.stack([quiet[:HOP], loud[:HOP]]))
    _, mel_db, mel, detail = streaming._stream_pre(st, hops, tcfg)
    assert mel.shape == (2, 16, 80) and detail.shape == (2, 3, 80)
    norm_max = torch.maximum(mel.amax((1, 2)), detail.amax((1, 2)))
    np.testing.assert_array_equal(norm_max.numpy(), [1.0, 1.0])
    assert float(mel_db[0].max()) < float(mel_db[1].max()) - 20.0


def test_reset_matches_jax(params, tcfg, model):
    audio = _lanes(3, 3 * K, seed=40)
    jserver = JaxMultiStream(params, jax_streaming.StreamingConfig(**KW), 3)
    server = MultiStreamInference(model, tcfg, 3, device="cpu")
    plain = MultiStreamInference(model, tcfg, 3, device="cpu")
    got, want, kept = [], [], []
    for i in range(3 * K):
        if i == K:                       # at a refresh-phase boundary
            jserver.reset_sessions([1])
            server.reset_sessions([1])
        hop = audio[:, i * HOP:(i + 1) * HOP]
        want.append(np.asarray(jserver.step(hop)))
        got.append(server.step(hop).numpy())
        kept.append(plain.step(hop).numpy())
    got, want, kept = map(np.stack, (got, want, kept))
    assert np.abs(got - want).max() <= 1e-5
    # the reset lane is a fresh session from the reset on; the others are
    # untouched
    fresh = _engine_frames(model, tcfg, audio[1, K * HOP:], 0)
    np.testing.assert_allclose(got[K:, 1], fresh, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, [0, 2]], kept[:, [0, 2]], atol=1e-6,
                               rtol=0)
    assert np.abs(got[K:, 1] - kept[K:, 1]).max() > 1e-3


def test_reset_keeps_phase_and_validates(tcfg, model):
    server = MultiStreamInference(model, tcfg, 4, device="cpu",
                                  refresh_cohorts=2)
    phases = server.clocks
    out = server.step(np.zeros((4, HOP), np.float32))
    before = out.clone()
    server.reset_sessions([0, 3, 3])
    assert server.clocks == [p + 1 for p in phases]
    # the last output is not written by the reset
    assert torch.equal(out, before)
    assert not server.states.temporal.initialized[[0, 3]].any()
    assert server.states.temporal.initialized[[1, 2]].all()
    with pytest.raises(ValueError, match="out of range"):
        server.reset_sessions([4])
    with pytest.raises(ValueError, match="out of range"):
        server.reset_sessions([-1])
    server.reset_sessions([])


def test_int16_bitwise_equal_to_float(tcfg, model):
    rng = np.random.default_rng(3)
    pcm = rng.integers(-32768, 32768, (2, (K + 1) * HOP)).astype(np.int16)
    as_float = pcm.astype(np.float32) / 32768.0
    a = MultiStreamInference(model, tcfg, 2, device="cpu")
    b = MultiStreamInference(model, tcfg, 2, device="cpu")
    b.warmup(dtype=torch.int16)
    for i in range(K + 1):
        sl = slice(i * HOP, (i + 1) * HOP)
        f = a.step(as_float[:, sl])
        g = b.step(torch.from_numpy(pcm[:, sl]) if i % 2 else pcm[:, sl])
        assert torch.equal(f, g), i


@pytest.mark.parametrize("cohorts", [1, 2])
def test_run_scan_equals_step_loop(tcfg, model, cohorts):
    audio = _lanes(2, K + 2, seed=50)
    a = MultiStreamInference(model, tcfg, 2, device="cpu",
                             refresh_cohorts=cohorts)
    scanned = a.run_scan(audio).numpy()
    b = MultiStreamInference(model, tcfg, 2, device="cpu",
                             refresh_cohorts=cohorts)
    np.testing.assert_array_equal(scanned, _steps(b, audio))
    assert a.clocks == b.clocks and a.frames_emitted == 2 * (K + 2)


def test_warmup_leaves_the_state(tcfg, model):
    server = MultiStreamInference(model, tcfg, 2, device="cpu",
                                  refresh_cohorts=2)
    server.step(_lanes(2, 1, seed=60))
    ring = server.states.lld_ring["loudness"].clone()
    emo = server.states.emotion_raw.clone()
    server.warmup()
    assert server.states.frame_count == 1
    assert torch.equal(server.states.lld_ring["loudness"], ring)
    assert torch.equal(server.states.emotion_raw, emo)


def test_stats_keys(tcfg, model):
    server = MultiStreamInference(model, tcfg, 2, device="cpu")
    assert server.performance_stats() == {"frames": 0}
    stats = server.sustained_stats(n_frames=3)
    assert set(stats) == {"sessions", "frames", "scans_run", "step_ms",
                          "per_session_us", "rtf", "realtime",
                          "frames_per_s"}
    assert stats["sessions"] == 2 and stats["frames"] == 3
    assert stats["scans_run"] == 2 and stats["step_ms"] > 0
    assert server.frames_emitted == 2 * 6
    server.step(np.zeros((2, HOP), np.float32))
    perf = server.performance_stats()
    assert set(perf) == {"sessions", "frames", "avg_step_ms", "p50_step_ms",
                         "p99_step_ms", "max_step_ms", "rtf"}
    assert perf["frames"] == 2 * 7


def test_constructor_and_input_validation(tcfg, model, monkeypatch):
    with pytest.raises(ValueError, match="n_sessions"):
        MultiStreamInference(model, tcfg, 0, device="cpu")
    with pytest.raises(ValueError, match="refresh_cohorts"):
        MultiStreamInference(model, tcfg, 8, device="cpu",
                             refresh_cohorts=K + 1)
    with pytest.raises(ValueError, match="divide into"):
        MultiStreamInference(model, tcfg, 5, device="cpu",
                             refresh_cohorts=2)
    server = MultiStreamInference(model, tcfg, 2, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        server.step(np.zeros((3, HOP), np.float32))
    with pytest.raises(ValueError, match="audio must be"):
        server.run_scan(np.zeros((2, HOP + 1), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamInference(model, tcfg, 2)


def test_lane_batched_ring_helpers():
    """``init_lld_ring`` / ``silence_lld_carry`` with lanes stack the
    single-session ones, and ``roll_lld_ring`` rolls each lane's rows (not
    the lanes) as a per-lane loop does; the single-session roll is the JAX
    one."""
    rng = np.random.default_rng(7)
    rows, n_new, lanes = 12, 5, 3
    cfg = eg.EgemapsConfig()
    single = eg.init_lld_ring(rows)
    batched = eg.init_lld_ring(rows, lanes=lanes)
    for k, v in single.items():
        assert torch.equal(batched[k], v.expand((lanes,) + v.shape))
    one = eg.silence_lld_carry(cfg)
    many = eg.silence_lld_carry(cfg, lanes=lanes)
    for a, b in zip(one, many):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(b, a.expand((lanes,) + a.shape))

    def rand(shape, dtype):
        x = rng.standard_normal(shape)
        return torch.from_numpy(x > 0 if dtype == torch.bool
                                else x.astype(np.float32))

    ring = {k: rand((lanes, rows) + shape, dtype)
            for k, shape, dtype in eg.LLD_RING_SPEC}
    block = {k: rand((lanes, n_new) + shape, dtype)
             for k, shape, dtype in eg.LLD_RING_SPEC}
    rolled = eg.roll_lld_ring(ring, block)
    for s in range(lanes):
        lane = eg.roll_lld_ring({k: v[s] for k, v in ring.items()},
                                {k: v[s] for k, v in block.items()})
        jlane = jeg.roll_lld_ring(
            {k: jnp.asarray(v[s].numpy()) for k, v in ring.items()},
            {k: jnp.asarray(v[s].numpy()) for k, v in block.items()})
        for k in ring:
            assert rolled[k].shape == ring[k].shape
            assert torch.equal(rolled[k][s], lane[k]), k
            np.testing.assert_array_equal(lane[k].numpy(),
                                          np.asarray(jlane[k]))
    # the lane-batched stream state stacks fresh single-session states
    tcfg = streaming.StreamingConfig(**KW)
    st1 = streaming.init_stream_state(tcfg, "cpu")
    st3 = streaming.init_stream_state(tcfg, "cpu", lanes)
    assert torch.equal(st3.audio_ring[2], st1.audio_ring)
    assert torch.equal(st3.mel_db[1], st1.mel_db)
    assert st3.temporal.prev.shape == (lanes, 52)
    assert st3.lld_carry.ctx_filled.shape == (lanes,)
