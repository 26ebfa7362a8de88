"""PyTorch port: eGeMAPS with frame-level voice quality
(``per_period_voice_quality=False``; ``egemaps_per_period=False`` on the
models, the emotion frontend and the stream).

Jitter is then the relative change of the F0 period from the previous
frame and shimmer the dB change of the frame RMS; across chunks the LLD
carry holds the last frame's period, voicing and RMS. No cycle
segmentation runs, so ``cycle_dsum`` (K1) is never called.

- ``compute_llds`` / ``compute_lld_block`` against JAX: boolean LLDs
  equal, floats at rtol 1e-4 / atol 1e-4 (formant frequencies and
  bandwidths 1e-3), as ``test_torch_egemaps``; the carry's period and
  RMS at rtol 1e-5, its voicing equal, its spectrum at
  ``test_torch_egemaps``'s rtol 1e-4 / atol 1e-6.
- In the port, blocks chained by the carry give the one long block's rows,
  as the reference guarantees for ``f0_smoother="none"``: booleans equal,
  floats at rtol 1e-4 / atol 1e-4, the bound of ``test_torch_egemaps``'s
  split-block test (the CPU's matrix products round by their row count,
  so a block's rows are not bitwise those of a longer block).
- The stream (15 frames, 5 refreshes) and the server (3 lanes at G = 1
  and 3, a lane reset) against JAX's ``stream_frame`` and
  ``MultiStreamInference``: blendshapes within 1e-5 absolute, the emotion
  vector at ``test_torch_streaming``'s tolerances (rtol 1e-3, the F0
  slope functionals 1e-2, atol 1e-4). On the server's lanes the four F0
  semitone slope statistics split a flat pitch stretch's rounding
  residues into rising and falling frames (``test_torch_stream_refresh``
  and ROADMAP.md section 3): after the reset, lane 1's window has 5
  rising frames in JAX and 4 in the port, one frame's slope being 1.9e-4
  semitones/s in one and 0 in the other, which moves the rising slopes'
  standard deviation by 43%. Those four are held through the contour they
  reduce: the LLD ring's F0 semitones within 1e-5 and its voicing equal.
- ``SequentialDualStreamModel(egemaps_per_period=False)`` against JAX's:
  blendshapes within 1e-5 absolute.
- A ``DualStreamTrainer`` step's loss against the JAX trainer's at rtol
  1e-5 (``test_torch_train``'s bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models import dual_stream_model as jdm
from koemorph_tpu.ops import egemaps as jeg
from koemorph_tpu.runtime import MultiStreamInference as JaxMultiStream
from koemorph_tpu.runtime import streaming as jax_streaming
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.ops import cuda as ck
from koemorph_tpu_torch.ops import egemaps as eg
from koemorph_tpu_torch.ops import f0 as f0_ops
from koemorph_tpu_torch.runtime import MultiStreamInference, streaming
from koemorph_tpu_torch.train.trainer import dropout_generator
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from tests.test_torch_egemaps import _assert_lld_close
from tests.test_torch_egemaps import _voice as _steady_voice
from tests.test_torch_stream_refresh import SPLIT
from tests.test_torch_streaming import EMOTION_RTOL, HOP, KW, _params, _voice

torch.set_num_threads(2)

SR, LLD_HOP = 16000, 160
FRAME_LEVEL = dict(per_period_voice_quality=False)
K = KW["emotion_update_frames"]


def _two_voices(n: int) -> np.ndarray:
    """80 -> 180 Hz, and 130 Hz with a 0.1 s pause every 0.5 s."""
    gate = (np.arange(n) / SR % 0.5) < 0.4
    return np.stack([_voice(n, seed=1),
                     _steady_voice(130.0, n, seed=2) * gate])


def _no_k1(monkeypatch):
    """Make every route to the per-cycle machinery and K1 raise."""
    def boom(*a, **kw):
        raise AssertionError("cycle_dsum called on the frame-level path")
    for mod, name in ((f0_ops, "cycle_dsum"), (f0_ops, "_per_cycle_periods"),
                      (f0_ops, "cycle_dsum_plain"), (ck, "cycle_dsum")):
        monkeypatch.setattr(mod, name, boom)


def test_compute_llds_matches_jax(monkeypatch):
    _no_k1(monkeypatch)
    x = _two_voices(SR)
    jcfg, cfg = jeg.EgemapsConfig(**FRAME_LEVEL), eg.EgemapsConfig(
        **FRAME_LEVEL)
    want, jcarry = jax.jit(lambda a: jeg.compute_lld_block(a, jcfg))(
        jnp.asarray(x))
    got, carry = eg.compute_lld_block(torch.from_numpy(x), cfg)
    _assert_lld_close(got, want)
    voiced = np.asarray(want["voiced"])
    jv = np.asarray(want["jitter_valid"])
    assert jv.any() and not np.array_equal(jv, voiced)
    assert (np.asarray(want["shimmer_db"])[voiced] > 0).any()
    # the carry: the last frame's spectrum, period, voicing and RMS; no
    # low-pitch context
    assert carry.audio_tail is None and carry.ctx_filled is None
    assert jcarry.audio_tail is None
    np.testing.assert_array_equal(carry.prev_voiced.numpy(),
                                  np.asarray(jcarry.prev_voiced))
    for name in ("prev_period", "prev_amp"):
        np.testing.assert_allclose(getattr(carry, name).numpy(),
                                   np.asarray(getattr(jcarry, name)),
                                   rtol=1e-5, atol=0, err_msg=name)
    np.testing.assert_allclose(carry.prev_mag.numpy(),
                               np.asarray(jcarry.prev_mag), rtol=1e-4,
                               atol=1e-6)
    # the functionals through the emotion frontend's knob
    fw = np.asarray(jeg.functionals_from_llds(want, jcfg))
    fg = eg.functionals_from_llds(got, cfg).numpy()
    tol = 1e-4 + EMOTION_RTOL[:88] * np.abs(fw)
    assert (np.abs(fg - fw) <= tol).all()


def test_silence_carry_and_carried_blocks_match_jax(monkeypatch):
    _no_k1(monkeypatch)
    rows = 10
    span = (rows - 1) * LLD_HOP + 512
    x = _two_voices(span + 2 * rows * LLD_HOP)
    jcfg, cfg = jeg.EgemapsConfig(**FRAME_LEVEL), eg.EgemapsConfig(
        **FRAME_LEVEL)
    jcarry = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v, (2,) + v.shape),
        jeg.silence_lld_carry(jcfg))
    carry = eg.silence_lld_carry(cfg, lanes=2)
    for field, jfield in zip(carry, jcarry):
        assert (field is None) == (jfield is None)
        if field is not None:
            np.testing.assert_array_equal(field.numpy(), np.asarray(jfield))
    assert carry.prev_voiced.dtype == torch.bool
    block = jax.jit(lambda c, k: jeg.compute_lld_block(c, jcfg, k))
    for i in range(3):
        chunk = x[:, i * rows * LLD_HOP: i * rows * LLD_HOP + span]
        want, jcarry = block(jnp.asarray(chunk), jcarry)
        got, carry = eg.compute_lld_block(torch.from_numpy(chunk), cfg,
                                          carry)
        _assert_lld_close(got, want, f"block {i}")


@pytest.mark.parametrize("n1", [1, 13, 25])
def test_chunked_equals_monolithic(n1, monkeypatch):
    """Two blocks chained by the carry give the one long block's rows (the
    frame-pairwise jitter and shimmer of the second block's first row read
    the carry)."""
    _no_k1(monkeypatch)
    cfg = eg.EgemapsConfig(**FRAME_LEVEL)
    n_rows = 40
    x = torch.from_numpy(_two_voices((n_rows - 1) * LLD_HOP + 512))
    whole, _ = eg.compute_lld_block(x, cfg, eg.silence_lld_carry(cfg, lanes=2))
    b1, carry = eg.compute_lld_block(x[:, : (n1 - 1) * LLD_HOP + 512], cfg,
                                     eg.silence_lld_carry(cfg, lanes=2))
    b2, _ = eg.compute_lld_block(x[:, n1 * LLD_HOP:], cfg, carry)
    for key in whole:
        both = torch.cat([b1[key], b2[key]], 1)
        if whole[key].dtype == torch.bool:
            assert torch.equal(both, whole[key]), key
        else:
            np.testing.assert_allclose(both.numpy(), whole[key].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
    assert bool(whole["jitter_valid"][:, n1].any())


def test_stream_matches_jax(monkeypatch):
    _no_k1(monkeypatch)
    params = _params()
    jcfg = jax_streaming.StreamingConfig(**KW, egemaps_per_period=False)
    tcfg = streaming.StreamingConfig(**KW, egemaps_per_period=False)
    assert tcfg.egemaps_config == eg.EgemapsConfig(**FRAME_LEVEL)
    model = streaming.model_for_config(tcfg)
    assert model.egemaps_per_period is False
    model.load_state_dict(state_dict_from_flax(params))
    n_frames = 15
    audio = _voice(n_frames * HOP)
    step = jax.jit(lambda p, s, a: jax_streaming.stream_frame(p, s, a, jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_streaming.init_stream_state(jcfg)
    tstate = streaming.init_stream_state(tcfg, "cpu")
    for i in range(n_frames):
        hop = audio[i * HOP:(i + 1) * HOP]
        jout, jstate = step(jparams, jstate, jnp.asarray(hop))
        with torch.inference_mode():
            tout, tstate = streaming.stream_frame(model, tstate,
                                                  torch.from_numpy(hop), tcfg)
        got = tout["blendshapes"].numpy()
        assert np.abs(got - np.asarray(jout["blendshapes"])).max() <= 1e-5, i
        want = np.asarray(jstate.emotion_raw)
        err = np.abs(tstate.emotion_raw.numpy() - want)
        assert (err <= 1e-4 + EMOTION_RTOL * np.abs(want)).all(), i
        np.testing.assert_array_equal(tstate.lld_carry.prev_voiced.numpy(),
                                      np.asarray(jstate.lld_carry.prev_voiced))
    assert float(tstate.emotion_raw.abs().max()) > 0
    assert bool(tstate.lld_ring["jitter_valid"].any())


@pytest.mark.parametrize("cohorts", [1, 3])
def test_server_matches_jax_with_reset(cohorts, monkeypatch):
    """Three lanes, then a reset of lane 1, against the JAX server doing
    the same; the reset writes the silence carry's period, voicing and
    RMS into the lane."""
    _no_k1(monkeypatch)
    params = _params()
    jcfg = jax_streaming.StreamingConfig(**KW, egemaps_per_period=False)
    tcfg = streaming.StreamingConfig(**KW, egemaps_per_period=False)
    model = streaming.model_for_config(tcfg)
    model.load_state_dict(state_dict_from_flax(params))
    n = 2 * K + 1
    audio = np.stack([_voice(n * HOP, seed=s + 5) * g
                      for s, g in enumerate((1.0, 0.2, 2.0))])
    audio = np.clip(audio, -1, 1).astype(np.float32)
    jserver = JaxMultiStream(params, jcfg, 3, refresh_cohorts=cohorts)
    server = MultiStreamInference(model, tcfg, 3, device="cpu",
                                  refresh_cohorts=cohorts)
    for i in range(2 * n):
        if i == n:
            carry = server.states.lld_carry
            assert bool(carry.prev_amp[1] > 0)
            jserver.reset_sessions([1])
            server.reset_sessions([1])
            fresh = eg.silence_lld_carry(tcfg.egemaps_config)
            for name in ("prev_period", "prev_voiced", "prev_amp",
                         "prev_mag"):
                assert torch.equal(getattr(carry, name)[1],
                                   getattr(fresh, name)), name
        t = i % n
        hop = audio[:, t * HOP:(t + 1) * HOP]
        want = np.asarray(jserver.step(hop))
        got = server.step(hop).numpy()
        assert np.abs(got - want).max() <= 1e-5, i
        w = np.asarray(jserver.states.emotion_raw)
        err = np.abs(server.states.emotion_raw.numpy() - w)
        assert (err <= 1e-4 + EMOTION_RTOL * np.abs(w))[:, ~SPLIT].all(), i
        ring, jring = server.states.lld_ring, jserver.states.lld_ring
        np.testing.assert_array_equal(ring["voiced"].numpy(),
                                      np.asarray(jring["voiced"]))
        np.testing.assert_allclose(ring["f0_semitone"].numpy(),
                                   np.asarray(jring["f0_semitone"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            server.states.lld_carry.prev_voiced.numpy(),
            np.asarray(jserver.states.lld_carry.prev_voiced))


def test_models_carry_the_knob():
    m = dm.SimplifiedDualStreamModel(d_model=32, num_heads=2,
                                     mel_sequence_length=16,
                                     egemaps_per_period=False)
    assert m.emotion_config.egemaps_per_period is False
    cfg = streaming.StreamingConfig.from_model(m)
    assert cfg.egemaps_per_period is False
    assert cfg.egemaps_config.per_period_voice_quality is False
    assert streaming.model_for_config(cfg).egemaps_per_period is False
    assert streaming.StreamingConfig.from_model(
        dm.SimplifiedDualStreamModel(d_model=32, num_heads=2)
    ).egemaps_per_period is True


def test_sequential_decode_matches_jax(monkeypatch):
    _no_k1(monkeypatch)
    small = dict(d_model=32, num_heads=2, mel_sequence_length=16,
                 stride_frames=3, egemaps_per_period=False)
    jm = jdm.SequentialDualStreamModel(**small, dropout=0.0)
    audio = _two_voices(40 * HOP)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(audio))["params"]
    tm = dm.SequentialDualStreamModel(**small)
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.eval()
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a)["blendshapes"])(
        params, jnp.asarray(audio))
    with torch.inference_mode():
        got = tm(torch.from_numpy(audio))["blendshapes"].numpy()
    assert got.shape == np.asarray(want).shape
    assert np.abs(got - np.asarray(want)).max() <= 1e-5


def test_dual_stream_trainer_loss_matches_jax(monkeypatch):
    from tests.test_torch_train import _case
    knob = dict(egemaps_per_period=False)
    jt, tt, batch = _case("window", "egemaps", jax_kw=knob, port_kw=knob)
    assert tt.model.emotion_config.egemaps_per_period is False
    _no_k1(monkeypatch)
    jprep = jt._prepare(batch)
    jloss, _ = jax.jit(lambda p, b: jt.loss_fn(p, b, jt.state.step_rng()))(
        jt.state.params, jprep)
    prep = tt._prepare(batch)
    tt.model.train()
    loss, _ = tt.loss_fn(prep, dropout_generator(0, 0, tt.device))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)


def test_stream_config_replace_keeps_knob():
    cfg = dataclasses.replace(streaming.StreamingConfig(**KW),
                              egemaps_per_period=False)
    st = streaming.init_stream_state(cfg, "cpu", lanes=2)
    assert st.lld_carry.prev_voiced.shape == (2,)
    assert st.lld_carry.prev_voiced.dtype == torch.bool
    assert st.lld_carry.audio_tail is None
