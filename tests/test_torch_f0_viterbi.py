"""PyTorch port: the Viterbi pitch smoother and the public F0 API.

Test signals (``_signals``, seeded): a steady 150 Hz vowel, a creaky
110 Hz stretch whose odd glottal cycles are 0.55 times as loud as the even
ones (CMNDF dips at the cycle lag and at its double), a true octave change
110 -> 220 Hz, and a glide gated by silence gaps, arranged with leading
batch axes ``(2, 2, L)``.

- ``_viterbi_pick`` on the same CMNDF input as JAX's: the chosen lags are
  equal on every frame.
- ``yin_f0`` / ``yin_core(smoother="viterbi")`` from audio, at the
  default F0 framing and at the eGeMAPS framing: the picks are equal on
  every frame the DP links (``voiced_hint``: a CMNDF dip below 3x the
  threshold and energy); voicing is equal and F0 within 1e-5 relative on
  every frame. A frame without that hint is a free reset of the path
  (both links to it cost nothing), so its pick decides nothing else, and
  it is unvoiced (F0 0) whatever the pick: on a silence-gap edge frame
  (RMS 2e-4) the CMNDF is flat to one float32 ulp around 1.0 and the two
  implementations' roundings choose different tied lags (ROADMAP.md
  section 3). Those frames are held by their F0 and voicing.
- ``compute_llds`` with ``f0_smoother="viterbi"`` and a chunked
  ``compute_lld_block`` (30-row blocks chained by the carry, against
  JAX's same chunked calls): boolean LLDs equal, floats at rtol 1e-4 /
  atol 1e-4 (formant frequencies and bandwidths 1e-3), as
  ``test_torch_egemaps``; the 88 functionals at rtol 1e-3 / atol 1e-4,
  the four F0 slope statistics at rtol 1e-2 (``test_torch_streaming``'s
  reason).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import egemaps as jeg
from koemorph_tpu.ops import f0 as jf
from koemorph_tpu_torch.ops import egemaps as eg
from koemorph_tpu_torch.ops import f0
from tests.test_torch_egemaps import _assert_lld_close

torch.set_num_threads(2)

SR = 16000
EGEMAPS_YIN = dict(frame_length=512, hop_length=160, f0_min=55.0,
                   f0_max=500.0, center=False)
FRAMINGS = {"default": {}, "egemaps": EGEMAPS_YIN}
SLOPES = np.asarray([n.startswith("F0semitone") and "Slope" in n
                     for n in jeg.FEATURE_NAMES])


def _harmonic(f0_hz: np.ndarray, seed: int, alternate: float = 1.0):
    """Harmonics of ``f0_hz`` (per sample) through formants at 700 / 1200 /
    2600 Hz; ``alternate`` scales every other glottal cycle."""
    n = f0_hz.shape[0]
    phase = np.cumsum(2 * np.pi * f0_hz / SR)
    x = np.zeros(n)
    for h in range(1, 40):
        fh = f0_hz * h
        gain = sum(np.exp(-((fh - c) / w) ** 2)
                   for c, w in ((700, 250), (1200, 300), (2600, 400))) + 0.05
        x += np.where(fh < 7600, gain, 0.0) * np.cos(h * phase)
    cycle = np.floor(phase / (2 * np.pi)).astype(np.int64)
    x *= np.where(cycle % 2 == 0, 1.0, alternate)
    rng = np.random.default_rng(seed)
    return 0.3 * x / np.abs(x).max() + 0.002 * rng.standard_normal(n)


def _signals(seconds: float = 0.8) -> np.ndarray:
    """(2, 2, L): steady vowel, creak, octave change, gated glide."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rows = [_harmonic(np.full(n, 150.0), 1),
            _harmonic(np.full(n, 110.0), 2, alternate=0.55),
            _harmonic(np.where(t < seconds / 2, 110.0, 220.0), 3),
            _harmonic(120.0 + 60.0 * t / seconds, 4)
            * (((t * 5.0) % 1.0) < 0.6)]
    return np.stack(rows).astype(np.float32).reshape(2, 2, n)


@functools.lru_cache(maxsize=None)
def _jax_core(framing: str):
    x = jnp.asarray(_signals())
    return (jf.yin_core(x, smoother="viterbi", **FRAMINGS[framing]),
            jf.yin_core(x, smoother="none", **FRAMINGS[framing]))


def _hint(x: np.ndarray, kw: dict) -> np.ndarray:
    """The DP's periodicity hint, from the port's CMNDF."""
    tau_min, tau_max = f0._tau_range(SR, kw.get("f0_min", 50.0),
                                     kw.get("f0_max", 400.0))
    frames = f0.frame_signal(torch.from_numpy(x), kw.get("frame_length",
                                                         1024),
                             kw.get("hop_length", 160),
                             center=kw.get("center", True))
    d = f0.yin_frame_difference(frames, tau_max)
    region = f0.cmndf(d)[..., tau_min:]
    rms = torch.sqrt(torch.mean(frames * frames, -1))
    return ((region.amin(-1) < 0.45) & (rms > 1e-4)).numpy()


@pytest.mark.parametrize("framing", list(FRAMINGS))
def test_dp_on_the_same_cmndf_matches_jax(framing):
    """The candidates, costs, forward pass and backtrack alone: JAX's own
    CMNDF and hint into both ``_viterbi_pick``s."""
    kw = FRAMINGS[framing]
    tau_min, tau_max = f0._tau_range(SR, kw.get("f0_min", 50.0),
                                     kw.get("f0_max", 400.0))
    x = jnp.asarray(_signals())
    frames = jf.frame_signal(x, kw.get("frame_length", 1024),
                             kw.get("hop_length", 160),
                             center=kw.get("center", True))
    dprime = jf.cmndf(jf.yin_frame_difference(frames, tau_max))
    rms = jnp.sqrt(jnp.mean(frames * frames, axis=-1))
    hint = (jnp.min(dprime[..., tau_min:], axis=-1) < 0.45) & (rms > 1e-4)
    want = np.asarray(jf._viterbi_pick(dprime, tau_min=tau_min,
                                       voiced_hint=hint))
    got = f0._viterbi_pick(torch.from_numpy(np.array(dprime)),
                           tau_min=tau_min,
                           voiced_hint=torch.from_numpy(np.array(hint)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("framing", list(FRAMINGS))
def test_yin_viterbi_matches_jax(framing):
    kw = FRAMINGS[framing]
    x = _signals()
    jcore, jplain = _jax_core(framing)
    core = f0.yin_core(torch.from_numpy(x), smoother="viterbi", **kw)
    hint = _hint(x, kw)
    jpick = np.asarray(jcore.pick)
    assert core.pick.shape == jpick.shape == x.shape[:2] + (hint.shape[-1],)
    np.testing.assert_array_equal(core.pick.numpy()[hint], jpick[hint])
    # the signals make the DP decide: its path leaves plain YIN's picks
    assert (jpick[hint] != np.asarray(jplain.pick)[hint]).sum() >= 3
    res, jres = core.result, jcore.result
    np.testing.assert_array_equal(res.voiced_flag.numpy(),
                                  np.asarray(jres.voiced_flag))
    np.testing.assert_allclose(res.f0_hz.numpy(), np.asarray(jres.f0_hz),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(res.voiced_prob.numpy(),
                               np.asarray(jres.voiced_prob),
                               rtol=1e-5, atol=1e-5)
    # hint-free frames are unvoiced whatever their pick
    assert not res.voiced_flag.numpy()[~hint].any()
    # the public yin_f0 is yin_core's result
    pub = f0.yin_f0(torch.from_numpy(x), smoother="viterbi", **kw)
    for a, b in zip(pub, res):
        assert torch.equal(a, b)


def test_yin_frame_difference_matches_jax():
    x = _signals()[0]
    frames = np.array(jf.frame_signal(jnp.asarray(x), 1024, 160))
    want = np.asarray(jf.yin_frame_difference(jnp.asarray(frames), 320))
    got = f0.yin_frame_difference(torch.from_numpy(frames), 320).numpy()
    assert got.shape == want.shape == frames.shape[:-1] + (321,)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def test_smoother_validation():
    with pytest.raises(ValueError, match="smoother"):
        f0.yin_core(torch.zeros(2048), smoother="median")
    # a frame of silence and a single frame: the path is one node
    out = f0.yin_core(torch.zeros(1024), smoother="viterbi", center=False)
    assert out.pick.shape == (1,) and float(out.result.f0_hz) == 0.0


def test_compute_llds_viterbi_matches_jax():
    x = _signals().reshape(4, -1)
    jcfg = jeg.EgemapsConfig(f0_smoother="viterbi")
    cfg = eg.EgemapsConfig(f0_smoother="viterbi")
    want = jax.jit(lambda a: jeg.compute_llds(a, jcfg))(jnp.asarray(x))
    got = eg.compute_llds(torch.from_numpy(x), cfg)
    _assert_lld_close(got, want, "monolithic")
    assert bool(np.asarray(want["voiced"]).any())
    fw = np.asarray(jeg.functionals_from_llds(want, jcfg))
    fg = eg.functionals_from_llds(got, cfg).numpy()
    tol = 1e-4 + np.where(SLOPES, 1e-2, 1e-3) * np.abs(fw)
    assert (np.abs(fg - fw) <= tol).all(), float(np.abs(fg - fw).max())


def test_chunked_viterbi_blocks_match_jax_chunked():
    """30-row blocks chained by the carry, as the streaming refresh runs
    them: each block smoothed on its own, in both implementations."""
    rows, hop = 30, 160
    x = _signals(1.3).reshape(4, -1)[1:3]
    jcfg = jeg.EgemapsConfig(f0_smoother="viterbi")
    cfg = eg.EgemapsConfig(f0_smoother="viterbi")
    jblock = jax.jit(lambda c, k: jeg.compute_lld_block(c, jcfg, k))
    span = (rows - 1) * hop + 512
    jcarry = jax.tree_util.tree_map(
        lambda v: jnp.broadcast_to(v, (2,) + v.shape),
        jeg.silence_lld_carry(jcfg))
    carry = eg.silence_lld_carry(cfg, lanes=2)
    n_blocks = (x.shape[-1] - span) // (rows * hop) + 1
    assert n_blocks >= 3
    for i in range(n_blocks):
        chunk = x[:, i * rows * hop: i * rows * hop + span]
        want, jcarry = jblock(jnp.asarray(chunk), jcarry)
        got, carry = eg.compute_lld_block(torch.from_numpy(chunk), cfg,
                                          carry)
        _assert_lld_close(got, want, f"block {i}")
        np.testing.assert_array_equal(carry.audio_tail.numpy(),
                                      np.asarray(jcarry.audio_tail))
