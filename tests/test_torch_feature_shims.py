"""PyTorch port: the reference-named feature extractors
(``features/stft.py``, ``features/sliding_window.py``,
``features/egemaps_extractor.py``) against the JAX package's, on the CPU.

The same numpy audio goes through both. Tolerances: the torchaudio-style
``MelSpectrogramExtractor`` and the librosa-style sliding-window mel and
detail at 1e-4 (float32 DFT and mel products in another order; the
stream tests' mel bound); the eGeMAPS extractor's functionals at rtol
1e-3 / atol 1e-4, the four F0 slope and the two jitter functionals at
rtol 1e-2 (they amplify YIN's ~3e-6 relative period rounding,
``ROADMAP.md`` section 3); the calibrated features the same, after one
float32 multiply-add; the audio buffers exactly. The Griffin-Lim round
trip keeps the tone's pitch and scale, as the JAX test holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu import features as jfeat
from koemorph_tpu.ops import egemaps as jeg
from koemorph_tpu_torch import features as feat
from koemorph_tpu_torch.ops import egemaps as eg
from koemorph_tpu_torch.ops.cuda import KernelError
from koemorph_tpu_torch.integration_check import synth_speech
from koemorph_tpu_torch.ops.egemaps import FEATURE_NAMES

SR = 16000
CPU = "cpu"
EGEMAPS_RTOL = np.asarray(
    [1e-2 if (n.startswith("F0semitone") and "Slope" in n)
     or n.startswith("jitterLocal") else 1e-3 for n in FEATURE_NAMES])


# speech-like audio (the integration check's). A formant root on the
# eGeMAPS validity bound flips the F1 choice, and an F1 / F0 ratio at a
# half-integer flips the harmonic that A1 is read at (4 dB on one frame of
# ``synth_speech(3.0, seed=0)``), in JAX and the port alike by rounding
# (``ROADMAP.md`` section 3); these clips have neither
AUDIO = synth_speech(3.0, seed=3)
AUDIO_B = np.stack([synth_speech(2.0, seed=1), synth_speech(2.0, seed=2)])


def _close(got, want, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` elementwise (array
    tolerances), naming the functionals that miss."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.flatnonzero(~(np.abs(got - want)
                           <= atol + rtol * np.abs(want)))
    names = [FEATURE_NAMES[i % 88] for i in bad % (88 * 3)]
    assert not bad.size, list(zip(names, got.flat[bad], want.flat[bad]))


def _table(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.5, 2.0, 88), rng.normal(0, 3, 88)],
                    -1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_egemaps():
    """JAX's streaming extractor on a 2 s context, concatenated, and its
    batch path (one jitted function each)."""
    ex = jfeat.EgemapsStreamingExtractor(context_window=2.0)
    single = ex.process_audio_frame(AUDIO, timestamp=0.0)
    return {"single": single, "concat": ex.get_concatenated_features(),
            "batch": ex.process_audio_batch(AUDIO_B)}


@pytest.mark.parametrize("batched", [False, True])
def test_mel_spectrogram_extractor_matches_jax(batched):
    audio = AUDIO_B if batched else AUDIO[:SR * 2]
    for fps in (30.0, 60.0):
        got = feat.MelSpectrogramExtractor(target_fps=fps, device=CPU)(
            audio).numpy()
        want = np.asarray(jfeat.MelSpectrogramExtractor(target_fps=fps)(
            audio))
        assert got.shape == want.shape == (len(audio) if batched else 1,
                                           int(2 * fps), 80)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mel_spectrogram_extractor_checks():
    ex = feat.MelSpectrogramExtractor(device=CPU)
    assert ex.get_output_length(SR) == 30
    with pytest.raises(ValueError):
        ex(np.zeros((1, 2, 100), np.float32))
    with pytest.raises(ValueError):
        feat.MelSpectrogramExtractor(sample_rate=100, target_fps=200.0,
                                     device=CPU)
    with pytest.raises(ValueError, match="power"):
        feat.MelSpectrogramExtractor(power=1.0, device=CPU)
    with pytest.raises(ValueError, match="center"):
        feat.MelSpectrogramExtractor(center=False, device=CPU)


def test_entry_points_need_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for make in (feat.MelSpectrogramExtractor, feat.InverseMelSpectrogram,
                 feat.MelSlidingWindowExtractor,
                 feat.EgemapsStreamingExtractor,
                 feat.OpenSMILEeGeMAPSExtractor):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_sliding_window_batch_matches_jax():
    ex = feat.MelSlidingWindowExtractor(window_frames=32, device=CPU)
    jex = jfeat.MelSlidingWindowExtractor(window_frames=32)
    audio = AUDIO_B[:, :32 * 533]
    got = ex.process_audio_batch(audio)
    want = jex.process_audio_batch(audio)
    assert got.shape == want.shape == (2, 33, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    mel, detail = ex._compute(audio)
    jmel, jdetail = (np.asarray(a) for a in jex._compute(
        jnp.asarray(audio)))
    np.testing.assert_allclose(detail, jdetail, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(detail, mel[:, -3:])


def test_sliding_window_frames_match_jax():
    """Every frame recomputed (update ratio 0): each served window and
    its detail against JAX's, on the same writes."""
    ex = feat.MelSlidingWindowExtractor(window_frames=32, update_ratio=0.0,
                                        device=CPU)
    jex = jfeat.MelSlidingWindowExtractor(window_frames=32,
                                          update_ratio=0.0)
    for i in range(6):
        frame = AUDIO[i * 533:(i + 1) * 533]
        got, want = ex.process_audio_frame(frame), jex.process_audio_frame(
            frame)
        assert got.shape == want.shape == (32, 80)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ex.get_temporal_detail(),
                               jex.get_temporal_detail(), rtol=0, atol=1e-4)
    stats, jstats = ex.get_stats(), jex.get_stats()
    for key in ("extractions", "cache_hits", "failures"):
        assert stats[key] == jstats[key]
    assert stats["buffer"] == jstats["buffer"]
    assert stats["extractions"] == 6


def test_sliding_window_throttle_and_failures(monkeypatch):
    ex = feat.MelSlidingWindowExtractor(window_frames=16, update_ratio=1e6,
                                        device=CPU)
    a = ex.process_audio_frame(AUDIO[:533])
    b = ex.process_audio_frame(AUDIO[533:1066])
    assert a is b and ex.get_stats()["cache_hits"] == 1
    ex.update_interval = 0.0

    def fail(exc):
        def raise_(audio):
            raise exc
        return raise_

    monkeypatch.setattr(ex, "_compute", fail(ValueError("bad input")))
    assert ex.process_audio_frame(AUDIO[:533]) is a   # the cache served
    assert ex.get_stats()["failures"] == 1
    monkeypatch.setattr(ex, "_compute", fail(KernelError("no kernel")))
    with pytest.raises(KernelError):
        ex.process_audio_frame(AUDIO[:533])
    ex.reset()
    assert ex.get_current_features() is None
    made = feat.create_mel_extractor({"mel_sequence_length": 16,
                                      "device": CPU})
    assert made.window_frames == 16 and made.device.type == CPU


@pytest.mark.parametrize("make,method,feed", [
    (lambda: feat.MelSlidingWindowExtractor(window_frames=16, device=CPU),
     "_compute", lambda ex: ex.process_audio_frame(AUDIO[:8533])),
    (lambda: feat.EgemapsStreamingExtractor(context_window=0.5, device=CPU),
     "_extract", lambda ex: ex.process_audio_frame(AUDIO[:8000],
                                                   timestamp=0.0)),
], ids=["sliding_window", "egemaps"])
def test_extraction_fault_on_the_card_raises(make, method, feed,
                                             monkeypatch):
    """A fault that surfaces at the copy back from the card (torch's own
    CUDA error, not a ``KernelError``) raises instead of serving a stale
    cache: the context it leaves behind fails every later extraction."""
    ex = make()
    ex.device = torch.device("cuda")

    def raise_(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(ex, method, raise_)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        feed(ex)
    assert ex.failures == 0


def test_audio_buffers_match_jax():
    for cls, jcls, kw, write in (
            (feat.MelAudioBuffer, jfeat.MelAudioBuffer,
             dict(window_duration=0.5, frame_hop=533), "add_audio_frame"),
            (feat.AudioBuffer, jfeat.AudioBuffer,
             dict(duration=1.0, margin=0.5), "append")):
        buf, jbuf = cls(**kw), jcls(**kw)
        for n in (533, 100, 533, 9000, 532, 3):
            x = np.random.default_rng(n).standard_normal(n).astype(
                np.float32)
            getattr(buf, write)(x)
            getattr(jbuf, write)(x)
            assert buf.get_stats() == jbuf.get_stats()
        if cls is feat.AudioBuffer:
            for dur, off in ((0.5, 0.0), (0.5, 0.3), (1.0, 0.6)):
                np.testing.assert_array_equal(buf.get_window(dur, off),
                                              jbuf.get_window(dur, off))
        else:
            np.testing.assert_array_equal(buf.get_current_audio(),
                                          jbuf.get_current_audio())
        buf.reset()
        jbuf.reset()
        assert buf.get_stats() == jbuf.get_stats()


def test_egemaps_extractor_matches_jax(jax_egemaps):
    ex = feat.EgemapsStreamingExtractor(context_window=2.0, device=CPU)
    single = ex.process_audio_frame(AUDIO, timestamp=0.0)
    concat = ex.get_concatenated_features()
    assert single.shape == (88,) and concat.shape == (264,)
    _close(single, jax_egemaps["single"], EGEMAPS_RTOL, 1e-4)
    _close(concat, jax_egemaps["concat"], np.tile(EGEMAPS_RTOL, 3), 1e-4)
    # throttled: inside the 300 ms interval the cache is served
    assert ex.process_audio_frame(AUDIO[:533], timestamp=0.1) is single
    assert ex.get_temporal_features().shape == (1, 88)
    assert ex.feature_dim == 264 and len(ex.get_feature_names()) == 88
    batch = ex.process_audio_batch(AUDIO_B)
    assert batch.shape == (2, 88)
    _close(batch, jax_egemaps["batch"], EGEMAPS_RTOL, 1e-4)


def test_egemaps_extractor_calibrated_matches_jax(jax_egemaps, monkeypatch):
    """``calibrate=True`` with a recorded table (a synthetic one: the
    repository records none) against JAX's calibration of its own
    features."""
    table = _table(7)
    monkeypatch.setattr(eg, "load_calibration", lambda path=None: table)
    ex = feat.EgemapsStreamingExtractor(context_window=2.0, calibrate=True,
                                        device=CPU)
    ex.process_audio_frame(AUDIO, timestamp=0.0)
    want = np.asarray(jeg.apply_calibration(
        jnp.asarray(jax_egemaps["concat"]), table))
    scale = np.tile(np.abs(table[:, 0]), 3)
    _close(ex.get_concatenated_features(), want, np.tile(EGEMAPS_RTOL, 3),
           1e-4 * scale)


def test_opensmile_named_extractor_and_factories():
    ex = feat.OpenSMILEeGeMAPSExtractor(
        feature_set="eGeMAPSv02", feature_level="Functionals",
        enable_caching=True, device=CPU)
    assert ex.feature_dim == 88 and not ex.use_concatenation
    with pytest.raises(ValueError, match="feature_set"):
        feat.OpenSMILEeGeMAPSExtractor(feature_set="ComParE_2016",
                                       device=CPU)
    with pytest.raises(ValueError, match="feature_level"):
        feat.OpenSMILEeGeMAPSExtractor(feature_level="LLD", device=CPU)
    made = feat.create_opensmile_extractor({"context_window": 1.0,
                                            "device": CPU})
    assert feat.create_opensmile_extractor is feat.create_egemaps_extractor
    assert made.context_window == 1.0 and made.feature_dim == 264
    made.set_context_window(1.5)
    assert made.buffer.capacity == int((1.5 + 2.6) * SR)


def test_inverse_mel_round_trip_keeps_pitch():
    """The JAX test's round trip (``tests/features/test_stft_api.py``):
    Griffin-Lim keeps the tone's dominant frequency and its scale."""
    t = np.arange(SR) / SR
    tone = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    ex = feat.MelSpectrogramExtractor(n_fft=1024, target_fps=60.0,
                                      device=CPU)
    inv = feat.InverseMelSpectrogram(n_fft=1024, target_fps=60.0,
                                     n_iter=32, device=CPU)
    rec = inv(ex(tone)).numpy()[0]
    assert np.isfinite(rec).all()
    spec = np.abs(np.fft.rfft(rec))
    dominant = np.fft.rfftfreq(len(rec), 1 / SR)[np.argmax(spec)]
    assert abs(dominant - 220.0) < 15.0, dominant
    assert 0.05 < np.abs(rec).max() < 5.0
    # the reference's calling convention: everything from the extractor
    short = feat.InverseMelSpectrogram(ex, n_iter=4)
    out = short(ex(tone[:SR // 2]))
    assert out.shape == (1, 30 * 266) and torch.isfinite(out).all()
    assert short.device == ex.device
