"""PyTorch port: the offline sequential decode as a whole.

Same numpy audio and the same converted params through the JAX package and
the port, at d_model 32, 2 heads, a 16-frame window, B = 2, 3 s:

- whole-utterance LLDs (booleans equal, floats rtol 1e-3 / atol 1e-3,
  formant bandwidths rtol 5e-3: ``-ln|z|`` of an LPC root near the unit
  circle amplifies the root's rounding; formants compared on the frames
  where both sides keep the same formant slots, at least 99% of them) and
  the emotion vectors (rtol 1e-3 / atol 1e-4; the four F0 slope
  functionals of each window at rtol 1e-2, see test_torch_streaming);
- the reflect-padded window-edge dB rows at 30 and 60 fps, static and
  per-utterance starts (rtol 1e-4 / atol 1e-3 dB, the frontend's bound);
- the EMA on both sides of the matmul / scan switch (1e-5);
- ``SequentialDualStreamModel`` blendshapes at 1e-5 absolute for every
  edge mode, decode mode and window-start form, with the emotion vector
  given and computed in the model; ``SimplifiedDualStreamModel`` too;
- ``BatchedSequentialDecoder`` against JAX's on one device;
- ``python -m koemorph_tpu_torch.infer`` on the CPU.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models import dual_stream_model as jdm
from koemorph_tpu.ops import egemaps as jeg
from koemorph_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from koemorph_tpu.parallel.batched_decode import (
    BatchedSequentialDecoder as JaxDecoder)
from koemorph_tpu.features.emotion import (
    EmotionFrontendConfig as JaxEmotionConfig,
    emotion_features as jax_emotion_features)
from koemorph_tpu_torch.data.wav import write_wav
from koemorph_tpu_torch.features.emotion import (EmotionFrontendConfig,
                                                 emotion_features)
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.ops import egemaps as eg
from koemorph_tpu_torch.parallel.batched_decode import (
    BatchedSequentialDecoder)
from koemorph_tpu_torch.runtime.streaming import StreamingConfig
from koemorph_tpu_torch.utils.params import state_dict_from_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SR = 16000
SMALL = dict(d_model=32, num_heads=2, mel_sequence_length=16)
EMOTION_RTOL = np.tile(
    [1e-2 if n.startswith("F0semitone") and "Slope" in n else 1e-3
     for n in jeg.FEATURE_NAMES], 3)


def _voice(n: int, seed: int) -> np.ndarray:
    """Harmonic pulse train through formants: 90 Hz, then a 140-230 Hz
    glide, with a short pause and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f = np.where(t < 1.0, 90.0 + 10 * seed, 140.0 + 45.0 * (t - 1.0))
    phase = np.cumsum(2 * np.pi * f / SR)
    x = np.zeros(n)
    for h in range(1, 40):
        fh = f * h
        gain = sum(np.exp(-((fh - c) / w) ** 2)
                   for c, w in ((700, 250), (1200, 300), (2600, 400))) + 0.05
        x += np.where(fh < 7500, gain, 0.0) * np.cos(h * phase)
    x *= ((t % 1.5) < 1.3)
    x = 0.3 * x / np.abs(x).max() + 0.003 * rng.standard_normal(n)
    return x.astype(np.float32)


# (seed 2 puts one frame's third formant at the 2 kHz bandwidth cut, where
# the two sides keep different formant slots and the F3 functionals move
# by ~2%; test_compute_llds_matches_jax bounds how often that happens)
AUDIO = np.stack([_voice(3 * SR, 1), _voice(3 * SR, 3)])


@functools.lru_cache(maxsize=1)
def _params(seed: int = 1):
    """A SimplifiedDualStreamModel tree (the sequential model's too), its
    init perturbed so every weight matters."""
    model = jdm.SimplifiedDualStreamModel(
        **SMALL, emotion_backend="precomputed", dropout=0.0)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16 * 533)),
        jdm.TemporalState.create(1),
        emotion_features_raw=jnp.zeros((1, 264)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x)
                   + rng.normal(0, 0.05, np.shape(x))).astype(np.float32),
        params)


def _models(fps=30, **kw):
    common = dict(SMALL, target_fps=fps)
    jm = jdm.SequentialDualStreamModel(**common, emotion_backend="egemaps",
                                       dropout=0.0, **kw)
    tm = dm.SequentialDualStreamModel(**common, **kw)
    tm.load_state_dict(state_dict_from_flax(_params()))
    return jm, tm.eval()


def _raw_emotion(b=2, seed=5):
    return np.random.default_rng(seed).normal(0, 1, (b, 264)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# emotion
# ---------------------------------------------------------------------------

def test_compute_llds_matches_jax():
    want = jax.jit(jeg.compute_llds)(jnp.asarray(AUDIO))
    got = eg.compute_llds(torch.from_numpy(AUDIO))
    assert set(got) == set(want)
    # a formant whose bandwidth sits at the 2 kHz validity cut may be kept
    # by one side only; that reorders the frame's formant slots
    flip = (got["formant_valid"].numpy()
            != np.asarray(want["formant_valid"])).any(-1)
    assert flip.mean() <= 0.01, flip.mean()
    formant_keys = ("formant_freq", "formant_bw", "formant_rel",
                    "formant_valid", "h1_a3")
    for key, w in want.items():
        w, g = np.asarray(w), got[key].numpy()
        assert g.shape == w.shape, key
        if key in formant_keys:
            w, g = w[~flip], g[~flip]
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            rtol = 5e-3 if key == "formant_bw" else 1e-3
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-3,
                                       err_msg=key)
    assert got["voiced"].shape == (2, 1 + (3 * SR - 512) // 160)
    assert bool(got["voiced"].any()) and not bool(got["voiced"].all())


@pytest.mark.parametrize("concat", [True, False])
def test_emotion_features_match_jax(concat):
    jcfg = JaxEmotionConfig(use_concatenation=concat)
    want = np.asarray(jax.jit(
        lambda a: jax_emotion_features(a, jcfg))(jnp.asarray(AUDIO)))
    got = emotion_features(torch.from_numpy(AUDIO),
                           EmotionFrontendConfig(use_concatenation=concat))
    assert got.shape == want.shape == (2, 264 if concat else 88)
    rtol = EMOTION_RTOL[:want.shape[-1]]
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-4 + rtol * np.abs(want)).all(), np.unravel_index(
        np.argmax(err / (1e-4 + rtol * np.abs(want))), err.shape)
    if concat:     # the three offsets differ
        assert not np.allclose(want[:, :88], want[:, 88:176])


def test_concat_windows_and_functionals_compose():
    a = torch.from_numpy(AUDIO[:1, : 2 * SR])
    cat = eg.egemaps_concat_windows(a, offsets_sec=(0.0,))
    torch.testing.assert_close(cat, eg.egemaps_functionals(a), rtol=0,
                               atol=0)


def test_basic_backend_raises():
    """The model frontends take the ``basic`` backend
    (``tests/test_torch_losses.py`` holds its features against JAX), and
    so does the stream's refresh (``tests/test_torch_stream_refresh.py``);
    ``emotion2vec`` has trained parameters, so the parameter-free feature
    function raises for it as JAX's does, and an unknown backend raises."""
    assert EmotionFrontendConfig(backend="basic").feature_dim == 9
    assert StreamingConfig(emotion_backend="basic").emotion_raw_dim == 9
    assert EmotionFrontendConfig(backend="emotion2vec").feature_dim == 1024
    with pytest.raises(ValueError):
        emotion_features(torch.zeros(16000),
                         EmotionFrontendConfig(backend="emotion2vec"))
    with pytest.raises(ValueError):
        StreamingConfig(emotion_backend="precomputed")


# ---------------------------------------------------------------------------
# window edges, EMA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fps", [30, 60])
@pytest.mark.parametrize("per_utterance", [False, True])
def test_reflect_edge_rows_match_jax(fps, per_utterance):
    hop = SR // fps
    w_hop = 16 * hop
    n = 6
    if per_utterance:
        p = np.stack([np.arange(n) * 3, np.arange(n) * 2 + 1]) * hop
        jp, tp = jnp.asarray(p, jnp.int32), torch.from_numpy(p)
    else:
        p = np.arange(n) * 2 * hop
        jp = tp = p
    fb = jax_mel_filterbank(SR, 1024, 80, 80.0, 8000.0)
    want = jdm._reflect_edge_rows(jnp.asarray(AUDIO), jp, w_hop, 1024, hop,
                                  fb)
    got = dm._reflect_edge_rows(torch.from_numpy(AUDIO), tp, w_hop, 1024,
                                hop)
    ne = dm._n_edge_frames(1024, hop)
    assert ne == jdm._n_edge_frames(1024, hop) == (1 if fps == 30 else 2)
    for g, w in zip(got, want):
        assert g.shape == (2, n, ne, 80)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("t", [5, 2100])
def test_ema_associative_matches_jax(t):
    x = np.random.default_rng(t).random((t, 2, 52)).astype(np.float32)
    alpha = np.float32(0.69)
    want = np.asarray(jdm._ema_associative(jnp.asarray(x),
                                           jnp.asarray(alpha)))
    got = dm._ema_associative(torch.from_numpy(x), torch.tensor(alpha))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the recurrence itself
    s = x[0].astype(np.float64)
    for i in range(1, min(t, 50)):
        s = alpha * x[i] + (1 - alpha) * s
    if t > 1:
        np.testing.assert_allclose(got[min(t, 50) - 1].numpy(), s,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

CASES = {
    "reflect": (30, dict(stride_frames=2), {}),
    "interior": (30, dict(stride_frames=2, window_edge="interior"), {}),
    "exact": (30, dict(stride_frames=5, exact_window_stft=True), {}),
    "chunked": (30, dict(stride_frames=2, decode_mode="chunked",
                         window_chunk=2), {}),
    "scan_alias": (30, dict(stride_frames=3, decode_mode="scan",
                            window_chunk=4), {}),
    "starts": (30, dict(), dict(window_starts=np.array([0, 3, 7, 20, 29]),
                                return_raw=True)),
    "starts_per_utt": (30, dict(), dict(
        window_starts=np.array([[0, 4, 8, 12, 16], [2, 3, 5, 8, 29]]),
        return_raw=True)),
    "fps60": (60, dict(stride_frames=4), dict(return_raw=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sequential_matches_jax(case):
    fps, kw, call_kw = CASES[case]
    jm, tm = _models(fps, **kw)
    raw = _raw_emotion()
    jcall = dict(call_kw)
    if "window_starts" in jcall:
        jcall["window_starts"] = jnp.asarray(jcall["window_starts"],
                                             jnp.int32)
    want = jm.apply({"params": _params()}, jnp.asarray(AUDIO),
                    emotion_features_raw=jnp.asarray(raw), **jcall)
    with torch.inference_mode():
        got = tm(torch.from_numpy(AUDIO),
                 emotion_features_raw=torch.from_numpy(raw), **call_kw)
    assert got["num_frames"] == want["num_frames"]
    assert got["fps"] == want["fps"] == fps
    w = np.asarray(want["blendshapes"])
    assert got["blendshapes"].shape == w.shape
    assert w.shape[1] > 3
    np.testing.assert_allclose(got["blendshapes"].numpy(), w, atol=1e-5)
    if call_kw.get("return_raw"):
        np.testing.assert_allclose(got["raw_blendshapes"].numpy(),
                                   np.asarray(want["raw_blendshapes"]),
                                   atol=1e-5)


def test_sequential_with_emotion_in_model_matches_jax():
    jm, tm = _models(30, stride_frames=2)
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a)["blendshapes"])(
        _params(), jnp.asarray(AUDIO))
    with torch.inference_mode():
        got = tm(torch.from_numpy(AUDIO))["blendshapes"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the edge splice changes the windows' first and last rows only
    with torch.inference_mode():
        tm.window_edge = "interior"
        interior = tm(torch.from_numpy(AUDIO))["blendshapes"]
    assert 0 < float((interior - got).abs().max()) < 0.05


def test_simplified_model_matches_jax():
    jm = jdm.SimplifiedDualStreamModel(**SMALL, emotion_backend="egemaps",
                                       dropout=0.0)
    tm = dm.SimplifiedDualStreamModel(**SMALL)
    tm.load_state_dict(state_dict_from_flax(_params()))
    a = AUDIO[:, : 17 * 533]
    want, jstate = jm.apply({"params": _params()}, jnp.asarray(a),
                            jdm.TemporalState.create(2))
    want2, _ = jm.apply({"params": _params()},
                        jnp.asarray(a[::-1].copy()), jstate)
    with torch.inference_mode():
        got, state = tm(torch.from_numpy(a), dm.TemporalState.create(2))
        got2, _ = tm(torch.from_numpy(a[::-1].copy()), state)
        plain = tm(torch.from_numpy(a))
    np.testing.assert_allclose(got["blendshapes"].numpy(),
                               np.asarray(want["blendshapes"]), atol=1e-5)
    np.testing.assert_allclose(got2["blendshapes"].numpy(),
                               np.asarray(want2["blendshapes"]), atol=1e-5)
    torch.testing.assert_close(plain["blendshapes"], got["blendshapes"])


def test_model_options_raise():
    _, tm = _models(30)
    x = torch.from_numpy(AUDIO)
    # return_attention is ported (test_torch_attention_out.py)
    assert tm(x, return_attention=True)["mel_attention_weights"].shape[-2:] \
        == (28, 80)
    with pytest.raises(ValueError):
        dm.SequentialDualStreamModel(**SMALL, window_edge="mirror")
    with pytest.raises(ValueError):
        dm.SequentialDualStreamModel(**SMALL, decode_mode="serial")
    with pytest.raises(ValueError):
        dm.SequentialDualStreamModel(**SMALL, stride_frames=0)
    with pytest.raises(ValueError):
        dm.SequentialDualStreamModel(**SMALL, exact_window_stft=True)(
            x, window_starts=np.array([0, 1]))
    with pytest.raises(ValueError):
        dm.SequentialDualStreamModel(**SMALL, emotion_backend="precomputed")


def test_state_dict_names_are_the_streaming_models():
    _, tm = _models(30)
    stream = dm.StreamingDualStreamModel(d_model=32, num_heads=2,
                                         window_frames=16)
    assert list(tm.state_dict()) == list(stream.state_dict())


# ---------------------------------------------------------------------------
# batched decoder, CLI
# ---------------------------------------------------------------------------

def test_batched_decoder_matches_jax():
    jm, tm = _models(30, stride_frames=3)
    jdec = JaxDecoder(jm, _params(), devices=jax.devices()[:1])
    tdec = BatchedSequentialDecoder(tm, device="cpu")
    assert tdec.num_devices == jdec.num_devices == 1

    got = tdec(AUDIO)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdec(AUDIO)),
                               atol=1e-5)

    jout, jmask = jdec.decode_scheduled(AUDIO, [2, 5])
    tout, tmask = tdec.decode_scheduled(AUDIO, [2, 5])
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask.sum(1).tolist() == [74 // 2 + 1, 74 // 5 + 1]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)

    seq = tdec.decode_sequence_parallel(AUDIO[1])
    np.testing.assert_allclose(
        seq.numpy(), np.asarray(jdec.decode_sequence_parallel(AUDIO[1])),
        atol=1e-5)
    torch.testing.assert_close(seq, tdec(AUDIO[1:])[0], rtol=0, atol=0)

    stats = tdec.throughput_stats(AUDIO[:1], iters=1)
    assert stats["frames_per_call"] == got.shape[1]
    assert stats["device"] == "cpu"
    with pytest.raises(ValueError):
        tdec.decode_scheduled(AUDIO, 0)


def test_decoder_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = _models(30)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedSequentialDecoder(tm)


def test_infer_cli_on_cpu(tmp_path):
    """``python -m koemorph_tpu_torch.infer --device cpu`` at the flagship
    window and d_model 32: one line per window, stamped like the JAX CLI."""
    wav = tmp_path / "in.wav"
    x = np.concatenate([AUDIO[0], AUDIO[1], AUDIO[0][:SR]])    # 7 s
    write_wav(wav, x, SR)
    out = tmp_path / "frames.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.infer", "--input",
         str(wav), "--output", str(out), "--d-model", "32", "--num-heads",
         "2", "--stride-frames", "4", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "excluding the first call" in proc.stderr
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    hop, window, stride = 533, 256, 4
    usable = max(len(x), (window + 1) * hop) // hop * hop
    n_out = (usable // hop - window) // stride + 1
    assert len(rows) == n_out
    for i, r in enumerate(rows):
        assert r["timestamp"] == round((window - 1 + i * stride) / 30, 6)
        assert len(r["blendshapes"]) == 52
    bs = np.asarray([r["blendshapes"] for r in rows])
    assert np.isfinite(bs).all() and bs.min() >= 0 and bs.max() <= 1


def test_infer_rejects_stereo_and_checkpoints(tmp_path):
    from koemorph_tpu_torch import infer

    wav = tmp_path / "stereo.wav"
    write_wav(wav, np.stack([AUDIO[0], AUDIO[1]], 1), SR)
    with pytest.raises(ValueError, match="channels"):
        infer.main(["--input", str(wav), "--device", "cpu",
                    "--output", str(tmp_path / "o.jsonl")])
    # checkpoints load now; a path that holds none fails before decoding
    with pytest.raises(FileNotFoundError):
        infer.main(["--input", str(wav), "--model", "ckpt", "--device",
                    "cpu"])
    # a short mono file is padded to one window and resampled like the
    # JAX CLI's reader
    mono = tmp_path / "short.wav"
    write_wav(mono, AUDIO[0][: SR // 2], 8000)
    audio = infer.load_audio(str(mono), SR, 256, 533)
    assert audio.shape == (257 * 533,)
