"""PyTorch port: the single-session streaming step as a whole.

The JAX ``stream_frame`` and the port's run on the same converted params
and the same audio for 15 frames (5 refreshes at cadence 3): per-frame
blendshapes at <= 1e-5 absolute, the cached emotion vector at rtol 1e-3 /
atol 1e-4, except the four F0 slope functionals of each window at rtol
1e-2: they divide frame-to-frame pitch differences by the 10 ms frame
period, which amplifies the ~3e-6 relative rounding of YIN's refined
period (see test_torch_f0) a hundredfold. The audio is a harmonic pulse
train through formants with a stretch at 80 Hz (below the 512-sample
frame's cycle-pair limit, so the 1024-sample low-pitch frames and their
carried context are used) and one at 180 Hz.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.data.wav import read_wav as jax_read_wav
from koemorph_tpu.ops.egemaps import FEATURE_NAMES
from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel, TemporalState as JaxTemporalState)
from koemorph_tpu.runtime import streaming as jax_streaming
from koemorph_tpu.runtime.streamers import (
    encode_osc_message as jax_encode_osc)
from koemorph_tpu_torch.data.wav import read_wav, write_wav
from koemorph_tpu_torch.ops import f0 as f0_ops
from koemorph_tpu_torch.runtime import engine, streaming
from koemorph_tpu_torch.runtime.streamers import (BlendshapeStreamer,
                                                  encode_osc_message)
from koemorph_tpu_torch.utils.params import state_dict_from_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SR, HOP = 16000, 533
KW = dict(window_frames=16, d_model=32, num_heads=2, emotion_context_s=2.0,
          emotion_update_frames=3)
EMOTION_RTOL = np.tile(
    [1e-2 if n.startswith("F0semitone") and "Slope" in n else 1e-3
     for n in FEATURE_NAMES], 3)


def _params(seed: int = 1):
    model = SimplifiedDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16,
        emotion_backend="precomputed", dropout=0.0)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16 * HOP)),
        JaxTemporalState.create(1),
        emotion_features_raw=jnp.zeros((1, 264)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x)
                   + rng.normal(0, 0.05, np.shape(x))).astype(np.float32),
        params)


def _voice(n: int, seed: int = 1) -> np.ndarray:
    """80 Hz for 0.25 s, then 180 Hz: phase-continuous harmonics through
    formant resonances at 700 / 1200 / 2600 Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f = np.where(t < 0.25, 80.0, 180.0)
    phase = np.cumsum(2 * np.pi * f / SR)
    x = np.zeros(n)
    for h in range(1, 40):
        fh = f * h
        gain = sum(np.exp(-((fh - c) / w) ** 2)
                   for c, w in ((700, 250), (1200, 300), (2600, 400))) + 0.05
        x += np.where(fh < 7500, gain, 0.0) * np.cos(h * phase)
    x = 0.3 * x / np.abs(x).max() + 0.003 * rng.standard_normal(n)
    return x.astype(np.float32)


def test_stream_matches_jax(monkeypatch):
    params = _params()
    jcfg = jax_streaming.StreamingConfig(**KW)
    tcfg = streaming.StreamingConfig(**KW)
    model = streaming.model_for_config(tcfg)
    model.load_state_dict(state_dict_from_flax(params))

    # record what each per-cycle segmentation saw: frame length, any
    # valid cycle pair
    seen = []
    per_cycle = f0_ops._per_cycle_periods

    def recording(frames, *args, **kw):
        periods, valid = per_cycle(frames, *args, **kw)
        pairs = (valid[..., 1:] & valid[..., :-1]).any()
        seen.append((frames.shape[-1], bool(pairs)))
        return periods, valid

    monkeypatch.setattr(f0_ops, "_per_cycle_periods", recording)

    n_frames = 15
    audio = _voice(n_frames * HOP)
    step = jax.jit(lambda p, s, a: jax_streaming.stream_frame(p, s, a, jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_streaming.init_stream_state(jcfg)
    tstate = streaming.init_stream_state(tcfg, "cpu")
    ctx_before_refresh = []
    for i in range(n_frames):
        hop = audio[i * HOP:(i + 1) * HOP]
        if i % 3 == 0:
            ctx_before_refresh.append(int(tstate.lld_carry.ctx_filled))
        jout, jstate = step(jparams, jstate, jnp.asarray(hop))
        with torch.inference_mode():
            tout, tstate = streaming.stream_frame(model, tstate,
                                                  torch.from_numpy(hop), tcfg)
        got = tout["blendshapes"].numpy()
        assert got.shape == (52,)
        assert np.abs(got - np.asarray(jout["blendshapes"])).max() <= 1e-5, i
        want = np.asarray(jstate.emotion_raw)
        err = np.abs(tstate.emotion_raw.numpy() - want)
        assert (err <= 1e-4 + EMOTION_RTOL * np.abs(want)).all(), (
            i, np.argmax(err / (1e-4 + EMOTION_RTOL * np.abs(want))))
        assert tstate.frame_count == int(jstate.frame_count) == i + 1

    # 5 refreshes, each segmenting 512- and 1024-sample frames
    assert [n for n, _ in seen] == [512, 1024] * 5
    short_ok = [ok for n, ok in seen if n == 512]
    long_ok = [ok for n, ok in seen if n == 1024]
    assert any(short_ok), "no valid cycle pair in a 512-sample frame"
    assert any(ok and ctx == 512
               for ok, ctx in zip(long_ok, ctx_before_refresh)), \
        "no valid low-pitch cycle pair with a fully carried context"
    assert float(tstate.emotion_raw.abs().max()) > 0


def test_refresh_cadence_and_override():
    tcfg = streaming.StreamingConfig(**KW)
    model = streaming.model_for_config(tcfg)
    model.init_random(torch.Generator().manual_seed(0))
    state = streaming.init_stream_state(tcfg, "cpu")
    audio = torch.from_numpy(_voice(7 * HOP, seed=2))
    history = []
    with torch.inference_mode():
        for i in range(7):
            _, state = streaming.stream_frame(model, state,
                                              audio[i * HOP:(i + 1) * HOP],
                                              tcfg)
            history.append(state.emotion_raw.clone())
        # refreshes at frames 0, 3 and 6; cached between
        assert torch.equal(history[1], history[2])
        assert not torch.equal(history[2], history[3])
        assert torch.equal(history[4], history[5])
        _, frozen = streaming.stream_frame(model, state, audio[:HOP], tcfg,
                                           update_every=0)
        assert frozen.emotion_raw is state.emotion_raw
        with pytest.raises(ValueError):
            streaming.stream_frame(model, state, audio[:HOP], tcfg,
                                   update_every=2)


def test_streaming_inference_on_cpu():
    tcfg = streaming.StreamingConfig(**KW)
    model = streaming.model_for_config(tcfg)
    model.init_random(torch.Generator().manual_seed(0))
    eng = streaming.StreamingInference(model, tcfg, device="cpu")
    eng.warmup()
    audio = _voice(5 * HOP + 100)
    frames = eng.process_audio(audio[:2 * HOP + 50])
    frames += eng.process_audio(audio[2 * HOP + 50:])
    assert len(frames) == 5 and eng.frames_emitted == 5
    assert len(eng._pending) == 100
    bs = np.stack(frames)
    assert np.isfinite(bs).all() and bs.min() >= 0 and bs.max() <= 1
    # the chunking does not change the frames
    eng.reset()
    again = np.stack(eng.process_audio(audio[:5 * HOP]))
    np.testing.assert_array_equal(again, bs)
    stats = eng.performance_stats()
    assert stats["frames"] == 5 and stats["target_fps"] == 30


def test_entry_points_need_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = streaming.StreamingConfig(**KW)
    model = streaming.model_for_config(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        streaming.StreamingInference(model, tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.build_streaming_model(d_model=32, num_heads=2)


def test_unported_configurations_raise():
    # the stream's basic, emotion2vec and full-ring refreshes run (held
    # against JAX by tests/test_torch_stream_refresh.py), and so do the
    # viterbi F0 smoother and the frame-level jitter and shimmer
    # (test_torch_f0_viterbi.py, test_torch_egemaps_frame_level.py); an
    # unknown smoother or backend raises
    from koemorph_tpu_torch.ops import egemaps as eg
    with pytest.raises(ValueError, match="smoother"):
        f0_ops.yin_core(torch.zeros(2048), smoother="median")
    cfg = streaming.StreamingConfig(**KW, egemaps_per_period=False)
    assert cfg.egemaps_config == eg.EgemapsConfig(
        per_period_voice_quality=False)
    with pytest.raises(ValueError):
        streaming.StreamingConfig(**KW, emotion_backend="precomputed")
    # checkpoints load: a missing path raises FileNotFoundError, and a
    # checkpoint with a parameter of another width ValueError naming it
    with pytest.raises(FileNotFoundError):
        engine.build_streaming_model(device="cpu", checkpoint="ckpt")
    model, _ = engine.build_streaming_model(device="cpu", d_model=32,
                                            num_heads=2)
    sd = dict(model.state_dict())
    sd["dual_stream_attention.mel_norm.weight"] = torch.ones(64)
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"model_state_dict": sd}, Path(tmp) / "wide.pth")
        with pytest.raises(ValueError,
                           match="dual_stream_attention.mel_norm.weight"):
            engine.build_streaming_model(
                device="cpu", d_model=32, num_heads=2,
                checkpoint=str(Path(tmp) / "wide.pth"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import koemorph_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'koemorph_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'matplotlib' not in sys.modules\n"
        "for m in ('serve', 'feed_serve', 'runtime.multistream',\n"
        "          'runtime.graphs', 'train', 'train.__main__',\n"
        "          'train.optim', 'train.trainer', 'train.checkpoint',\n"
        "          'visualization.attention_viz', 'ops.reconstruct',\n"
        "          'ops.prosody', 'ops.library', 'features.stft',\n"
        "          'features.sliding_window', 'features.egemaps_extractor',\n"
        "          'export', 'export.exporter', 'export_model'):\n"
        "    assert 'koemorph_tpu_torch.' + m in sys.modules, m\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('koemorph_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_rt_cli_on_cpu(tmp_path):
    """``python -m koemorph_tpu_torch.rt`` end to end: flagship window and
    ring at d_model 32, 12 frames to a JSONL file."""
    from koemorph_tpu_torch import rt

    wav = tmp_path / "in.wav"
    write_wav(wav, _voice(SR // 2), SR)
    out = tmp_path / "frames.jsonl"
    rc = rt.main(["--input", str(wav), "--output", "file", "--output-file",
                  str(out), "--no-realtime", "--max-frames", "12",
                  "--d-model", "32", "--num-heads", "2", "--device", "cpu"])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 12
    bs = np.asarray([r["blendshapes"] for r in rows])
    assert bs.shape == (12, 52) and np.isfinite(bs).all()


def test_wav_and_streamer_formats(tmp_path):
    x = _voice(2000)
    for subtype in ("pcm16", "float32"):
        path = tmp_path / f"{subtype}.wav"
        write_wav(path, np.stack([x, -x], 1), SR, subtype=subtype)
        got, sr = read_wav(path)
        want, _ = jax_read_wav(path)
        assert sr == SR
        np.testing.assert_array_equal(got, want)
    values = list(np.linspace(0, 1, 52))
    assert encode_osc_message("/bs", values) == jax_encode_osc("/bs", values)
    with BlendshapeStreamer("file",
                            output_file=str(tmp_path / "o.jsonl")) as s:
        s.send(np.asarray(values, np.float32), 1.5)
    row = json.loads((tmp_path / "o.jsonl").read_text())
    assert row["timestamp"] == 1.5 and len(row["blendshapes"]) == 52


def test_stereo_replay_mixes_to_mono(tmp_path):
    """A deliberate deviation from the JAX reader: the port's
    ``AudioFileReader`` mixes a stereo file to mono, where the JAX reader
    flattens the (L, 2) samples and so replays them interleaved at twice
    the length."""
    from koemorph_tpu.runtime.audio import AudioFileReader as JaxReader
    from koemorph_tpu_torch.runtime.audio import AudioFileReader

    x = _voice(1600)
    path = tmp_path / "stereo.wav"
    write_wav(path, np.stack([x, 0.5 * x], 1), SR, subtype="float32")
    got = AudioFileReader(path, SR, HOP, realtime=False).audio
    np.testing.assert_array_equal(got, (0.75 * x).astype(np.float32))
    jax_audio = JaxReader(path, SR, HOP, realtime=False).audio
    assert jax_audio.shape == (2 * len(x),)
    np.testing.assert_array_equal(jax_audio[0::2], x)
    np.testing.assert_array_equal(jax_audio[1::2], 0.5 * x)


def test_chip_smoke_imports_no_jax_or_matplotlib():
    """``chip_smoke.py`` runs on a machine without JAX or matplotlib: no
    import of either, or of the JAX package, anywhere in it."""
    import ast
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "koemorph_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "koemorph_tpu",
                        "matplotlib"}, roots
