"""PyTorch port: ``EmotionExtractor``, its heuristics, the emotion monitor
and ``integration_check`` against the JAX package, on the same audio.

Tolerances: the heuristics and the mapping are equal (bitwise arrays,
equal dicts) on the same inputs; the extractor's eGeMAPS embeddings at
the stream tests' rtol 1e-3 / atol 1e-4, with 1e-2 for the four F0 slope
functionals and for the two jitter functionals: jitter divides
period-to-period differences by the period, so YIN's ~3e-6 relative
period rounding reaches its mean and stddevNorm over 1 s of audio at up to
1.6e-3 (the port against JAX's jitted ``emotion_features`` as well); the ``basic`` embeddings at the losses tests' rtol 1e-5
(f0_std 1e-4 Hz, the clip mean 1e-8 absolute), the ConvEmotionEncoder
level's 1024-D embedding within 1e-5 (the encoder test's bound), and the
blendshape weights derived from those features within 1e-3. Levels,
backends served, predictions, cache hits and call counts are equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.features import emotion as jem
from koemorph_tpu.features.emotion2vec import (
    ConvEmotionEncoder as JaxConvEncoder)
from koemorph_tpu.utils import emotion_monitor as jmon
from koemorph_tpu_torch import integration_check
from koemorph_tpu_torch.features import emotion as tem
from koemorph_tpu_torch.ops.cuda import KernelError
from koemorph_tpu_torch.ops.egemaps import FEATURE_NAMES
from koemorph_tpu_torch.utils import emotion_monitor as tmon

torch.set_num_threads(2)

EGEMAPS_RTOL = np.tile(
    [1e-2 if (n.startswith("F0semitone") and "Slope" in n)
     or n.startswith("jitterLocal") else 1e-3 for n in FEATURE_NAMES], 3)
BASIC_ATOL = np.array([0, 0, 0, 0, 1e-4, 1e-8, 0, 0, 0])


def _audio(seed=0):
    """1 s of speech-like audio: one length throughout, so the JAX side
    compiles its eGeMAPS and basic graphs once per process (~45 s and
    ~10 s on the CPU)."""
    return integration_check.synth_speech(1.0, seed=seed)


@pytest.fixture(autouse=True)
def fresh_monitors(tmp_path):
    """Each test starts both packages' monitors anew, under tmp_path."""
    jmon.initialize_monitor({"log_dir": str(tmp_path / "jax_monitor")})
    tmon.initialize_monitor({"log_dir": str(tmp_path / "monitor")})


def _pair(**kw):
    return (jem.EmotionExtractor(**kw),
            tem.EmotionExtractor(**kw, device="cpu"))


def test_mapping_and_labels_equal():
    assert tem.EMOTION_TO_BLENDSHAPE_MAPPING == \
        jem.EMOTION_TO_BLENDSHAPE_MAPPING
    assert tem.EMOTION2VEC_LABELS == jem.EMOTION2VEC_LABELS


@pytest.mark.parametrize("preds", [
    {"happy": 0.6, "surprised": 0.2, "neutral": 0.2},
    {"angry": 0.9, "disgusted": 0.8, "fearful": 0.7},
    {"sad": 0.6, "neutral": 0.4}, {"other": 1.0}, {}])
def test_emotion_to_blendshapes_bitwise(preds):
    np.testing.assert_array_equal(tem.emotion_to_blendshapes(preds),
                                  jem.emotion_to_blendshapes(preds))


def test_egemaps_heuristics_match_jax():
    """Random 88-D vectors spread over every branch of both heuristics,
    and the short-vector guards."""
    rng = np.random.default_rng(0)
    seen = set()
    for i in range(400):
        f = rng.uniform(0, 1, 88).astype(np.float32)
        f[0] = rng.uniform(20, 45)            # F0 mean, semitones
        f[1] = rng.uniform(0, 0.2)            # F0 CV
        f[10] = rng.uniform(0, 0.01)          # jitter
        f[12] = rng.uniform(0, 3)             # loudness mean
        f[13] = rng.uniform(0, 0.6)           # loudness CV
        f[22] = rng.uniform(0, 0.1)           # shimmer
        f[24] = rng.uniform(0, 15)            # HNR
        got = tem.egemaps_to_emotion(f)
        assert got == jem.egemaps_to_emotion(f)
        seen.add(tuple(sorted(got)))
        np.testing.assert_array_equal(
            tem.egemaps_to_expression_blendshapes(f),
            jem.egemaps_to_expression_blendshapes(f))
    assert len(seen) == 5
    for n in (5, 20):
        f = np.ones(n, np.float32)
        assert tem.egemaps_to_emotion(f) == jem.egemaps_to_emotion(f)
        np.testing.assert_array_equal(
            tem.egemaps_to_expression_blendshapes(f),
            jem.egemaps_to_expression_blendshapes(f))


@pytest.mark.parametrize("args", [(0.2, 0.1, 150, 60), (0.06, 0.1, 250, 10),
                                  (0.001, 0.1, 100, 5), (0.03, 0.1, 120, 5)])
def test_basic_heuristic_matches_jax(args):
    assert tem.basic_emotion_heuristic(*args) == \
        jem.basic_emotion_heuristic(*args)


def _assert_same_result(got, want, level):
    ge, we = got["embeddings"], want["embeddings"]
    assert ge.shape == we.shape
    if level in (1, 2):
        bound = (1e-4 + EGEMAPS_RTOL * np.abs(we) if level == 1
                 else BASIC_ATOL + 1e-5 * np.abs(we))
        bad = np.abs(ge - we) > bound
        assert not bad.any(), (np.argwhere(bad), ge[bad], we[bad])
    else:
        assert np.abs(ge - we).max() <= 1e-5
    assert got["predictions"] == want["predictions"]
    np.testing.assert_allclose(got["blendshape_weights"],
                               want["blendshape_weights"], rtol=0,
                               atol=1e-3)
    assert got["metadata"]["backend_used"] == \
        want["metadata"]["backend_used"]


@pytest.mark.parametrize("backend,level", [("egemaps", 1), ("basic", 2),
                                           ("emotion2vec", 1)])
def test_levels_match_jax(backend, level):
    jx, tx = _pair(backend=backend, enable_caching=False)
    assert jx.fallback_level == tx.fallback_level == level
    assert tx.feature_dim == jx.feature_dim
    audio = np.stack([_audio(seed=1), _audio(seed=2)])
    _assert_same_result(tx.extract_features(audio),
                        jx.extract_features(audio), level)
    js, ts = jx.get_statistics(), tx.get_statistics()
    js.pop("avg_processing_time"), ts.pop("avg_processing_time")
    assert ts == js


def _conv_state_dict(params):
    """A JAX ``ConvEmotionEncoder`` tree in the port module's names."""
    sd = {"proj.weight": params["proj"]["kernel"].T,
          "proj.bias": params["proj"]["bias"],
          "layer_fusion_weights": params["layer_fusion_weights"]}
    for i in range(7):
        sd[f"conv_{i}.weight"] = np.transpose(params[f"conv_{i}"]["kernel"],
                                              (2, 1, 0))
        sd[f"conv_{i}.bias"] = params[f"conv_{i}"]["bias"]
        sd[f"norm_{i}.weight"] = params[f"norm_{i}"]["scale"]
        sd[f"norm_{i}.bias"] = params[f"norm_{i}"]["bias"]
    for i in range(4):
        sd[f"ff_{i}.weight"] = params[f"ff_{i}"]["kernel"].T
        sd[f"ff_{i}.bias"] = params[f"ff_{i}"]["bias"]
        sd[f"lnorm_{i}.weight"] = params[f"lnorm_{i}"]["scale"]
        sd[f"lnorm_{i}.bias"] = params[f"lnorm_{i}"]["bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_conv_encoder_level_and_runtime_demotion():
    audio = _audio(seed=3)
    params = jax.jit(JaxConvEncoder().init)(
        jax.random.PRNGKey(1), jnp.asarray(audio[None]))
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    jx = jem.EmotionExtractor(emotion2vec_params=params,
                              enable_caching=False)
    tx = tem.EmotionExtractor(emotion2vec_params=_conv_state_dict(tree),
                              enable_caching=False, device="cpu")
    assert jx.fallback_level == tx.fallback_level == 0
    _assert_same_result(tx.extract_features(audio),
                        jx.extract_features(audio), 0)
    # weights of another shape fail at the first extraction: both demote
    # to eGeMAPS at run time and log the event
    bad = {k: v[..., :1] for k, v in _conv_state_dict(tree).items()}
    jbad = jax.tree_util.tree_map(lambda v: v[..., :1], params)
    jx = jem.EmotionExtractor(emotion2vec_params=jbad,
                              enable_caching=False)
    tx = tem.EmotionExtractor(emotion2vec_params=bad, enable_caching=False,
                              device="cpu")
    got, want = tx.extract_features(audio), jx.extract_features(audio)
    assert jx.fallback_level == tx.fallback_level == 1
    _assert_same_result(got, want, 1)
    for mon in (jmon.get_monitor(), tmon.get_monitor()):
        assert [(e["from"], e["to"]) for e in mon.fallback_events] == [
            ("emotion2vec", "opensmile")]


def test_kernel_fault_is_not_demoted(monkeypatch):
    """A kernel that fails to build or launch raises through the extractor:
    no lower level serves in its place."""
    def broken(*a, **k):
        raise KernelError("CUDA kernel cycle_dsum failed to launch")

    monkeypatch.setattr(tem, "emotion_features", broken)
    tx = tem.EmotionExtractor(backend="egemaps", enable_caching=False,
                              device="cpu")
    with pytest.raises(KernelError, match="failed to launch"):
        tx.extract_features(_audio(seed=3))
    assert tx.fallback_level == 1
    assert tmon.get_monitor().fallback_events == []


def test_precomputed_miss_restores_level(tmp_path):
    known, unknown = _audio(seed=4), _audio(seed=5)
    feats = np.random.default_rng(0).normal(size=(7, 1024)).astype(
        np.float32)
    tem.PrecomputedEmotionFeatures.save(tmp_path / "pre", known, feats)
    jx, tx = _pair(precomputed_dir=tmp_path / "pre", enable_caching=False)
    assert jx.fallback_level == tx.fallback_level == 0
    for audio, level in ((known, 0), (unknown, 1), (known, 0)):
        got, want = tx.extract_features(audio), jx.extract_features(audio)
        _assert_same_result(got, want, level)
        assert jx.fallback_level == tx.fallback_level == 0
    np.testing.assert_array_equal(
        tx.extract_features(known)["embeddings"][0], feats.mean(0))


def _tiny_hf_checkpoint(path):
    """A local HuggingFace wav2vec2 checkpoint of a tiny config:
    ``config.json`` and ``pytorch_model.bin`` (the port encoder's random
    weights under ``wav2vec2.``)."""
    from koemorph_tpu_torch.features import wav2vec2 as w2v
    kw = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, conv_dim=[16, 16, 16],
              conv_stride=[5, 2, 2], conv_kernel=[10, 3, 3],
              num_conv_pos_embedding_groups=4, num_conv_pos_embeddings=16)
    enc = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}))
    enc.init_random(torch.Generator().manual_seed(2))
    sd = {f"wav2vec2.{k}": v for k, v in enc.state_dict().items()
          if k != "layer_fusion_weights"}
    w = sd.pop("wav2vec2.encoder.pos_conv_embed.conv.weight")
    sd["wav2vec2.encoder.pos_conv_embed.conv.weight_g"] = torch.ones(
        1, 1, w.shape[-1])
    sd["wav2vec2.encoder.pos_conv_embed.conv.weight_v"] = w
    path.mkdir()
    (path / "config.json").write_text(json.dumps(
        dict(kw, conv_bias=True, layer_norm_eps=1e-5)))
    torch.save(sd, path / "pytorch_model.bin")


def test_pretrained_source_matches_jax(tmp_path):
    """Level 0 from a local HuggingFace checkpoint: the utterance
    embedding (the encoder's hidden size wide) within 1e-5 of JAX's."""
    _tiny_hf_checkpoint(tmp_path / "hf")
    jx, tx = _pair(pretrained_path=tmp_path / "hf", enable_caching=False)
    assert jx.fallback_level == tx.fallback_level == 0
    audio = _audio(seed=9)
    got, want = tx.extract_features(audio), jx.extract_features(audio)
    assert got["embeddings"].shape == (1, 32)
    _assert_same_result(got, want, 0)


def test_pretrained_failure_falls_through(tmp_path, caplog):
    jx, tx = _pair(pretrained_path=tmp_path / "missing",
                   enable_caching=False)
    assert jx.fallback_level == tx.fallback_level == 1
    assert "pretrained emotion2vec weights unavailable" in caplog.text


def test_cache_hits_and_stats_match_jax(tmp_path):
    audio = np.stack([_audio(seed=6), _audio(seed=6), _audio(seed=7)])
    jx = jem.EmotionExtractor(backend="basic", cache_dir=tmp_path / "j")
    tx = tem.EmotionExtractor(backend="basic", cache_dir=tmp_path / "t",
                              device="cpu")
    for _ in range(2):
        got, want = tx.extract_features(audio), jx.extract_features(audio)
        _assert_same_result(got, want, 2)
        assert got["metadata"]["cache_used"] == \
            want["metadata"]["cache_used"]
    js, ts = jx.get_statistics(), tx.get_statistics()
    assert ts["cache_hits"] == js["cache_hits"] == 4
    js.pop("avg_processing_time"), ts.pop("avg_processing_time")
    assert ts == js
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    tx.reset_statistics()
    assert tx.get_statistics()["total_calls"] == 0


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tem.EmotionExtractor(backend="basic")
    with pytest.raises(RuntimeError, match="CUDA"):
        tem.create_emotion_extractor({"backend": "basic"})
    ex = tem.create_emotion_extractor({"backend": "egemaps",
                                       "device": "cpu",
                                       "use_concatenation": False})
    assert ex.feature_dim == 88 and ex.fallback_level == 1


def test_monitor_stats_and_report(tmp_path):
    """One sequence of extractions and a demotion: both monitors count
    the same records per backend, success rate and fallback events; the
    report and the export carry them."""
    audio = _audio(seed=8)
    for mod, ex in ((jmon, jem), (tmon, tem)):
        kw = {} if ex is jem else {"device": "cpu"}
        for backend in ("egemaps", "basic", "basic"):
            ex.EmotionExtractor(backend=backend, enable_caching=False,
                                **kw).extract_features(audio)
        mod.get_monitor().log_fallback_usage("emotion2vec", "opensmile",
                                             "test")
    js, ts = (m.get_monitor().get_statistics() for m in (jmon, tmon))
    for s in (js, ts):
        s.pop("uptime_s"), s.pop("avg_processing_ms")
        for b in s["backends"].values():
            for k in ("avg_ms", "p50_ms", "p95_ms", "max_ms"):
                b.pop(k)
    assert ts == js
    assert ts["backends"] == {"opensmile": {"count": 1},
                              "basic": {"count": 2}}
    mon = tmon.get_monitor()
    assert not mon.log_dir.exists()        # created when written to
    report = mon.generate_report()
    assert mon.log_dir.is_dir()
    assert "| basic | 2 |" in report and "- Fallback events: 1" in report
    assert "emotion2vec -> opensmile: test" in report
    exported = json.loads(open(mon.export_data()).read())
    assert len(exported["history"]) == 3
    assert exported["statistics"]["fallback_events"] == 1
    rec = exported["history"][0]
    assert rec["backend"] == "opensmile" and rec["success"]
    assert set(rec["blendshape_stats"]) == {"mean", "max", "active_count"}
    mon.reset_metrics()
    assert mon.get_statistics()["total_extractions"] == 0


def test_integration_check_on_cpu(capsys):
    assert integration_check.main(["--cpu", "--seconds", "2"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["device"] == "cpu"
    assert report["streaming"]["frames"] == 60
    matrix = report["fallback_matrix"]
    assert matrix["emotion2vec"]["resolved_backend"] == "opensmile"
    assert matrix["emotion2vec"]["dim"] == 264
    assert matrix["basic"]["dim"] == 9
    assert set(report["backend_perf_ms"]) == {"egemaps", "basic"}
