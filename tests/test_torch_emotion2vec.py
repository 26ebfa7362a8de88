"""PyTorch port: the ``emotion2vec`` backend.

Same numpy inputs (seeded) and the same params through the JAX package and
the port, at tiny widths:
- the wav2vec2 encoder (``features/wav2vec2.py``) with and without layer
  fusion, at an even and an odd positional kernel: within 1e-5 absolute;
- ``load_hf_checkpoint`` on a HuggingFace-named state dict the test writes
  (``wav2vec2.`` prefix, unused keys, the weight norm in the legacy and
  the parametrized layout) as ``pytorch_model.bin`` and as
  ``model.safetensors``: the port's state dict equals the JAX loader's
  params converted (the resolved weight norm within 1e-7), and both
  encoders' outputs agree within 1e-5;
- ``ConvEmotionEncoder`` at lengths that are not multiples of the strides
  (Flax's ``SAME`` padding, LayerNorm eps 1e-6, tanh GELU): within 1e-5;
- ``pool_to_fps``, all three methods: within 1e-6; the cache's SHA-1 keys
  and ``PrecomputedEmotionFeatures`` files: equal;
- ``SimplifiedDualStreamModel`` and ``SequentialDualStreamModel`` with
  the in-model encoder: blendshapes within 1e-5 absolute.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.features import emotion2vec as je2v
from koemorph_tpu.features import wav2vec2 as jw2v
from koemorph_tpu.features.emotion import (
    PrecomputedEmotionFeatures as JaxPrecomputed)
from koemorph_tpu.models import dual_stream_model as jdm
from koemorph_tpu_torch.features import emotion2vec as e2v
from koemorph_tpu_torch.features import wav2vec2 as w2v
from koemorph_tpu_torch.features.emotion import (EmotionFrontendConfig,
                                                 PrecomputedEmotionFeatures,
                                                 emotion_features)
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.utils.params import (encoder_state_dict_from_flax,
                                             state_dict_from_flax)

torch.set_num_threads(2)

W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
           intermediate_size=64, conv_dim=(16, 16, 16),
           conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
           num_conv_pos_embedding_groups=4)
HOP = 533


def _audio(shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(tree, seed=1, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, scale, np.shape(x))
                   ).astype(np.float32), tree)


def _encoder_sd(params: dict) -> dict:
    """The port encoder's state dict of a JAX ``Wav2Vec2Encoder`` tree,
    through the model bridge's ``emotion2vec`` subtree (zero fusion
    logits where the tree has none)."""
    tree = dict(params)
    n = sum(k.startswith("layer_") and k[6:].isdigit() for k in tree) + 1
    tree.setdefault("layer_fusion_weights", np.zeros((n,), np.float32))
    return encoder_state_dict_from_flax(tree)


@pytest.mark.parametrize("fusion", [True, False])
@pytest.mark.parametrize("pos_kernel", [16, 15])
def test_encoder_matches_jax(fusion, pos_kernel):
    jcfg = jw2v.Wav2Vec2Config(**W2V, num_conv_pos_embeddings=pos_kernel)
    tcfg = w2v.Wav2Vec2Config(**W2V, num_conv_pos_embeddings=pos_kernel)
    x = _audio((2, 4001))
    jenc = jw2v.Wav2Vec2Encoder(jcfg, use_layer_fusion=fusion)
    params = _perturbed(_np(jax.jit(jenc.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    tenc = w2v.Wav2Vec2Encoder(tcfg, use_layer_fusion=fusion)
    sd = _encoder_sd(params)
    if not fusion:
        sd.pop("layer_fusion_weights")
    tenc.load_state_dict(sd)
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, tcfg.frames(4001), 32)
    assert np.abs(got - want).max() <= 1e-5


def _hf_state_dict(layout: str, seed: int = 3) -> dict:
    """A HuggingFace ``Wav2Vec2ForCTC``-style state dict of the tiny
    config: ``wav2vec2.``-prefixed encoder weights (the positional conv
    weight-normed in ``layout``), a CTC head and a masking vector the
    encoder does not use."""
    cfg = w2v.Wav2Vec2Config(**W2V, num_conv_pos_embeddings=16)
    enc = w2v.Wav2Vec2Encoder(cfg)
    enc.init_random(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in enc.state_dict().items():
        if k == "layer_fusion_weights":
            continue
        v = v.numpy() + rng.normal(0, 0.05, v.shape).astype(np.float32)
        sd[f"wav2vec2.{k}"] = v.astype(np.float32)
    pos = "wav2vec2.encoder.pos_conv_embed.conv"
    w = sd.pop(f"{pos}.weight")
    g = rng.uniform(0.5, 2.0, (1, 1, w.shape[-1])).astype(np.float32)
    names = (("weight_g", "weight_v") if layout == "legacy" else
             ("parametrizations.weight.original0",
              "parametrizations.weight.original1"))
    sd[f"{pos}.{names[0]}"], sd[f"{pos}.{names[1]}"] = g, w
    sd["lm_head.weight"] = rng.normal(0, 1, (8, 32)).astype(np.float32)
    sd["wav2vec2.masked_spec_embed"] = rng.uniform(0, 1, 32).astype(
        np.float32)
    return sd


@pytest.mark.parametrize("layout", ["legacy", "parametrized"])
@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_hf_checkpoint_loads_as_jax(tmp_path, layout, fmt):
    sd = _hf_state_dict(layout)
    hf_cfg = dict(W2V, num_conv_pos_embeddings=16, conv_bias=True,
                  layer_norm_eps=1e-5, conv_dim=list(W2V["conv_dim"]),
                  conv_stride=list(W2V["conv_stride"]),
                  conv_kernel=list(W2V["conv_kernel"]))
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg))
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / "pytorch_model.bin")
    else:
        from safetensors.numpy import save_file
        save_file(sd, str(tmp_path / "model.safetensors"))
    fusion = np.linspace(-1, 1, 3).astype(np.float32)
    jcfg, jparams = jw2v.load_hf_checkpoint(tmp_path,
                                            layer_fusion_weights=fusion)
    tcfg, tsd = w2v.load_hf_checkpoint(tmp_path, layer_fusion_weights=fusion)
    assert tcfg == w2v.Wav2Vec2Config(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    want = _encoder_sd(_np(jparams))
    assert set(tsd) == set(want)
    for k, v in want.items():
        tol = 1e-7 if "pos_conv_embed.conv.weight" in k else 0.0
        np.testing.assert_allclose(tsd[k].numpy(), v.numpy(), atol=tol,
                                   rtol=0, err_msg=k)
    enc = w2v.Wav2Vec2Encoder(tcfg)
    enc.load_state_dict(tsd)
    x = _audio((1, 3200), seed=4)
    jout = np.asarray(jw2v.Wav2Vec2Encoder(jcfg).apply(
        {"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        tout = enc(torch.from_numpy(x)).numpy()
    assert np.abs(tout - jout).max() <= 1e-5


def test_hf_checkpoint_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        (tmp_path / "config.json").write_text(json.dumps(dict(
            W2V, num_conv_pos_embeddings=16)))
        w2v.load_hf_checkpoint(tmp_path)
    sd = _hf_state_dict("legacy")
    del sd["wav2vec2.encoder.layers.1.final_layer_norm.bias"]
    cfg = w2v.Wav2Vec2Config(**W2V, num_conv_pos_embeddings=16)
    with pytest.raises(ValueError, match="final_layer_norm.bias"):
        w2v.hf_state_dict(sd, cfg)
    with pytest.raises(ValueError, match="layer_fusion_weights"):
        w2v.hf_state_dict(_hf_state_dict("legacy"), cfg,
                          layer_fusion_weights=np.zeros(2))


@pytest.mark.parametrize("length", [3203, 4799, 6417])
def test_conv_emotion_encoder_matches_jax(length):
    x = _audio((2, length), seed=length)
    jenc = je2v.ConvEmotionEncoder(embed_dim=48, num_fusion_layers=3)
    params = _perturbed(_np(jax.jit(jenc.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"]))
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    tenc = e2v.ConvEmotionEncoder(embed_dim=48, num_fusion_layers=3)
    sd = {"proj.weight": params["proj"]["kernel"].T,
          "proj.bias": params["proj"]["bias"],
          "layer_fusion_weights": params["layer_fusion_weights"]}
    for i in range(7):
        sd[f"conv_{i}.weight"] = np.transpose(params[f"conv_{i}"]["kernel"],
                                              (2, 1, 0))
        sd[f"conv_{i}.bias"] = params[f"conv_{i}"]["bias"]
        sd[f"norm_{i}.weight"] = params[f"norm_{i}"]["scale"]
        sd[f"norm_{i}.bias"] = params[f"norm_{i}"]["bias"]
    for i in range(3):
        sd[f"ff_{i}.weight"] = params[f"ff_{i}"]["kernel"].T
        sd[f"ff_{i}.bias"] = params[f"ff_{i}"]["bias"]
        sd[f"lnorm_{i}.weight"] = params[f"lnorm_{i}"]["scale"]
        sd[f"lnorm_{i}.bias"] = params[f"lnorm_{i}"]["bias"]
    tenc.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()})
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("method", ["adaptive", "linear", "conv"])
@pytest.mark.parametrize("t_in,audio_len", [(50, 16000), (37, 11000),
                                            (8, 32000)])
def test_pool_to_fps_matches_jax(method, t_in, audio_len):
    f = _audio((2, t_in, 6), seed=t_in, scale=1.0)
    want = np.asarray(je2v.pool_to_fps(jnp.asarray(f), audio_len, 16000,
                                       30.0, method))
    got = e2v.pool_to_fps(torch.from_numpy(f), audio_len, 16000, 30.0,
                          method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        e2v.utterance_embedding(torch.from_numpy(f)).numpy(),
        np.asarray(je2v.utterance_embedding(jnp.asarray(f))), atol=1e-6)
    with pytest.raises(ValueError):
        e2v.pool_to_fps(torch.from_numpy(f), audio_len, 16000, 30.0, "max")


def test_cache_keys_and_precomputed_files(tmp_path):
    a = _audio((8000,), seed=7)
    b = a.copy()
    b[100] += 1e-3
    for x in (a, b, a.astype(np.float64), a[::2]):
        assert (e2v.Emotion2VecCache.compute_audio_hash(x)
                == je2v.Emotion2VecCache.compute_audio_hash(x))
    cache = e2v.Emotion2VecCache(max_size=1)
    assert cache.get(a) is None
    cache.put(a, np.ones(4))
    assert cache.get(a) is not None
    cache.put(b, np.zeros(4))
    assert cache.get(a) is None and len(cache) == 1
    assert cache.stats() == {"size": 1, "hits": 1, "misses": 2,
                             "hit_rate": 1 / 3}
    feats = _audio((5, 1024), seed=8, scale=1.0)
    path = PrecomputedEmotionFeatures.save(tmp_path, a, feats)
    assert path == JaxPrecomputed.save(tmp_path / "jax", a, feats).parents[
        1] / path.name
    np.testing.assert_array_equal(
        PrecomputedEmotionFeatures(tmp_path).lookup(a),
        JaxPrecomputed(tmp_path).lookup(a))
    with pytest.raises(KeyError):
        PrecomputedEmotionFeatures(tmp_path).lookup(b)
    with pytest.raises(FileNotFoundError):
        PrecomputedEmotionFeatures(tmp_path / "missing")


def test_emotion_config_emotion2vec():
    cfg = EmotionFrontendConfig(backend="emotion2vec")
    assert cfg.feature_dim == 1024
    with pytest.raises(ValueError, match="through the model"):
        emotion_features(torch.zeros(16000), cfg)
    with pytest.raises(ValueError):
        EmotionFrontendConfig(backend="opensmile")


SMALL = dict(d_model=32, num_heads=2, mel_sequence_length=16)
W2V_MODEL = dict(W2V, num_conv_pos_embeddings=16)


def _model_params(jm, x):
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return _perturbed(_np(params["params"]))


@pytest.mark.parametrize("kind", ["simplified", "sequential"])
def test_models_match_jax(kind):
    jcfg = jw2v.Wav2Vec2Config(**W2V_MODEL)
    tcfg = w2v.Wav2Vec2Config(**W2V_MODEL)
    common = dict(SMALL, emotion_backend="emotion2vec", dropout=0.0)
    if kind == "simplified":
        x = _audio((2, 16 * HOP), seed=11)
        jm = jdm.SimplifiedDualStreamModel(**common,
                                           emotion2vec_config=jcfg)
        tm = dm.SimplifiedDualStreamModel(**common, emotion2vec_config=tcfg)
    else:
        x = _audio((2, 40 * HOP), seed=12)
        jm = jdm.SequentialDualStreamModel(**common, emotion2vec_config=jcfg,
                                           stride_frames=4)
        tm = dm.SequentialDualStreamModel(**common, emotion2vec_config=tcfg,
                                          stride_frames=4)
    params = _model_params(jm, x)
    sd = state_dict_from_flax(params)
    assert any(k.startswith("emotion2vec.encoder.layers.1.") for k in sd)
    tm.load_state_dict(sd)
    tm.eval()
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        raw = tm.emotion_raw(torch.from_numpy(x)).numpy()
    assert raw.shape == (2, 32)
    np.testing.assert_allclose(
        raw, np.asarray(jw2v.Wav2Vec2Encoder(jcfg).apply(
            {"params": params["emotion2vec"]}, jnp.asarray(x)).mean(-2)),
        atol=1e-5, rtol=0)
    g, w = got["blendshapes"].numpy(), np.asarray(want["blendshapes"])
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= 1e-5
    assert tm.emotion_projection.in_features == 32


def test_init_random_follows_flax():
    """Flax's initializers: LeCun normal kernels (fan-in over the kernel
    and a group's inputs), zero biases, unit scales, zero fusion logits;
    the attention's draws are those of a model without the encoder."""
    cfg = w2v.Wav2Vec2Config(**W2V_MODEL)
    m = dm.StreamingDualStreamModel(d_model=32, num_heads=2,
                                    window_frames=16,
                                    emotion_backend="emotion2vec",
                                    emotion2vec_config=cfg)
    m.init_random(torch.Generator().manual_seed(0))
    ref = dm.StreamingDualStreamModel(d_model=32, num_heads=2,
                                      window_frames=16, emotion_raw_dim=32)
    ref.init_random(torch.Generator().manual_seed(0))
    for k, v in ref.state_dict().items():
        assert torch.equal(m.state_dict()[k], v), k
    enc = m.emotion2vec
    pos = enc.encoder.pos_conv_embed.conv.weight.detach()
    fan_in = pos.shape[1] * pos.shape[2]
    assert abs(float(pos.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(pos.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert all(float(p.abs().max()) == 0 for n, p in enc.named_parameters()
               if n.endswith(".bias") or n == "layer_fusion_weights")
    assert all(torch.equal(mod.weight, torch.ones_like(mod.weight))
               for mod in enc.modules()
               if isinstance(mod, torch.nn.LayerNorm))
