"""PyTorch port: the legacy models against the JAX package.

On the same numpy inputs made from a seed and the same parameters (JAX's
initialization moved off its initializers, carried across by
``utils/params.py``):

- ``KoeMorphModel`` over 5 carried steps with ``return_attention``, a key
  padding mask and the previous frame, for each smoothing method: within
  1e-5;
- ``SimplifiedKoeMorphModel`` on 1 s of audio at flagship width (d_model
  256, 8 heads, 80 mels): within 1e-5. The port takes the plain form of
  the ``logmel`` kernel on the CPU; JAX its XLA frontend.

The bridge: both models' trees round-trip bit for bit, under the port's
names, and a name no rule maps raises. The modules one by one:
``tests/test_torch_legacy_modules.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models.legacy import KoeMorphModel as JaxKoeMorph
from koemorph_tpu.models.legacy import KoeMorphModelState as JaxState
from koemorph_tpu.models.simplified import (
    SimplifiedKoeMorphModel as JaxSimplified)
from koemorph_tpu_torch.models import (KoeMorphModelState,
                                       SimplifiedKoeMorphModel,
                                       create_koemorph_model)
from koemorph_tpu_torch.utils.params import (flax_from_state_dict,
                                             state_dict_from_flax)

torch.set_num_threads(2)


def _moved(params, seed=0, scale=0.05):
    """JAX parameters as numpy, every leaf moved off its initializer."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, scale, np.shape(x))
                   ).astype(np.float32), params)


def _init(module, *args, seed=0, scale=0.05, **kw):
    params = module.init(jax.random.PRNGKey(seed), *args, **kw)["params"]
    return _moved(params, seed, scale)


def _load(module, params):
    module.load_state_dict(state_dict_from_flax(params), strict=True)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _rand(*shape, seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

LEGACY = dict(mel_dim=16, emotion_dim=12, d_model=32, d_query=16,
              num_heads=4, num_encoder_layers=1, num_attention_layers=2,
              decoder_hidden_dim=24, decoder_layers=2, causal=True,
              window_size=6, attention_dropout=0.0, dropout=0.0,
              smoothing_alpha=0.6)


@functools.lru_cache(maxsize=4)
def _legacy_params(method: str):
    jm = JaxKoeMorph(smoothing_method=method, **LEGACY)
    mel = jnp.zeros((2, 20, 16))
    emo = jnp.zeros((2, 20, 12))
    return _init(jm, mel, emo, JaxState.create(2), seed=24)


@pytest.mark.parametrize("method", ["exponential", "gaussian", "median"])
def test_koemorph_model_matches_jax_over_carried_steps(method):
    jm = JaxKoeMorph(smoothing_method=method, **LEGACY)
    params = _legacy_params(method)
    tm = _load(create_koemorph_model(dict(LEGACY, smoothing_method=method)),
               params)
    jstate = JaxState.create(2)
    tstate = KoeMorphModelState.create(2)
    apply = jax.jit(lambda p, mel, emo, st, mask, prev: jm.apply(
        {"params": p}, mel, emo, st, audio_mask=mask,
        prev_blendshapes=prev, return_attention=True))
    prev = None
    for step in range(5):
        mel = _rand(2, 20, 16, seed=30 + step)
        emo = _rand(2, 20, 12, seed=40 + step, lo=-1, hi=1)
        mask = np.ones((2, 20), bool)
        mask[1, 14 + step:] = False
        jout, jstate = apply(params, jnp.asarray(mel), jnp.asarray(emo),
                             jstate, jnp.asarray(mask),
                             None if prev is None else jnp.asarray(prev))
        with torch.no_grad():
            tout, tstate = tm(_t(mel), _t(emo), tstate, audio_mask=_t(mask),
                              prev_blendshapes=None if prev is None
                              else _t(prev), return_attention=True)
        _close(tout["raw_blendshapes"], jout["raw_blendshapes"], 1e-5)
        _close(tout["blendshapes"], jout["blendshapes"], 1e-5)
        assert len(tout["attention_weights"]) == 2
        for g, w in zip(tout["attention_weights"], jout["attention_weights"]):
            _close(g, w, 1e-5)
        _close(tstate.smoother.history, jstate.smoother.history, 1e-5)
        _close(tstate.smoother.prev_output, jstate.smoother.prev_output,
               1e-5)
        assert int(tstate.smoother.history_ptr) == int(
            jstate.smoother.history_ptr)
        prev = np.asarray(jout["blendshapes"])
    b = tout["blendshapes"]
    assert ((b >= 0) & (b <= 1)).all()
    # without a state: no smoothing, the constraints alone
    jout, none = jm.apply({"params": params}, jnp.asarray(mel),
                          jnp.asarray(emo))
    with torch.no_grad():
        tout, tnone = tm(_t(mel), _t(emo))
    assert none is None and tnone is None and \
        "attention_weights" not in tout
    _close(tout["blendshapes"], jout["blendshapes"], 1e-5)


def test_simplified_model_matches_jax_at_flagship_width():
    jm = JaxSimplified(d_model=256, num_heads=8, dropout=0.0)
    rng = np.random.default_rng(25)
    t = np.arange(16000) / 16000
    audio = np.stack([0.4 * np.sin(2 * np.pi * 180 * t),
                      0.2 * np.sin(2 * np.pi * 310 * t)]).astype(np.float32)
    audio += 0.01 * rng.standard_normal(audio.shape).astype(np.float32)
    params = _init(jm, jnp.zeros((1, 16000)), seed=26)
    tm = _load(SimplifiedKoeMorphModel(d_model=256, num_heads=8,
                                       dropout=0.0), params)
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(
        params, jnp.asarray(audio))
    with torch.no_grad():
        got = tm(_t(audio))
    assert got.shape == (2, 52)
    _close(got, want, 1e-5)
    # mel features given directly skip the frontend
    mel = _rand(2, 31, 80, seed=27)
    with torch.no_grad():
        got = tm(mel_features=_t(mel))
    _close(got, jm.apply({"params": params}, mel_features=jnp.asarray(mel)),
           1e-5)


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def _simplified_params():
    jm = JaxSimplified(d_model=32, num_heads=2, decoder_hidden=16)
    return _init(jm, mel_features=jnp.zeros((1, 8, 80)), seed=28)


@pytest.mark.parametrize("which", ["simplified", "legacy"])
def test_bridge_round_trip_and_names(which):
    params = (_simplified_params() if which == "simplified"
              else _legacy_params("exponential"))
    sd = state_dict_from_flax(params)
    model = (SimplifiedKoeMorphModel(d_model=32, num_heads=2,
                                     decoder_hidden=16)
             if which == "simplified"
             else create_koemorph_model(LEGACY))
    assert sorted(sd) == sorted(model.state_dict())
    back = flax_from_state_dict(sd)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    if which == "legacy":
        layer = sd["audio_encoder.mel_layer_0.linear1.weight"]
        np.testing.assert_array_equal(
            layer.numpy(),
            params["audio_encoder"]["mel_layer_0"]["Dense_0"]["kernel"].T)
        assert "query_embeddings.cond_hidden.weight" in sd
        assert sd["temporal_smoother.alpha"].shape == ()
    # a name no rule maps raises, in both directions
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        state_dict_from_flax(extra)
    with pytest.raises(ValueError, match="stray"):
        flax_from_state_dict(dict(sd, **{"stray.weight": torch.zeros(2)}))
