"""PyTorch port: the legacy model family's modules against the JAX
package.

On the same numpy inputs made from a seed and the same parameters (JAX's
initialization moved off its initializers, carried across by
``utils/params.py``):

- ``TemporalSmoother``, each method, learnable or not, carried over 6
  steps (median windows 4 and 5), and ``BlendshapeConstraints`` with and
  without a state, violations included: within 1e-6;
- ``BlendshapeDecoder``, each activation and output activation, with and
  without ``prev_blendshapes``: within 1e-5;
- the causal, window and combined masks: equal to JAX's arrays;
- ``MultiHeadCrossAttention`` with the causal, window and key padding
  masks, whose 52 queries over 200 keys leave rows with every key masked:
  within 1e-5 and no NaN (such a row is uniform, as in JAX);
  ``TorchStyleMHA`` with a key padding mask;
- ``TransformerEncoderLayer``, ``MultiStreamAudioEncoder`` (concat, add,
  gate), ``BlendshapeQueryEmbedding``, ``PositionalEncoding`` and
  ``DualStreamEncoder``: within 1e-5.

The models and the bridge: ``tests/test_torch_legacy_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models import attention as jatt
from koemorph_tpu.models import decoder as jdec
from koemorph_tpu.models.dual_stream import DualStreamEncoder as JaxDSE
from koemorph_tpu_torch.models import attention as tatt
from koemorph_tpu_torch.models import decoder as tdec
from koemorph_tpu_torch.models.dual_stream import DualStreamEncoder
from koemorph_tpu_torch.utils import params as bridge

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


#: each module's pairs in the parameter bridge (Flax path, state-dict
#: name, kind), for converting its tree alone
PAIRS = {tdec.TemporalSmoother: bridge._smoother_pairs,
         tdec.BlendshapeDecoder: bridge._decoder_pairs,
         tatt.MultiHeadCrossAttention: bridge._cross_attention_pairs,
         tatt.TransformerEncoderLayer: bridge._transformer_layer_pairs,
         tatt.MultiStreamAudioEncoder: bridge._multistream_encoder_pairs,
         tatt.BlendshapeQueryEmbedding: bridge._query_embedding_pairs,
         DualStreamEncoder: bridge._dual_stream_encoder_pairs}


def _load(module, params):
    sd = bridge._module_state_dict(params, PAIRS[type(module)])
    module.load_state_dict(sd, strict=True)
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
# smoother and constraints
# ---------------------------------------------------------------------------

SMOOTHERS = [("exponential", False, 5), ("exponential", True, 5),
             ("gaussian", False, 5), ("gaussian", True, 5),
             ("median", False, 4), ("median", False, 5)]


@pytest.mark.parametrize("method,learnable,window", SMOOTHERS)
def test_temporal_smoother_matches_jax(method, learnable, window):
    kw = dict(smoothing_method=method, alpha=0.7, window_size=window,
              learnable=learnable)
    jm = jdec.TemporalSmoother(**kw)
    tm = tdec.TemporalSmoother(**kw)
    jstate = jdec.SmootherState.create(3, 52, window)
    tstate = tdec.SmootherState.create(3, 52, window)
    frames = [_rand(3, 52, seed=s) for s in range(6)]
    params = {}
    if learnable:
        params = _init(jm, jnp.asarray(frames[0]), jstate, seed=1,
                       scale=0.3)
        _load(tm, params)
    for x in frames:
        jout, jstate = jm.apply({"params": params}, jnp.asarray(x), jstate)
        tout, tstate = tm(_t(x), tstate)
        _close(tout, jout, 1e-6)
        _close(tstate.prev_output, jstate.prev_output, 1e-6)
        _close(tstate.history, jstate.history, 1e-6)
        assert int(tstate.history_ptr) == int(jstate.history_ptr)
        assert tstate.history_ptr.dtype == torch.int32


@pytest.mark.parametrize("with_state", [False, True])
def test_constraints_match_jax(with_state):
    kw = dict(mutual_exclusions=((25, 26), (20, 21), (3, 40)))
    jm = jdec.BlendshapeConstraints(**kw)
    tm = tdec.BlendshapeConstraints(**kw)
    jstate = jdec.ConstraintState.create(4) if with_state else None
    tstate = tdec.ConstraintState.create(4) if with_state else None
    for step in range(3):
        x = _rand(4, 52, seed=10 + step, lo=-0.3, hi=1.3)
        for apply in (True, False):
            jout = jm.apply({}, jnp.asarray(x), jstate,
                            apply_constraints=apply, return_violations=True)
            tout = tm(_t(x), tstate, apply_constraints=apply,
                      return_violations=True)
            assert len(tout) == len(jout) == (3 if with_state else 2)
            _close(tout[0], jout[0], 1e-6)
            assert sorted(tout[1]) == sorted(jout[1])
            for k, v in jout[1].items():
                _close(tout[1][k], v, 1e-6)
        if with_state:
            jstate, tstate = jout[2], tout[2]
            _close(tstate.prev_blendshapes, jstate.prev_blendshapes, 0)
            assert bool(tstate.valid) == bool(jstate.valid)
    # no violation report unless asked for
    assert tm(_t(x), tstate)[1] is None


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation,output", [
    ("gelu", "sigmoid"), ("relu", "sigmoid"), ("swish", "sigmoid"),
    ("leaky_relu", "sigmoid"), ("gelu", "tanh"), ("gelu", "none")])
def test_decoder_matches_jax(activation, output):
    kw = dict(d_model=32, hidden_dim=24, num_layers=2,
              activation=activation, output_activation=output, dropout=0.0)
    x = _rand(3, 52, 32, seed=2, lo=-1, hi=1)
    prev = _rand(3, 52, seed=3)
    jm = jdec.BlendshapeDecoder(**kw)
    params = _init(jm, jnp.asarray(x), jnp.asarray(prev), seed=4)
    tm = _load(tdec.BlendshapeDecoder(**kw), params)
    for p in (None, prev):
        want = jm.apply({"params": params}, jnp.asarray(x),
                        None if p is None else jnp.asarray(p))
        with torch.no_grad():
            got = tm(_t(x), None if p is None else _t(p))
        _close(got, want, 1e-5)


def test_validate_blendshape_output_matches_jax():
    for x in (_rand(6, 52, seed=5), _rand(4, 52, seed=6, lo=-0.5, hi=1.5),
              np.zeros((3, 52), np.float32), _rand(2, 51, seed=7)):
        want = jdec.validate_blendshape_output(x)
        assert tdec.validate_blendshape_output(_t(x)) == want


# ---------------------------------------------------------------------------
# masks and attention
# ---------------------------------------------------------------------------

def test_masks_equal_jax():
    for q, k, w in ((52, 200, 30), (52, 24, 6), (7, 7, 3), (1, 5, 2),
                    (10, 3, 1)):
        np.testing.assert_array_equal(tatt.causal_mask(q, k),
                                      jatt.causal_mask(q, k))
        np.testing.assert_array_equal(tatt.window_mask(q, k, w),
                                      jatt.window_mask(q, k, w))
    for n, w, causal in ((9, None, True), (9, 3, False), (12, 4, True),
                         (5, None, False)):
        np.testing.assert_array_equal(
            tatt.create_attention_mask(n, w, causal),
            jatt.create_attention_mask(n, w, causal))


def test_cross_attention_matches_jax_with_masked_rows():
    b, q_len, t = 3, 52, 200
    kw = dict(d_query=16, d_key=24, d_value=20, d_model=32, num_heads=4,
              dropout=0.0, causal=True, window_size=4, temperature=1.5)
    query = _rand(b, q_len, 16, seed=8, lo=-1, hi=1)
    key = _rand(b, t, 24, seed=9, lo=-1, hi=1)
    value = _rand(b, t, 20, seed=10, lo=-1, hi=1)
    pad = np.ones((b, t), bool)
    pad[1, 150:] = False
    pad[2, :] = False                  # every key of the row masked
    attn_mask = np.zeros((q_len, t), bool)
    attn_mask[:, 3] = True
    jm = jatt.MultiHeadCrossAttention(**kw)
    params = _init(jm, jnp.asarray(query), jnp.asarray(key),
                   jnp.asarray(value), seed=11)
    tm = _load(tatt.MultiHeadCrossAttention(**kw), params)
    jout, jw = jm.apply({"params": params}, jnp.asarray(query),
                        jnp.asarray(key), jnp.asarray(value),
                        key_padding_mask=jnp.asarray(pad),
                        attn_mask=jnp.asarray(attn_mask),
                        return_attention=True)
    with torch.no_grad():
        tout, tw = tm(_t(query), _t(key), _t(value),
                      key_padding_mask=_t(pad), attn_mask=_t(attn_mask),
                      return_attention=True)
    assert torch.isfinite(tout).all() and torch.isfinite(tw).all()
    # rows with every key masked exist (causal + window, and the padded
    # row) and come out uniform
    empty = (np.asarray(jw) == np.asarray(jw)[..., :1]).all(-1)
    assert empty.any() and empty[2].all()
    _close(tw, jw, 1e-5)
    _close(tout, jout, 1e-5)
    assert tm(_t(query), _t(key), _t(value))[1] is None


def test_torch_style_mha_key_padding_matches_jax():
    e, h = 16, 2
    x = _rand(2, 9, e, seed=12, lo=-1, hi=1)
    pad = np.ones((2, 9), bool)
    pad[0, 5:] = False
    jm = jatt.TorchStyleMHA(e, h)
    params = _init(jm, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                   seed=13)
    tm = tatt.TorchStyleMHA(e, h)
    tm.load_state_dict({"in_proj_weight": _t(params["in_proj_weight"]),
                        "in_proj_bias": _t(params["in_proj_bias"]),
                        "out_proj.weight": _t(params["out_proj"]["kernel"].T),
                        "out_proj.bias": _t(params["out_proj"]["bias"])})
    want, wweights = jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(x), jnp.asarray(x),
                              key_padding_mask=jnp.asarray(pad),
                              need_weights=True)
    with torch.no_grad():
        got, weights = tm(_t(x), _t(x), _t(x), need_weights=True,
                          key_padding_mask=_t(pad))
    _close(got, want, 1e-5)
    _close(weights, wweights, 1e-6)


# ---------------------------------------------------------------------------
# encoders and queries
# ---------------------------------------------------------------------------

def _encoder_case(name):
    """(JAX module, port module, inputs as numpy, keyword arguments)."""
    d, t = 32, 11
    pad = np.ones((2, t), bool)
    pad[1, 8:] = False
    if name == "transformer_layer":
        return (jatt.TransformerEncoderLayer(d, num_heads=4,
                                             dim_feedforward=48,
                                             dropout=0.0),
                tatt.TransformerEncoderLayer(d, num_heads=4,
                                             dim_feedforward=48,
                                             dropout=0.0),
                (_rand(2, t, d, seed=14, lo=-1, hi=1),),
                {"key_padding_mask": pad})
    if name.startswith("multistream"):
        kw = dict(mel_dim=10, prosody_dim=4, emotion_dim=12, d_model=d,
                  num_layers=2, dropout=0.0,
                  fusion_method=name.split("_")[1])
        return (jatt.MultiStreamAudioEncoder(**kw),
                tatt.MultiStreamAudioEncoder(**kw),
                (_rand(2, t, 10, seed=15), _rand(2, t, 4, seed=16),
                 _rand(2, t, 12, seed=17)), {"mask": pad})
    if name == "dual_stream_encoder":
        kw = dict(mel_dim=10, emotion_dim=12, d_model=d, num_layers=2,
                  dropout=0.0)
        return (JaxDSE(**kw), DualStreamEncoder(**kw),
                (_rand(2, t, 10, seed=18), _rand(2, t, 12, seed=19)),
                {"mel_mask": pad, "emotion_mask": pad[::-1].copy()})
    raise KeyError(name)


@pytest.mark.parametrize("name", ["transformer_layer", "multistream_concat",
                                  "multistream_add", "multistream_gate",
                                  "dual_stream_encoder"])
def test_encoders_match_jax(name):
    jm, tm, inputs, kw = _encoder_case(name)
    jin = [jnp.asarray(x) for x in inputs]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = _init(jm, *jin, seed=20, **jkw)
    _load(tm, params)
    want = jm.apply({"params": params}, *jin, **jkw)
    with torch.no_grad():
        got = tm(*[_t(x) for x in inputs], **{k: _t(v)
                                             for k, v in kw.items()})
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        _close(g, w, 1e-5)


def test_query_embedding_matches_jax():
    jm = jatt.BlendshapeQueryEmbedding(d_query=16, dropout=0.0)
    tm = tatt.BlendshapeQueryEmbedding(d_query=16, dropout=0.0)
    prev = _rand(3, 52, seed=21)
    params = _init(jm, 3, jnp.asarray(prev), seed=22)
    _load(tm, params)
    for p in (None, prev):
        want = jm.apply({"params": params}, 3,
                        None if p is None else jnp.asarray(p))
        with torch.no_grad():
            got = tm(3, None if p is None else _t(p))
        _close(got, want, 1e-5)


def test_positional_encoding_matches_jax():
    x = _rand(2, 17, 24, seed=23)
    want = jatt.PositionalEncoding(24, dropout=0.0).apply({}, jnp.asarray(x))
    _close(tatt.PositionalEncoding(24, dropout=0.0)(_t(x)), want, 1e-6)
