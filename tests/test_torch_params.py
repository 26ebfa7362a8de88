"""PyTorch port: Flax <-> state_dict converter and the decoder core.

The decoder core (emotion projection, dual-stream cross-attention, EMA)
is held against the Flax modules on the same converted parameters at
1e-5 absolute, the weight-transplant bar of the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models.dual_stream import (
    DualStreamCrossAttention as JaxDualStream)
from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel, TemporalState as JaxTemporalState)
from koemorph_tpu.models.dual_stream_model import _ema_step as jax_ema_step
from koemorph_tpu_torch.models.dual_stream_model import (
    StreamingDualStreamModel, TemporalState, _ema_step)
from koemorph_tpu_torch.utils.params import (flax_from_state_dict,
                                             state_dict_from_flax)

torch.set_num_threads(2)

D, HEADS, W = 32, 2, 16


@functools.lru_cache(maxsize=2)
def _init_params(learnable: bool):
    model = SimplifiedDualStreamModel(
        d_model=D, num_heads=HEADS, mel_sequence_length=W,
        emotion_backend="precomputed", use_learnable_weights=learnable,
        dropout=0.0)
    return jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, W * 533)),
        JaxTemporalState.create(1),
        emotion_features_raw=jnp.zeros((1, 264)))["params"]


def flax_params(seed: int = 0, learnable: bool = True):
    """The parameter tree ``SimplifiedDualStreamModel.init`` produces, every
    leaf moved off its initializer (nonzero biases, non-unit norms)."""
    params = _init_params(learnable)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x)
                   + rng.normal(0, 0.05, np.shape(x))).astype(np.float32),
        params)


def torch_model(params, learnable: bool = True):
    model = StreamingDualStreamModel(d_model=D, num_heads=HEADS,
                                     window_frames=W, emotion_raw_dim=264,
                                     use_learnable_weights=learnable)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval()


class TestConverter:
    def test_round_trip_is_bit_exact(self):
        params = flax_params(1)
        back = flax_from_state_dict(torch_model(params).state_dict())
        want = jax.tree_util.tree_leaves_with_path(params)
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                          err_msg=str(path))

    def test_layout(self):
        sd = state_dict_from_flax(flax_params(2))
        att = flax_params(2)["dual_stream_attention"]
        np.testing.assert_array_equal(
            sd["dual_stream_attention.blendshape_decoder.3.weight"].numpy(),
            np.asarray(att["decoder_out"]["kernel"]).T)
        np.testing.assert_array_equal(
            sd["dual_stream_attention.mel_norm.weight"].numpy(),
            np.asarray(att["mel_norm"]["scale"]))
        assert sd["smoothing_alpha"].shape == ()
        assert all(v.dtype == torch.float32 for v in sd.values())


class TestDecoderCore:
    @pytest.mark.parametrize("learnable", [True, False])
    def test_matches_flax(self, learnable):
        """Projection + attention + two EMA steps at <= 1e-5 absolute."""
        params = flax_params(3, learnable)
        model = torch_model(params, learnable)
        rng = np.random.default_rng(3)
        mel = rng.uniform(0, 1, (2, W, 80)).astype(np.float32)
        detail = rng.uniform(0, 1, (2, 3, 80)).astype(np.float32)
        raw = rng.normal(0, 5, (2, 264)).astype(np.float32)

        att = JaxDualStream(d_model=D, num_heads=HEADS, num_mel_channels=80,
                            mel_sequence_length=W, emotion_dim=D,
                            dropout=0.0, use_learnable_weights=learnable)
        proj = params["emotion_projection"]
        emo = raw @ proj["kernel"] + proj["bias"]
        want = np.asarray(att.apply(
            {"params": params["dual_stream_attention"]}, jnp.asarray(mel),
            jnp.asarray(detail), jnp.asarray(emo))["blendshapes"])
        with torch.no_grad():
            got = model(torch.from_numpy(mel), torch.from_numpy(detail),
                        torch.from_numpy(raw)).numpy()
        assert np.abs(got - want).max() <= 1e-5

        alpha_j = jax.nn.sigmoid(params["smoothing_alpha"])
        js, ts = JaxTemporalState.create(2), TemporalState.create(2)
        for frame in (want, want[::-1] * 0.5):
            jo, js = jax_ema_step(jnp.asarray(frame), js, alpha_j)
            to, ts = _ema_step(torch.from_numpy(frame.copy()), ts,
                               model.alpha().detach())
            assert np.abs(to.numpy() - np.asarray(jo)).max() <= 1e-5
        assert bool(ts.initialized.all())

    def test_layernorm_eps_is_flax(self):
        model = torch_model(flax_params(0))
        eps = {m.eps for m in model.modules()
               if isinstance(m, torch.nn.LayerNorm)}
        assert eps == {1e-6}


class TestRandomInit:
    def test_generator_seeds_the_weights(self):
        def weights(seed):
            m = StreamingDualStreamModel(d_model=D, num_heads=HEADS,
                                         window_frames=W)
            m.init_random(torch.Generator().manual_seed(seed))
            return torch.cat([p.detach().reshape(-1)
                              for p in m.parameters()])

        a, b, c = weights(0), weights(0), weights(1)
        assert torch.equal(a, b)
        assert not torch.equal(a, c)
        assert torch.isfinite(a).all()

    def test_initializer_scales(self):
        m = StreamingDualStreamModel(d_model=D, num_heads=HEADS,
                                     window_frames=W)
        m.init_random(torch.Generator().manual_seed(0))
        att = m.dual_stream_attention
        w = m.emotion_projection.weight.detach()
        # LeCun normal truncated at 2 std: std 1/sqrt(fan_in)
        assert abs(float(w.std()) * np.sqrt(264) - 1.0) < 0.1
        assert float(w.abs().max()) <= 2.0 / np.sqrt(264) / 0.8796 + 1e-6
        assert float(att.mouth_queries.detach().std()) == pytest.approx(
            0.02, rel=0.2)
        assert float(m.alpha().detach()) == pytest.approx(1 / (1 + np.exp(-0.8)))
        assert float(att.mel_weights.detach().max()) == 2.0
