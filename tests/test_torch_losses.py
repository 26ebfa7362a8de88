"""PyTorch port: the losses, metrics and the ``basic`` emotion features
against the JAX package, on the same numpy inputs.

- Every loss term and metric value at rtol 1e-6 (atol 1e-7 for values
  that are near 0 by construction); the gradient of each total loss with
  respect to the prediction at rtol 1e-5, with an absolute floor of 1e-5
  of the largest gradient element.
- The host accumulators (``BlendshapeMetrics``,
  ``compute_lip_sync_metrics``) equal.
- ``basic_emotion_features`` at rtol 1e-5, except the two columns whose
  value is a small difference of large terms: ``f0_std`` within 1e-4 Hz
  (YIN's refined periods agree to ~1e-7 relative, and the std of a
  150 Hz contour with ~0.2 Hz spread carries that) and the clip mean within
  1e-8 (a sum of 32,000 terms near zero).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.features.basic import basic_emotion_features as jax_basic
from koemorph_tpu.features.emotion import EmotionFrontendConfig as JCfg
from koemorph_tpu.features.emotion import emotion_features as jax_emotion
from koemorph_tpu.models import losses as jl
from koemorph_tpu_torch.features.basic import basic_emotion_features
from koemorph_tpu_torch.features.emotion import (EmotionFrontendConfig,
                                                 emotion_features)
from koemorph_tpu_torch.models import losses as tl

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
GRAD_RTOL = 1e-5


def _frames(b=6, seed=0, t=None):
    rng = np.random.default_rng(seed)
    shape = (b, 52) if t is None else (b, t, 52)
    pred = rng.uniform(0, 0.3, shape).astype(np.float32)
    target = rng.uniform(0, 0.3, shape).astype(np.float32)
    # a few active channels, so the thresholded metrics are not trivial
    target[..., 12:16] += 0.4
    pred[..., 14:18] += 0.35
    return pred, target


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _compare(jfn, tfn, inputs, grad_arg=0):
    """Values of every metric and the total, and the gradient of the total
    with respect to input ``grad_arg``."""
    j_total, j_metrics = jfn(*[jnp.asarray(x) for x in inputs])
    t_in = [torch.from_numpy(x.copy()) for x in inputs]
    t_in[grad_arg].requires_grad_(True)
    t_total, t_metrics = tfn(*t_in)
    _close(float(t_total.detach()), float(j_total), "total")
    assert sorted(t_metrics) == sorted(j_metrics)
    for k in j_metrics:
        _close(float(t_metrics[k]), float(j_metrics[k]), k)

    def jax_total(x):
        args = [jnp.asarray(v) for v in inputs]
        args[grad_arg] = x
        return jfn(*args)[0]

    j_grad = np.asarray(jax.grad(jax_total)(jnp.asarray(inputs[grad_arg])))
    (t_grad,) = torch.autograd.grad(t_total, t_in[grad_arg])
    np.testing.assert_allclose(t_grad.numpy(), j_grad, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(j_grad).max())


CONFIGS = {
    "default": {},
    "active_weight": dict(active_weight=3.0, active_threshold=0.2),
    "reconstruction_only": dict(perceptual_weight=0.0, sparsity_weight=0.0,
                                smoothness_weight=0.0, landmark_weight=0.0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("extras", ["none", "prev", "audio2d", "audio3d"])
def test_koemorph_loss(name, extras):
    pred, target = _frames()
    prev_p, prev_t = _frames(seed=1)
    rng = np.random.default_rng(2)
    audio2 = rng.standard_normal((6, 80)).astype(np.float32)
    audio3 = rng.standard_normal((6, 5, 80)).astype(np.float32)
    jcfg = jl.KoeMorphLossConfig(**CONFIGS[name])
    tcfg = tl.KoeMorphLossConfig(**CONFIGS[name])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    inputs = [pred, target]
    kw_names = []
    if extras == "prev":
        inputs += [prev_p, prev_t]
        kw_names = ["prev_pred", "prev_target"]
    elif extras.startswith("audio"):
        inputs.append(audio2 if extras == "audio2d" else audio3)
        kw_names = ["audio_features"]

    def call(mod, cfg):
        return lambda p, t, *rest: mod.koemorph_loss(
            p, t, config=cfg, **dict(zip(kw_names, rest)))

    _compare(call(jl, jcfg), call(tl, tcfg), inputs)


@pytest.mark.parametrize("weights", [dict(), dict(temporal_weight=0.3,
                                                  velocity_weight=0.2),
                                     dict(velocity_weight=0.1,
                                          temporal_weight=0.0)])
def test_sequence_loss(weights):
    pred, target = _frames(b=3, t=7)
    jcfg = jl.KoeMorphLossConfig(**weights)
    tcfg = tl.KoeMorphLossConfig(**weights)
    _compare(lambda p, t: jl.sequence_koemorph_loss(p, t, config=jcfg),
             lambda p, t: tl.sequence_koemorph_loss(p, t, config=tcfg),
             [pred, target])


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("grad_arg", [0, 2])
def test_dual_stream_loss(with_prev, grad_arg):
    """Gradients with respect to the prediction and the mel stream
    weights (the separation regularizer)."""
    pred, target = _frames()
    prev_p, prev_t = _frames(seed=3)
    rng = np.random.default_rng(4)
    mel_w = rng.normal(1.0, 0.5, 52).astype(np.float32)
    emo_w = rng.normal(1.0, 0.5, 52).astype(np.float32)
    kw = dict(l1_weight=0.7, l2_weight=0.4, velocity_weight=0.2,
              separation_weight=0.05)

    def call(mod):
        def fn(p, t, mw, ew, pp, pt):
            return mod.dual_stream_loss(
                p, t, mel_weights=mw, emotion_weights=ew,
                prev_pred=pp if with_prev else None,
                prev_target=pt if with_prev else None, **kw)
        return fn

    _compare(call(jl), call(tl), [pred, target, mel_w, emo_w, prev_p, prev_t],
             grad_arg=grad_arg)


def test_perceptual_and_landmark_terms():
    pred, target = _frames(seed=5)
    np.testing.assert_array_equal(tl._LANDMARK_W, jl._LANDMARK_W)
    _close(float(tl.landmark_loss(torch.from_numpy(pred),
                                  torch.from_numpy(target))),
           float(jl.landmark_loss(jnp.asarray(pred), jnp.asarray(target))))
    _close(float(tl.perceptual_loss(torch.from_numpy(pred),
                                    torch.from_numpy(target))),
           float(jl.perceptual_loss(jnp.asarray(pred),
                                    jnp.asarray(target))))


def test_frame_metrics_edge_cases():
    """Constant rows (zero variance), nothing active, everything active. A
    constant row's correlation is 0 up to the rounding of its mean (a
    ratio of ~1e-9 residues over ``eps``): held within 1e-6."""
    cases = [np.full((4, 52), 0.05, np.float32),
             np.full((4, 52), 0.9, np.float32)]
    pred, target = _frames(b=4, seed=6)
    for p, t in ((cases[0], target), (pred, cases[1]),
                 (cases[0], cases[0])):
        got = tl.frame_metrics(torch.from_numpy(p), torch.from_numpy(t))
        want = jl.frame_metrics(jnp.asarray(p), jnp.asarray(t))
        for k in want:
            if k == "correlation":
                assert abs(float(got[k]) - float(want[k])) < 1e-6
            else:
                _close(float(got[k]), float(want[k]), k)


def test_host_metric_accumulators():
    jm, tm = jl.BlendshapeMetrics(), tl.BlendshapeMetrics()
    for seed in range(3):
        p, t = _frames(b=5, seed=10 + seed)
        jm.update(p, t)
        tm.update(torch.from_numpy(p), t)
    assert tm.compute() == jm.compute()
    tm.reset()
    assert tm.compute() == {}
    p, t = _frames(b=9, seed=20)
    af = np.random.default_rng(0).standard_normal((9, 4, 8)).astype(
        np.float32)
    for audio in (None, af, af[:, 0]):
        assert tl.compute_lip_sync_metrics(torch.from_numpy(p), t, audio) \
            == jl.compute_lip_sync_metrics(p, t, audio)


def _basic_audio():
    sr = 16000
    rng = np.random.default_rng(0)
    t = np.arange(2 * sr) / sr
    return np.stack([
        0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.5 * np.sin(
            2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(t.size),
        0.1 * rng.standard_normal(t.size),
        np.zeros(t.size),
        0.5 * np.sign(np.sin(2 * np.pi * 120 * t)) * np.exp(-t),
    ]).astype(np.float32)


BASIC_ATOL = np.array([0, 0, 0, 0, 1e-4, 1e-8, 0, 0, 0])


@functools.lru_cache(maxsize=1)
def _jax_basic_features() -> np.ndarray:
    return np.asarray(jax.jit(jax_basic)(jnp.asarray(_basic_audio())))


def _basic_close(got, want):
    bad = np.abs(got - want) > BASIC_ATOL + 1e-5 * np.abs(want)
    assert not bad.any(), (np.argwhere(bad), got[bad], want[bad])


def test_basic_emotion_features():
    x = _basic_audio()
    want = _jax_basic_features()
    got = basic_emotion_features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 9)
    _basic_close(got, want)


def test_basic_backend_through_the_emotion_frontend():
    """The JAX frontend's ``basic`` branch is ``basic_emotion_features``."""
    x = _basic_audio()
    cfg = EmotionFrontendConfig(backend="basic", use_concatenation=False)
    assert cfg.feature_dim == JCfg(backend="basic").feature_dim == 9
    assert jax_emotion.__globals__["basic_emotion_features"] is jax_basic
    want = _jax_basic_features()
    got = emotion_features(torch.from_numpy(x), cfg).numpy()
    _basic_close(got, want)
    with pytest.raises(ValueError):
        emotion_features(torch.from_numpy(x),
                         EmotionFrontendConfig(backend="emotion2vec"))
