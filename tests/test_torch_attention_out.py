"""PyTorch port: ``return_attention``, the attention visualizer and the
trainer's attention images, against the JAX package.

- ``DualStreamCrossAttention(return_attention=True)`` (a mel batch of 4
  against one emotion row, the emotion branch repeated) and both models
  (``SimplifiedDualStreamModel``; ``SequentialDualStreamModel`` in
  ``"parallel"`` and ``"chunked"`` mode, per-window weights joined over
  chunks): the head-averaged weights within 1e-5 of JAX's, the per-stream
  blendshapes within 1e-5, each weight row summing to 1; the blendshapes
  bitwise equal to those of the same call without ``return_attention``.
- In training mode with dropout, the returned weights are those before
  dropout, as JAX's are: bitwise the eval call's weights in the port, and
  JAX's own training-mode weights equal its deterministic ones.
- The visualizer: PNGs written with matplotlib; the interactive HTML
  equal to JAX's string for the same weights; the specialization summary
  equal to JAX's.
- The trainer's images through a fake writer: the same tags, steps and
  shapes as the JAX trainer's, the arrays within 1e-5; a model without
  ``return_attention`` turns them off once; with images logged every step
  the losses and parameters are bitwise those of a run without them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models import dual_stream as jds
from koemorph_tpu.models import dual_stream_model as jdm
from koemorph_tpu.visualization import attention_viz as jviz
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.train.trainer import dropout_generator
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from koemorph_tpu_torch.visualization import attention_viz as viz
from tests.test_torch_sequential import SMALL, _params, _raw_emotion
from tests.test_torch_streaming import _voice

torch.set_num_threads(2)

HOP = 533
KEYS = ("mel_attention_weights", "emotion_attention_weights")


def _close(got, want, what=""):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5, err_msg=what)


def _rows_sum_to_one(w):
    np.testing.assert_allclose(w.sum(-1).detach().numpy(), 1.0, atol=1e-5)


def test_cross_attention_weights_match_jax():
    params = _params()
    att = jds.DualStreamCrossAttention(d_model=32, num_heads=2,
                                       mel_sequence_length=16,
                                       emotion_dim=32, dropout=0.1)
    tm = dm.SimplifiedDualStreamModel(**SMALL)
    tm.load_state_dict(state_dict_from_flax(params))
    tm.eval()
    rng = np.random.default_rng(2)
    mel = rng.uniform(0, 1, (4, 16, 80)).astype(np.float32)
    det = rng.uniform(0, 1, (4, 3, 80)).astype(np.float32)
    emo = rng.normal(0, 1, (1, 32)).astype(np.float32)
    jp = {"params": params["dual_stream_attention"]}
    want = att.apply(jp, jnp.asarray(mel), jnp.asarray(det),
                     jnp.asarray(emo), return_attention=True)
    module = tm.dual_stream_attention
    args = [torch.from_numpy(a) for a in (mel, det, emo)]
    with torch.no_grad():
        got = module(*args, return_attention=True)
        plain = module(*args)
    assert sorted(got) == sorted(want)
    assert got["mel_attention_weights"].shape == (4, 28, 80)
    assert got["emotion_attention_weights"].shape == (4, 24, 1)
    for key in want:
        _close(got[key], want[key], key)
    for key in KEYS:
        _rows_sum_to_one(got[key])
    assert torch.equal(got["blendshapes"], plain["blendshapes"])
    assert sorted(plain) == ["blendshapes"]

    # with dropout in training mode the weights are those before dropout
    module.train()
    with torch.no_grad():
        dropped = module(*args, return_attention=True,
                         generator=dropout_generator(0, 0, torch.device(
                             "cpu")))
    module.eval()
    assert not torch.equal(dropped["blendshapes"], got["blendshapes"])
    for key in KEYS:
        assert torch.equal(dropped[key], got[key]), key
    jdrop = att.apply(jp, jnp.asarray(mel), jnp.asarray(det),
                      jnp.asarray(emo), return_attention=True,
                      deterministic=False,
                      rngs={"dropout": jax.random.PRNGKey(3)})
    assert not np.array_equal(np.asarray(jdrop["blendshapes"]),
                              np.asarray(want["blendshapes"]))
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(jdrop[key]),
                                      np.asarray(want[key]))


def test_simplified_model_attention_matches_jax():
    jm = jdm.SimplifiedDualStreamModel(**SMALL, emotion_backend="precomputed",
                                       dropout=0.0)
    tm = dm.SimplifiedDualStreamModel(**SMALL)
    tm.load_state_dict(state_dict_from_flax(_params()))
    tm.eval()
    a = np.stack([_voice(17 * HOP, seed=s) for s in (1, 2)])
    raw = _raw_emotion()
    want, _ = jm.apply({"params": _params()}, jnp.asarray(a),
                       jdm.TemporalState.create(2),
                       emotion_features_raw=jnp.asarray(raw),
                       return_attention=True)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(a), dm.TemporalState.create(2),
                    emotion_features_raw=torch.from_numpy(raw),
                    return_attention=True)
        plain, _ = tm(torch.from_numpy(a), dm.TemporalState.create(2),
                      emotion_features_raw=torch.from_numpy(raw))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], key)
    assert torch.equal(got["blendshapes"], plain["blendshapes"])


@pytest.mark.parametrize("mode", ["parallel", "chunked"])
def test_sequential_model_attention_matches_jax(mode):
    kw = dict(SMALL, stride_frames=3, decode_mode=mode, window_chunk=4)
    jm = jdm.SequentialDualStreamModel(**kw, emotion_backend="egemaps",
                                       dropout=0.0)
    tm = dm.SequentialDualStreamModel(**kw)
    tm.load_state_dict(state_dict_from_flax(_params()))
    tm.eval()
    a = np.stack([_voice(40 * HOP, seed=s) for s in (1, 2)])
    raw = _raw_emotion()
    want = jm.apply({"params": _params()}, jnp.asarray(a),
                    emotion_features_raw=jnp.asarray(raw),
                    return_attention=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(a), emotion_features_raw=torch.from_numpy(
            raw), return_attention=True)
        plain = tm(torch.from_numpy(a),
                   emotion_features_raw=torch.from_numpy(raw))
    n_out = got["num_frames"]
    assert n_out == 9 and (mode == "parallel" or n_out > kw["window_chunk"])
    assert got["mel_attention_weights"].shape == (2, n_out, 28, 80)
    assert got["emotion_attention_weights"].shape == (2, n_out, 24, 1)
    assert sorted(got) == sorted(want)
    for key in KEYS + ("blendshapes",):
        _close(got[key], want[key], key)
    for key in KEYS:
        _rows_sum_to_one(got[key])
    assert torch.equal(got["blendshapes"], plain["blendshapes"])


def _weights(seed: int = 4):
    rng = np.random.default_rng(seed)
    mel = rng.uniform(0, 1, (2, 28, 80)).astype(np.float32)
    emo = rng.uniform(0, 1, (24, 3)).astype(np.float32)
    return mel / mel.sum(-1, keepdims=True), emo


def test_visualizer_plots_and_html_match_jax(tmp_path):
    mel, emo = _weights()
    vis = viz.AttentionVisualizer(tmp_path / "plots")
    for path in (vis.plot_mel_attention(torch.from_numpy(mel)),
                 vis.plot_stream_weights(torch.randn(52), np.zeros(52))):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    got = viz.create_interactive_attention_html(
        torch.from_numpy(mel), emo, tmp_path / "t.html")
    want = jviz.create_interactive_attention_html(mel, emo,
                                                  tmp_path / "j.html")
    assert open(got, encoding="utf-8").read() \
        == open(want, encoding="utf-8").read()
    assert viz.frequency_bands() == jviz.frequency_bands()
    logits = np.random.default_rng(5).normal(0, 1, (2, 52))
    assert viz.AttentionVisualizer(tmp_path).specialization_summary(
        *logits, temperature=0.7) == jviz.AttentionVisualizer(
            tmp_path).specialization_summary(*logits, temperature=0.7)
    assert [ln for ln in open(viz.__file__) if "import matplotlib" in ln] \
        == ["    import matplotlib\n", "    import matplotlib.pyplot as plt\n"]


class _Writer:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step, dataformats):
        self.images.append((tag, np.array(img), step, dataformats))

    def add_scalar(self, *args):
        pass


@pytest.mark.parametrize("kind", ["window", "sequence"])
def test_trainer_images_match_jax(kind):
    from tests.test_torch_train import _batch, _case
    jt, tt, _ = _case(kind)
    batch = _batch(2, 32 if kind == "window" else 24)
    jt.writer, tt.writer = _Writer(), _Writer()
    jt.global_step = tt.global_step = 5
    jt._log_attention_images(jt._prepare(batch))
    tt._log_attention_images(tt._prepare(batch))
    assert [i[0] for i in tt.writer.images] == ["attention/mel",
                                                "attention/emotion"]
    assert len(tt.writer.images) == len(jt.writer.images) == 2
    for (tag, img, step, fmt), (jtag, jimg, jstep, jfmt) in zip(
            tt.writer.images, jt.writer.images):
        assert (tag, step, fmt) == (jtag, jstep, jfmt) == (tag, 5, "HW")
        assert img.dtype == np.float32 and img.shape == jimg.shape
        np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-5,
                                   err_msg=tag)
        assert img.max() == 1.0


def test_model_without_attention_disables_images_once(tmp_path, caplog):
    from tests.test_torch_train import _batch, _case
    _, tt, _ = _case("window")

    class NoAttention(torch.nn.Module):
        def forward(self, audio):
            raise AssertionError("called")

    tt.writer = _Writer()
    tt.model = NoAttention()
    batch = tt._prepare(_batch(2, 32))
    with caplog.at_level("INFO"):
        tt._log_attention_images(batch)
        tt._log_attention_images(batch)
    assert tt.writer.images == []
    assert sum("attention images disabled" in r.message
               for r in caplog.records) == 1


def test_image_logging_leaves_the_steps_alone():
    from tests.test_torch_train import TRAIN_CFG, _batch, _case
    cfg = dict(TRAIN_CFG, logging={"log_every_n_steps": 1,
                                   "tensorboard": False,
                                   "log_images_every_n_steps": 1})
    kw = dict(dropout=0.1)
    runs = []
    for images in (True, False):
        _, tt, _ = _case("sequence", cfg=cfg, jax_kw=kw, port_kw=kw)
        tt.writer = _Writer() if images else None
        batches = [_batch(4, 24, seed=s) for s in (0, 10)]
        losses = [float(tt.train_step(tt._prepare(b))["loss"])
                  for b in batches[:1]]
        tt._log_attention_images(tt._prepare(batches[0]))
        losses.append(float(tt.train_step(tt._prepare(batches[1]))["loss"]))
        runs.append((losses, {k: v.detach().clone()
                              for k, v in tt.params.items()},
                     tt.writer.images if images else None))
    (l_on, p_on, imgs), (l_off, p_off, _) = runs
    assert len(imgs) == 2
    assert l_on == l_off
    for k in p_on:
        assert torch.equal(p_on[k], p_off[k]), k
