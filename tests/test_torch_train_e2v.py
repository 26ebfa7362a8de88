"""PyTorch port: training with the ``emotion2vec`` backend, the wav2vec2
encoder trained end to end inside the model (tiny encoder: hidden 32, two
layers, three convs).

- The first step's loss (rtol 1e-5) and every gradient leaf, the
  encoder's included, of ``DualStreamTrainer`` and ``SequentialTrainer``
  against the JAX trainers' float64 gradient, at ``test_torch_train``'s
  bounds (1e-4 of the leaf's largest element, or twice JAX's own float32
  distance where larger).
- ``_check_full_fp32`` refuses a CUDA trainer while cuDNN's TF32 flag is
  on (it reads flags only, so it runs here).
- A resume (2 steps, a checkpoint, a fresh trainer's ``resume()``, 2
  more) bit for bit equal to 4 steps at once.
- The ``emotion2vec`` subtree through an orbax checkpoint
  (``scripts/orbax_to_torch.py``) and the optimizer-state bridge, both
  ways, exactly.
- ``python -m koemorph_tpu_torch.train`` with
  ``model.emotion_config.backend=emotion2vec`` on the CPU.
"""

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.features.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel as JaxSimple)
from koemorph_tpu.train.checkpoint import save_checkpoint as jax_save
from koemorph_tpu.train.optim import create_optimizer as jax_optimizer
from koemorph_tpu_torch.features.wav2vec2 import (Wav2Vec2Config,
                                                  Wav2Vec2Encoder)
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.train import checkpoint as ck
from koemorph_tpu_torch.train.trainer import (SequentialTrainer,
                                              _check_full_fp32,
                                              dropout_generator)
from koemorph_tpu_torch.utils.params import (flax_from_state_dict,
                                             optax_from_optimizer_state,
                                             optimizer_state_from_optax,
                                             read_state_dict,
                                             state_dict_from_flax)
from tests.test_torch_train import (TRAIN_CFG, _batch, _case, _check_grads,
                                    _jax_grads)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import orbax_to_torch  # noqa: E402

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_dim=(16, 16, 16),
            conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
JAX_KW = dict(emotion2vec_config=JaxW2VConfig(**TINY))
PORT_KW = dict(emotion2vec_config=Wav2Vec2Config(**TINY))


@pytest.mark.parametrize("kind", ["window", "sequence"])
def test_first_step_loss_and_gradients_match_jax(kind):
    jt, tt, batch = _case(kind, "emotion2vec", jax_kw=JAX_KW,
                          port_kw=PORT_KW)
    jprep = jt._prepare(batch)
    jloss, jmetrics, want32 = _jax_grads(jt, jprep, np.float32)
    _, _, want64 = _jax_grads(jt, jprep, np.float64)
    prep = tt._prepare(batch)
    tt.model.train()
    loss, metrics = tt.loss_fn(prep, dropout_generator(0, 0, tt.device))
    grads = torch.autograd.grad(loss, list(tt.params.values()),
                                allow_unused=True)
    got = {k: np.zeros(p.shape, np.float32) if g is None else g.numpy()
           for (k, p), g in zip(tt.params.items(), grads)}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    assert sorted(got) == sorted(want64)
    enc = [k for k in got if k.startswith("emotion2vec.")]
    # 3 conv layers (conv, LayerNorm), the projection, the positional
    # conv, 2 transformer layers, the final LayerNorm, the fusion logits
    assert len(enc) == 3 * 4 + 4 + 2 + 2 * 16 + 2 + 1
    # a key bias adds one constant to every score of a query, which the
    # softmax cancels: its gradient is 0, and float32 leaves residues of
    # ~1e-12 of the largest gradient (JAX's and the port's alike)
    zero = [k for k in enc if k.endswith("attention.k_proj.bias")]
    top = max(np.abs(w).max() for w in want64.values())
    for k in zero:
        assert np.abs(want64[k]).max() <= 1e-15 * top, k
        assert np.abs(got[k]).max() <= 1e-9 * top, k
        assert np.abs(want32[k]).max() <= 1e-9 * top, k
    assert all(np.abs(got[k]).max() > 0 for k in enc if k not in zero)
    _check_grads(got, want32, {k: w for k, w in want64.items()
                               if k not in zero})


def test_full_fp32_check_covers_cudnn(monkeypatch):
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(ValueError, match="cuDNN"):
        _check_full_fp32(cuda)
    _check_full_fp32(torch.device("cpu"))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _check_full_fp32(cuda)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="matmul"):
        _check_full_fp32(cuda)


def test_encoder_scopes_cudnn_flags(monkeypatch):
    """The encoder's convolutions run with cuDNN's TF32 off, no
    autotuning and deterministic algorithms; the process's flags are as
    they were afterwards."""
    seen = []
    real = torch.nn.functional.conv1d

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.deterministic))
        return real(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    enc = Wav2Vec2Encoder(Wav2Vec2Config(**TINY))
    with torch.no_grad():
        enc(torch.zeros(1, 4000))
    assert len(seen) == 4 and set(seen) == {(False, False, True)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.benchmark


def test_train_step_backward_runs_deterministic_cudnn(tmp_path,
                                                      monkeypatch):
    """The backward, which picks the encoder's convolution algorithms
    outside the encoder's forward, runs under deterministic cuDNN flags
    with TF32 off too."""
    seen = []
    real = torch.autograd.grad

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **kw)

    trainer = _trainer(tmp_path)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.autograd, "grad", spy)
    trainer.train_step(trainer._prepare(_batch(2, 24)))
    assert seen == [(True, False, False)]
    assert torch.backends.cudnn.benchmark


def _trainer(work, seed=3):
    full = {"training": dict(TRAIN_CFG, seed=seed),
            "data": {"window_frames": 24}}
    model = dm.SequentialDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16, stride_frames=4,
        emotion_backend="emotion2vec", use_concatenation=False,
        dropout=0.1, **PORT_KW)
    return SequentialTrainer(model, full, work_dir=work, steps_per_epoch=4,
                             device="cpu")


def test_resume_equals_uninterrupted(tmp_path):
    batches = [_batch(4, 24, seed=s) for s in range(4)]
    whole = _trainer(tmp_path / "whole")
    whole.train_epoch(iter(batches))
    first = _trainer(tmp_path / "split")
    first.train_epoch(iter(batches[:2]))
    first._save(None)
    second = _trainer(tmp_path / "split")
    assert second.resume()
    second.train_epoch(iter(batches[2:]))
    assert second.global_step == whole.global_step == 4
    for k, v in whole.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[k], v), k
    assert any(k.startswith("emotion2vec.") for k in whole.params)


def test_orbax_and_optimizer_state_round_trip(tmp_path):
    model = JaxSimple(d_model=32, num_heads=2, mel_sequence_length=16,
                      emotion_backend="emotion2vec", dropout=0.0, **JAX_KW)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16 * 533)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tx = jax_optimizer(TRAIN_CFG, 1)
    g = jax.tree_util.tree_map(lambda x: np.full(np.shape(x), 0.01,
                                                 np.float32), params)
    _, opt_state = tx.update(g, tx.init(params), params)
    opt_state = jax.tree_util.tree_map(np.asarray, opt_state)
    jax_save(tmp_path / "orbax", params, epoch=1, global_step=3,
             config={"training": TRAIN_CFG}, opt_state=opt_state)
    orbax_to_torch.main([str(tmp_path / "orbax"), str(tmp_path / "pt")])
    sd = read_state_dict(tmp_path / "pt")
    want = state_dict_from_flax(params)
    assert sorted(sd) == sorted(want)
    assert sum(k.startswith("emotion2vec.") for k in sd) == 53
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    back = flax_from_state_dict(sd)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    port = ck.load_opt_state(tmp_path / "pt")["optimizer"]
    direct = optimizer_state_from_optax(opt_state, params)
    assert sorted(direct["mu"]) == sorted(want)
    for key in ("mu", "nu"):
        for k in want:
            assert torch.equal(port[key][k], direct[key][k]), (key, k)
    again = optax_from_optimizer_state(direct, tx.init(params))
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    loaded = dm.SimplifiedDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16,
        emotion_backend="emotion2vec", dropout=0.0, **PORT_KW)
    loaded.load_state_dict(sd)


def test_train_cli_emotion2vec_on_cpu(tmp_path):
    work = tmp_path / "run"
    overrides = ["model.d_model=32", "model.num_heads=2",
                 "model.mel_sequence_length=16", "data.window_frames=24",
                 "data.batch_size=2", "model.emotion_config.backend="
                 "emotion2vec", "training.logging.tensorboard=false"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.train", "--cpu",
         "--config", str(REPO / "configs" / "dual_stream_config.yaml"),
         "--synthetic", "2", "--max-epochs", "1", "--steps-per-epoch", "1",
         "--work-dir", str(work), *overrides], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    final = json.loads(out.stdout.strip().splitlines()[-1])
    assert np.isfinite(final["final_train_metrics"]["loss"])
    sd = read_state_dict(work / "checkpoints" / "last")
    enc = {k: v for k, v in sd.items() if k.startswith("emotion2vec.")}
    assert enc["emotion2vec.encoder.layers.1.attention.q_proj.weight"].shape \
        == (1024, 1024)
    assert sd["emotion_projection.weight"].shape == (32, 1024)
