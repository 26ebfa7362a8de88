"""PyTorch port: checkpoints, resume, the orbax converter and serving a
trained model.

- ``save_checkpoint``/``load_checkpoint`` round trip, the best/last/epoch_N
  policy, and ``best`` surviving a resume (as the JAX package's
  ``tests/train/test_trainer.py`` holds its own);
- a run interrupted after one epoch and resumed by a fresh trainer equals
  the uninterrupted run bit for bit on the CPU, dropout on;
- a checkpoint without optimizer state fast-forwards the update count, so
  the schedule resumes at ``global_step``;
- an orbax checkpoint of the JAX package, converted by
  ``scripts/orbax_to_torch.py``, serves through the port's
  ``build_streaming_model(checkpoint=...)`` with the parameters bit for
  bit and the stream's blendshapes within 1e-5 of the JAX stream built by
  JAX's ``build_streaming_model(checkpoint=...)``; a checkpoint the port
  wrote, through ``flax_from_state_dict``, drives the JAX stream within
  1e-5 of the port's;
- a JAX run with optimizer state (AdamW with gradient accumulation),
  converted, has the optax state's moments, accumulator and counts
  exactly, converts back to an equal optax state, and its next update in
  the port is JAX's: each leaf's change within 1e-4 of its largest change
  plus one float32 rounding step of the parameter, on the elements whose
  gradient is at least 1e-2 of the leaf's largest (Adam moves an element
  by about the learning rate whatever its gradient's size, so the sign of
  a gradient that is rounding noise decides the step), every leaf held,
  the run starting from the stream weights perturbed as in
  ``tests/test_torch_train.py``; an SGD momentum state converts both
  ways exactly;
- ``python -m koemorph_tpu_torch.train --synthetic 2 --cpu`` and then
  ``infer --model`` on what it wrote, end to end.
"""

import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models.dual_stream_model import (
    SequentialDualStreamModel as JaxSeq)
from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel as JaxSimple)
from koemorph_tpu.models.dual_stream_model import (
    TemporalState as JaxTemporalState)
from koemorph_tpu.runtime import engine as jax_engine
from koemorph_tpu.runtime import streaming as jax_streaming
from koemorph_tpu.train import SequentialTrainer as JaxST
from koemorph_tpu.train.checkpoint import save_checkpoint as jax_save
from koemorph_tpu.train.optim import create_optimizer as jax_optimizer
from koemorph_tpu_torch.data.wav import write_wav
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.runtime import engine, streaming
from koemorph_tpu_torch.train import checkpoint as ck
from koemorph_tpu_torch.train.trainer import SequentialTrainer
from koemorph_tpu_torch.utils.params import (flax_from_state_dict,
                                             optax_from_optimizer_state,
                                             optimizer_state_from_optax,
                                             read_state_dict,
                                             state_dict_from_flax)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import orbax_to_torch  # noqa: E402

HOP = 533
TRAIN_CFG = {
    "optimizer": {"name": "adamw", "lr": 1e-3, "weight_decay": 1e-5,
                  "betas": [0.9, 0.999]},
    "lr_scheduler": {"name": "cosine", "t_max": 2, "eta_min": 1e-6,
                     "warmup_steps": 2},
    "loss": {"mse_weight": 1.0, "l1_weight": 0.1, "perceptual_weight": 0.0},
    "gradient_clip_val": 1.0,
    "max_epochs": 2,
    "logging": {"log_every_n_steps": 1, "tensorboard": False},
    "checkpoint": {"keep_epoch_every": 100},
}


def _sd(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(2, 3, generator=g),
            "b": torch.randn(3, generator=g)}


def test_round_trip(tmp_path):
    state = _sd()
    opt = {"optimizer": {"name": "adamw", "count": 4,
                         "mu": {"w": torch.ones(2, 3)}},
           "dropout_seed": 9}
    ck.save_checkpoint(tmp_path / "ck", state, opt_state=opt, epoch=3,
                       global_step=42, best_val_loss=0.5, config={"a": 1})
    restored, meta = ck.load_checkpoint(tmp_path / "ck")
    assert restored.keys() == state.keys()
    assert all(torch.equal(restored[k], state[k]) for k in state)
    assert meta == {"epoch": 3, "global_step": 42, "best_val_loss": 0.5,
                    "config": {"a": 1}}
    got = ck.load_opt_state(tmp_path / "ck")
    assert got["optimizer"]["count"] == 4 and got["dropout_seed"] == 9
    assert torch.equal(got["optimizer"]["mu"]["w"], torch.ones(2, 3))
    # the reference's trainer-checkpoint form, and a bare state dict
    blob = torch.load(tmp_path / "ck" / "state.pth", weights_only=True)
    assert sorted(blob) == ["model_state_dict"]
    torch.save(state, tmp_path / "bare.pth")
    assert read_state_dict(tmp_path / "bare.pth").keys() == state.keys()
    # a params-only save over it drops the stale optimizer state
    ck.save_checkpoint(tmp_path / "ck", state)
    assert ck.load_opt_state(tmp_path / "ck") is None
    with pytest.raises(FileNotFoundError):
        read_state_dict(tmp_path / "missing")


def test_manager_best_last_policy(tmp_path):
    mgr = ck.CheckpointManager(tmp_path, keep_epoch_every=2)
    zeros, ones = {"w": torch.zeros(2)}, {"w": torch.ones(2)}
    mgr.save(zeros, epoch=0, global_step=1, val_loss=1.0)
    mgr.save(ones, epoch=1, global_step=2, val_loss=0.5)
    mgr.save(zeros, epoch=2, global_step=3, val_loss=0.9)   # not best
    best, _ = ck.load_checkpoint(tmp_path / "best")
    assert torch.equal(best["w"], torch.ones(2))
    assert (tmp_path / "last").exists() and (tmp_path / "epoch_2").exists()
    assert (tmp_path / "epoch_0").exists()
    assert not (tmp_path / "epoch_1").exists()
    _, last_meta = ck.load_checkpoint(tmp_path / "last")
    assert last_meta["epoch"] == 2


def test_best_survives_resume(tmp_path):
    mgr = ck.CheckpointManager(tmp_path, keep_epoch_every=1000)
    best_state = {"w": torch.ones(2)}
    mgr.save({"w": torch.zeros(2)}, epoch=0, global_step=1, val_loss=0.12)
    mgr.save(best_state, epoch=1, global_step=2, val_loss=0.10)
    mgr2 = ck.CheckpointManager(tmp_path, keep_epoch_every=1000)
    assert mgr2.latest() is not None
    assert mgr2.best_val_loss == pytest.approx(0.10)
    mgr2.save({"w": torch.full((2,), 9.0)}, epoch=2, global_step=3,
              val_loss=0.11)                      # worse than the true best
    best, _ = ck.load_checkpoint(tmp_path / "best")
    assert torch.equal(best["w"], best_state["w"])


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

def _audio(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * rng.random((b, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) + 0.02 * rng.standard_normal((b, n))).astype(
            np.float32)


def _batches(n, b=4, frames=24):
    rng = np.random.default_rng(7)
    return [{"audio": _audio(b, frames * HOP, seed=s),
             "blendshapes": rng.uniform(0, 1, (b, frames, 52)).astype(
                 np.float32),
             "file_indices": np.full((b,), s // 2, np.int32)}
            for s in range(n)]


def _trainer(work, cfg=TRAIN_CFG, dropout=0.1):
    model = dm.SequentialDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16, stride_frames=4,
        emotion_backend="basic", use_concatenation=False, dropout=dropout)
    return SequentialTrainer(model, {"training": cfg,
                                     "data": {"window_frames": 24}},
                             work_dir=work, steps_per_epoch=2, device="cpu")


def test_resume_equals_uninterrupted(tmp_path):
    batches = _batches(4)

    def loader(epoch):
        return iter(batches[2 * epoch: 2 * epoch + 2])

    full = _trainer(tmp_path / "full")
    full.fit(loader, lambda: iter(batches[:1]), max_epochs=2)

    first = _trainer(tmp_path / "split")
    first.fit(loader, lambda: iter(batches[:1]), max_epochs=1)
    second = _trainer(tmp_path / "split")
    assert second.resume()
    assert second.epoch == 1 and second.global_step == 2
    assert second.optimizer.count == 2
    second.fit(loader, lambda: iter(batches[:1]), max_epochs=2)
    for k, p in full.params.items():
        assert torch.equal(p, second.params[k]), k
    a, b = full.optimizer.state_dict(), second.optimizer.state_dict()
    assert a["count"] == b["count"] == 4
    for key in ("mu", "nu"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    # dropout acted: the same run without it lands elsewhere
    plain = _trainer(tmp_path / "plain", dropout=0.0)
    plain.fit(loader, None, max_epochs=2)
    key = "dual_stream_attention.blendshape_decoder.0.weight"
    assert not torch.equal(plain.params[key], full.params[key])


def test_params_only_checkpoint_fast_forwards_schedule(tmp_path):
    t_a = _trainer(tmp_path)
    ck.save_checkpoint(tmp_path / "checkpoints" / "last",
                       t_a.model.state_dict(), epoch=4, global_step=10)
    t_b = _trainer(tmp_path)
    assert t_b.resume()
    assert (t_b.global_step, t_b.epoch, t_b.optimizer.count) == (10, 5, 10)
    assert t_b.optimizer.lr == t_b._schedule(10)
    assert all(float(v.abs().max()) == 0 for v in t_b.optimizer.mu.values())


def test_resume_rejects_a_wrong_model(tmp_path):
    t_a = _trainer(tmp_path)
    sd = t_a.model.state_dict()
    sd["emotion_projection.weight"] = torch.zeros(32, 264)
    ck.save_checkpoint(tmp_path / "checkpoints" / "last", sd)
    with pytest.raises(ValueError, match="emotion_projection.weight"):
        _trainer(tmp_path).resume()


# ---------------------------------------------------------------------------
# JAX <-> port checkpoints, served
# ---------------------------------------------------------------------------

KW = dict(d_model=32, num_heads=2)
STREAM_KW = dict(window_frames=256, d_model=32, num_heads=2,
                 emotion_context_s=2.0, emotion_update_frames=3)


def _jax_params(seed=1):
    model = JaxSimple(d_model=32, num_heads=2, mel_sequence_length=256,
                      emotion_backend="precomputed", dropout=0.0)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 256 * HOP)),
        JaxTemporalState.create(1),
        emotion_features_raw=jnp.zeros((1, 264)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, np.shape(x))).astype(
            np.float32), params)


def _voice(n, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    phase = np.cumsum(2 * np.pi * np.where(t < 0.2, 90.0, 170.0) / 16000)
    x = sum(np.cos(h * phase) / h for h in range(1, 20))
    return (0.2 * x / np.abs(x).max()
            + 0.003 * rng.standard_normal(n)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _jax_step():
    cfg = jax_streaming.StreamingConfig(**STREAM_KW)
    return cfg, jax.jit(
        lambda p, s, a: jax_streaming.stream_frame(p, s, a, cfg))


def _streams_agree(jparams, model, n_frames=6):
    """The JAX stream on ``jparams`` and the port's on ``model``: per-frame
    blendshapes within 1e-5."""
    jcfg, step = _jax_step()
    tcfg = streaming.StreamingConfig(**STREAM_KW)
    jstate = jax_streaming.init_stream_state(jcfg)
    tstate = streaming.init_stream_state(tcfg, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    audio = _voice(n_frames * HOP)
    for i in range(n_frames):
        hop = audio[i * HOP:(i + 1) * HOP]
        jout, jstate = step(jp, jstate, jnp.asarray(hop))
        with torch.inference_mode():
            tout, tstate = streaming.stream_frame(
                model, tstate, torch.from_numpy(hop), tcfg)
        d = np.abs(tout["blendshapes"].numpy()
                   - np.asarray(jout["blendshapes"])).max()
        assert d <= 1e-5, (i, d)


def test_orbax_checkpoint_serves_in_the_port(tmp_path):
    params = _jax_params()
    jax_save(tmp_path / "orbax", params, epoch=2, global_step=7,
             config={"training": TRAIN_CFG})
    orbax_to_torch.main([str(tmp_path / "orbax"), str(tmp_path / "pt")])
    assert not (tmp_path / "pt" / "opt_state.pth").exists()
    meta = json.loads((tmp_path / "pt" / "meta.json").read_text())
    assert (meta["epoch"], meta["global_step"]) == (2, 7)

    jparams, jcfg = jax_engine.build_streaming_model(
        checkpoint=str(tmp_path / "orbax"), **KW)
    model, cfg = engine.build_streaming_model(
        checkpoint=str(tmp_path / "pt"), device="cpu", **KW)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       jparams))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert (cfg.window_frames, cfg.emotion_raw_dim) == (
        jcfg.window_frames, jcfg.emotion_raw_dim)
    _streams_agree(jparams, model)


def test_port_checkpoint_drives_the_jax_stream(tmp_path):
    model = streaming.model_for_config(streaming.StreamingConfig(
        **STREAM_KW))
    model.init_random(torch.Generator().manual_seed(3))
    ck.save_checkpoint(tmp_path / "ck", model.state_dict())
    loaded, _ = engine.build_streaming_model(checkpoint=str(tmp_path / "ck"),
                                             device="cpu", **KW)
    jparams = flax_from_state_dict(read_state_dict(tmp_path / "ck"))
    _streams_agree(jparams, loaded)


def test_checkpoint_errors_name_the_parameter(tmp_path):
    model = streaming.model_for_config(streaming.StreamingConfig(
        **STREAM_KW))
    sd = model.state_dict()
    with pytest.raises(FileNotFoundError):
        engine.build_streaming_model(checkpoint=str(tmp_path / "none"),
                                     device="cpu", **KW)
    wide = dict(sd, **{"emotion_projection.bias": torch.zeros(64)})
    ck.save_checkpoint(tmp_path / "wide", wide)
    with pytest.raises(ValueError, match="emotion_projection.bias"):
        engine.build_streaming_model(checkpoint=str(tmp_path / "wide"),
                                     device="cpu", **KW)
    short = {k: v for k, v in sd.items() if k != "smoothing_alpha"}
    torch.save({"model_state_dict": short}, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="smoothing_alpha"):
        engine.build_streaming_model(checkpoint=str(tmp_path / "short.pth"),
                                     device="cpu", **KW)


def _jax_run(tmp_path, cfg, n_steps):
    """A JAX SequentialTrainer after ``n_steps`` steps, checkpointed with
    its optimizer state, and the port trainer resumed from the converted
    checkpoint."""
    kw = dict(d_model=32, num_heads=2, mel_sequence_length=16,
              stride_frames=4, emotion_backend="basic",
              use_concatenation=False, dropout=0.0)
    full = {"training": cfg, "data": {"window_frames": 24}}
    jt = JaxST(JaxSeq(**kw), full, work_dir=tmp_path / "jax",
               steps_per_epoch=2)
    # the stream weights off their two-valued start, where the smoothness
    # term's |diff| sits on its kink (as in tests/test_torch_train.py)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.params))
    rng = np.random.default_rng(7)
    for k in ("dual_stream_attention.mel_weights",
              "dual_stream_attention.emotion_weights"):
        sd[k] = sd[k] + torch.from_numpy(
            rng.normal(0, 0.5, sd[k].shape).astype(np.float32))
    jt.state = jt.state.replace(params=jax.tree_util.tree_map(
        lambda old, new: jax.device_put(np.asarray(new), old.sharding),
        jt.state.params, flax_from_state_dict(sd)))
    batches = _batches(n_steps + 1)
    jt.train_epoch(iter(batches[:n_steps]))
    jt.checkpoints.save(jt.state.params, epoch=0, global_step=jt.global_step,
                        opt_state=jt.state.opt_state)
    orbax_to_torch.convert(tmp_path / "jax" / "checkpoints" / "last",
                           tmp_path / "port" / "checkpoints" / "last")
    tt = SequentialTrainer(dm.SequentialDualStreamModel(**kw), full,
                           work_dir=tmp_path / "port", steps_per_epoch=2,
                           device="cpu")
    assert tt.resume()
    return jt, tt, batches[n_steps]


def test_converted_run_takes_jax_next_step(tmp_path):
    """AdamW with gradient accumulation (k = 2): three JAX steps (one
    update, one gradient in the accumulator), converted; the optimizer
    state is JAX's exactly, converts back to an equal optax state, and the
    fourth step, the second update, is JAX's."""
    cfg = dict(TRAIN_CFG, accumulate_grad_batches=2)
    jt, tt, nxt = _jax_run(tmp_path, cfg, 3)
    jparams = jax.tree_util.tree_map(np.asarray, jt.state.params)
    want = optimizer_state_from_optax(
        jax.tree_util.tree_map(np.asarray, jt.state.opt_state), jparams)
    got = tt.optimizer.state_dict()
    assert (got["count"], got["mini_step"], got["gradient_step"]) == (
        want["count"], want["mini_step"], want["gradient_step"]) == (1, 1, 1)
    for key in ("mu", "nu", "acc"):
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (key, k)
    template = jax_optimizer(cfg, 2).init(jparams)
    back = optax_from_optimizer_state(got, template)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jt.state.opt_state)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jt.state.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    start = {k: v.detach().clone().numpy() for k, v in tt.params.items()}
    jstart = state_dict_from_flax(jparams)
    assert all(np.array_equal(start[k], jstart[k].numpy()) for k in start)
    # the update's gradient (the mean of the accumulated and the next),
    # to tell signal from rounding noise
    jprep = jt._prepare(nxt)
    g4 = jax.jit(jax.grad(lambda p: jt.loss_fn(p, jprep, None)[0]))(
        jt.state.params)
    mean = state_dict_from_flax(jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a) + np.asarray(b)) / 2,
        jt.state.opt_state.acc_grads, g4))
    jt.train_epoch(iter([nxt]))
    tt.train_epoch(iter([nxt]))
    assert tt.global_step == jt.global_step == 4
    assert tt.optimizer.count == 2
    jp = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.params))
    for k, p in tt.params.items():
        g = np.abs(mean[k].numpy())
        if g.max() == 0:
            continue
        keep = g >= 1e-2 * g.max()
        d_port = (p.detach().numpy() - start[k])[keep]
        d_jax = (jp[k].numpy() - start[k])[keep]
        np.testing.assert_allclose(
            d_port, d_jax, rtol=0, err_msg=k,
            atol=1e-4 * np.abs(d_jax).max() + _ulp(start[k]))


def _ulp(x) -> float:
    """One float32 rounding step at the largest magnitude of ``x``: the
    resolution of a parameter change measured as a difference."""
    return float(np.finfo(np.float32).eps * np.abs(x).max())


def test_sgd_state_converts_both_ways():
    jparams = _jax_params()
    cfg = dict(TRAIN_CFG, optimizer={"name": "sgd", "lr": 0.1,
                                     "momentum": 0.9})
    tx = jax_optimizer(cfg, 2)
    state = tx.init(jparams)
    g = jax.tree_util.tree_map(
        lambda x: np.full(np.shape(x), 0.01, np.float32), jparams)
    _, state = tx.update(g, state, jparams)
    state = jax.tree_util.tree_map(np.asarray, state)
    port = optimizer_state_from_optax(state, jparams)
    assert port["name"] == "sgd" and port["count"] == 1
    assert sorted(port["trace"]) == sorted(state_dict_from_flax(jparams))
    back = optax_from_optimizer_state(port, tx.init(jparams))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_then_infer_cli_on_cpu(tmp_path):
    """Train two steps on two synthetic files, then decode a WAV with what
    the run wrote; the decode equals the model loaded in-process."""
    work = tmp_path / "run"
    overrides = ["model.d_model=32", "model.num_heads=2",
                 "data.batch_size=8", "model.emotion_config.backend=basic",
                 "model.emotion_config.use_concatenation=false",
                 "training.logging.tensorboard=false"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.train", "--cpu",
         "--config", str(REPO / "configs" / "dual_stream_config.yaml"),
         "--synthetic", "2", "--max-epochs", "1", "--work-dir", str(work),
         *overrides], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    final = json.loads(out.stdout.strip().splitlines()[-1])
    assert final["work_dir"] == str(work)
    assert np.isfinite(final["final_train_metrics"]["loss"])
    last = work / "checkpoints" / "last"
    meta = json.loads((last / "meta.json").read_text())
    assert meta["global_step"] == 2 and meta["epoch"] == 0
    assert ck.load_opt_state(last)["optimizer"]["count"] == 2

    wav = tmp_path / "in.wav"
    write_wav(wav, _voice(300 * HOP), 16000)
    frames = tmp_path / "frames.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.infer", "--input",
         str(wav), "--output", str(frames), "--model", str(last),
         "--d-model", "32", "--num-heads", "2", "--emotion-backend",
         "basic", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "random weights" not in out.stderr
    rows = [json.loads(line) for line in frames.read_text().splitlines()]
    got = np.asarray([r["blendshapes"] for r in rows])

    model = dm.SequentialDualStreamModel(
        d_model=32, num_heads=2, emotion_backend="basic",
        use_concatenation=False, dropout=0.0)
    model.load_state_dict(read_state_dict(last))
    model.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(_voice(300 * HOP))[None])[
            "blendshapes"][0].numpy()
    assert got.shape == want.shape == (45, 52)
    # infer's rows carry 6 decimals: against the unrounded output that is
    # at most 5e-7 of rounding plus float32 error, wherever a value falls
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_trainer_cli_needs_cuda_unless_asked(monkeypatch, tmp_path):
    from koemorph_tpu_torch.train import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--work-dir", str(tmp_path), "--synthetic", "1"])
    # the legacy config (model.name: simplified) trains on the card too
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config", str(REPO / "configs" / "config.yaml"),
                  "--work-dir", str(tmp_path)])
    # --scan-epochs trains (device-resident epochs; eager on the CPU)
    work = tmp_path / "scan"
    assert cli.main([
        "--cpu", "--scan-epochs", "--synthetic", "1", "--max-epochs", "1",
        "--work-dir", str(work), "model.d_model=32", "model.num_heads=2",
        "data.batch_size=8", "model.emotion_config.backend=basic",
        "model.emotion_config.use_concatenation=false",
        "training.logging.tensorboard=false"]) == 0
    meta = json.loads((work / "checkpoints" / "last" / "meta.json")
                      .read_text())
    assert meta["global_step"] >= 1 and meta["epoch"] == 0
