"""PyTorch port: the optimizer, the trainers and train-mode dropout.

Against optax and the JAX trainers, on the same numpy inputs and the same
(converted) parameters:

- the learning-rate schedules at every step 0..300 at rtol 1e-6, with an
  absolute floor of 1e-7 of the base rate (optax evaluates them in
  float32, where the cosine's terms are of the base rate's size);
- clip + AdamW (and Adam, SGD) for three updates from given gradients,
  with the clip triggered and not, and ``MultiSteps`` with k = 2: the
  parameters and the moments at rtol 1e-6 of each leaf's largest value;
- the first step's loss (rtol 1e-5) and every gradient of
  ``DualStreamTrainer`` and ``SequentialTrainer`` at d_model 32, 2 heads,
  window 16, span 24 on the ``basic`` backend, and one step of the
  sequential trainer on the 264-D eGeMAPS frontend, from one parameter set
  (JAX's initialization with the stream weights perturbed off their
  two-valued start, where the smoothness term sits on its kink). Every
  leaf is held against JAX's gradient in float64 (the features JAX's
  float32 ones): within 1e-4 of the leaf's largest element, or within
  twice JAX's own float32 distance from it where that is larger (the
  mouth queries and ``smoothing_alpha`` sum terms far larger than
  themselves; JAX's float32 stands up to 1.5e-4 off there), JAX's own
  distance being held under 1e-3;
- three SGD steps' parameters: each leaf's change within 1e-4 of its
  largest change (plus one float32 rounding step of the parameter).

Port only: dropout sites, keep rate, independence across windows, the
deterministic eval forward, a decode under inference mode followed by
training in one process, and learning a constant target.
"""

import dataclasses
import tempfile

import jax
import numpy as np
import optax
import pytest
import torch

from koemorph_tpu.models.dual_stream_model import (
    SequentialDualStreamModel as JaxSeq)
from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel as JaxSimple)
from koemorph_tpu.train import DualStreamTrainer as JaxDST
from koemorph_tpu.train import SequentialTrainer as JaxST
from koemorph_tpu.train.optim import create_lr_schedule as jax_schedule
from koemorph_tpu.train.optim import create_optimizer as jax_optimizer
from koemorph_tpu_torch.blendshapes import EXPRESSION_INDICES
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.models.dropout import Dropout
from koemorph_tpu_torch.parallel.batched_decode import (
    BatchedSequentialDecoder)
from koemorph_tpu_torch.train import optim
from koemorph_tpu_torch.train.trainer import (DualStreamTrainer,
                                              SequentialTrainer,
                                              dropout_generator,
                                              sequence_targets)
from koemorph_tpu_torch.utils.params import (flax_from_state_dict,
                                             state_dict_from_flax)

torch.set_num_threads(2)

HOP = 533
TRAIN_CFG = {
    "optimizer": {"name": "adamw", "lr": 1e-3, "weight_decay": 1e-5,
                  "betas": [0.9, 0.999]},
    "lr_scheduler": {"name": "cosine", "t_max": 2, "eta_min": 1e-6},
    "loss": {"mse_weight": 1.0, "l1_weight": 0.1, "perceptual_weight": 0.0},
    "gradient_clip_val": 1.0,
    "max_epochs": 1,
    "logging": {"log_every_n_steps": 1, "tensorboard": False},
    "checkpoint": {"keep_epoch_every": 100},
}
GRAD_TOL = 1e-4
PERTURBED = ("dual_stream_attention.mel_weights",
             "dual_stream_attention.emotion_weights")


# ---------------------------------------------------------------------------
# schedules and optimizer steps
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": {"name": "constant"},
    "constant_warmup": {"name": "constant", "warmup_steps": 7},
    "cosine": {"name": "cosine", "t_max": 20, "eta_min": 1e-6},
    "cosine_warmup": {"name": "cosine", "t_max": 20, "eta_min": 1e-6,
                      "warmup_steps": 13},
    "restarts": {"name": "cosine_restarts", "restart_period": 2,
                 "restart_mult": 2, "eta_min": 1e-5},
    "restarts_warmup": {"name": "cosine_restarts", "restart_period": 1,
                        "restart_mult": 3, "warmup_steps": 4},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    cfg = {"optimizer": {"lr": 3e-4}, "lr_scheduler": SCHEDULES[name]}
    want = jax_schedule(cfg, steps_per_epoch=5)
    got = optim.create_lr_schedule(cfg, steps_per_epoch=5)
    steps = np.arange(301)
    w = np.asarray([float(want(s)) for s in steps])
    g = np.asarray([got(int(s)) for s in steps])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7 * 3e-4)
    with pytest.raises(ValueError):
        optim.create_lr_schedule({"lr_scheduler": {"name": "step"}}, 5)


def _tree(seed=0):
    """A small parameter set with a vector, a matrix and a scalar leaf."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1, (4, 3)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32),
            "c": np.asarray([0.8], np.float32)}


def _grads(step, scale):
    rng = np.random.default_rng(100 + step)
    # well above rounding noise: |g| >= 0.1 * scale
    return {k: np.asarray(rng.uniform(0.1, 1.0, v.shape)
                          * rng.choice([-1.0, 1.0], v.shape) * scale,
                          np.float32) for k, v in _tree().items()}


def _run_both(cfg, n_calls, scale):
    params = _tree()
    tx = jax_optimizer(cfg, steps_per_epoch=4)
    state = tx.init(params)
    jp = params
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = optim.create_optimizer(cfg, tp, steps_per_epoch=4)
    out = []
    for i in range(n_calls):
        g = _grads(i, scale)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: v.numpy().copy() for k, v in tp.items()}))
    return out, state, opt


def _leaf_close(got, want, rtol=1e-6):
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rtol * scale, err_msg=k)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
@pytest.mark.parametrize("clipped", [False, True])
def test_optimizer_steps_match_optax(name, clipped):
    cfg = {"optimizer": {"name": name, "lr": 1e-2, "weight_decay": 0.05,
                         "betas": [0.8, 0.95], "momentum": 0.7},
           "lr_scheduler": {"name": "cosine", "t_max": 2,
                            "warmup_steps": 1},
           "gradient_clip_val": 1.0}
    # gradient norms ~5 (clip triggered) or ~0.05 (left alone)
    out, state, opt = _run_both(cfg, 3, 2.0 if clipped else 0.02)
    for want, got in out:
        _leaf_close(got, want)
    if name != "sgd":
        adam = state[1][0]
        assert opt.count == int(adam.count) == 3
        _leaf_close({k: v.numpy() for k, v in opt.mu.items()},
                    {k: np.asarray(v) for k, v in adam.mu.items()})
        _leaf_close({k: v.numpy() for k, v in opt.nu.items()},
                    {k: np.asarray(v) for k, v in adam.nu.items()})
    norm = float(optim.global_norm(
        [torch.from_numpy(v) for v in _grads(0, 2.0).values()]))
    assert norm > 1.0   # the clipped case really clips


def test_multisteps_k2():
    cfg = dict(TRAIN_CFG, accumulate_grad_batches=2)
    out, state, opt = _run_both(cfg, 5, 0.3)
    start = _tree()
    for i, (want, got) in enumerate(out):
        _leaf_close(got, want)
        prev = out[i - 1][1] if i else start
        moved = not np.array_equal(got["a"], prev["a"])
        assert moved == (i % 2 == 1), i
    assert (opt.mini_step, opt.gradient_step, opt.count) == (1, 2, 2)
    assert (int(state.mini_step), int(state.gradient_step)) == (1, 2)


def test_optimizer_state_round_trip():
    params = {k: torch.from_numpy(v) for k, v in _tree().items()}
    opt = optim.create_optimizer(dict(TRAIN_CFG, accumulate_grad_batches=2),
                                 params)
    for i in range(3):
        opt.step({k: torch.from_numpy(v) for k, v in _grads(i, 1.0).items()})
    sd = opt.state_dict()
    other = optim.create_optimizer(
        dict(TRAIN_CFG, accumulate_grad_batches=2),
        {k: v.clone() for k, v in params.items()})
    other.load_state_dict(sd)
    assert other.state_dict().keys() == sd.keys()
    for key in ("mu", "nu", "acc"):
        for k in sd[key]:
            assert torch.equal(other.state_dict()[key][k], sd[key][k])
    bad = dict(sd, mu={**sd["mu"], "a": torch.zeros(2)})
    with pytest.raises(ValueError, match="mu"):
        other.load_state_dict(bad)
    with pytest.raises(ValueError, match="sgd"):
        other.load_state_dict(dict(sd, name="sgd"))


# ---------------------------------------------------------------------------
# the trainers against the JAX trainers
# ---------------------------------------------------------------------------

def _audio(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * rng.random((b, 1))
    x = (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) + 0.02 * rng.standard_normal((b, n)))
    return x.astype(np.float32)


def _batch(b, frames, seed=0, window_target=False):
    rng = np.random.default_rng(seed + 1)
    return {"audio": _audio(b, frames * HOP, seed),
            "blendshapes": rng.uniform(0, 1, (b, frames, 52)).astype(
                np.float32)}


def _case(kind, backend="basic", cfg=TRAIN_CFG, jax_kw=None, port_kw=None):
    """(JAX trainer, port trainer with JAX's initial parameters, batch);
    ``jax_kw`` / ``port_kw`` go to the JAX / the port's model."""
    kw = dict(d_model=32, num_heads=2, emotion_backend=backend,
              use_concatenation=backend == "egemaps", target_fps=30,
              dropout=0.0)
    jkw, pkw = dict(kw, **(jax_kw or {})), dict(kw, **(port_kw or {}))
    tmp = tempfile.mkdtemp()
    if kind == "window":
        jt = JaxDST(JaxSimple(mel_sequence_length=32, **jkw),
                    {"training": cfg}, work_dir=tmp + "/j",
                    steps_per_epoch=1)
        tt = DualStreamTrainer(dm.SimplifiedDualStreamModel(
            mel_sequence_length=32, **pkw), {"training": cfg},
            work_dir=tmp + "/t", steps_per_epoch=1, device="cpu")
        batch = _batch(8, 32)
    else:
        full = {"training": cfg, "data": {"window_frames": 24}}
        jt = JaxST(JaxSeq(mel_sequence_length=16, stride_frames=4, **jkw),
                   full, work_dir=tmp + "/j", steps_per_epoch=1)
        tt = SequentialTrainer(dm.SequentialDualStreamModel(
            mel_sequence_length=16, stride_frames=4, **pkw), full,
            work_dir=tmp + "/t", steps_per_epoch=1, device="cpu")
        batch = _batch(8, 24)
    # One parameter set for both trainers: JAX's initialization with the
    # stream weights moved off their two-valued start. There every
    # expression blendshape of a window predicts the same value, so the
    # smoothness term's |diff| sits on its kink and the gradient's sign
    # is decided by rounding.
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.params))
    rng = np.random.default_rng(7)
    for k in PERTURBED:
        sd[k] = sd[k] + torch.from_numpy(
            rng.normal(0, 0.5, sd[k].shape).astype(np.float32))
    tt.model.load_state_dict(sd)
    jt.state = jt.state.replace(params=jax.tree_util.tree_map(
        lambda old, new: jax.device_put(np.asarray(new), old.sharding),
        jt.state.params, flax_from_state_dict(sd)))
    return jt, tt, batch


def _jax_grads(jt, prepared, dtype):
    """JAX's gradients of the first step's loss, with the parameters and
    every float input but the audio in ``dtype``: in float64 the features
    stay JAX's float32 ones and the projection, attention, smoothing and
    loss after them are float64."""
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                    jt.state.params)
    batch = {k: np.asarray(v, dtype) if k != "audio"
             and np.asarray(v).dtype == np.float32 else np.asarray(v)
             for k, v in prepared.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, b, jt.state.step_rng()), has_aux=True))
    with jax.enable_x64(dtype == np.float64):
        (loss, metrics), grads = fn(params, batch)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    return loss, metrics, _named(grads)


def _named(tree: dict) -> dict:
    """A flax gradient tree under the state dict's names, in float64. The
    bridge is float32, so a float64 leaf crosses it as two float32 parts
    (the rounded value and the rest), joined again after it."""
    hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    lo = jax.tree_util.tree_map(lambda a, h: (a - h).astype(np.float32),
                                tree, hi)
    hi, lo = state_dict_from_flax(hi), state_dict_from_flax(lo)
    return {k: hi[k].double().numpy() + lo[k].double().numpy() for k in hi}


def _check_grads(got: dict, want32: dict, want64: dict):
    """Each leaf of the port's float32 gradient within GRAD_TOL of the
    leaf's largest element of JAX's float64 gradient, or within twice the
    distance of JAX's own float32 gradient from it where that is larger
    (a gradient that sums terms much larger than itself, where any float32
    computation rounds at that level). JAX's own distance is held under
    ten times GRAD_TOL, so no leaf is held looser than 2e-3."""
    for k, w in want64.items():
        scale = np.abs(w).max()
        d_jax = np.abs(want32[k] - w).max()
        assert d_jax <= 10 * GRAD_TOL * scale, (k, d_jax / scale)
        d_port = np.abs(got[k] - w).max()
        assert d_port <= max(GRAD_TOL * scale, 2 * d_jax), (
            k, d_port / scale, d_jax / scale)


@pytest.mark.parametrize("kind,backend", [("window", "basic"),
                                          ("sequence", "basic"),
                                          ("sequence", "egemaps")])
def test_first_step_loss_and_gradients_match_jax(kind, backend):
    jt, tt, batch = _case(kind, backend)
    jprep = jt._prepare(batch)
    jloss, jmetrics, want32 = _jax_grads(jt, jprep, np.float32)
    _, _, want64 = _jax_grads(jt, jprep, np.float64)

    prep = tt._prepare(batch)
    tt.model.train()
    loss, metrics = tt.loss_fn(prep, dropout_generator(0, 0, tt.device))
    grads = torch.autograd.grad(loss, list(tt.params.values()),
                                allow_unused=True)
    # an unused parameter (the window model's smoothing_alpha) has a zero
    # gradient in JAX
    got = {k: np.zeros(p.shape, np.float32) if g is None else g.numpy()
           for (k, p), g in zip(tt.params.items(), grads)}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    assert sorted(got) == sorted(want64)
    _check_grads(got, want32, want64)


def test_sgd_three_steps_match_jax():
    cfg = dict(TRAIN_CFG, optimizer={"name": "sgd", "lr": 0.5,
                                     "momentum": 0.9})
    jt, tt, _ = _case("sequence", cfg=cfg)
    batches = [_batch(8, 24, seed=s) for s in (0, 10, 20)]
    start = {k: v.detach().clone().numpy() for k, v in tt.params.items()}
    jt.train_epoch(iter(batches))
    tt.train_epoch(iter(batches))
    jp = {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.state.params)).items()}
    assert tt.global_step == jt.global_step == 3
    for k, p in tt.params.items():
        d_port = p.detach().numpy() - start[k]
        d_jax = jp[k] - start[k]
        scale = np.abs(d_jax).max()
        # plus one float32 rounding step of the parameter, the resolution
        # of a change measured as a difference
        ulp = np.finfo(np.float32).eps * np.abs(start[k]).max()
        np.testing.assert_allclose(d_port, d_jax, rtol=0,
                                   atol=GRAD_TOL * scale + ulp, err_msg=k)


def test_sequence_targets_alignment():
    bs = torch.arange(10)[None, :, None] * torch.ones((1, 10, 52))
    t = sequence_targets(bs, window_frames=4, stride_frames=2, n_out=3)
    assert t[0, :, 0].tolist() == [3, 5, 7]


# ---------------------------------------------------------------------------
# dropout (port only: masks cannot equal JAX's)
# ---------------------------------------------------------------------------

def _seq_model(dropout=0.1, seed=0):
    m = dm.SequentialDualStreamModel(d_model=32, num_heads=2,
                                     mel_sequence_length=16, stride_frames=4,
                                     emotion_backend="basic",
                                     use_concatenation=False,
                                     dropout=dropout)
    m.init_random(torch.Generator().manual_seed(seed))
    return m


def test_dropout_module():
    d = Dropout(0.25)
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(3)
    y = d(x, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.005
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    assert torch.equal(d(x, torch.Generator().manual_seed(3)), y)
    assert d(x) is x                      # no generator: identity
    d.eval()
    assert d(x, g) is x                   # eval mode: identity
    with pytest.raises(ValueError):
        Dropout(1.0)


def test_dropout_sites_and_eval_forward():
    m = _seq_model()
    sites = {name for name, mod in m.named_modules()
             if isinstance(mod, Dropout)}
    assert sites == {"dual_stream_attention.mel_attention.attn_dropout",
                     "dual_stream_attention.emotion_attention.attn_dropout",
                     "dual_stream_attention.blendshape_decoder.2"}
    assert all(m.get_submodule(s).rate == 0.1 for s in sites)
    x = torch.from_numpy(_audio(2, 28 * HOP))
    with torch.no_grad():
        plain = _seq_model(dropout=0.0)(x)["blendshapes"]
        m.eval()
        evald = m(x, generator=torch.Generator().manual_seed(1))
        m.train()
        no_gen = m(x)["blendshapes"]
        a = m(x, generator=torch.Generator().manual_seed(1))["blendshapes"]
        b = m(x, generator=torch.Generator().manual_seed(1))["blendshapes"]
        c = m(x, generator=torch.Generator().manual_seed(2))["blendshapes"]
    assert torch.equal(evald["blendshapes"], plain)
    assert torch.equal(no_gen, plain)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)


def test_dropout_masks_differ_across_windows():
    """In training each window gets its own emotion row, so the expression
    half of the output (which depends on the emotion branch alone) differs
    between the windows of one utterance; in eval it is shared."""
    m = _seq_model(dropout=0.3)
    m.train()
    att = m.dual_stream_attention
    seen = {}
    hook = att.register_forward_hook(
        lambda mod, i, o: seen.__setitem__("raw", o["blendshapes"].detach()))
    x = torch.from_numpy(_audio(2, 28 * HOP))
    with torch.no_grad():
        m(x, generator=torch.Generator().manual_seed(4))
        n = seen["raw"].shape[0] // 2
        expr = seen["raw"].reshape(2, n, 52)[:, :, list(EXPRESSION_INDICES)]
        assert n == 4 and not torch.equal(expr[:, 0], expr[:, 1])
        m.eval()
        m(x)
        expr = seen["raw"].reshape(2, n, 52)[:, :, list(EXPRESSION_INDICES)]
    hook.remove()
    assert torch.equal(expr[:, 0], expr[:, 1])


def test_dropout_generator_is_a_function_of_seed_and_step():
    a = torch.rand(5, generator=dropout_generator(7, 3, torch.device("cpu")))
    b = torch.rand(5, generator=dropout_generator(7, 3, torch.device("cpu")))
    c = torch.rand(5, generator=dropout_generator(7, 4, torch.device("cpu")))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# inference tensors, convergence
# ---------------------------------------------------------------------------

def test_decode_then_train_in_one_process(tmp_path):
    """A decode under inference mode fills the constant caches and moves
    the model; a train step afterwards must not meet inference tensors. A
    model built under inference mode trains too."""
    cfg = {"training": TRAIN_CFG, "data": {"window_frames": 24}}
    model = _seq_model(dropout=0.1)
    x = _audio(2, 24 * HOP)
    dec = BatchedSequentialDecoder(model, "cpu", graphs=False)
    dec(x)
    tt = SequentialTrainer(model, cfg, work_dir=tmp_path / "a",
                           steps_per_epoch=1, device="cpu")
    before = {k: v.detach().clone() for k, v in tt.params.items()}
    m = tt.train_epoch(iter([_batch(2, 24)]))
    assert np.isfinite(m["loss"])
    assert all(not torch.equal(before[k], v) for k, v in tt.params.items()
               if k != "dual_stream_attention.expression_queries")
    out = dec(x)
    assert out.shape == (2, 3, 52)
    with torch.inference_mode():
        built = _seq_model()
    t2 = SequentialTrainer(built, cfg, work_dir=tmp_path / "b",
                           steps_per_epoch=1, device="cpu")
    assert np.isfinite(t2.train_epoch(iter([_batch(2, 24)]))["loss"])


def test_dual_stream_learns_constant_target(tmp_path):
    cfg = {"optimizer": {"name": "adamw", "lr": 5e-3, "weight_decay": 0.0,
                         "betas": [0.9, 0.999]},
           "lr_scheduler": {"name": "constant"},
           "loss": {"mse_weight": 1.0, "l1_weight": 0.0,
                    "perceptual_weight": 0.0},
           "gradient_clip_val": 1.0,
           "logging": {"log_every_n_steps": 1000, "tensorboard": False},
           "checkpoint": {"keep_epoch_every": 1000}}
    target = np.linspace(0.005, 0.04, 52)
    model = dm.SimplifiedDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16,
        emotion_backend="basic", use_concatenation=False, target_fps=30,
        dropout=0.0)
    trainer = DualStreamTrainer(model, {"training": cfg}, work_dir=tmp_path,
                                steps_per_epoch=25, device="cpu")
    rng = np.random.default_rng(0)
    batches = [{"audio": (rng.standard_normal((8, 16 * HOP)) * 0.1).astype(
                    np.float32),
                "blendshapes": np.tile(target, (8, 16, 1)).astype(
                    np.float32)} for _ in range(25)]
    first = trainer.validate(iter(batches[:1]))["loss"]
    trainer.train_epoch(iter(batches))
    last = trainer.validate(iter(batches[:1]))["loss"]
    assert last < 0.6 * first, (first, last)


def test_unported_trainer_features_raise(tmp_path):
    cfg = {"training": dict(TRAIN_CFG, logging={"tensorboard": False})}
    kw = dict(work_dir=tmp_path, steps_per_epoch=1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        SequentialTrainer(_seq_model(), cfg, tensor_parallel=True, **kw)
    tt = SequentialTrainer(_seq_model(), cfg, **kw)
    with pytest.raises(NotImplementedError, match="item 10"):
        tt.fit(lambda: iter([]), use_scan=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        tt.train_epoch_scan(iter([]))
    tt._log_attention_images({})          # no writer: nothing to log
    # attention images are ported (test_torch_attention_out.py): a call
    # that fails logs and leaves the writer untouched, to retry later
    tt.writer = object()
    tt._log_attention_images({})
    assert dataclasses.fields(tt.loss_config)
