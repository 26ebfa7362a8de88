"""PyTorch port: the compiled train step and the scan epochs.

Against the JAX package, on the same numpy batches and the same
(converted) parameters:

- ``SequentialTrainer.train_epoch_scan`` (3 steps, SGD with momentum, the
  last batch partial: padded and masked) against JAX's: each parameter's
  change within 1e-4 of its largest change plus one float32 rounding
  step of the parameter, the step-parity tolerance of
  ``test_torch_train.py``; the epoch's mean loss within 1e-5 relative;
- ``pad_batch_to_size``, ``pad_batch_to_multiple`` and
  ``batch_leading_size`` equal to JAX's.

Port only:

- the scan against the port's own step loop: bit for bit on full batches
  with dropout 0.1, within JAX's ``rtol=1e-6, atol=1e-7`` with a partial
  last batch; ``train_epochs_scan(n_epochs=2, shuffle_seed=5)`` bit for
  bit equal to per-epoch scans in the same orders (JAX's
  ``test_epochs_scan_matches_per_epoch_scan``, in the port's orders);
- the optimizer's device scalars bit for bit equal to the update with
  host scalars (a copy of the update before them), across a warm-up ->
  cosine boundary, with clipping and with ``accumulate_grad_batches=2``;
- the graphed step's logic on the CPU, with a stand-in for the CUDA graphs
  that warms and captures as ``StepGraphs`` does and replays the captured
  body: bit for bit the eager step over 5 steps (dropout 0.1, k = 1 and
  2), the first step included, and a resumed run bit for bit an
  uninterrupted one;
- each trainer's step body with every host copy and sync patched to raise,
  list and array indices included.
"""

import contextlib
import math
import tempfile

import jax
import numpy as np
import pytest
import torch

from koemorph_tpu.parallel import mesh as jmesh
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.models.simplified import SimplifiedKoeMorphModel
from koemorph_tpu_torch.parallel import mesh
from koemorph_tpu_torch.train import optim
from koemorph_tpu_torch.train.trainer import (DualStreamTrainer,
                                              KoeMorphTrainer,
                                              SequentialTrainer,
                                              dropout_generator,
                                              dropout_seed, scan_orders)
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from tests.test_torch_train import GRAD_TOL, TRAIN_CFG, _batch, _case

torch.set_num_threads(2)

SGD_CFG = dict(TRAIN_CFG, optimizer={"name": "sgd", "lr": 0.5,
                                     "momentum": 0.9})


# ---------------------------------------------------------------------------
# the scan epoch against JAX's
# ---------------------------------------------------------------------------

def test_scan_epoch_matches_jax_with_partial_batch():
    jt, tt, _ = _case("sequence", cfg=SGD_CFG)
    batches = [_batch(8, 24, seed=s) for s in (0, 10, 20)]
    batches[-1] = {k: v[:5] for k, v in batches[-1].items()}
    start = {k: v.detach().clone().numpy() for k, v in tt.params.items()}
    jm = jt.train_epoch_scan(iter(batches))
    tm = tt.train_epoch_scan(iter(batches))
    assert tt.global_step == jt.global_step == 3
    assert tt.optimizer.count == 3
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    jp = {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.state.params)).items()}
    for k, p in tt.params.items():
        d_port = p.detach().numpy() - start[k]
        d_jax = jp[k] - start[k]
        ulp = np.finfo(np.float32).eps * np.abs(start[k]).max()
        np.testing.assert_allclose(d_port, d_jax, rtol=0,
                                   atol=GRAD_TOL * np.abs(d_jax).max() + ulp,
                                   err_msg=k)


@pytest.mark.parametrize("sizes", [(4, 4), (4, 3), (1, 0), (3, 5)])
def test_pad_helpers_match_jax(sizes):
    b, target = sizes
    rng = np.random.default_rng(b)
    batch = {"audio": rng.standard_normal((b, 7)).astype(np.float32),
             "arkit": rng.uniform(0, 1, (b, 2, 52)).astype(np.float32),
             "step": np.asarray(3)}
    for fn, jfn, arg in ((mesh.pad_batch_to_size, jmesh.pad_batch_to_size,
                          target),
                         (mesh.pad_batch_to_multiple,
                          jmesh.pad_batch_to_multiple, max(target, 1))):
        got, real = fn(batch, arg)
        want, jreal = jfn(batch, arg)
        assert real == jreal == mesh.batch_leading_size(batch) \
            == jmesh.batch_leading_size(batch)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
    assert mesh.batch_leading_size({"s": np.asarray(1.0)}) == 0
    bad = {"a": np.zeros((2, 3)), "b": np.zeros((3,))}
    with pytest.raises(ValueError, match="Heterogeneous"):
        mesh.batch_leading_size(bad)
    with pytest.raises(ValueError, match="Heterogeneous"):
        jmesh.batch_leading_size(bad)


# ---------------------------------------------------------------------------
# the scan against the port's own step loop
# ---------------------------------------------------------------------------

def _seq_trainer(tmp, dropout=0.1, cfg=TRAIN_CFG, **kw):
    model = dm.SequentialDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16, stride_frames=4,
        emotion_backend="basic", use_concatenation=False, dropout=dropout)
    return SequentialTrainer(model, {"training": cfg,
                                     "data": {"window_frames": 24}},
                             work_dir=tmp, steps_per_epoch=3, device="cpu",
                             **kw)


def _legacy_trainer(tmp, dropout=0.1):
    return KoeMorphTrainer(
        SimplifiedKoeMorphModel(d_model=32, num_heads=2, decoder_hidden=16,
                                dropout=dropout),
        {"training": TRAIN_CFG}, work_dir=tmp, steps_per_epoch=3,
        device="cpu")


def _legacy_batches(n, batch=8, samples=1600):
    rng = np.random.default_rng(0)
    return [{"audio": rng.standard_normal((batch, samples)).astype(
                 np.float32) * 0.1,
             "arkit": rng.uniform(0, 1, (batch, 2, 52)).astype(np.float32),
             "arkit_mask": np.ones((batch, 2), bool)} for _ in range(n)]


def _state(trainer) -> dict:
    out = {f"p.{k}": v.detach().clone() for k, v in trainer.params.items()}
    opt = trainer.optimizer
    for name in ("mu", "nu", "trace", "acc"):
        for k, v in (getattr(opt, name, None) or {}).items():
            out[f"{name}.{k}"] = v.clone()
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_scan_epoch_equals_step_loop_bitwise(tmp_path):
    batches = [_batch(4, 24, seed=s) for s in (0, 10, 20)]
    loop = _seq_trainer(tmp_path / "a")
    m_loop = loop.train_epoch(iter(batches))
    scan = _seq_trainer(tmp_path / "b")
    m_scan = scan.train_epoch_scan(iter(batches))
    assert scan.global_step == loop.global_step == 3
    assert scan.optimizer.count == loop.optimizer.count == 3
    _assert_same(_state(scan), _state(loop))
    assert m_scan.keys() == m_loop.keys()
    for k in m_loop:
        np.testing.assert_allclose(m_scan[k], m_loop[k], rtol=1e-6,
                                   err_msg=k)


def test_scan_epoch_with_partial_batch_matches_step_loop(tmp_path):
    batches = _legacy_batches(3)
    batches[-1] = {k: v[:5] for k, v in batches[-1].items()}
    # no dropout: a padded batch draws its masks over more rows
    loop = _legacy_trainer(tmp_path / "a", dropout=0.0)
    m_loop = loop.train_epoch(iter(batches))
    scan = _legacy_trainer(tmp_path / "b", dropout=0.0)
    m_scan = scan.train_epoch_scan(iter(batches))
    assert scan.global_step == loop.global_step == 3
    a, b = _state(scan), _state(loop)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # the logged loss is not held: on padded rows the regularizers see the
    # detached targets (no gradient, a constant in the metric), as in JAX,
    # whose step loop pads to the device count too
    assert np.isfinite(m_scan["loss"]) and m_scan.keys() == m_loop.keys()


def test_epochs_scan_matches_per_epoch_scan(tmp_path):
    batches = _legacy_batches(3)
    multi = _legacy_trainer(tmp_path / "a")
    hist = multi.train_epochs_scan(iter(batches), n_epochs=2,
                                   shuffle_seed=5)
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    assert multi.global_step == 6 and multi.epoch == 2
    orders = scan_orders(3, 2, 5)
    assert orders[0] != orders[1]          # the order changes per epoch
    ref = _legacy_trainer(tmp_path / "b")
    per_epoch = [ref.train_epoch_scan(iter([batches[i] for i in order]))
                 for order in orders]
    _assert_same(_state(multi), _state(ref))
    for got, want in zip(hist, per_epoch):
        assert got == want


def test_stack_refuses_batches_of_other_shapes(tmp_path):
    trainer = _legacy_trainer(tmp_path)
    batches = _legacy_batches(2)
    batches[1]["audio"] = batches[1]["audio"][:, :800]
    with pytest.raises(ValueError, match="leading size"):
        trainer.train_epoch_scan(iter(batches))
    assert trainer.global_step == 0


# ---------------------------------------------------------------------------
# the optimizer's device scalars against the host-scalar update
# ---------------------------------------------------------------------------

def _host_scalar_step(opt, grads):
    """The update as it was with host scalars (``lr``, ``bc1``, ``bc2``
    Python floats), the moments and the accumulator reassigned."""
    if opt.acc is not None:
        n = opt.mini_step
        for k, g in grads.items():
            opt.acc[k] = opt.acc[k] + (g - opt.acc[k]) / (n + 1)
        opt.mini_step = (n + 1) % opt.accumulate
        if n != opt.accumulate - 1:
            return
        opt.gradient_step += 1
        grads = opt.acc
        opt.acc = {k: torch.zeros_like(p) for k, p in opt.params.items()}
    if opt.clip is not None:
        norm = optim.global_norm(grads.values())
        keep = norm < opt.clip
        grads = {k: torch.where(keep, g, g / norm * opt.clip)
                 for k, g in grads.items()}
    lr = opt.schedule(opt.count)
    opt.count += 1
    if opt.name == "sgd":
        for k, p in opt.params.items():
            opt.trace[k] = grads[k] + opt.momentum * opt.trace[k]
            p.add_(opt.trace[k] * -lr)
        return
    bc1 = 1.0 - opt.b1 ** opt.count
    bc2 = 1.0 - opt.b2 ** opt.count
    for k, p in opt.params.items():
        g = grads[k]
        opt.mu[k] = (1.0 - opt.b1) * g + opt.b1 * opt.mu[k]
        opt.nu[k] = (1.0 - opt.b2) * (g * g) + opt.b2 * opt.nu[k]
        update = (opt.mu[k] / bc1) / (torch.sqrt(opt.nu[k] / bc2) + opt.eps)
        if opt.weight_decay:
            update = update + opt.weight_decay * p
        p.add_(update * -lr)


@pytest.mark.parametrize("name,accumulate", [("adamw", 1), ("adamw", 2),
                                             ("sgd", 2)])
def test_device_scalars_equal_host_scalars(name, accumulate):
    cfg = {"optimizer": {"name": name, "lr": 3e-3, "weight_decay": 0.05,
                         "betas": [0.8, 0.95], "momentum": 0.7},
           "lr_scheduler": {"name": "cosine", "t_max": 3,
                            "warmup_steps": 3},
           "gradient_clip_val": 1.0, "accumulate_grad_batches": accumulate}
    rng = np.random.default_rng(accumulate)
    start = {"a": rng.normal(0, 1, (64, 3)).astype(np.float32),
             "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    new = optim.create_optimizer(
        cfg, {k: torch.from_numpy(v.copy()) for k, v in start.items()},
        steps_per_epoch=2)
    old = optim.create_optimizer(
        cfg, {k: torch.from_numpy(v.copy()) for k, v in start.items()},
        steps_per_epoch=2)
    lrs = set()
    for i in range(8 * accumulate):
        scale = 3.0 if i % 3 == 0 else 0.01        # clipped and not
        g = {k: torch.from_numpy(rng.normal(0, scale, v.shape).astype(
            np.float32)) for k, v in start.items()}
        lrs.add(new.lr)
        new.step(g)
        _host_scalar_step(old, g)
        for k in start:
            assert torch.equal(new.params[k], old.params[k]), (i, k)
        assert (new.count, new.mini_step) == (old.count, old.mini_step)
    # the run crossed the warm-up -> cosine boundary (step 3)
    assert len(lrs) >= 6 and new.count == 8
    for key in (("trace",) if name == "sgd" else ("mu", "nu")):
        for k in start:
            assert torch.equal(getattr(new, key)[k], getattr(old, key)[k])


def test_device_scalar_rows():
    cfg = {"optimizer": {"lr": 1e-3, "betas": [0.9, 0.999]},
           "lr_scheduler": {"name": "cosine", "t_max": 2}}
    opt = optim.create_optimizer(cfg, {"a": torch.zeros(3)},
                                 steps_per_epoch=5)
    rows = opt.scalars(300, 4)
    assert rows.shape == (4, 3) and rows.dtype == torch.float32
    for i, c in enumerate(range(300, 304)):
        assert rows[i, 0] == np.float32(-opt.schedule(c))
        assert rows[i, 1] == np.float32(1.0 - 0.9 ** (c + 1))
        assert rows[i, 2] == np.float32(1.0 - 0.999 ** (c + 1))
    assert torch.equal(opt.scalars(302)[0], rows[2])
    assert math.isclose(float(opt.scalars(0)[0, 0]), -1e-3, rel_tol=1e-6)


# ---------------------------------------------------------------------------
# the graphed step's logic, with a stand-in for the CUDA graphs
# ---------------------------------------------------------------------------

class _GraphsOnCPU:
    """Stands in for ``StepGraphs`` on the CPU: a capture runs the warm-up
    and keeps the body, a replay calls the body and returns a copy."""
    enabled = True

    def __init__(self):
        self.bodies, self.warmed, self.replays = {}, [], 0

    def __contains__(self, key):
        return key in self.bodies

    def keys(self):
        return list(self.bodies)

    def capture(self, key, body, warm=None, generators=()):
        assert len(generators) == 1
        if warm is not None:
            warm()
            self.warmed.append(key)
        self.bodies[key] = body

    def run(self, key, body):
        self.replays += 1
        return self.bodies[key]().clone()

    def drop(self, key):
        del self.bodies[key]


def _graphed(trainer):
    trainer.step_graphs = _GraphsOnCPU()
    return trainer


@pytest.mark.parametrize("accumulate", [1, 2])
def test_graphed_steps_equal_eager_steps(tmp_path, accumulate):
    cfg = dict(TRAIN_CFG, accumulate_grad_batches=accumulate)
    batches = [{k: torch.from_numpy(v) for k, v in
                _batch(4, 24, seed=s).items()} for s in range(5)]
    for b in batches:
        b["sample_mask"] = torch.ones(4)
    eager = _seq_trainer(tmp_path / "e", cfg=cfg)
    graphed = _graphed(_seq_trainer(tmp_path / "g", cfg=cfg))
    for i, b in enumerate(batches):
        want = eager.train_step(b)
        got = graphed.compiled_step(b)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        _assert_same(_state(graphed), _state(eager))
        assert graphed.optimizer.count == eager.optimizer.count
    # one graph per accumulation phase, captured after a warm-up that left
    # the state as it found it (the first step equals the eager one)
    assert len(graphed.step_graphs.warmed) == accumulate
    assert graphed.step_graphs.replays == len(batches)


def test_graphed_resume_equals_uninterrupted(tmp_path):
    batches = [_batch(4, 24, seed=s) for s in range(4)]
    full = _graphed(_seq_trainer(tmp_path / "full"))
    full.fit(lambda: iter(batches), max_epochs=1, use_scan=True)
    half = _graphed(_seq_trainer(tmp_path / "half"))
    half.train_epoch_scan(iter(batches[:2]))
    half._save(None)
    resumed = _graphed(_seq_trainer(tmp_path / "half"))
    assert resumed.resume() and resumed.global_step == 2
    resumed.train_epoch_scan(iter(batches[2:]))
    _assert_same(_state(resumed), _state(full))


def test_dropout_seed_is_the_generators():
    a = dropout_generator(42, 7, torch.device("cpu"))
    b = torch.Generator().manual_seed(dropout_seed(42, 7))
    assert torch.equal(torch.rand(16, generator=a),
                       torch.rand(16, generator=b))


# ---------------------------------------------------------------------------
# the step bodies reach no host
# ---------------------------------------------------------------------------

def _raise(*a, **k):
    raise AssertionError("host traffic in a captured body")


def _host_index(idx) -> bool:
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, (list, np.ndarray)) for i in items)


@contextlib.contextmanager
def _no_host_traffic(monkeypatch):
    """Every call that copies between host and device or waits for the
    device raises, a list or array index too; checked to take effect."""
    get, set_ = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def getitem(self, idx):
        if _host_index(idx):
            _raise()
        return get(self, idx)

    def setitem(self, idx, value):
        if _host_index(idx):
            _raise()
        return set_(self, idx, value)

    with monkeypatch.context() as m:
        for name in ("tensor", "as_tensor", "from_numpy"):
            m.setattr(torch, name, _raise)
        for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                     "__float__", "__int__"):
            m.setattr(torch.Tensor, name, _raise)
        m.setattr(torch.Tensor, "__getitem__", getitem)
        m.setattr(torch.Tensor, "__setitem__", setitem)
        probe = torch.zeros((3,))
        for call in (lambda: torch.tensor([1]), lambda: probe.item(),
                     lambda: bool(probe[0]), lambda: probe[[0, 1]],
                     lambda: probe[np.arange(2)],
                     lambda: torch.from_numpy(np.zeros(2)).to("cpu")):
            with pytest.raises(AssertionError, match="captured body"):
                call()
        yield


@pytest.mark.parametrize("kind", ["legacy", "window", "sequence"])
def test_step_bodies_reach_no_host(tmp_path, monkeypatch, kind):
    if kind == "legacy":
        trainer = _legacy_trainer(tmp_path)
        batch = _legacy_batches(1)[0]
    elif kind == "window":
        trainer = DualStreamTrainer(dm.SimplifiedDualStreamModel(
            d_model=32, num_heads=2, mel_sequence_length=32,
            emotion_backend="basic", use_concatenation=False, dropout=0.1),
            {"training": TRAIN_CFG}, work_dir=tmp_path, steps_per_epoch=1,
            device="cpu")
        batch = _batch(4, 32)
    else:
        trainer = _seq_trainer(tmp_path)
        batch = _batch(4, 24)
    assert trainer.params.get("dual_stream_attention.mel_weights",
                              kind == "legacy") is not None
    prepared = trainer._prepare(batch)
    gen = torch.Generator().manual_seed(1)
    scalars = trainer.optimizer.scalars(0)[0]
    trainer._step_body(prepared, gen, 0, scalars)       # warm the caches
    with _no_host_traffic(monkeypatch):
        metrics = trainer._step_body(prepared, gen, 0, scalars)
    assert "loss" in metrics and "grad_norm" in metrics
    if kind != "legacy":
        assert "stream/mel_on_mouth" in metrics


def test_scan_runs_on_a_fresh_trainer_without_jax_state():
    # the graph-free paths need no CUDA: fit(use_scan=True) on the CPU
    with tempfile.TemporaryDirectory() as tmp:
        trainer = _legacy_trainer(tmp)
        hist = trainer.fit(lambda: iter(_legacy_batches(2)), max_epochs=2,
                           use_scan=True)
    assert len(hist["train"]) == 2 and trainer.global_step == 4
    assert all(np.isfinite(h["loss"]) for h in hist["train"])


def test_rehearsal_smoke_sets_the_passing_recipe(monkeypatch, tmp_path):
    """``training_rehearsal --smoke`` takes the values of ``SMOKE`` (the
    recipe the gate probe found passing) before it writes its data."""
    from koemorph_tpu_torch import training_rehearsal
    from koemorph_tpu_torch.train import __main__ as train_cli

    seen = {}

    def stop(out_dir, n_files, **kw):
        seen.update(n_files=n_files, **kw)
        raise KeyboardInterrupt

    monkeypatch.setattr(train_cli, "write_synthetic_dataset", stop)
    with pytest.raises(KeyboardInterrupt):
        training_rehearsal.main(["--smoke", "--cpu", "--work-dir",
                                 str(tmp_path)])
    assert seen["n_files"] == training_rehearsal.SMOKE["files"] == 8
    assert training_rehearsal.SMOKE["epochs"] == 880
