"""PyTorch port: data-parallel training over a ``torch.distributed`` group.

The port's ranks run in processes of their own, gloo on the CPU
(``tests/test_torch_dp_ranks.py``: one spawn per world size, all started
before the JAX side compiles, one thread each). Against the JAX trainers
on ``make_mesh(2)`` and ``make_mesh(4)`` of the 8 virtual CPU devices,
from one parameter set, on batches of 7 rows (padded to 8: at world 2
the second rank holds one padding row of four, at world 4 the last rank
one of two; the loss depends on the padding, since the batch mask's
scale also multiplies the stream-separation term, so both meshes pad
alike and share JAX's gradient), for
the dual-stream window trainer and ``KoeMorphTrainer`` with the
perceptual term on, the tolerances of ``tests/parallel/``:

- the loss at rtol 1e-5;
- every gradient leaf within 1e-4 of its largest element of JAX's float64
  gradient, or twice JAX's own float32 distance where larger, the rule of
  ``tests/test_torch_train.py`` for the one-device step;
- the parameters after the step at rtol 2e-4 / atol 2e-6. Adam's first
  update is about ``lr * sign(g)``, so on a gradient element within the
  gradient check's tolerance of zero, reduction-order epsilon can flip
  the update (JAX's own sharded test saw O(10%) of an element). An element
  that trips the parameter check is accepted only where its gradient is
  that close to zero: there the gradient check is the one that decides.

Port only: at world 1 the data-parallel step is the single-process step
bit for bit; at world 2 with dropout 0.1 (the global batch's masks, each
rank keeping its rows) two steps on batches that need no padding stay
within the tolerances above of the single-process steps (a padded batch
draws the padded batch's masks, which a single process that does not pad
does not draw); every rank's replica is rank 0's after the trainer
starts (each rank draws other weights first) and stays identical; a
resumed run is bit for bit the uninterrupted one; the scan epoch is bit
for bit the step loop; the compiled step refuses gloo.
"""

import tempfile

import jax
import numpy as np
import pytest
import torch

from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel as JaxSimple)
from koemorph_tpu.models.simplified import (
    SimplifiedKoeMorphModel as JaxSimplified)
from koemorph_tpu.parallel.mesh import make_mesh as jax_make_mesh
from koemorph_tpu.train import DualStreamTrainer as JaxDST
from koemorph_tpu.train import KoeMorphTrainer as JaxKT
from koemorph_tpu_torch.parallel import make_mesh
from koemorph_tpu_torch.train.trainer import DualStreamTrainer
from koemorph_tpu_torch.utils.params import (flax_from_state_dict,
                                             state_dict_from_flax)
from tests import test_torch_dp_ranks as ranks
from tests.test_torch_train import GRAD_TOL, PERTURBED, _check_grads, _named

torch.set_num_threads(2)

KINDS = ("window", "frame")
WORLDS = (1, 2, 4)
CHECKS = {1: ["step"], 2: ["broadcast", "step", "dropout", "resume", "scan"],
          4: ["broadcast", "step"]}


def _jax_trainer(kind: str, n_dev: int):
    mesh = jax_make_mesh(n_dev)
    tmp = tempfile.mkdtemp()
    if kind == "window":
        return JaxDST(JaxSimple(**ranks.WINDOW_MODEL, dropout=0.0),
                      {"training": ranks.WINDOW_CFG}, work_dir=tmp,
                      steps_per_epoch=1, mesh=mesh)
    return JaxKT(JaxSimplified(**ranks.FRAME_MODEL, dropout=0.0),
                 {"training": ranks.FRAME_CFG}, work_dir=tmp,
                 steps_per_epoch=1, audio_samples=8000, mesh=mesh)


def _set_params(jt, sd: dict) -> None:
    jt.state = jt.state.replace(params=jax.tree_util.tree_map(
        lambda old, new: jax.device_put(np.asarray(new), old.sharding),
        jt.state.params, flax_from_state_dict(sd)))


def _jax_grads(jt, prepared, dtype) -> dict:
    """JAX's gradient of the step's loss, the parameters and the float
    inputs but the audio in ``dtype``, under the state dict's names."""
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                    jt.state.params)
    batch = {k: np.asarray(v, dtype) if k != "audio"
             and np.asarray(v).dtype == np.float32 else np.asarray(v)
             for k, v in prepared.items()}
    fn = jax.jit(jax.grad(lambda p, b: jt.loss_fn(p, b, None)[0]))
    with jax.enable_x64(dtype == np.float64):
        grads = jax.tree_util.tree_map(np.asarray, fn(params, batch))
    return _named(grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results of every world (started first), then the JAX
    trainers' steps and gradients and the port's single-process steps."""
    out = tmp_path_factory.mktemp("dp")
    batches = {"window": ranks.window_batch(7, seed=3),
               "frame": ranks.frame_batch(7, seed=4)}
    jts = {(k, n): _jax_trainer(k, n) for k in KINDS for n in (2, 4)}
    states = {}
    for kind in KINDS:
        sd = state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, jts[kind, 2].state.params))
        if kind == "window":
            # off the stream weights' two-valued start, as in
            # tests/test_torch_train.py
            rng = np.random.default_rng(7)
            for k in PERTURBED:
                sd[k] = sd[k] + torch.from_numpy(
                    rng.normal(0, 0.5, sd[k].shape).astype(np.float32))
        states[kind] = sd
        torch.save(sd, out / f"{kind}_state.pth")
    np.savez(out / "batches.npz", **{f"{k}/{n}": v for k in KINDS
                                     for n, v in batches[k].items()})
    started = {}
    for world in WORLDS:
        d = out / f"w{world}"
        d.mkdir()
        (d / "batches.npz").symlink_to(out / "batches.npz")
        for kind in KINDS:
            (d / f"{kind}_state.pth").symlink_to(out / f"{kind}_state.pth")
        started[world] = ranks.start(world, CHECKS[world], d)

    jax_out = {}
    for (kind, n), jt in jts.items():
        _set_params(jt, states[kind])
        prep = jt._prepare(batches[kind])
        assert np.asarray(prep["sample_mask"]).tolist() == [1] * 7 + [0]
        if n == 2:
            jax_out[kind, "grad32"] = _jax_grads(jt, prep, np.float32)
            jax_out[kind, "grad64"] = _jax_grads(jt, prep, np.float64)
        metrics = jt.train_epoch(iter([batches[kind]]))
        jax_out[kind, n, "loss"] = metrics["loss"]
        jax_out[kind, n, "params"] = {
            k: v.numpy() for k, v in state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, jt.state.params)).items()}

    # the ranks run one thread; the CPU's reductions order by thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    single = {}
    for kind in KINDS:
        t = ranks.make_trainer(kind, out / f"single_{kind}")
        t.model.load_state_dict(states[kind])
        m = t.train_step(t._prepare(batches[kind]))
        single[kind] = (float(m["loss"]), {k: v.detach().numpy().copy()
                                           for k, v in t.params.items()})
    t = ranks.make_trainer("window", out / "single_drop", dropout=0.1)
    m = t.train_epoch(iter(ranks.dropout_batches()))
    single["dropout"] = (m["loss"], {k: v.detach().numpy().copy()
                                     for k, v in t.params.items()})
    torch.set_num_threads(threads)
    return ({w: ranks.join(h) for w, h in started.items()}, jax_out,
            single)


def _params(res: dict, prefix: str) -> dict:
    head = f"{prefix}/param/"
    return {k[len(head):]: v for k, v in res.items() if k.startswith(head)}


def _check_params(got: dict, want: dict, grad64: dict = None):
    """rtol 2e-4 / atol 2e-6; with ``grad64``, an element off by more is
    accepted only where its gradient is within the gradient check's
    tolerance of zero (Adam's first update there is a sign of noise)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        bad = ~np.isclose(got[k], w, rtol=2e-4, atol=2e-6)
        if grad64 is not None and bad.any():
            g = grad64[k]
            bad &= np.abs(g) > GRAD_TOL * np.abs(g).max()
        assert not bad.any(), (k, np.abs(got[k] - w).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_dp_step_matches_jax_mesh(runs, kind, world):
    results, jax_out, _ = runs
    res = results[world][0]
    np.testing.assert_allclose(float(res[f"{kind}/loss"]),
                               jax_out[kind, world, "loss"], rtol=1e-5)
    grads = {k[len(kind) + 6:]: v for k, v in res.items()
             if k.startswith(f"{kind}/grad/")}
    want64 = jax_out[kind, "grad64"]
    assert sorted(grads) == sorted(want64)
    _check_grads(grads, jax_out[kind, "grad32"], want64)
    _check_params(_params(res, kind), jax_out[kind, world, "params"],
                  want64)


@pytest.mark.parametrize("kind", KINDS)
def test_world_1_is_the_single_process_step(runs, kind):
    results, _, single = runs
    res = results[1][0]
    loss, params = single[kind]
    assert float(res[f"{kind}/loss"]) == np.float32(loss)
    got = _params(res, kind)
    for k, v in params.items():
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_stay_identical(runs, world):
    """Every rank starts from rank 0's weights (each drew its own) and
    ends each check with rank 0's parameters, bit for bit."""
    results = runs[0][world]
    first = results[0]
    for other in results[1:]:
        assert int(other["world"]) == world
        assert sorted(other) == sorted(first)
        for k, v in first.items():
            assert np.array_equal(other[k], v), k
    start = _params(first, "broadcast")
    assert start and any(
        not np.array_equal(v, p) for v, p in zip(
            start.values(), ranks.make_trainer(
                "window", tempfile.mkdtemp(), seed=43).params.values()))


def test_dp_dropout_matches_single_process(runs):
    results, _, single = runs
    res = results[2][0]
    loss, params = single["dropout"]
    np.testing.assert_allclose(float(res["dropout/loss"]), loss, rtol=1e-5)
    _check_params(_params(res, "dropout"), params)


def test_dp_resume_is_the_uninterrupted_run(runs):
    res = runs[0][2][0]
    whole, resumed = _params(res, "resume_whole"), _params(
        res, "resume_resumed")
    assert whole and sorted(whole) == sorted(resumed)
    for k, v in whole.items():
        assert np.array_equal(resumed[k], v), k


def test_dp_scan_epoch_is_the_step_loop(runs):
    res = runs[0][2][0]
    assert float(res["scan/loss"]) == float(res["loop/loss"])
    scan, loop = _params(res, "scan"), _params(res, "loop")
    for k, v in loop.items():
        assert np.array_equal(scan[k], v), k


def test_compiled_step_refuses_gloo(runs):
    for world in (2, 4):
        assert all(bool(r["gloo_graph_refused"]) for r in runs[0][world])


def test_training_meshes_are_process_groups(tmp_path):
    """A mesh of several entries in one process is not a way to train: one
    process per card. A one-entry mesh is its device."""
    with pytest.raises(ValueError, match="one process per device"):
        ranks.make_trainer("window", tmp_path / "a",
                           mesh=make_mesh(devices=["cpu", "cpu"]))
    t = ranks.make_trainer("window", tmp_path / "b",
                           mesh=make_mesh(devices=["cpu"]))
    assert t.mesh is None and t.world == 1 and t.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="item 8"):
        DualStreamTrainer(t.model, {}, work_dir=tmp_path / "c",
                          device="cpu", tensor_parallel=True)
