"""PyTorch port: tensor-parallel training (``parallel/tp.py``,
``Trainer(tensor_parallel=True)``).

In one process, against ``koemorph_tpu.parallel.tp`` on the 8 virtual
CPU devices: the rule table on each family's parameters (the flagship
``SequentialDualStreamModel`` and ``SimplifiedDualStreamModel``,
``SimplifiedKoeMorphModel``, and the sequential model with an
``emotion2vec`` encoder at a small wav2vec2 width), leaf for leaf through
``utils/params.py``'s name mapping with each kernel's axes flipped, at
grids (4, 2) and (1, 8); the indivisible fallback; the optimizer's
moments taking their parameters' specs; a model axis of 1 replicating
every leaf.

Over ranks (gloo on the CPU, processes of ``tests/test_torch_tp_ranks.py``
started before the JAX side compiles, one thread each), at grids (1, 2)
and (2, 2), against JAX's tensor-parallel ``SequentialTrainer`` on
``make_mesh_2d`` of the same grid at JAX's ``tiny_model`` (d_model 32, 2
heads, window 16, ``basic``), from one parameter set, on 7 spans padded
to 8 (a multiple of every rank), with the tolerances of
``tests/test_torch_train_dp.py``: the loss at rtol 1e-5, every gradient
leaf by ``tests/test_torch_train.py``'s rule against JAX's float64
gradient, the parameters after the step at rtol 2e-4 / atol 2e-6, an
element outside accepted only where its gradient is within the gradient
check's tolerance of zero (Adam's first update there is a sign of
reduction-order noise).

Port only: two steps at dropout 0.1 at grid (2, 2) against the
single-process steps; the replicated leaves bitwise equal on every rank,
the shards equal across a data group, and each rank's shards and their
Adam moments 1/M of the whole; a tensor-parallel checkpoint (whole
tensors) loaded by a single-process trainer; a resumed run bitwise the
uninterrupted one; a single-process checkpoint resumed under tensor
parallelism; the scan epoch bitwise the step loop; the compiled step
refusing gloo; ``DualStreamTrainer`` and ``KoeMorphTrainer`` at grid
(1, 2) against their single-process steps.
"""

import functools
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JaxP
from torch import nn

from koemorph_tpu.features.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from koemorph_tpu.models.dual_stream_model import (
    SequentialDualStreamModel as JaxSeq)
from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel as JaxSimple)
from koemorph_tpu.models.simplified import (
    SimplifiedKoeMorphModel as JaxSimplified)
from koemorph_tpu.parallel import tp as jtp
from koemorph_tpu.train import SequentialTrainer as JaxST
from koemorph_tpu_torch.features.wav2vec2 import Wav2Vec2Config
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.models.simplified import SimplifiedKoeMorphModel
from koemorph_tpu_torch.parallel import tp
from koemorph_tpu_torch.train.optim import create_optimizer
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from tests import test_torch_dp_ranks as dp
from tests import test_torch_tp_ranks as ranks
from tests.test_torch_train import GRAD_TOL, PERTURBED, _check_grads
from tests.test_torch_train_dp import _check_params, _jax_grads, _set_params

torch.set_num_threads(2)

TINY_W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, conv_dim=(16, 16, 16),
                conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
#: family -> (JAX model, port model, samples of the init input, leaves,
#: leaves split at grid (4, 2)): the counts of the flagship widths
FAMILIES = {
    "sequential": (JaxSeq, dm.SequentialDualStreamModel, {}, 288 * 533, 31,
                   17),
    "simplified": (JaxSimple, dm.SimplifiedDualStreamModel, {}, 256 * 533,
                   31, 17),
    "legacy": (JaxSimplified, SimplifiedKoeMorphModel, {}, 16000, 15, 3),
    "emotion2vec": (JaxSeq, dm.SequentialDualStreamModel,
                    {"emotion_backend": "emotion2vec"}, 288 * 533, 84, 19),
}
GRIDS = ((1, 2), (2, 2))


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _family(name: str):
    """JAX's parameter shapes of the family (traced, not run) and the
    port's names for them: ``{port name: (JAX path, JAX shape,
    flipped)}``, from two crossings of ``state_dict_from_flax``: leaf ids,
    then each leaf's element order (a kernel crosses transposed)."""
    jax_cls, _, kw, samples, _, _ = FAMILIES[name]
    if name == "emotion2vec":
        kw = dict(kw, emotion2vec_config=JaxW2VConfig(**TINY_W2V))
    shapes = jax.eval_shape(jax_cls(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, samples), jnp.float32))["params"]
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    paths = [jax.tree_util.keystr(p) for p, _ in flat]
    dims = [tuple(leaf.shape) for _, leaf in flat]
    ids = state_dict_from_flax(jax.tree_util.tree_unflatten(
        treedef, [np.full(s, i, np.float32) for i, s in enumerate(dims)]))
    order = state_dict_from_flax(jax.tree_util.tree_unflatten(
        treedef, [np.arange(np.prod(s), dtype=np.float32).reshape(s)
                  for s in dims]))
    out = {}
    for k, v in ids.items():
        i = int(v.reshape(-1)[0])
        got = order[k].numpy()
        want = np.arange(np.prod(dims[i]), dtype=np.float32).reshape(
            dims[i])
        flipped = got.shape != want.shape or not np.array_equal(got, want)
        if flipped:
            assert np.array_equal(got, want.transpose()), k
        out[k] = (paths[i], dims[i], flipped)
    return shapes, out


def _port_spec(jax_spec, ndim: int, flipped: bool) -> tuple:
    full = tuple(jax_spec) + (None,) * (ndim - len(jax_spec))
    return full[::-1] if flipped else full


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("grid", [(4, 2), (1, 8)])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spec_table_matches_jax(family, grid, cpu_devices):
    shapes, names = _family(family)
    _, port_cls, kw, _, n_leaves, n_split = FAMILIES[family]
    if family == "emotion2vec":
        kw = dict(kw, emotion2vec_config=Wav2Vec2Config(**TINY_W2V))
    state = port_cls(**kw).state_dict()
    assert sorted(state) == sorted(names) and len(state) == n_leaves
    for k, (_, shape, flipped) in names.items():
        assert tuple(state[k].shape) == (shape[::-1] if flipped else shape)

    jmesh = jtp.make_mesh_2d(*grid)
    mesh = tp.make_mesh_2d(*grid, devices=["cpu"] * 8)
    assert mesh.shape == {"data": grid[0], "model": grid[1]}
    jspecs = jtp.tree_partition_specs(shapes, jmesh)
    flat = {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, JaxP))}
    specs = tp.tree_partition_specs(state, mesh)
    split = 0
    for k, (path, shape, flipped) in names.items():
        want = _port_spec(flat[path], len(shape), flipped)
        assert _padded(specs[k], len(shape)) == want, (k, path, flat[path])
        split += tp.MODEL_AXIS in want
    if grid == (4, 2):
        assert split == n_split


def test_indivisible_falls_back_to_replicated(cpu_devices):
    jmesh = jtp.make_mesh_2d(data=1, model=8)
    mesh = tp.make_mesh_2d(data=1, model=8, devices=["cpu"] * 8)
    for shape in ((96, 32), (17, 32)):
        want = jtp.partition_spec_for("x/in_proj_weight", shape, jmesh)
        got = tp.partition_spec_for("x.in_proj_weight", shape, mesh)
        assert tuple(got) == tuple(want)
    assert tp.partition_spec_for("a.out_proj.weight", (32, 12), mesh) == ()
    assert tp.partition_spec_for("a.out_proj.weight", (12, 32),
                                 mesh) == (None, tp.MODEL_AXIS)


def test_optimizer_moments_inherit_param_specs():
    model = dm.SequentialDualStreamModel(**ranks.SEQ_MODEL)
    params = dict(model.named_parameters())
    opt = create_optimizer({"optimizer": {"name": "adamw"}}, params)
    mesh = tp.make_mesh_2d(data=4, model=2, devices=["cpu"] * 8)
    specs = tp.tree_partition_specs(opt.state_dict(), mesh)
    by_param = tp.tree_partition_specs(model.state_dict(), mesh)
    assert specs["count"] == () and specs["name"] == ()
    for key in ("mu", "nu"):
        assert specs[key] == by_param
    assert specs["mu"]["dual_stream_attention.mel_attention."
                       "in_proj_weight"] == (tp.MODEL_AXIS, None)


def test_model_axis_of_one_replicates():
    model = dm.SequentialDualStreamModel(**ranks.SEQ_MODEL)
    mesh = tp.make_mesh_2d(model=1, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 8, "model": 1}
    specs = tp.tree_partition_specs(model.state_dict(), mesh)
    assert specs and all(s == () for s in specs.values())


def test_shard_tree_splits_and_rejoins():
    """In one process, ``shard_tree`` gives each entry (row-major) its
    contiguous blocks; the blocks of a row rejoin the whole."""
    model = dm.SequentialDualStreamModel(**ranks.SEQ_MODEL)
    model.init_random(torch.Generator().manual_seed(0))
    state = model.state_dict()
    mesh = tp.make_mesh_2d(data=2, model=2, devices=["cpu"] * 4)
    parts = tp.shard_tree(state, mesh)
    shardings = tp.tree_shardings(state, mesh)
    assert len(parts) == 4
    for k, v in state.items():
        spec = shardings[k].spec
        assert shardings[k].mesh is mesh
        if tp.MODEL_AXIS not in spec:
            assert all(torch.equal(p[k], v) for p in parts)
            continue
        dim = spec.index(tp.MODEL_AXIS)
        assert parts[0][k].shape[dim] * 2 == v.shape[dim]
        for row in (0, 2):
            assert torch.equal(torch.cat([parts[row][k], parts[row + 1][k]],
                                         dim), v)


def test_make_mesh_2d_raises_like_jax():
    with pytest.raises(ValueError, match="must divide"):
        tp.make_mesh_2d(model=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 12"):
        tp.make_mesh_2d(data=6, model=2, devices=["cpu"] * 8)
    mesh = tp.make_mesh_2d(data=2, model=2, devices=["cpu"] * 8)
    assert mesh.devices.shape == (2, 2) and not mesh.distributed


def test_parallelize_refuses_what_it_cannot_split():
    """A rule that matches a parameter of a module no sharded layer
    implements raises: nothing is replicated in silence."""
    mesh = tp.Mesh(tp.make_mesh_2d(data=1, model=2,
                                   devices=["cpu"] * 2).devices,
                   ("data", "model"), rank=0)
    model = nn.Module()
    model.attention = nn.MultiheadAttention(32, 2)
    with pytest.raises(ValueError, match="no sharded layer"):
        tp.parallelize(model, mesh)
    with pytest.raises(ValueError, match="process group"):
        tp.parallelize(model, tp.make_mesh_2d(1, 2, devices=["cpu"] * 2))


# ---------------------------------------------------------------------------
# over ranks
# ---------------------------------------------------------------------------

def _jax_trainer(grid):
    model = JaxSeq(**ranks.SEQ_MODEL, dropout=0.0)
    return JaxST(model, {"training": ranks.SEQ_CFG},
                 work_dir=tempfile.mkdtemp(), steps_per_epoch=1,
                 span_frames=ranks.SPAN, tensor_parallel=True,
                 mesh=jtp.make_mesh_2d(*grid))


def _single_step(kind, state, batch):
    t = ranks.make_trainer(kind, tempfile.mkdtemp(), tp=False)
    t.model.load_state_dict(state)
    prep = t._prepare(batch)
    grads = dp.step_grads(t, prep)
    m = t.train_step(prep)
    return (float(m["loss"]), float(m["grad_norm"]), grads,
            {k: v.detach().numpy().copy() for k, v in t.params.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_devices):
    """The ranks' results of both grids (started first), JAX's
    tensor-parallel steps and gradients, and the port's single-process
    runs."""
    out = tmp_path_factory.mktemp("tp")
    # the single-process steps do not pad: 8 rows of the other kinds
    batches = {"sequence": ranks.seq_batch(7, seed=3),
               "window": dp.window_batch(8, seed=4),
               "frame": dp.frame_batch(8, seed=5)}
    jts = {g: _jax_trainer(g) for g in GRIDS}
    states = {"sequence": state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jts[GRIDS[0]].state.params))}
    for kind in ("window", "frame"):
        states[kind] = ranks.make_trainer(kind, out / f"init_{kind}",
                                          tp=False).model.state_dict()
    rng = np.random.default_rng(7)
    for kind in ("sequence", "window"):      # off the kink, as in PR 14
        for k in PERTURBED:
            states[kind][k] = states[kind][k] + torch.from_numpy(
                rng.normal(0, 0.5, states[kind][k].shape).astype(
                    np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the ranks' reductions run one thread
    single_src = out / "single_src"
    first = ranks.make_trainer("sequence", single_src, dropout=0.1, tp=False)
    first.fit(ranks.epochs, max_epochs=1)
    ckpt = {k: v.detach().numpy().copy() for k, v in first.params.items()}
    moments = {key: {k: v.numpy().copy() for k, v in getattr(
        first.optimizer, key).items()} for key in ("mu", "nu")}
    torch.set_num_threads(threads)

    started = {}
    for grid in GRIDS:
        d = out / f"g{grid[0]}{grid[1]}"
        d.mkdir()
        np.savez(d / "batches.npz", **{f"{k}/{n}": v for k in batches
                                       for n, v in batches[k].items()})
        for kind, sd in states.items():
            torch.save(sd, d / f"{kind}_state.pth")
        if grid == (2, 2):
            shutil.copytree(single_src / "checkpoints",
                            d / "single_ckpt" / "checkpoints")
            checks, kinds = ["step", "dropout", "resume"], ["sequence"]
        else:
            checks, kinds = ["step", "scan"], ["sequence", "window", "frame"]
        started[grid] = dp.start(grid[0] * grid[1], checks, d,
                                 module="tests.test_torch_tp_ranks",
                                 grid=list(grid), kinds=kinds)

    jax_out = {}
    for grid, jt in jts.items():
        _set_params(jt, states["sequence"])
        prep = jt._prepare(batches["sequence"])
        assert np.asarray(prep["sample_mask"]).tolist() == [1] * 7 + [0]
        if grid == GRIDS[0]:
            jax_out["grad32"] = _jax_grads(jt, prep, np.float32)
            jax_out["grad64"] = _jax_grads(jt, prep, np.float64)
        metrics = jt.train_epoch(iter([batches["sequence"]]))
        jax_out[grid, "loss"] = metrics["loss"]
        jax_out[grid, "grad_norm"] = metrics["grad_norm"]
        jax_out[grid, "params"] = {
            k: v.numpy() for k, v in state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, jt.state.params)).items()}

    torch.set_num_threads(1)
    single = {kind: _single_step(kind, states[kind], batches[kind])
              for kind in ("window", "frame")}
    t = ranks.make_trainer("sequence", out / "single_drop", dropout=0.1,
                           tp=False)
    m = t.train_epoch(iter(ranks.dropout_batches()))
    single["dropout"] = (m["loss"], {k: v.detach().numpy().copy()
                                     for k, v in t.params.items()})
    t = ranks.make_trainer("sequence", single_src, dropout=0.1, tp=False)
    assert t.resume() and t.global_step == 2
    t.fit(ranks.even_epochs, max_epochs=2)
    single["next"] = {k: v.detach().numpy().copy()
                      for k, v in t.params.items()}
    single["ckpt"], single["moments"] = ckpt, moments
    torch.set_num_threads(threads)
    return ({g: dp.join(h) for g, h in started.items()}, jax_out, single,
            out)


def _sub(res: dict, head: str) -> dict:
    head += "/"
    return {k[len(head):]: v for k, v in res.items() if k.startswith(head)}


@pytest.mark.parametrize("grid", GRIDS)
def test_tp_step_matches_jax(runs, grid):
    results, jax_out, _, _ = runs
    res = results[grid][0]
    np.testing.assert_allclose(float(res["sequence/loss"]),
                               jax_out[grid, "loss"], rtol=1e-5)
    # the norm of the whole gradients (the split leaves' squares summed
    # over the model group)
    np.testing.assert_allclose(float(res["sequence/grad_norm"]),
                               jax_out[grid, "grad_norm"], rtol=1e-5)
    grads = _sub(res, "sequence/grad")
    assert sorted(grads) == sorted(jax_out["grad64"])
    _check_grads(grads, jax_out["grad32"], jax_out["grad64"])
    _check_params(_sub(res, "sequence/param"), jax_out[grid, "params"],
                  jax_out["grad64"])


@pytest.mark.parametrize("grid", GRIDS)
def test_replicas_and_shards(runs, grid):
    """Whole tensors bitwise equal on every rank; a replicated leaf's copy
    too, a split leaf's shard on the ranks of its model rank; each shard
    and its two Adam moments 1/M of the whole."""
    results = runs[0][grid]
    assert len(results) == grid[0] * grid[1]
    first = results[0]
    split = set(first["sequence/split"].tolist())
    assert len(split) == 17
    for r, res in enumerate(results):
        assert res["grid"].tolist() == list(grid)
        assert res["coords"].tolist() == [r // grid[1], r % grid[1]]
        assert sorted(res) == sorted(first)
        for k, v in res.items():
            if k == "coords":
                continue
            head, _, name = k.partition("/local/")
            of = f"{head}/split"
            if not name or name not in (set(first[of].tolist())
                                        if of in first else split):
                assert np.array_equal(v, first[k]), (r, k)
            else:
                same = results[r % grid[1]][k]
                assert np.array_equal(v, same), (r, k)
        whole = _sub(res, "sequence/param")
        for (mu, nu, local), name in zip(res["sequence/moments"],
                                         sorted(split)):
            assert mu == nu == local == whole[name].size // grid[1], name


def test_tp_dropout_matches_single_process(runs):
    results, _, single, _ = runs
    res = results[(2, 2)][0]
    loss, params = single["dropout"]
    np.testing.assert_allclose(float(res["dropout/loss"]), loss, rtol=1e-5)
    _check_params(_sub(res, "dropout/param"), params)


def test_tp_checkpoint_loads_into_a_single_process_trainer(runs):
    """The checkpoint a tensor-parallel run writes holds whole tensors:
    a single-process trainer resumes from it to the run's parameters and
    moments, bit for bit."""
    results, _, _, out = runs
    res = results[(2, 2)][0]
    t = ranks.make_trainer("sequence", out / "g22" / "whole", dropout=0.1,
                           tp=False)
    assert t.resume() and t.global_step == 4
    want = _sub(res, "resume_whole/param")
    assert sorted(want) == sorted(t.params)
    for k, v in t.params.items():
        assert np.array_equal(v.detach().numpy(), want[k]), k
        assert t.optimizer.mu[k].shape == v.shape


def test_tp_resume_is_the_uninterrupted_run(runs):
    res = runs[0][(2, 2)][0]
    whole, resumed = _sub(res, "resume_whole/param"), _sub(
        res, "resume_resumed/param")
    assert whole and sorted(whole) == sorted(resumed)
    for k, v in whole.items():
        assert np.array_equal(resumed[k], v), k


def test_single_process_checkpoint_resumes_under_tp(runs):
    """Every rank keeps its shards of a single-process checkpoint, bit for
    bit with its moments, and trains on from it as the single process
    does, within the sharded step's bounds."""
    results, _, single, _ = runs
    res = results[(2, 2)][0]
    got = _sub(res, "from_single/param")
    for k, v in single["ckpt"].items():
        assert np.array_equal(got[k], v), k
        for key in ("mu", "nu"):
            assert np.array_equal(res[f"from_single/{key}/{k}"],
                                  single["moments"][key][k]), (key, k)
    _check_params(_sub(res, "from_single_next/param"), single["next"])


def test_tp_scan_epoch_is_the_step_loop(runs):
    res = runs[0][(1, 2)][0]
    assert float(res["scan/loss"]) == float(res["loop/loss"])
    scan, loop = _sub(res, "scan/param"), _sub(res, "loop/param")
    assert loop and sorted(scan) == sorted(loop)
    for k, v in loop.items():
        assert np.array_equal(scan[k], v), k


@pytest.mark.parametrize("grid", GRIDS)
def test_compiled_step_refuses_gloo(runs, grid):
    assert all(bool(r["gloo_graph_refused"]) for r in runs[0][grid])


@pytest.mark.parametrize("kind", ["window", "frame"])
def test_other_trainers_match_single_process(runs, kind):
    """``DualStreamTrainer`` and ``KoeMorphTrainer`` at grid (1, 2): one
    step against the single-process step from the same parameters."""
    results, _, single, _ = runs
    res = results[(1, 2)][0]
    loss, norm, grads, params = single[kind]
    np.testing.assert_allclose(float(res[f"{kind}/loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(float(res[f"{kind}/grad_norm"]), norm,
                               rtol=1e-5)
    got = _sub(res, f"{kind}/grad")
    assert sorted(got) == sorted(grads)
    for k, g in grads.items():
        assert np.abs(got[k] - g).max() <= GRAD_TOL * np.abs(g).max(), k
    _check_params(_sub(res, f"{kind}/param"), params, grads)
    assert len(res[f"{kind}/split"]) == (17 if kind == "window" else 3)

