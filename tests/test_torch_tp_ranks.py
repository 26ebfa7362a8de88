"""The rank program of the port's tensor-parallel tests
(``tests/test_torch_tp.py``); it holds no tests.

``python -m tests.test_torch_tp_ranks <spec.json>`` runs as one rank of
a ``(data, model)`` grid (``spec["grid"]``), started by
:func:`tests.test_torch_dp_ranks.start` with the environment
``torch.distributed.run`` would give it: a gloo group on the CPU, one
thread, the spec's checks, and what it measured written to
``<out>/rank<r>.npz``. Gradients and parameters are written whole
(gathered over the model group, ``/grad/`` and ``/param/``) and as this
rank's shards (``/local/``). It imports torch, numpy and the port, never
JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.models.simplified import SimplifiedKoeMorphModel
from koemorph_tpu_torch.train.trainer import (DualStreamTrainer,
                                              KoeMorphTrainer,
                                              SequentialTrainer)
from tests import test_torch_dp_ranks as dp

HOP = dp.HOP
#: the sequential trainer's config (tests/test_torch_train.py's)
SEQ_CFG = dict(dp.WINDOW_CFG)
#: JAX's ``tiny_model`` (tests/parallel/test_tp_sp.py), window 16
SEQ_MODEL = dict(d_model=32, num_heads=2, mel_sequence_length=16,
                 emotion_backend="basic", use_concatenation=False,
                 stride_frames=4, target_fps=30)
SPAN = 24


def make_trainer(kind: str, work_dir, *, dropout: float = 0.0, mesh=None,
                 tp: bool = True):
    """The port's trainer of ``kind`` on the CPU, tensor-parallel on
    ``mesh`` by default: ``"sequence"`` (JAX's ``tiny_model``), or the
    window and frame trainers of ``tests/test_torch_dp_ranks.py``."""
    kw = dict(work_dir=work_dir, steps_per_epoch=1, device="cpu", mesh=mesh,
              tensor_parallel=tp)
    if kind == "window":
        return DualStreamTrainer(
            dm.SimplifiedDualStreamModel(**dp.WINDOW_MODEL, dropout=dropout),
            {"training": dp.WINDOW_CFG}, **kw)
    if kind == "frame":
        return KoeMorphTrainer(
            SimplifiedKoeMorphModel(**dp.FRAME_MODEL, dropout=dropout),
            {"training": dp.FRAME_CFG}, **kw)
    return SequentialTrainer(
        dm.SequentialDualStreamModel(**SEQ_MODEL, dropout=dropout),
        {"training": SEQ_CFG}, span_frames=SPAN, **kw)


def seq_batch(b: int, seed: int = 0) -> dict:
    """``b`` spans of voiced audio with random targets."""
    rng = np.random.default_rng(seed)
    n = SPAN * HOP
    t = np.arange(n) / 16000
    f0 = 140 + 40 * rng.random((b, 1))
    audio = (0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.02 * rng.standard_normal((b, n))).astype(np.float32)
    return {"audio": audio,
            "blendshapes": rng.uniform(0, 1, (b, SPAN, 52)).astype(
                np.float32)}


def dropout_batches() -> list:
    """Two batches that divide over every rank of a (2, 2) grid."""
    return [seq_batch(8, seed=1), seq_batch(4, seed=2)]


def epochs(epoch):
    """An epoch of 4 and 3 spans (the second padded to 4, in the step loop
    as in the scan epoch's stack)."""
    return iter([seq_batch(4, seed=10 + epoch), seq_batch(3, seed=20 + epoch)])


def even_epochs(epoch):
    """An epoch of 8 and 4 spans: no rank of a (2, 2) grid pads, so the
    dropout masks are a single process's."""
    return iter([seq_batch(8, seed=30 + epoch), seq_batch(4, seed=40 + epoch)])


def _whole(trainer, tensors: dict) -> dict:
    from koemorph_tpu_torch.parallel.tp import gather_shards
    return gather_shards(tensors, trainer.tp_specs, trainer.mesh)


def _host(prefix: str, tensors: dict) -> dict:
    return {f"{prefix}/{k}": v.detach().numpy().copy()
            for k, v in tensors.items()}


def record(trainer, prefix: str) -> dict:
    """The trainer's parameters whole and as this rank's shards."""
    return {**_host(f"{prefix}/param", _whole(trainer, trainer.params)),
            **_host(f"{prefix}/local", trainer.params)}


def load_whole(trainer, state: dict) -> None:
    """Load a whole state dict into a tensor-parallel trainer."""
    from koemorph_tpu_torch.parallel.tp import local_shards
    trainer.model.load_state_dict(
        local_shards(state, trainer.tp_specs, trainer.mesh))


def step_grads(trainer, prepared: dict) -> dict:
    """The whole reduced gradients of the trainer's next step."""
    grads = dp.step_grads(trainer, prepared)
    return {k: v.numpy() for k, v in _whole(trainer, {
        k: torch.from_numpy(g) for k, g in grads.items()}).items()}


# ---------------------------------------------------------------------------
# the checks, each run on every rank
# ---------------------------------------------------------------------------

def check_step(spec, mesh, rank) -> dict:
    """One step of each kind of ``spec["kinds"]`` from the given
    parameters on the given batch: the whole gradients, the loss and the
    parameters after the step; the shards' and moments' sizes."""
    out = {}
    root = Path(spec["out"])
    data = np.load(root / "batches.npz")
    for kind in spec["kinds"]:
        t = make_trainer(kind, root / f"{kind}{rank}", mesh=mesh)
        load_whole(t, torch.load(root / f"{kind}_state.pth",
                                 weights_only=True))
        batch = {k.split("/", 1)[1]: data[k] for k in data.files
                 if k.startswith(kind + "/")}
        prep = t._prepare(batch)
        out.update({f"{kind}/grad/{k}": g
                    for k, g in step_grads(t, prep).items()})
        metrics = t.train_step(prep)
        out[f"{kind}/loss"] = np.float32(metrics["loss"])
        out[f"{kind}/grad_norm"] = np.float32(metrics["grad_norm"])
        out.update(record(t, kind))
        out[f"{kind}/split"] = np.asarray(sorted(t.tp_specs))
        out[f"{kind}/moments"] = np.asarray(
            [[t.optimizer.mu[k].numel(), t.optimizer.nu[k].numel(),
              t.params[k].numel()] for k in sorted(t.tp_specs)])
    # gloo's collectives cannot be captured: the compiled step refuses
    t.step_graphs.enabled = True
    try:
        t.compiled_step(prep)
    except RuntimeError as e:
        out["gloo_graph_refused"] = np.bool_("cannot be captured" in str(e))
    return out


def check_dropout(spec, mesh, rank) -> dict:
    """Two steps at dropout 0.1 on batches no rank pads."""
    t = make_trainer("sequence", Path(spec["out"]) / f"drop{rank}",
                     dropout=0.1, mesh=mesh)
    metrics = t.train_epoch(iter(dropout_batches()))
    return {"dropout/loss": np.float32(metrics["loss"]),
            **record(t, "dropout")}


def check_resume(spec, mesh, rank) -> dict:
    """Two epochs at dropout 0.1 uninterrupted, and one, a checkpoint
    (rank 0 writes it whole) and a resumed second one; then a resume of
    the single-process checkpoint of ``single_ckpt`` and one epoch of
    :func:`even_epochs`."""
    root = Path(spec["out"])
    whole = make_trainer("sequence", root / "whole", dropout=0.1, mesh=mesh)
    whole.fit(epochs, max_epochs=2)
    first = make_trainer("sequence", root / "resumed", dropout=0.1,
                         mesh=mesh)
    first.fit(epochs, max_epochs=1)
    second = make_trainer("sequence", root / "resumed", dropout=0.1,
                          mesh=mesh)
    assert second.resume() and second.global_step == 2
    second.fit(epochs, max_epochs=2)
    from_single = make_trainer("sequence", root / "single_ckpt",
                               dropout=0.1, mesh=mesh)
    assert from_single.resume() and from_single.global_step == 2
    out = {**record(whole, "resume_whole"), **record(second,
                                                     "resume_resumed"),
           **record(from_single, "from_single"),
           **_host("from_single/mu", _whole(from_single,
                                            from_single.optimizer.mu)),
           **_host("from_single/nu", _whole(from_single,
                                            from_single.optimizer.nu))}
    from_single.fit(even_epochs, max_epochs=2)
    out.update(record(from_single, "from_single_next"))
    return out


def check_scan(spec, mesh, rank) -> dict:
    """One epoch of :func:`epochs` through the scan epoch and through the
    step loop."""
    root = Path(spec["out"])
    scan = make_trainer("sequence", root / f"scan{rank}", dropout=0.1,
                        mesh=mesh)
    loop = make_trainer("sequence", root / f"loop{rank}", dropout=0.1,
                        mesh=mesh)
    ms = scan.train_epoch_scan(epochs(0))
    ml = loop.train_epoch(epochs(0))
    return {"scan/loss": np.float32(ms["loss"]),
            "loop/loss": np.float32(ml["loss"]),
            **record(scan, "scan"), **record(loop, "loop")}


CHECKS = {"step": check_step, "dropout": check_dropout,
          "resume": check_resume, "scan": check_scan}


def main(argv=None) -> int:
    from koemorph_tpu_torch.parallel import distributed
    from koemorph_tpu_torch.parallel.tp import make_mesh_2d

    spec = json.loads(Path((argv or sys.argv[1:])[0]).read_text())
    torch.set_num_threads(1)
    distributed.init_process_group(device="cpu")
    try:
        rank = distributed.rank()
        data, model = spec["grid"]
        mesh = make_mesh_2d(data=data, model=model,
                            devices=["cpu"] * distributed.world_size())
        out = {"grid": np.asarray(list(mesh.shape.values())),
               "coords": np.asarray([mesh.data_rank, mesh.model_rank])}
        for name in spec["checks"]:
            out.update(CHECKS[name](spec, mesh, rank))
        np.savez(Path(spec["out"]) / f"rank{rank}.npz", **out)
    finally:
        distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
