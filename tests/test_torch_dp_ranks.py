"""The rank program of the port's data-parallel tests
(``tests/test_torch_train_dp.py``); it holds no tests.

:func:`start` starts ``world`` processes of ``python -m
tests.test_torch_dp_ranks <spec.json>``, each with the environment
``torch.distributed.run`` would give it (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Each joins a gloo group
on the CPU (``distributed.init_process_group(device="cpu")``), runs the
spec's checks with one thread, and writes what it measured to
``<out>/rank<r>.npz``. It imports torch, numpy and the port, never JAX, so
a child starts in a few seconds; the tests hold its results against the
JAX trainers and the port's single-process trainers in the pytest
process.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.models.simplified import SimplifiedKoeMorphModel
from koemorph_tpu_torch.train.trainer import (DualStreamTrainer,
                                              KoeMorphTrainer)

REPO = Path(__file__).resolve().parents[1]
HOP = 533
#: the window trainer's config (tests/test_torch_train.py's)
WINDOW_CFG = {
    "optimizer": {"name": "adamw", "lr": 1e-3, "weight_decay": 1e-5,
                  "betas": [0.9, 0.999]},
    "lr_scheduler": {"name": "cosine", "t_max": 2, "eta_min": 1e-6},
    "loss": {"mse_weight": 1.0, "l1_weight": 0.1, "perceptual_weight": 0.0},
    "gradient_clip_val": 1.0,
    "max_epochs": 1,
    "logging": {"log_every_n_steps": 1, "tensorboard": False},
    "checkpoint": {"keep_epoch_every": 100},
}
#: the legacy frame trainer's config, the perceptual term on
#: (tests/test_torch_legacy_train.py's)
FRAME_CFG = dict(WINDOW_CFG, loss={"mse_weight": 1.0, "l1_weight": 0.1,
                                   "perceptual_weight": 0.5})
WINDOW_MODEL = dict(mel_sequence_length=32, d_model=32, num_heads=2,
                    emotion_backend="basic", use_concatenation=False,
                    target_fps=30)
FRAME_MODEL = dict(d_model=32, num_heads=2)


def make_trainer(kind: str, work_dir, *, dropout: float = 0.0, mesh=None,
                 seed: int = 42):
    """The port's trainer of ``kind`` (``"window"``: the dual-stream
    window trainer; ``"frame"``: the legacy ``KoeMorphTrainer``) on the
    CPU."""
    kw = dict(work_dir=work_dir, steps_per_epoch=1, device="cpu", mesh=mesh,
              seed=seed)
    if kind == "window":
        model = dm.SimplifiedDualStreamModel(**WINDOW_MODEL, dropout=dropout)
        return DualStreamTrainer(model, {"training": WINDOW_CFG}, **kw)
    model = SimplifiedKoeMorphModel(**FRAME_MODEL, dropout=dropout)
    return KoeMorphTrainer(model, {"training": FRAME_CFG}, **kw)


def window_batch(b: int, seed: int = 0) -> dict:
    """``b`` windows of voiced audio with random targets."""
    rng = np.random.default_rng(seed)
    n = 32 * HOP
    t = np.arange(n) / 16000
    f0 = 140 + 40 * rng.random((b, 1))
    audio = (0.3 * np.sin(2 * np.pi * f0 * t)
             * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
             + 0.02 * rng.standard_normal((b, n))).astype(np.float32)
    return {"audio": audio,
            "blendshapes": rng.uniform(0, 1, (b, 32, 52)).astype(np.float32)}


def frame_batch(b: int, seed: int = 0) -> dict:
    """``b`` half-second files of the legacy frame trainer."""
    rng = np.random.default_rng(seed)
    t = np.arange(8000) / 16000
    f0 = 120 + 80 * rng.random((b, 1))
    audio = (0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.02 * rng.standard_normal((b, 8000))).astype(np.float32)
    return {"audio": audio, "audio_mask": np.ones((b, 8000), bool),
            "arkit": rng.uniform(0, 1, (b, 15, 52)).astype(np.float32),
            "arkit_mask": np.ones((b, 15), bool)}


def dropout_batches() -> list:
    """Two batches that divide over 2 ranks: the ranks draw the masks a
    single process draws."""
    return [window_batch(6, seed=1), window_batch(4, seed=2)]


def step_grads(trainer, prepared: dict) -> dict:
    """The reduced gradients of the trainer's next step (its loss, its
    backward and the all-reduce, as ``Trainer._step_body`` takes them)."""
    trainer.model.train()
    loss, _ = trainer._loss(prepared, None)
    grads = torch.autograd.grad(loss, list(trainer.params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(trainer.params.items(), grads)}
    if trainer.mesh is not None:
        grads = trainer._reduce_grads(grads)
    return {k: g.detach().numpy() for k, g in grads.items()}


def _params(trainer, prefix: str) -> dict:
    return {f"{prefix}/param/{k}": v.detach().numpy().copy()
            for k, v in trainer.params.items()}


# ---------------------------------------------------------------------------
# the checks, each run on every rank
# ---------------------------------------------------------------------------

def check_broadcast(spec, mesh, rank) -> dict:
    """Each rank draws its own initial weights (seed 42 + rank); the
    trainer replaces them with rank 0's."""
    t = make_trainer("window", Path(spec["out"]) / f"bc{rank}", mesh=mesh,
                     seed=42 + rank)
    return _params(t, "broadcast")


def check_step(spec, mesh, rank) -> dict:
    """One data-parallel step of each trainer kind from the given
    parameters on the given batch: the reduced gradients, the loss and
    the parameters after the step."""
    out = {}
    data = np.load(Path(spec["out"]) / "batches.npz")
    for kind in ("window", "frame"):
        t = make_trainer(kind, Path(spec["out"]) / f"{kind}{rank}",
                         mesh=mesh)
        t.model.load_state_dict(torch.load(
            Path(spec["out"]) / f"{kind}_state.pth", weights_only=True))
        batch = {k.split("/", 1)[1]: data[k] for k in data.files
                 if k.startswith(kind + "/")}
        prep = t._prepare(batch)
        out.update({f"{kind}/grad/{k}": g
                    for k, g in step_grads(t, prep).items()})
        metrics = t.train_step(prep)
        out[f"{kind}/loss"] = np.float32(metrics["loss"])
        out[f"{kind}/grad_norm"] = np.float32(metrics["grad_norm"])
        out.update(_params(t, kind))
    # gloo's collectives cannot be captured: the compiled step refuses
    # before it captures anything (graphs are off on the CPU: turned on
    # here only to reach the check)
    t.step_graphs.enabled = True
    try:
        t.compiled_step(prep)
    except RuntimeError as e:
        out["gloo_graph_refused"] = np.bool_("cannot be captured" in str(e))
    return out


def check_dropout(spec, mesh, rank) -> dict:
    """Two steps of the window trainer at dropout 0.1."""
    t = make_trainer("window", Path(spec["out"]) / f"drop{rank}",
                     dropout=0.1, mesh=mesh)
    metrics = t.train_epoch(iter(dropout_batches()))
    return {"dropout/loss": np.float32(metrics["loss"]),
            **_params(t, "dropout")}


def _epochs(epoch):
    return iter([window_batch(4, seed=10 + epoch),
                 window_batch(3, seed=20 + epoch)])


def check_resume(spec, mesh, rank) -> dict:
    """Two epochs at dropout 0.1, uninterrupted and as one epoch, a
    checkpoint (rank 0 writes) and a resumed second epoch."""
    root = Path(spec["out"])
    whole = make_trainer("window", root / "whole", dropout=0.1, mesh=mesh)
    whole.fit(_epochs, max_epochs=2)
    first = make_trainer("window", root / "resumed", dropout=0.1, mesh=mesh)
    first.fit(_epochs, max_epochs=1)
    second = make_trainer("window", root / "resumed", dropout=0.1,
                          mesh=mesh)
    assert second.resume() and second.global_step == 2
    second.fit(_epochs, max_epochs=2)
    return {**_params(whole, "resume_whole"),
            **_params(second, "resume_resumed")}


def check_scan(spec, mesh, rank) -> dict:
    """One epoch of batches of 4 and 3 windows (padded to 4) through the
    scan epoch and through the step loop."""
    root = Path(spec["out"])
    scan = make_trainer("window", root / f"scan{rank}", dropout=0.1,
                        mesh=mesh)
    loop = make_trainer("window", root / f"loop{rank}", dropout=0.1,
                        mesh=mesh)
    ms = scan.train_epoch_scan(_epochs(0))
    ml = loop.train_epoch(_epochs(0))
    return {"scan/loss": np.float32(ms["loss"]),
            "loop/loss": np.float32(ml["loss"]),
            **_params(scan, "scan"), **_params(loop, "loop")}


CHECKS = {"broadcast": check_broadcast, "step": check_step,
          "dropout": check_dropout, "resume": check_resume,
          "scan": check_scan}


def main(argv=None) -> int:
    from koemorph_tpu_torch.parallel import distributed, make_mesh

    spec = json.loads(Path((argv or sys.argv[1:])[0]).read_text())
    torch.set_num_threads(1)
    distributed.init_process_group(device="cpu")
    try:
        rank = distributed.rank()
        mesh = make_mesh(devices=["cpu"] * distributed.world_size())
        out = {"world": np.int64(mesh.size)}
        for name in spec["checks"]:
            out.update(CHECKS[name](spec, mesh, rank))
        np.savez(Path(spec["out"]) / f"rank{rank}.npz", **out)
    finally:
        distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def start(world: int, checks: list, out: Path) -> tuple:
    """Start ``checks`` on ``world`` ranks in processes of their own (gloo
    on the CPU), writing under ``out``; :func:`join` waits for them."""
    out = Path(out)
    spec = out / "spec.json"
    spec.write_text(json.dumps({"out": str(out), "checks": checks}))
    base = {**os.environ, "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(free_port()), "WORLD_SIZE": str(world),
            "LOCAL_WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(REPO)}
    procs = []
    for r in range(world):
        env = dict(base, RANK=str(r), LOCAL_RANK=str(r))
        log = tempfile.TemporaryFile(mode="w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_dp_ranks", str(spec)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return out, procs


def join(started: tuple, timeout: float = 300) -> list[dict]:
    """Each rank's results of :func:`start`; raises with the ranks'
    output when one failed."""
    out, procs = started
    failed = []
    for r, (proc, log) in enumerate(procs):
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
            rc = "timeout"
        log.seek(0)
        if rc != 0:
            failed.append(f"rank {r} ({rc}):\n{log.read()[-3000:]}")
        log.close()
    if failed:
        raise RuntimeError("\n".join(failed))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


if __name__ == "__main__":
    sys.exit(main())
