"""Checkpoints with the best/last/epoch_N layout: the counterpart of
``koemorph_tpu.train.checkpoint``, written with ``torch.save``::

    <ckpt_dir>/best/   <ckpt_dir>/last/   <ckpt_dir>/epoch_<N>/

Each directory holds

- ``state.pth``: ``{"model_state_dict": ...}``, the model's parameters in
  the reference PyTorch module's names (what
  ``koemorph_tpu.utils.torch_import.load_torch_state_dict`` reads);
- ``opt_state.pth`` (when given): the optimizer state, its update count
  (which sets the schedule) and the dropout seed, for an exact resume;
- ``meta.json``: epoch, global_step, best_val_loss and the config.

Files are read back with ``torch.load(..., weights_only=True)``. In a
data-parallel process group only rank 0 writes, and
:meth:`CheckpointManager.save` returns on every rank after a barrier, so
no rank reads a checkpoint before it is whole.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import torch

from koemorph_tpu_torch.parallel import distributed
from koemorph_tpu_torch.utils.params import STATE_FILE, read_state_dict

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "load_opt_state"]

OPT_FILE = "opt_state.pth"


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: Union[str, Path], state: dict, *,
                    opt_state: Optional[dict] = None, epoch: int = 0,
                    global_step: int = 0,
                    best_val_loss: float = float("inf"),
                    config: Optional[dict] = None) -> Path:
    """Write one checkpoint directory: ``state`` (a model state dict),
    ``opt_state`` when given, and the metadata."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state_dict": _host(state)}, path / STATE_FILE)
    if opt_state is not None:
        torch.save(_host(opt_state), path / OPT_FILE)
    elif (path / OPT_FILE).exists():
        (path / OPT_FILE).unlink()
    meta = {"epoch": int(epoch), "global_step": int(global_step),
            "best_val_loss": float(best_val_loss), "config": config or {}}
    with open(path / "meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return path


def load_checkpoint(path: Union[str, Path]) -> tuple[dict, dict]:
    """``(state_dict, meta)`` of a checkpoint directory (meta is empty when
    the directory has no ``meta.json``)."""
    path = Path(path).absolute()
    state = read_state_dict(path)
    meta_file = path / "meta.json"
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    return state, meta


def load_opt_state(path: Union[str, Path]) -> Optional[dict]:
    """The optimizer-state file saved next to ``state``; None for a
    params-only checkpoint."""
    opt_path = Path(path).absolute() / OPT_FILE
    if not opt_path.exists():
        return None
    return torch.load(opt_path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """best/last/epoch_N checkpoint policy over a run directory."""

    def __init__(self, ckpt_dir: Union[str, Path],
                 keep_epoch_every: int = 10,
                 config: Optional[dict] = None):
        self.ckpt_dir = Path(ckpt_dir).absolute()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.keep_epoch_every = keep_epoch_every
        self.config = config or {}
        self.best_val_loss = float("inf")

    def save(self, state: dict, *, epoch: int, global_step: int,
             val_loss: Optional[float] = None,
             opt_state: Optional[dict] = None) -> None:
        # update best BEFORE writing 'last' so a crash+resume restores the
        # true best_val_loss and cannot overwrite 'best' with a worse model
        improved = val_loss is not None and val_loss < self.best_val_loss
        if improved:
            self.best_val_loss = float(val_loss)
        kwargs = dict(epoch=epoch, global_step=global_step,
                      best_val_loss=self.best_val_loss, config=self.config,
                      opt_state=opt_state)
        if distributed.rank() == 0:
            self._write(state, improved, epoch, kwargs)
        distributed.barrier()

    def _write(self, state: dict, improved: bool, epoch: int,
               kwargs: dict) -> None:
        save_checkpoint(self.ckpt_dir / "last", state, **kwargs)
        if improved:
            save_checkpoint(self.ckpt_dir / "best", state, **kwargs)
        if self.keep_epoch_every and epoch % self.keep_epoch_every == 0:
            save_checkpoint(self.ckpt_dir / f"epoch_{epoch}", state,
                            **kwargs)

    def latest(self, with_opt: bool = False) -> Optional[tuple]:
        """``(state, meta)`` of ``last``, or ``(state, opt_state, meta)``
        with ``with_opt`` (opt_state is None for params-only
        directories); None when there is no ``last``."""
        last = self.ckpt_dir / "last"
        if not last.exists():
            return None
        state, meta = load_checkpoint(last)
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        if with_opt:
            return state, load_opt_state(last), meta
        return state, meta
