"""The process group of data- and tensor-parallel training: what XLA's
collectives do for the JAX package's meshes.

Training over several GPUs runs one process per card, launched by
``python -m torch.distributed.run --nproc-per-node N ...``, which sets
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in each process's environment. :func:`init_process_group`
joins the group they describe: NCCL for CUDA tensors, gloo for the CPU,
or the ``backend`` the caller names (gloo also reduces CUDA tensors, on
the host; NCCL refuses two ranks on one card). A failed initialization
raises; nothing here falls back to one process.

:func:`all_reduce` is a differentiable sum over the ranks: its backward
sums the ranks' gradients, the adjoint of the forward.
:func:`gather_rows` places a rank's block of rows into a zero-filled
buffer of the global batch and sums it over the ranks, so every rank
holds the global batch (adding zeros is exact).

The collectives take a ``group`` (a subgroup from
``torch.distributed.new_group``; None is every rank). Tensor parallelism
(:mod:`koemorph_tpu_torch.parallel.tp`) runs Megatron's four operators
over the model group, each for ranks that hold the same replicated
activations and backpropagate the same loss:

- :func:`copy_to_group`: identity forward, the gradients summed over the
  group backward (a layer whose ranks each use a part of the weight);
- :func:`reduce_from_group`: the sum over the group forward, identity
  backward (the partial products of a row-split layer);
- :func:`gather_last`: each rank's block of the last axis placed in zeros
  and summed over the group forward (an all-gather; exact), this rank's
  block of the gradient backward;
- :func:`scatter_last`: this rank's block of the last axis forward, the
  gradient gathered backward.

:data:`COLLECTIVES` counts the collectives issued from Python, by name
(``all_reduce``, ``all_gather``, ``broadcast``), as ``ops.cuda.LAUNCHES``
counts kernel launches: a CUDA graph that captured them replays them
without a call.
"""

from __future__ import annotations

import collections
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from koemorph_tpu_torch.device import DeviceLike

__all__ = ["launched", "init_process_group", "is_initialized", "world_size",
           "rank", "local_rank", "backend", "rank_device", "all_reduce",
           "all_reduce_", "COLLECTIVES", "gather_rows", "copy_to_group",
           "reduce_from_group", "gather_last", "scatter_last", "broadcast_",
           "barrier", "destroy_process_group"]

_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
#: collectives issued, by name (a graph's replays issue none)
COLLECTIVES: collections.Counter = collections.Counter()


def launched() -> bool:
    """Whether the environment describes a process group (the variables
    ``torch.distributed.run`` sets)."""
    return all(k in os.environ for k in _ENV)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The group's size; 1 outside a process group."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its node (``LOCAL_RANK``, else the rank)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def backend() -> Optional[str]:
    """The group's backend (``"nccl"`` or ``"gloo"``); None outside one."""
    return dist.get_backend() if is_initialized() else None


def rank_device(local: Optional[int] = None) -> torch.device:
    """The card of the rank with local rank ``local`` (this process's by
    default): ``cuda:<local rank modulo the visible cards>``, so several
    ranks share a card only where there are more ranks than cards (which
    gloo allows and NCCL refuses). Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; name the ranks' devices "
                           "(make_mesh(devices=['cpu', ...]))")
    local = local_rank() if local is None else int(local)
    return torch.device("cuda", local % torch.cuda.device_count())


def init_process_group(backend: Optional[str] = None,
                       device: DeviceLike = None) -> torch.device:
    """Join the process group the environment describes and return this
    rank's device: ``device`` when given, else :func:`rank_device`.
    ``backend`` defaults to NCCL for a CUDA device and gloo otherwise.
    Raises ``RuntimeError`` when the environment describes no group, and
    whatever ``torch.distributed`` raises when the initialization fails."""
    if not launched():
        raise RuntimeError(
            "no process group in the environment: launch with python -m "
            "torch.distributed.run --nproc-per-node N ... (missing "
            f"{[k for k in _ENV if k not in os.environ]})")
    dev = rank_device() if device is None else torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method="env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        # NCCL's communicator is made now, not inside a graph's capture
        device_id=dev if backend == "nccl" else None)
    return dev


def destroy_process_group() -> None:
    if is_initialized():
        dist.destroy_process_group()


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        return all_reduce_(out, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, as a new tensor, differentiable:
    when every rank backpropagates the same loss through it, each input's
    gradient is the world size times that loss's gradient."""
    return _AllReduce.apply(x, group)


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` over the ranks in place (not differentiable)."""
    dist.all_reduce(x, group=group)
    COLLECTIVES["all_reduce"] += 1
    return x


def gather_rows(x: torch.Tensor, start: int, total: int,
                group=None) -> torch.Tensor:
    """The ``(total, ...)`` global batch on every rank, from each rank's
    rows ``[start, start + len(x))``: the block placed in zeros and summed
    over the ranks (differentiable, through :func:`all_reduce`)."""
    tail = total - start - x.shape[0]
    if start < 0 or tail < 0:
        raise ValueError(f"rows [{start}, {start + x.shape[0]}) outside a "
                         f"batch of {total}")
    full = torch.cat([x.new_zeros((start,) + x.shape[1:]), x,
                      x.new_zeros((tail,) + x.shape[1:])])
    return all_reduce(full, group)


def _gather_last(x: torch.Tensor, start: int, total: int,
                 group) -> torch.Tensor:
    """Every rank's block of the last axis, in a new ``(..., total)``
    tensor: this rank's ``x`` at ``[start, start + x.shape[-1])``, zeros
    elsewhere, summed over the group (adding zeros is exact)."""
    if start < 0 or start + x.shape[-1] > total:
        raise ValueError(f"features [{start}, {start + x.shape[-1]}) "
                         f"outside {total}")
    full = x.new_zeros(x.shape[:-1] + (total,))
    full[..., start:start + x.shape[-1]] = x
    dist.all_reduce(full, group=group)
    COLLECTIVES["all_gather"] += 1
    return full


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return all_reduce_(x.detach().clone(
            memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, start: int, total: int,
                group) -> torch.Tensor:
        ctx.block = (start, start + x.shape[-1])
        return _gather_last(x.detach(), start, total, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        lo, hi = ctx.block
        return grad[..., lo:hi], None, None, None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, start: int, stop: int,
                group) -> torch.Tensor:
        ctx.block, ctx.total, ctx.group = start, x.shape[-1], group
        return x[..., start:stop]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (_gather_last(grad, ctx.block, ctx.total, ctx.group), None,
                None, None)


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` unchanged; its gradient is summed over the group, where each
    rank computed a part of it (Megatron's copy to the model-parallel
    region)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group, as a new tensor; the gradient
    passes unchanged (every rank holds the same one)."""
    return _ReduceFromGroup.apply(x, group)


def gather_last(x: torch.Tensor, start: int, total: int,
                group=None) -> torch.Tensor:
    """The ``(..., total)`` tensor whose features ``[start, start +
    x.shape[-1])`` each rank of the group holds as ``x`` (the blocks
    cover ``total`` once), on every rank; the gradient of ``x`` is this
    rank's block of the output's gradient."""
    return _GatherLast.apply(x, start, total, group)


def scatter_last(x: torch.Tensor, start: int, stop: int,
                 group=None) -> torch.Tensor:
    """This rank's features ``[start, stop)`` of ``x``, which every rank
    of the group holds whole; the gradient of ``x`` gathers the ranks'
    blocks."""
    return _ScatterLast.apply(x, start, stop, group)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src)
            COLLECTIVES["broadcast"] += 1


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if not is_initialized():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
