"""Device meshes and batch sharding: the counterpart of
``koemorph_tpu.parallel.mesh``.

A :class:`Mesh` is a 1-D row of device entries on the ``data`` axis. It
comes in two kinds:

- **one process drives every entry** (``mesh.rank is None``): the
  session-sharded server (``MultiStreamInference(mesh=...)``) and the mesh
  decode (``BatchedSequentialDecoder(mesh=...)``) keep one engine per
  entry and split their lanes or utterances into one contiguous block per
  entry. Inference has no collectives, so nothing needs a second process.
- **one process per entry** (``mesh.rank`` is this process's entry): the
  ranks of a ``torch.distributed`` process group
  (:mod:`koemorph_tpu_torch.parallel.distributed`), which data-parallel
  training needs for its gradient reductions.

A device may stand in several entries (the CPU is one device; the
one-card smoke runs two entries of ``cuda:0``). The sharding functions
follow JAX's layout: entry ``i`` of ``D`` holds rows ``[i*b/D,
(i+1)*b/D)`` of a batch of ``b``; a 0-d leaf is replicated.

The padding helpers work on host numpy arrays. The scan epochs stack an
epoch's batches into one tensor, so every batch must have the epoch's
largest size: a short batch (a file boundary's) is padded by repeating its
last row and the trainer masks the padding out of the loss
(``sample_mask``).
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from koemorph_tpu_torch.parallel import distributed

__all__ = ["DATA_AXIS", "Mesh", "Sharding", "make_mesh", "batch_sharding",
           "replicated_sharding", "shard_batch", "replicate",
           "local_batch_size", "block_rows",
           "batch_leading_size", "pad_batch_to_size",
           "pad_batch_to_multiple"]

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D device mesh. ``devices`` is a numpy object array of
    ``torch.device`` (``.size`` and ``.shape[0]`` read as in JAX);
    ``rank`` is this process's entry when each entry is a process of a
    ``torch.distributed`` group, None when one process drives them all."""

    devices: np.ndarray
    axis_names: tuple = (DATA_AXIS,)
    rank: Optional[int] = None

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: int(self.devices.shape[0])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        """One process per entry (a ``torch.distributed`` group)."""
        return self.rank is not None

    @property
    def local_device(self) -> torch.device:
        """This process's entry's device (the first entry's when one
        process drives them all)."""
        return self.devices[self.rank or 0]


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A placement on a mesh: ``spec`` ``("data",)`` splits axis 0 into
    the entries' blocks, ``()`` replicates (JAX's ``NamedSharding(mesh,
    P(axis))`` and ``NamedSharding(mesh, P())``)."""

    mesh: Mesh
    spec: tuple


def _device_array(devs: Sequence) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = [torch.device(d) for d in devs]
    return arr


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D data mesh.

    - ``devices`` given: those entries, in order (a device may be listed
      more than once: the CPU tests list ``"cpu"`` D times, the one-card
      smoke ``cuda:0`` twice).
    - In a process group of world W: the W ranks, this process's entry
      ``cuda:LOCAL_RANK`` (:func:`distributed.rank_device`), or
      ``devices`` (W of them, entry ``r`` rank ``r``'s device).
    - Otherwise the visible CUDA devices; raises ``RuntimeError`` when
      there are none (name CPU entries with ``devices``).

    ``num_devices`` takes the first entries; more than there are raises
    ``ValueError``, as in JAX. A process group's mesh has all its ranks.
    """
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if distributed.is_initialized():
        world = distributed.world_size()
        if num_devices is not None and num_devices != world:
            raise ValueError(f"Requested {num_devices} devices in a process "
                             f"group of {world}")
        if devices is not None:
            devs = list(devices)
            if len(devs) != world:
                raise ValueError(f"{len(devs)} devices named for a process "
                                 f"group of {world}")
        else:
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            me = distributed.rank()
            devs = [distributed.rank_device(
                distributed.local_rank() if r == me else r % local_world)
                for r in range(world)]
        return Mesh(_device_array(devs), (axis_name,),
                    rank=distributed.rank())
    if devices is not None:
        devs = list(devices)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; name the mesh's entries "
                "(make_mesh(devices=['cpu', ...]))")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(
                f"Requested {num_devices} devices, have {len(devs)}")
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(_device_array(devs), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> Sharding:
    """Split the leading (batch) axis over the mesh."""
    return Sharding(mesh, (axis_name,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def block_rows(n_rows: int, n_entries: int, entry: int) -> slice:
    """Rows of entry ``entry`` when ``n_rows`` split over ``n_entries``
    contiguous blocks; raises ``ValueError`` when they do not divide."""
    if n_rows % n_entries:
        raise ValueError(f"batch {n_rows} not divisible by {n_entries} "
                         "devices; pad upstream (pad_batch_to_multiple)")
    per = n_rows // n_entries
    return slice(entry * per, (entry + 1) * per)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def shard_batch(batch: Any, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Place a batch (a dict, list or tuple of arrays or tensors, or one)
    on the mesh, split on axis 0 into the entries' blocks; 0-d leaves are
    replicated. The leading dims must divide over the mesh (pad with
    :func:`pad_batch_to_multiple`).

    In one process: a list with one batch per entry, on that entry's
    device. In a process group: this rank's block, on its device."""
    del axis_name                     # the mesh has one axis

    def place(entry):
        dev = mesh.devices[entry]

        def put(x):
            t = _as_tensor(x)
            if t.dim() > 0:
                t = t[block_rows(t.shape[0], mesh.size, entry)]
            return t.to(dev)
        return _map(put, batch)

    if mesh.distributed:
        return place(mesh.rank)
    return [place(i) for i in range(mesh.size)]


def replicate(tree: Any, mesh: Mesh):
    """Parameters (a module, or a dict, list or tuple of tensors) on
    every entry.

    In one process: a list of copies, one per entry, on its device (a
    module is deep-copied). In a process group: the tree moved to this
    rank's device and overwritten in place with rank 0's values
    (a broadcast), returned."""
    if mesh.distributed:
        dev = mesh.local_device
        if isinstance(tree, torch.nn.Module):
            tree = tree.to(dev)
            distributed.broadcast_(list(tree.parameters())
                                   + list(tree.buffers()))
            return tree
        tree = _map(lambda x: _as_tensor(x).to(dev), tree)
        leaves: list = []
        _map(leaves.append, tree)
        distributed.broadcast_(leaves)
        return tree
    if isinstance(tree, torch.nn.Module):
        return [copy.deepcopy(tree).to(d) for d in mesh.devices]
    return [_map(lambda x: _as_tensor(x).to(d, copy=True), tree)
            for d in mesh.devices]


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.size
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by {n} devices")
    return global_batch // n


def batch_leading_size(batch: dict) -> int:
    """The (unique) leading dim of a batch's arrays, or 0 if none.

    Raises ``ValueError`` on leading dims that differ: padding a
    misaligned batch would corrupt the samples' alignment."""
    sizes = {v.shape[0] for v in batch.values()
             if hasattr(v, "ndim") and getattr(v, "ndim", 0) > 0}
    if not sizes:
        return 0
    if len(sizes) > 1:
        raise ValueError(
            f"Heterogeneous leading dims in batch: {sorted(sizes)}; "
            "padding would corrupt sample alignment")
    return sizes.pop()


def pad_batch_to_size(batch: dict, target: int) -> tuple[dict, int]:
    """Pad every array's leading dim up to exactly ``target`` rows by
    repeating the last row; returns ``(padded_batch, real_batch_size)``.
    A batch of ``target`` rows or more is returned as it is."""
    b = batch_leading_size(batch)
    if b == 0 or b >= target:
        return batch, b

    def pad_one(x):
        x = np.asarray(x)
        if x.ndim == 0 or x.shape[0] != b:
            return x
        reps = np.repeat(x[-1:], target - b, axis=0)
        return np.concatenate([x, reps], axis=0)

    return {k: pad_one(v) for k, v in batch.items()}, b


def pad_batch_to_multiple(batch: dict, multiple: int) -> tuple[dict, int]:
    """Pad every array's leading dim up to a multiple of ``multiple``
    (repeating the last row, see :func:`pad_batch_to_size`)."""
    b = batch_leading_size(batch)
    return pad_batch_to_size(batch, b + (-b) % multiple)
