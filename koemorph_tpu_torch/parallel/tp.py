"""Tensor parallelism: the counterpart of ``koemorph_tpu.parallel.tp``.

The rule table :data:`TP_RULES` maps parameter names (regexes, the first
match wins, no match means replicated) to partition specs over a ``(data,
model)`` grid (:func:`make_mesh_2d`), Megatron's column and row pairs:
the packed ``(3E, E)`` in-projection's rows, the attention output
projection's input features, the dual-stream encoders' and output
projections' and the decoder head's hidden layer's output features, and
the decoder's output layer's input features. The names are the port's
(``blendshape_decoder.0`` / ``.3`` for JAX's ``decoder_hidden`` /
``decoder_out``) and the layout is ``nn.Linear``'s ``(out, in)``, so each
of JAX's ``(in, out)`` kernel specs appears with its axes flipped. A
dimension the model axis does not divide, and every leaf of a grid whose
model axis is 1, stays replicated. The optimizer's moments are keyed by
the parameters' names, so a tree holding them (``mu.<name>``) takes the
parameters' specs.

JAX lets GSPMD insert the collectives. The port makes them explicit and
keeps them inside the sharded layers (:func:`parallelize`): each layer a
rule splits holds 1/M of its parameters (and the optimizer 1/M of their
moments) but takes and returns the unsharded layer's replicated
activations, so the model around it runs unchanged, every model rank
draws the same dropout masks and the attention weights are whole on
every rank.

- A column layer (output features split): the input through
  :func:`~koemorph_tpu_torch.parallel.distributed.copy_to_group`, the
  local ``F.linear``, and the ranks' output features gathered.
- A row layer (input features split): this rank's block of the input's
  features, the local product, the sum over the model group, then the
  replicated bias.
- The packed in-projection: each rank holds a contiguous block of the
  ``3E`` rows (at M = 2, rank 0 all of Q and half of K), projects each of
  its rows with the input the row belongs to, and the query, key and
  value projections are gathered; the attention core then runs
  replicated and the output projection is a row layer. GSPMD computes the
  same function with the same parameter layout; a head-local attention
  that skips the gathers would need a head-aligned layout.

Every rank of a model group runs the same collectives in the same order
(a rank whose block holds none of the query's rows projects an empty
block), so none waits on a collective another rank skips.
"""

from __future__ import annotations

import math
import re
from typing import Any, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from koemorph_tpu_torch.models.attention import TorchStyleMHA, _apply_masks
from koemorph_tpu_torch.parallel import distributed
from koemorph_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharding,
                                              make_mesh)

__all__ = [
    "MODEL_AXIS", "TP_RULES", "PartitionSpec", "make_mesh_2d",
    "partition_spec_for", "tree_partition_specs", "tree_shardings",
    "shard_tree", "local_shards", "gather_shards", "parallelize",
    "ColumnParallelLinear", "RowParallelLinear", "ParallelMHA",
]

MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """One axis name (or None) per dimension of a tensor, as JAX's
    ``PartitionSpec``; ``PartitionSpec()`` is replicated. It is a tuple,
    equal to the plain tuple of its entries (``Sharding.spec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


_OUT = PartitionSpec(MODEL_AXIS, None)     # (out, in): output features
_IN = PartitionSpec(None, MODEL_AXIS)      # (out, in): input features
_VEC = PartitionSpec(MODEL_AXIS)

#: (name regex, PartitionSpec): the first match wins; no match is
#: replicated. Names are dotted (state-dict keys, optimizer paths).
TP_RULES: tuple[tuple[str, PartitionSpec], ...] = (
    (r"(^|\.)in_proj_weight$", _OUT),
    (r"(^|\.)in_proj_bias$", _VEC),
    (r"(^|\.)out_proj\.weight$", _IN),
    (r"(^|\.)(mel_channel_encoder|emotion_encoder)\.weight$", _OUT),
    (r"(^|\.)(mel_channel_encoder|emotion_encoder)\.bias$", _VEC),
    (r"(^|\.)(mel_output_proj|emotion_output_proj)\.weight$", _OUT),
    (r"(^|\.)(mel_output_proj|emotion_output_proj)\.bias$", _VEC),
    (r"(^|\.)blendshape_decoder\.0\.weight$", _OUT),
    (r"(^|\.)blendshape_decoder\.0\.bias$", _VEC),
    (r"(^|\.)blendshape_decoder\.3\.weight$", _IN),
)


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------

def _new_group(ranks: list, world: int):
    """A subgroup of ``ranks`` (None when it is every rank). Every rank
    must create every group, in one order."""
    if len(ranks) == world:
        return None
    return torch.distributed.new_group(ranks)


def make_mesh_2d(data: Optional[int] = None, model: int = 1,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` grid, row-major as JAX reshapes its devices.

    - In a process group of world W: the W ranks, rank ``r`` at ``(r //
      model, r % model)``; ``data`` defaults to ``W // model`` and must
      make the grid W ranks. The subgroups of every row (the model
      groups) and then every column (the data groups) are created on
      every rank, in that order; the mesh keeps this rank's two. The
      ranks' devices are :func:`~koemorph_tpu_torch.parallel.make_mesh`'s
      (``devices`` names them, W entries).
    - Otherwise the first ``data * model`` of ``devices`` (a device may
      stand in several entries), or of the visible CUDA devices; raises
      ``RuntimeError`` when there are none.

    ``model`` must divide the number of entries (``ValueError``, as in
    JAX); ``model=1`` is the data mesh with a model axis of one.
    """
    if distributed.is_initialized():
        world = distributed.world_size()
        if model < 1 or world % model:
            raise ValueError(
                f"model axis {model} must divide device count {world}")
        data = world // model if data is None else data
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} needs {data * model} "
                             f"ranks, the process group has {world}")
        me = distributed.rank()
        rows = [_new_group([d * model + m for m in range(model)], world)
                for d in range(data)]
        cols = [_new_group([d * model + m for d in range(data)], world)
                for m in range(model)]
        flat = make_mesh(devices=devices)
        return Mesh(flat.devices.reshape(data, model),
                    (DATA_AXIS, MODEL_AXIS), rank=me,
                    data_group=cols[me % model], model_group=rows[me // model])
    if devices is not None:
        devs = list(devices)
    else:
        devs = list(make_mesh().devices)
    if model < 1 or len(devs) % model:
        raise ValueError(
            f"model axis {model} must divide device count {len(devs)}")
    if data is None:
        data = len(devs) // model
    if data * model > len(devs):
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {len(devs)}")
    flat = make_mesh(devices=devs[: data * model])
    return Mesh(flat.devices.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


# ---------------------------------------------------------------------------
# the rule table over names and trees
# ---------------------------------------------------------------------------

def _divisible(shape: tuple, spec: PartitionSpec, mesh: Mesh) -> bool:
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % mesh.shape[axis]:
            return False
    return len(spec) <= len(shape)


def partition_spec_for(path: str, shape: tuple, mesh: Mesh,
                       rules: Sequence = TP_RULES) -> PartitionSpec:
    """The spec of the tensor named ``path``: replicated when the mesh's
    model axis is absent or 1, when no rule matches, or when the matched
    spec does not divide ``shape``."""
    if mesh.shape.get(MODEL_AXIS, 1) == 1:
        return PartitionSpec()
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec if _divisible(tuple(shape), spec, mesh) \
                else PartitionSpec()
    return PartitionSpec()


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; a path
    joins the keys (and list positions) with dots."""
    def join(key):
        return f"{path}.{key}" if path else str(key)

    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_partition_specs(tree: Any, mesh: Mesh,
                         rules: Sequence = TP_RULES) -> Any:
    """The same tree of specs: a state dict, an optimizer's state
    (``mu.<name>`` takes ``<name>``'s spec), or a leaf; a leaf without a
    shape is replicated."""
    return _map_with_path(
        lambda path, leaf: partition_spec_for(
            path, tuple(getattr(leaf, "shape", ())), mesh, rules), tree)


def tree_shardings(tree: Any, mesh: Mesh,
                   rules: Sequence = TP_RULES) -> Any:
    """The same tree of :class:`~koemorph_tpu_torch.parallel.mesh.
    Sharding` (JAX's ``NamedSharding`` per leaf)."""
    return _map_with_path(
        lambda path, leaf: Sharding(mesh, partition_spec_for(
            path, tuple(getattr(leaf, "shape", ())), mesh, rules)), tree)


def _split_dim(spec) -> Optional[int]:
    """The dimension a spec splits over the model axis, or None."""
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            return dim
    return None


def _block(t: torch.Tensor, spec, n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of ``t`` along the dimension ``spec`` splits,
    a copy of its own (a view would keep the whole tensor alive)."""
    dim = _split_dim(spec)
    if dim is None or not isinstance(t, torch.Tensor):
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).clone(
        memory_format=torch.contiguous_format)


def _shard(p: nn.Parameter, spec, mesh: Mesh) -> nn.Parameter:
    """This rank's block of parameter ``p``, trained as ``p`` is."""
    return nn.Parameter(_block(p.data, spec, mesh.model_size,
                               mesh.model_rank),
                        requires_grad=p.requires_grad)


def shard_tree(tree: Any, mesh: Mesh, rules: Sequence = TP_RULES) -> Any:
    """The tree's tensors split by the rules: in a process group, this
    rank's contiguous shards (its block on the model axis), on its device;
    in one process, a list with one tree per entry (row-major), on that
    entry's device. Replicated tensors stay whole; leaves that are not
    tensors pass unchanged."""
    m = mesh.model_size

    def place(i, dev):
        def put(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            spec = partition_spec_for(path, tuple(leaf.shape), mesh, rules)
            return _block(leaf, spec, m, i).to(dev)
        return _map_with_path(put, tree)

    if mesh.distributed:
        return place(mesh.model_rank, mesh.local_device)
    return [place(i % m, d) for i, d in enumerate(mesh.devices.flat)]


def local_shards(tensors: dict, specs: dict, mesh: Mesh) -> dict:
    """This rank's blocks of the whole tensors ``tensors`` (by name), for
    the names ``specs`` (name -> spec, from :func:`parallelize`) splits;
    the others unchanged."""
    return {k: _block(v, specs[k], mesh.model_size, mesh.model_rank)
            if k in specs else v for k, v in tensors.items()}


def gather_shards(tensors: dict, specs: dict, mesh: Mesh) -> dict:
    """The whole tensors of this rank's shards ``tensors`` (by name),
    gathered over the model group for the names ``specs`` splits (every
    rank of the group calls it, with the same names); the others
    unchanged. Not differentiable."""
    out = {}
    for k, v in tensors.items():
        dim = _split_dim(specs.get(k, ()))
        if dim is None:
            out[k] = v
            continue
        with torch.no_grad():
            moved = v.detach().movedim(dim, -1)
            full = distributed.gather_last(
                moved, mesh.model_rank * moved.shape[-1],
                moved.shape[-1] * mesh.model_size, mesh.model_group)
        out[k] = full.movedim(-1, dim).contiguous()
    return out


# ---------------------------------------------------------------------------
# the sharded layers
# ---------------------------------------------------------------------------

class ColumnParallelLinear(nn.Module):
    """``nn.Linear`` with its output features split over the model group:
    ``weight`` (out/M, in) and ``bias`` (out/M) are this rank's rows; the
    call takes and returns the whole features."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        self.start = mesh.model_rank * (self.out_features // mesh.model_size)
        self.group = mesh.model_group
        self.weight = _shard(linear.weight, _OUT, mesh)
        self.bias = (_shard(linear.bias, _VEC, mesh)
                     if linear.bias is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(distributed.copy_to_group(x, self.group), self.weight,
                     self.bias)
        return distributed.gather_last(y, self.start, self.out_features,
                                       self.group)


class RowParallelLinear(nn.Module):
    """``nn.Linear`` with its input features split over the model group:
    ``weight`` (out, in/M) is this rank's columns, ``bias`` whole; the
    call takes and returns the whole features."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        per = self.in_features // mesh.model_size
        self.block = (mesh.model_rank * per, (mesh.model_rank + 1) * per)
        self.group = mesh.model_group
        self.weight = _shard(linear.weight, _IN, mesh)
        self.bias = linear.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        part = F.linear(distributed.scatter_last(x, *self.block, self.group),
                        self.weight)
        y = distributed.reduce_from_group(part, self.group)
        return y if self.bias is None else y + self.bias


class ParallelMHA(nn.Module):
    """:class:`~koemorph_tpu_torch.models.attention.TorchStyleMHA` with its
    packed in-projection's ``3E`` rows split over the model group into
    contiguous blocks (``in_proj_weight`` (3E/M, E), ``in_proj_bias``
    (3E/M)); the call, its arguments and its outputs are
    ``TorchStyleMHA``'s. ``out_proj`` is the module's own (a
    :class:`RowParallelLinear` when the rules split it)."""

    def __init__(self, mha: TorchStyleMHA, mesh: Mesh):
        super().__init__()
        self.embed_dim, self.num_heads = mha.embed_dim, mha.num_heads
        per = 3 * self.embed_dim // mesh.model_size
        self.rows = (mesh.model_rank * per, (mesh.model_rank + 1) * per)
        self.group = mesh.model_group
        self.in_proj_weight = _shard(mha.in_proj_weight, _OUT, mesh)
        self.in_proj_bias = _shard(mha.in_proj_bias, _VEC, mesh)
        self.out_proj = mha.out_proj
        self.attn_dropout = mha.attn_dropout

    def _project(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """Q, K or V (``part`` 0, 1, 2) of ``x``: this rank's rows of the
        part (none, some or all), gathered over the group."""
        e = self.embed_dim
        lo = min(max(self.rows[0], part * e), (part + 1) * e)
        hi = max(min(self.rows[1], (part + 1) * e), lo)
        a, b = lo - self.rows[0], hi - self.rows[0]
        y = distributed.copy_to_group(x, self.group) \
            @ self.in_proj_weight[a:b].T + self.in_proj_bias[a:b]
        return distributed.gather_last(y, lo - part * e, e, self.group)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                need_weights: bool = False,
                key_padding_mask: Optional[torch.Tensor] = None):
        e = self.embed_dim
        h = self.num_heads
        hd = e // h
        bq, q_len, _ = query.shape
        b, t = key.shape[0], key.shape[1]
        if bq not in (1, b):
            raise ValueError(
                f"query batch {bq} must be 1 or match key batch {b}")
        q = self._project(query, 0)
        k = self._project(key, 1)
        v = self._project(value, 2)
        # TorchStyleMHA's core, on the whole projections
        q = q.reshape(bq, q_len, h, hd).transpose(1, 2).expand(b, h, q_len,
                                                                hd)
        k = k.reshape(b, t, h, hd).transpose(1, 2)
        v = v.reshape(b, t, h, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        scores = _apply_masks(scores, key_padding_mask, None)
        attn = torch.softmax(scores, -1)
        dropped = self.attn_dropout(attn, generator)
        out = torch.matmul(dropped, v).transpose(1, 2).reshape(b, q_len, e)
        out = self.out_proj(out)
        if need_weights:
            return out, attn.mean(1)
        return out


def parallelize(model: nn.Module, mesh: Mesh,
                rules: Sequence = TP_RULES) -> dict:
    """Split ``model``'s parameters over ``mesh``'s model axis by the
    rules, in place: every module holding a parameter a rule splits is
    replaced by its sharded layer (``nn.Linear`` by a
    :class:`ColumnParallelLinear` or :class:`RowParallelLinear`,
    :class:`TorchStyleMHA` by a :class:`ParallelMHA`), under the same
    names, holding this rank's shards. Returns ``{name: spec}`` of the
    split parameters (empty when the model axis is 1, and then nothing
    changes). A split that no sharded layer implements (another module,
    or a split of a module's parameters that is not one of those layers')
    raises ``ValueError``; nothing is silently replicated."""
    if not mesh.distributed:
        raise ValueError("parallelize needs a process group's mesh "
                         "(make_mesh_2d inside torch.distributed.run)")
    specs = {}
    for name, p in model.named_parameters():
        spec = partition_spec_for(name, tuple(p.shape), mesh, rules)
        if _split_dim(spec) is not None:
            specs[name] = spec
    owners: dict = {}
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        owners.setdefault(owner, {})[leaf] = tuple(spec)
    for owner, split in owners.items():
        module = model.get_submodule(owner)
        if isinstance(module, TorchStyleMHA) and split == {
                "in_proj_weight": _OUT, "in_proj_bias": _VEC}:
            layer = ParallelMHA(module, mesh)
        elif isinstance(module, nn.Linear) and split in (
                {"weight": _OUT, "bias": _VEC}, {"weight": _OUT}) and (
                ("bias" in split) == (module.bias is not None)):
            layer = ColumnParallelLinear(module, mesh)
        elif isinstance(module, nn.Linear) and split == {"weight": _IN}:
            layer = RowParallelLinear(module, mesh)
        else:
            raise ValueError(
                f"the rules split {owner}'s {sorted(split)} "
                f"({type(module).__name__}: {split}), which no sharded "
                "layer implements")
        parent, _, attr = owner.rpartition(".")
        setattr(model.get_submodule(parent), attr, layer)
    return specs

