"""Device meshes, sharding and the process group of data- and
tensor-parallel training, and the batched and sequence-parallel decode
over a mesh: the counterpart of ``koemorph_tpu.parallel``. One process
drives every entry of an inference mesh; training runs one process per
card under ``torch.distributed``
(:mod:`koemorph_tpu_torch.parallel.distributed`), over a row of ranks or
a ``(data, model)`` grid of them (:mod:`koemorph_tpu_torch.parallel.tp`:
the rule table, the grid and the sharded layers)."""

from koemorph_tpu_torch.parallel.batched_decode import BatchedSequentialDecoder
from koemorph_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    batch_sharding,
    local_batch_size,
    make_mesh,
    pad_batch_to_multiple,
    replicate,
    replicated_sharding,
    shard_batch,
)
from koemorph_tpu_torch.parallel.tp import (
    MODEL_AXIS,
    TP_RULES,
    make_mesh_2d,
    partition_spec_for,
    shard_tree,
    tree_partition_specs,
    tree_shardings,
)

__all__ = [
    "DATA_AXIS", "make_mesh", "batch_sharding", "replicated_sharding",
    "shard_batch", "replicate", "pad_batch_to_multiple", "local_batch_size",
    "BatchedSequentialDecoder", "MODEL_AXIS", "TP_RULES", "make_mesh_2d",
    "partition_spec_for", "tree_partition_specs", "tree_shardings",
    "shard_tree",
]
