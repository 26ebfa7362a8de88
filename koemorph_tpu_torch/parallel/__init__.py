"""Device meshes, sharding and the process group of data-parallel
training, and the batched and sequence-parallel decode over a mesh: the
counterpart of ``koemorph_tpu.parallel``. One process drives every entry
of an inference mesh; training runs one process per card under
``torch.distributed`` (:mod:`koemorph_tpu_torch.parallel.distributed`).
``parallel/tp.py`` (tensor parallelism) is not ported yet
(``ROADMAP.md`` section 1)."""

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

__all__ = [
    "DATA_AXIS", "make_mesh", "batch_sharding", "replicated_sharding",
    "shard_batch", "replicate", "pad_batch_to_multiple", "local_batch_size",
    "BatchedSequentialDecoder",
]
