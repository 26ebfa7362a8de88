"""Batched decoding, and the batch padding helpers of the JAX package's
``parallel/mesh.py``. Its device-mesh functions and ``parallel/tp.py``
are not ported yet (``ROADMAP.md`` section 1, item 8)."""

from koemorph_tpu_torch.parallel.batched_decode import BatchedSequentialDecoder
from koemorph_tpu_torch.parallel.mesh import pad_batch_to_multiple

__all__ = ["BatchedSequentialDecoder", "pad_batch_to_multiple"]
