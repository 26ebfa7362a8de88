"""Batched decoding. The JAX package's mesh and tensor-parallel helpers
(``parallel/mesh.py``, ``parallel/tp.py``) are not ported yet
(``ROADMAP.md`` section 1, item 8)."""

from koemorph_tpu_torch.parallel.batched_decode import BatchedSequentialDecoder

__all__ = ["BatchedSequentialDecoder"]
