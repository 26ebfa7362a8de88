"""Batch padding helpers of ``koemorph_tpu.parallel.mesh``, on host numpy
arrays.

The scan epochs stack an epoch's batches into one tensor, so every batch
must have the epoch's largest size: a short batch (a file boundary's) is
padded by repeating its last row and the trainer masks the padding out of
the loss (``sample_mask``). The JAX module's device-mesh and sharding
functions are not ported (``ROADMAP.md`` section 1, item 8).
"""

from __future__ import annotations

import numpy as np

__all__ = ["batch_leading_size", "pad_batch_to_size",
           "pad_batch_to_multiple"]


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
