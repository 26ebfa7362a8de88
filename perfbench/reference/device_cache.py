"""Cached constants and a device scalar for the plain reference.

The reference runs eagerly, so a cache is ``functools.lru_cache`` whose
values are built outside ``torch.inference_mode`` (so a later autograd pass
may read them)."""

from __future__ import annotations

import functools
from typing import Optional

import torch

__all__ = ["device_cache", "scalar_like"]


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` with values built outside
    ``torch.inference_mode``."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            with torch.inference_mode(False):
                return cached(*args)

        call.cache_clear = cached.cache_clear
        return call
    return wrap


def scalar_like(value: float, like: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A 0-dim tensor on ``like``'s device: dividing by it is a true IEEE
    division on every device, as dividing by a Python number is not."""
    return torch.full((), value, dtype=dtype or like.dtype, device=like.device)
