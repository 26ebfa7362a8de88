"""Cached device constants that CUDA graphs can rely on.

The operators build their constant tensors (DFT and mel tables, index
grids, masks) once per key and keep them in bounded caches. A CUDA graph
reads such a tensor by its address but does not keep it alive: once the
cache evicted it, its memory would go back to PyTorch's allocator, be
reused, and the next replay would read whatever was written there.

:func:`device_cache` is ``functools.lru_cache`` for such functions, plus
one thing: inside :func:`holding` (which
:class:`koemorph_tpu_torch.runtime.graphs.StepGraphs` wraps around each
capture) every value it returns, cached or new, is added to the holder,
and the graph keeps the holder for as long as it lives.

Values are built outside ``torch.inference_mode`` even when the first call
comes from inside it (a decode or a stream step): an inference tensor
cannot be saved for backward, and a later train step in the same process
reads the same cached constants. While a program is being exported they
are built outside the tracer's modes too: a value built under its fake
tensor mode would hold no data, and every later live call would read it
from the cache. Built as real tensors, they enter the exported program as
constants.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["device_cache", "holding", "index_constant"]

#: the holders of the captures in progress, innermost last
_HOLDERS: list[dict] = []


def _untraced():
    """Outside the modes of an export's tracer while one is exporting."""
    if torch.compiler.is_exporting():
        from torch.utils._python_dispatch import _disable_current_modes
        return _disable_current_modes()
    return contextlib.nullcontext()


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` whose values a capture in progress
    (:func:`holding`) also holds."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            with torch.inference_mode(False), _untraced():
                value = cached(*args)
            if _HOLDERS:
                _HOLDERS[-1][id(value)] = value
            return value

        call.cache_clear = cached.cache_clear
        call.cache_info = cached.cache_info
        return call
    return wrap


@contextlib.contextmanager
def holding():
    """Yields a list that, when the block ends, holds every value a
    :func:`device_cache` function returned inside it."""
    held: dict = {}
    _HOLDERS.append(held)
    out: list = []
    try:
        yield out
    finally:
        _HOLDERS.pop()
        out.extend(held.values())


@device_cache(64)
def index_constant(indices: tuple, device: torch.device) -> torch.Tensor:
    """``indices`` as an int64 tensor on ``device``, built once: what a
    captured body indexes with where a list or an array index would copy
    from the host at every call."""
    return torch.tensor(indices, dtype=torch.int64, device=device)
