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
"""

from __future__ import annotations

import contextlib
import functools

__all__ = ["device_cache", "holding"]

#: the holders of the captures in progress, innermost last
_HOLDERS: list[dict] = []


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` whose values a capture in progress
    (:func:`holding`) also holds."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
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
