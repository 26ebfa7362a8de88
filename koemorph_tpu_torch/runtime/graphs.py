"""CUDA graphs of the port's steps.

The reference compiles every path it serves with ``jax.jit``, the server's
state donated so it is updated in place. The port's counterpart on the
card is a CUDA graph: a step's kernels captured once per static shape and
branch, then replayed with one launch. The step reads its inputs from
static buffers (the caller copies each input in), keeps its state in
static buffers that it writes in place (the port's form of
``donate_argnums``), and a replay's outputs are copied out, so an output
the caller holds is never written by a later replay.

:class:`StepGraphs` holds one engine's graphs by key, in one memory pool
that all of them share: an engine's graphs never run concurrently, and
only a graph's outputs outlive its capture, each copied out right after
its replay. A capture follows PyTorch's recipe: the step runs eagerly on a
side stream first (kernel modules load, cached constants are built, cuBLAS
sets up its workspace for that stream), then is captured on the same
stream. A capture or replay failure raises; nothing falls back to the
eager step. Disabled (the CPU, or ``graphs=False`` on the card), a step
simply runs eagerly.

A graph reads memory by address and keeps none of it alive. Its static
buffers belong to its engine and its intermediates to the pool; the cached
device constants its body reached (:mod:`koemorph_tpu_torch.ops.
device_cache`) are held by the graph itself, so a cache that evicts one
frees nothing a graph still reads. Dropping a graph releases them.

The kernel wrappers count the launches a capture records
(:func:`koemorph_tpu_torch.ops.cuda.capturing`), not those of a replay:
:meth:`StepGraphs.launches` gives a graph's record and
:attr:`StepGraphs.replays` how often each graph ran.

In the span registry (:mod:`koemorph_tpu_torch.utils.spans`) a run is the
host spans ``<span>.launch`` (the replay's launch, or the eager body) and
``<span>.out`` (the outputs' copies), ``span`` given by the engine; each
capture is noted with whether it carries stage stamps.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Hashable, Optional

import torch

from koemorph_tpu_torch.ops import cuda as cuda_kernels
from koemorph_tpu_torch.ops.device_cache import holding
from koemorph_tpu_torch.utils import spans

__all__ = ["StepGraphs"]


class StepGraphs:
    """The CUDA graphs of one engine's steps, keyed by the branch each
    replays.

    ``enabled=None`` means graphs on a CUDA device and none elsewhere; an
    explicit ``enabled=True`` on another device raises ``ValueError``.
    ``span`` names the host spans of a run (``<span>.launch``,
    ``<span>.out``)."""

    def __init__(self, device: torch.device, enabled: Optional[bool] = None,
                 span: str = "koemorph.graphs"):
        if enabled is None:
            enabled = device.type == "cuda"
        if enabled and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device} "
                             "(pass graphs=False, or leave it unset)")
        self.device = device
        self.enabled = enabled
        self._graphs: dict = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        #: wall seconds spent in warm-up runs and captures
        self.capture_s = 0.0
        #: replays of each graph, by key
        self.replays: collections.Counter = collections.Counter()
        self._launch, self._out = f"{span}.launch", f"{span}.out"

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        return list(self._graphs)

    def launches(self, key: Hashable):
        """The kernel launches the graph of ``key`` recorded, by
        ``(name, shape)``: those each of its replays runs."""
        return self._graphs[key][2]

    def drop(self, key: Hashable) -> None:
        """Forget the graph of ``key``, and the constants it held."""
        del self._graphs[key]

    def capture(self, key: Hashable, body: Callable,
                warm: Optional[Callable] = None,
                generators: tuple = ()) -> None:
        """Run ``warm()`` (unless None) eagerly on the capture stream, then
        capture ``body()`` as the graph of ``key``; ``body``'s return
        value (a tensor or a tuple of tensors) is the graph's output.
        ``generators`` are the CUDA generators ``body`` draws from: each
        replay reads its seed and offset as they stand when it starts (a
        train step's dropout masks, reseeded before each replay)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if warm is not None:
            with torch.cuda.stream(stream):
                warm()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with holding() as held, cuda_kernels.capturing() as launches:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                out = body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        spans.note_capture(key)
        self._graphs[key] = (graph, out, launches, held)
        self.capture_s += time.perf_counter() - t0

    def run(self, key: Hashable, body: Callable):
        """``body()`` eagerly when disabled; else one replay of the graph
        of ``key`` (captured before), returning fresh copies of its
        outputs."""
        if not self.enabled:
            with spans.host(self._launch):
                return body()
        entry = self._graphs.get(key)
        if entry is None:
            raise KeyError(f"no CUDA graph captured for {key!r}")
        graph, out = entry[:2]
        with spans.host(self._launch):
            graph.replay()
        self.replays[key] += 1
        with spans.host(self._out):
            if isinstance(out, tuple):
                return tuple(t.clone() for t in out)
            return out.clone()
