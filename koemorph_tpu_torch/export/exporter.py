"""Model export through ``torch.export`` with a parity gate.

:func:`export_program` traces a function with ``torch.export.export``,
writes the program with ``torch.export.save`` (a ``.pt2`` file), loads it
back and gates it on its largest absolute difference from the live
function on the example inputs (1e-5, the reference exporter's gate for a
traced model). The three hand-written kernels enter the program as the
custom operators of :mod:`koemorph_tpu_torch.ops.library`: on the card the
loaded program launches the CUDA kernels, on the CPU it runs their plain
forms. :func:`load_program` registers those operators before it loads, so
a fresh process can run an artifact. The span registry is paused while the
function is traced, so no stage stamp enters a program.

The exported function is the model's frame function
(:class:`FrameFunction`): audio and the EMA carry in, blendshapes and the
new carry out. The carry is an explicit input and output, so the exported
graph is the whole model, smoothing included; a caller threads the carry
from one call to the next.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_leaves

from koemorph_tpu_torch.device import device_label
from koemorph_tpu_torch.models.dual_stream_model import TemporalState
from koemorph_tpu_torch.utils import spans

logger = logging.getLogger(__name__)

__all__ = ["ExportReport", "FrameFunction", "export_program",
           "load_program", "verify_export", "benchmark_fn",
           "benchmark_rounds"]


@dataclasses.dataclass
class ExportReport:
    """One artifact: where it is, its gate, and (with a benchmark) its
    latency and the live function's, on ``device`` (``cpu`` or the card's
    ``nvidia-smi`` name and power limit): the medians of the rounds in
    ``latency_rounds_ms`` (``{"exported": [...], "live": [...]}``)."""

    path: str
    format: str
    max_abs_diff: float
    passed: bool
    threshold: float
    latency_ms: Optional[float] = None
    live_latency_ms: Optional[float] = None
    latency_rounds_ms: Optional[dict] = None
    device: Optional[str] = None
    size_bytes: Optional[int] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FrameFunction(nn.Module):
    """``(audio (B, L), prev (B, 52), initialized (B,) bool) ->
    (blendshapes (B, 52), prev, initialized)``: one smoothed frame of a
    :class:`~koemorph_tpu_torch.models.dual_stream_model.
    SimplifiedDualStreamModel` with the EMA carry threaded through."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, audio: torch.Tensor, prev: torch.Tensor,
                initialized: torch.Tensor):
        out, state = self.model(audio, TemporalState(prev=prev,
                                                     initialized=initialized))
        return out["blendshapes"], state.prev, state.initialized


class _Call(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def load_program(path: Union[str, Path]) -> torch.export.ExportedProgram:
    """A ``.pt2`` program :func:`export_program` wrote, with the kernels'
    operators registered; call it through ``.module()``."""
    from koemorph_tpu_torch.ops import library  # noqa: F401

    return torch.export.load(str(path))


def export_program(fn: Callable, example_args: Sequence,
                   out_file: Union[str, Path], *,
                   verify_threshold: float = 1e-5) -> ExportReport:
    """Export ``fn(*example_args)`` (a module or a function of tensors) to
    the ``.pt2`` file ``out_file`` and gate the program loaded back from
    it on its largest absolute difference from ``fn`` on the example
    inputs."""
    module = fn if isinstance(fn, nn.Module) else _Call(fn)
    args = tuple(example_args)
    with torch.no_grad(), spans.paused():
        program = torch.export.export(module, args)
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out_file))
    loaded = load_program(out_file).module()
    diff = _max_diff(fn, loaded, args)
    report = ExportReport(
        path=str(out_file), format="pt2", max_abs_diff=diff,
        passed=diff < verify_threshold, threshold=verify_threshold,
        size_bytes=out_file.stat().st_size)
    (logger.info if report.passed else logger.warning)(
        "pt2 export: max|diff|=%.2e (threshold %.0e) -> %s",
        diff, verify_threshold, "OK" if report.passed else "FAILED")
    return report


def _flatten(out) -> list[np.ndarray]:
    # bool leaves (the EMA carry's `initialized`) compare as numbers
    return [t.detach().cpu().to(torch.float64).numpy()
            for t in tree_leaves(out)]


def _max_diff(fn_a: Callable, fn_b: Callable, args: Sequence) -> float:
    with torch.no_grad():
        a = _flatten(fn_a(*args))
        b = _flatten(fn_b(*args))
    if len(a) != len(b):
        raise ValueError(
            f"Output leaf count mismatch: {len(a)} vs {len(b)} — parity "
            "comparison would silently truncate")
    return float(max(np.max(np.abs(x - y)) for x, y in zip(a, b)))


def verify_export(fn: Callable, exported_fn: Callable, args: Sequence,
                  threshold: float = 1e-5) -> tuple[bool, float]:
    """(passed, largest absolute difference) of ``exported_fn`` against
    ``fn`` on ``args``; raises ``ValueError`` when their outputs have
    different numbers of leaves."""
    diff = _max_diff(fn, exported_fn, args)
    return diff < threshold, diff


def benchmark_fn(fn: Callable, args: Sequence, *, warmup: int = 10,
                 iters: int = 100) -> dict:
    """Latency of ``fn(*args)`` after ``warmup`` calls: between CUDA
    events around ``iters`` back-to-back calls when the first tensor
    argument lies on the card, else by the host clock. ``device`` names
    where it ran (the card's ``nvidia-smi`` name and power limit)."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    with torch.no_grad():
        for _ in range(max(warmup, 1)):
            fn(*args)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / iters
            clock = "cuda_events"
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ms = (time.perf_counter() - t0) / iters * 1e3
            clock = "perf_counter"
    return {"latency_ms": ms, "iters": iters, "throughput_per_s": 1e3 / ms,
            "clock": clock, "device": device_label(dev)}


def benchmark_rounds(fns: dict, args: Sequence, *, rounds: int,
                     warmup: int = 5, iters: int = 20) -> dict:
    """:func:`benchmark_fn`'s latency of each of ``fns`` (name ->
    function) on ``args`` in ``rounds`` rounds, the first name going first
    in even rounds and last in odd ones, so that neither the order nor a
    drift of the host's speed favours one: ``{name: [ms per round]}``."""
    names = list(fns)
    got: dict = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            got[name].append(benchmark_fn(fns[name], args, warmup=warmup,
                                          iters=iters)["latency_ms"])
    return got
