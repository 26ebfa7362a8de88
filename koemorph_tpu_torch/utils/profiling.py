"""Timing utilities with the reference's RTF report format: the
counterpart of ``koemorph_tpu.utils.profiling`` on PyTorch.

Per-frame timing deques with average / maximum reports (the reference's
real-time loops), a warm-up then best-of-reps benchmark, and a
``torch.profiler`` trace written as Chrome-trace JSON. On the card the
benchmark and :func:`scan_timed` time with CUDA events; on the CPU with
the host clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["FrameTimer", "benchmark", "trace", "rtf_report",
           "fetch_scalar", "measure_rtt", "scan_timed"]


def _on_card(device) -> bool:
    """Whether to time on the card: ``device`` when given, else whether
    one is present."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def fetch_scalar(x) -> float:
    """A synchronizing read: the first element of ``x`` on the host (a
    device tensor's read waits for the work that produces it)."""
    if isinstance(x, (tuple, list)):
        x = x[0]
    if isinstance(x, dict):
        x = next(iter(x.values()))
    if isinstance(x, torch.Tensor):
        return float(x.detach().reshape(-1)[0])
    return float(np.asarray(x).ravel()[0])


def measure_rtt(device=None) -> float:
    """Best of 30 round trips of a trivial launch and a synchronizing
    read, in seconds: the floor :func:`scan_timed` subtracts from each
    timed window (which ends in one such read)."""
    dev = torch.device("cuda" if _on_card(device) else "cpu")
    x = torch.zeros((8,), device=dev)
    fetch_scalar(x.sum())
    best = float("inf")
    for _ in range(30):
        t0 = time.perf_counter()
        fetch_scalar(x.sum())
        best = min(best, time.perf_counter() - t0)
    return best


def scan_timed(fn: Callable, args: Sequence = (), *, rtt: float,
               iters: int = 8, reps: int = 3, device=None):
    """Time ``fn(*args)`` over ``iters`` back-to-back calls, the best of
    ``reps`` windows, each closed by one synchronizing read of the last
    call's output; ``rtt`` (:func:`measure_rtt`) is subtracted from the
    window, as the JAX harness does, and the rest divided by ``iters``.
    On the card a window is timed between CUDA events (a graphed step,
    such as ``Trainer.compiled_step``, replays its graph back to back);
    on the CPU with the host clock. One untimed call warms ``fn`` first
    (a graphed step captures its graph there). Returns ``(ms_per_iter,
    flops)``; ``flops`` is ``None``: the card has no counterpart of XLA's
    cost analysis here."""
    card = _on_card(device)
    fetch_scalar(fn(*args))
    best = float("inf")
    for _ in range(reps):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        fetch_scalar(out)
        if card:
            end.record()
            end.synchronize()
            window = start.elapsed_time(end) / 1e3
        else:
            window = time.perf_counter() - t0
        best = min(best, window)
    return max(best - rtt, 0.0) / iters * 1e3, None


class FrameTimer:
    """Rolling per-frame timing with RTF accounting (the reference's
    per-frame time lists in its real-time loop)."""

    def __init__(self, target_fps: float = 30.0, window: int = 300):
        self.target_fps = target_fps
        self.times: deque[float] = deque(maxlen=window)
        self.total_frames = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self.total_frames += 1

    def report(self) -> dict:
        return rtf_report(np.asarray(self.times), self.target_fps,
                          total_frames=self.total_frames)


def rtf_report(frame_times_s: np.ndarray, target_fps: float,
               total_frames: Optional[int] = None) -> dict:
    """The RTF report (the reference's technical specification's
    format): frame count, average / median / p95 / maximum ms, the
    real-time factor and whether the average is inside the budget."""
    if len(frame_times_s) == 0:
        return {"frames": 0}
    budget = 1.0 / target_fps
    return {
        "frames": total_frames if total_frames is not None
        else len(frame_times_s),
        "avg_ms": float(frame_times_s.mean() * 1e3),
        "p50_ms": float(np.percentile(frame_times_s, 50) * 1e3),
        "p95_ms": float(np.percentile(frame_times_s, 95) * 1e3),
        "max_ms": float(frame_times_s.max() * 1e3),
        "rtf": float(frame_times_s.mean() / budget),
        "rtf_p95": float(np.percentile(frame_times_s, 95) / budget),
        "target_fps": target_fps,
        "realtime_ok": bool(frame_times_s.mean() < budget),
    }


def benchmark(fn: Callable, args: Sequence = (), *, warmup: int = 10,
              iters: int = 100, reps: int = 3, device=None) -> dict:
    """Warm-up calls, then the best of ``reps`` runs of ``iters`` calls,
    each run timed to a device synchronization: between CUDA events on
    the card, with the host clock on the CPU (the reference's
    ``cuda.synchronize`` harness)."""
    card = _on_card(device)
    for _ in range(max(warmup, 1)):
        fn(*args)
    if card:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        if card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            dt = (time.perf_counter() - t0) / iters
        best = min(best, dt)
    return {"latency_ms": best * 1e3, "iters": iters, "reps": reps,
            "throughput_per_s": 1.0 / best}


@contextlib.contextmanager
def trace(log_dir: str = "build/trace", *, host: bool = False):
    """Trace a block with ``torch.profiler`` and write it as Chrome-trace
    JSON, ``<log_dir>/trace.json`` (open it in Perfetto or
    ``chrome://tracing``; :func:`koemorph_tpu_torch.utils.trace_latency.
    parse_device_durations` reads it). The device's activities are traced
    when a card is present, the host's operators with ``host=True`` (and
    always without a card)."""
    from torch.profiler import ProfilerActivity, profile
    acts = []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out / "trace.json"))
