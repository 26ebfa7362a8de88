"""Per-step device durations from a ``torch.profiler`` trace: the
counterpart of ``koemorph_tpu.utils.trace_latency``.

A timing loop between CUDA events sees the whole window, not each step's
own device time, nor its jitter. Here N individual step calls run under
the profiler, and each step's device activities are read back out of the
Chrome-trace JSON the profiler writes: the kernels, copies and fills
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``), each tied by its
``correlation`` id to the runtime call (``cudaLaunchKernel``,
``cudaGraphLaunch``, ...) that the host made inside one step's
``record_function`` range. No TensorBoard dependency is needed.

A profiling window loses its first few device activities, so a traced
window starts with a lead-in (:func:`lead_in`: tiny kernels, a
synchronization and 20 ms of sleep) and its activities are cut at the
lead-in's idle gap on the device's own clock (:func:`lead_in_end`): the
device's timestamps line up with the host's only to about a millisecond,
and a cut on the host's clock once lost 6 of a window's 7 frames.
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = [
    "parse_device_durations",
    "capture_step_trace",
    "summarize_ms",
    "lead_in",
    "lead_in_end",
]

#: the trace's categories of device activities
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the device's idle time that ends the lead-in (its synchronization and
#: 20 ms of sleep) on the device's own clock, in µs
LEAD_GAP_US = 15000
#: the ``record_function`` name of step ``i`` is this prefix and ``i``
STEP_PREFIX = "koemorph.step."


def lead_in(device="cuda") -> None:
    """The start of a traced window: 256 tiny kernels, a
    synchronization and 20 ms of sleep, which :func:`lead_in_end` finds
    and leaves out."""
    lead = torch.zeros(1, device=device)
    for _ in range(256):
        lead.add_(1.0)
    torch.cuda.synchronize(device)
    time.sleep(0.02)


def _is_lead_in(name: str) -> bool:
    """The lead-in's device activities: its fill and its adds."""
    low = name.lower()
    return "fill" in low or "add" in low or name.startswith("Memset")


def lead_in_end(activities: Sequence[tuple]) -> Optional[float]:
    """Where a window's own device activities begin: ``activities`` are
    ``(start, end, name)`` on the device's clock (µs), in start order;
    returns the start of the first activity after the first idle gap of
    :data:`LEAD_GAP_US` with nothing but lead-in activities before it,
    or ``None`` where no such gap shows (the lead-in's activities
    lost)."""
    for i in range(1, len(activities)):
        if not _is_lead_in(activities[i - 1][2]):
            return None
        if activities[i][0] - activities[i - 1][1] >= LEAD_GAP_US:
            return activities[i][0]
    return None


def _base_name(name: str) -> str:
    """A kernel's name without its trailing parameter list, so the calls
    of one kernel land in one bucket (``Memcpy HtoD (Pageable ->
    Device)`` becomes ``Memcpy HtoD``)."""
    name = name.strip()
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip() or name
    return name


def _trace_file(log_dir: str) -> str:
    """The newest Chrome-trace JSON (``*.json`` or ``*.json.gz``) under
    ``log_dir``, or ``log_dir`` itself when it is a file."""
    if os.path.isfile(log_dir):
        return log_dir
    found = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(log_dir, "**", pat),
                                recursive=True)]
    if not found:
        raise FileNotFoundError(f"no Chrome-trace JSON under {log_dir!r}")
    return max(found, key=os.path.getmtime)


def _events(log_dir: str) -> list[dict]:
    path = _trace_file(log_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _device_activities(events: list[dict]) -> list[dict]:
    """The complete device events, in start order, from the lead-in's end
    on where a lead-in shows."""
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATEGORIES),
                 key=lambda e: float(e["ts"]))
    first = lead_in_end([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          str(e.get("name", ""))) for e in dev])
    return dev if first is None else [e for e in dev
                                      if float(e["ts"]) >= first]


def parse_device_durations(log_dir: str,
                           name_prefix: str | None = None
                           ) -> dict[str, list[float]]:
    """Device durations (ms) of each kernel, copy and fill in a trace.

    Reads the newest Chrome-trace JSON under ``log_dir`` (or the file
    ``log_dir``), keeps the complete device events (categories
    :data:`DEVICE_CATEGORIES`; after the lead-in where one shows) and
    groups their durations by base name (the trailing parameter list
    stripped). ``name_prefix`` keeps only names starting with it.

    Returns ``{base_name: [duration_ms, ...]}`` in event order."""
    durations: dict[str, list[float]] = {}
    for e in _device_activities(_events(log_dir)):
        name = str(e.get("name", ""))
        if name_prefix is not None and not name.startswith(name_prefix):
            continue
        durations.setdefault(_base_name(name), []).append(
            float(e.get("dur", 0.0)) / 1e3)
    return durations


def step_durations(log_dir: str) -> dict[str, list[float]]:
    """Each traced step's device time (ms) from a trace of
    :func:`capture_step_trace`: ``step``, from its first device
    activity's start to its last one's end, and ``step_busy``, the sum of
    its activities' durations. An activity belongs to the step inside
    whose ``record_function`` range the host made the runtime call of the
    activity's ``correlation`` id."""
    events = _events(log_dir)
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("ph") == "X"
                 and e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    int(str(e["name"])[len(STEP_PREFIX):]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith(STEP_PREFIX))
    spans: dict[int, list[float]] = {}
    for e in _device_activities(events):
        host = launch_ts.get(e.get("args", {}).get("correlation"))
        if host is None:
            continue
        for lo, hi, i in steps:
            if lo <= host <= hi:
                ts, dur = float(e["ts"]), float(e["dur"])
                s = spans.setdefault(i, [ts, ts + dur, 0.0])
                s[0], s[1] = min(s[0], ts), max(s[1], ts + dur)
                s[2] += dur
                break
    order = sorted(spans)
    return {"step": [(spans[i][1] - spans[i][0]) / 1e3 for i in order],
            "step_busy": [spans[i][2] / 1e3 for i in order]}


def capture_step_trace(step_fn: Callable[..., Any],
                       carry: Any,
                       inputs: Sequence[Any],
                       *,
                       log_dir: str = "build/trace-latency",
                       warmup: int = 10,
                       sync: Callable[[Any], None] | None = None
                       ) -> dict[str, list[float]]:
    """Run ``carry = step_fn(carry, x)`` for each x under a trace, each
    call in its own ``record_function`` range, after up to ``warmup``
    untimed calls and a lead-in; nothing waits for the device between
    calls. Returns :func:`step_durations` of the trace (``{}`` with a
    warning where it holds no device activity: the CPU)."""
    from torch.profiler import record_function

    from koemorph_tpu_torch.utils.profiling import trace

    card = torch.cuda.is_available()
    if sync is None:
        def sync(_carry):
            if card:
                torch.cuda.synchronize()

    for x in inputs[:min(warmup, len(inputs))]:
        carry = step_fn(carry, x)
    sync(carry)
    shutil.rmtree(log_dir, ignore_errors=True)
    with trace(log_dir, host=True):
        if card:
            lead_in()
        for i, x in enumerate(inputs):
            with record_function(f"{STEP_PREFIX}{i}"):
                carry = step_fn(carry, x)
        sync(carry)
    durations = step_durations(log_dir)
    if not durations["step"]:
        logger.warning("no device activities in the trace under %s "
                       "(the CPU?)", log_dir)
        return {}
    return durations


def summarize_ms(samples: Sequence[float]) -> dict[str, float]:
    """p50 / p90 / p99 / max / mean (ms) of a list of durations."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        raise ValueError("no samples")
    return {
        "n": int(arr.size),
        "p50_ms": float(np.percentile(arr, 50)),
        "p90_ms": float(np.percentile(arr, 90)),
        "p99_ms": float(np.percentile(arr, 99)),
        "max_ms": float(arr.max()),
        "mean_ms": float(arr.mean()),
    }
