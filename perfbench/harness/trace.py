"""A profiled slice of a run, read out of the profiler's Chrome trace.

A profiling window loses its first few device activities, so a slice
starts with a lead-in (tiny kernels, a synchronization and 20 ms of
sleep) and its device activities are taken from the end of the lead-in's
idle gap on the device's own clock. The profiler also drops activities
that end after it stops, so a slice ends with a lead-out (a
synchronization, one marker kernel and 20 ms of sleep). The traced
window runs, on the device's clock, from the slice's first activity to
the marker; on the host the slice is one ``record_function`` range,
``perfbench.slice``.

Device busy time is the union of the device activities (kernels, copies,
fills) inside the window; the idle gaps between them are labelled by the
innermost ``perfbench.*`` range the host was in at the gap's start.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LEAD_GAP_US = 15000
SLICE = "perfbench.slice"


def lead_in() -> None:
    lead = torch.zeros(1, device="cuda")
    for _ in range(256):
        lead.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(0.02)


def lead_out() -> None:
    torch.cuda.synchronize()
    time.sleep(0.02)


def _is_lead_in(name: str) -> bool:
    low = name.lower()
    return "fill" in low or "add" in low or name.startswith("Memset")


def lead_in_end(acts: list) -> Optional[float]:
    """The start of the first activity after the lead-in's idle gap;
    ``acts`` are ``(start, end, name)`` in start order."""
    for i in range(1, len(acts)):
        if not _is_lead_in(acts[i - 1][2]):
            return None
        if acts[i][0] - acts[i - 1][1] >= LEAD_GAP_US:
            return acts[i][0]
    return None


def base_name(name: str) -> str:
    """A device activity's name without its parameter list and namespaces,
    cut to 120 characters (``Memcpy HtoD (Pageable -> Device)`` becomes
    ``Memcpy HtoD``)."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    for junk in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    return name[:120]


def warm_profiler() -> None:
    """Start and stop the profiler once over a tiny kernel, so that the
    tracer's own start-up (seconds, the first time in a process) falls in
    set-up and not in the window."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        x.add_(1.0)
        torch.cuda.synchronize()


class Slice:
    """``with Slice(path) as s:`` profiles the block; afterwards
    ``s.result`` is the parsed :class:`TraceResult`."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.result: Optional[TraceResult] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._marker = torch.ones(1, device="cuda")
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        lead_in()
        self._range = record_function(SLICE)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._marker.mul_(3.0)
        lead_out()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.path))
            with open(self.path) as fh:
                data = json.load(fh)
            events = data.get("traceEvents", data) if isinstance(data, dict) \
                else data
            self.result = TraceResult(events)
        return False


class TraceResult:
    """The device activities of a slice and the host ranges around them
    (times in µs on the trace's clock)."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X"]
        slices = [e for e in xs if e.get("name") == SLICE]
        if not slices:
            raise RuntimeError("the trace holds no perfbench.slice range")
        dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATEGORIES),
                     key=lambda e: float(e["ts"]))
        raw = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                str(e.get("name", ""))) for e in dev]
        first = lead_in_end(raw)
        if first is None or len(raw) < 2:
            raise RuntimeError("the trace shows no lead-in: its first "
                               "device activities were lost")
        acts = [(a, b, base_name(name)) for a, b, name in raw if a >= first]
        #: the window on the device's clock: from the slice's first
        #: activity to the end marker, the last activity of the trace
        self.t0, self.t1 = first, acts[-1][0]
        #: (start, end, base name) of each device activity in the window
        self.activities = acts[:-1]
        self.host_ranges = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("perfbench.")
            and e.get("name") != SLICE)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _merged(self) -> list[list[float]]:
        out: list[list[float]] = []
        for a, b, _ in sorted(self.activities):
            b = min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) / 1e6

    def kernel_us(self, pattern: str) -> tuple[int, float]:
        """(count, total µs) of the activities whose name holds
        ``pattern``."""
        durs = [b - a for a, b, name in self.activities if pattern in name]
        return len(durs), float(sum(durs))

    def device_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for a, b, name in self.activities:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def _host_label(self, t: float) -> str:
        inner = None
        for a, b, name in self.host_ranges:
            if a <= t < b and (inner is None or a >= inner[0]):
                inner = (a, b, name)
        return inner[2] if inner else "perfbench.none"

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time inside the window, summed by what the host was
        doing at each gap's start, largest first."""
        merged = self._merged()
        edges = [self.t0] + [x for ab in merged for x in ab] + [self.t1]
        by: dict[str, float] = {}
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b > a:
                label = self._host_label(a)
                by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]
