"""What the program records about itself in a traced run, and the readers
of the per-layer metrics that rest on it.

The program (``koemorph_tpu_torch``) has a span registry
(``koemorph_tpu_torch/utils/spans.py``), off by default. In a traced run
(``--trace 1`` on the command line of ``perfbench/run.py``) it is switched
on when the drivers' package is imported (:func:`enable_for_traced_run`),
before a driver builds the program's engines and captures their CUDA
graphs: the drivers take no part in it, and the command line is what
names a traced run before then. Three records follow:

- **Stage stamps** in the profiled slice: one-thread kernels named
  ``koemorph_stamp<id>`` inside each step's graph, whose slot ids the
  registry's :func:`slot_names` maps to (track, stage). A step of a track
  runs from its ``begin`` stamp to its last stage's; a stage lasts from the
  stamp before it to its own (:func:`stage_steps`), on the device's clock.
- **Host spans** (``koemorph.*``), kept by the registry on the host's
  ``perf_counter_ns`` clock and read after the window
  (:func:`host_rows`); while the profiler runs each is also a
  ``record_function`` range on the trace's host clock.
- **Counters**, read after the window.

:class:`ProgramTrace` reads the slice's Chrome trace once more for what
:class:`~perfbench.harness.trace.TraceResult` does not keep: the
``koemorph.*`` ranges of the thread that ran the slice and the runtime
calls' correlation ids. It checks the host clock against the device's
(every ``cudaGraphLaunch`` and ``cudaMemcpyAsync`` in the slice must have
begun before the first activity it issued; the host's times are moved
back by the largest violation) and splits each idle gap of the window by
the innermost ``koemorph.*`` range the host was in over each part of it.

Every reader returns None where the program has no registry (an older
program) or the record holds nothing to read. What a reader works out once
per run (the registry's export, the slice's program trace) is kept in the
run's record under ``"program"``.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path
from typing import Optional

from perfbench.harness.trace import SLICE

ROOT = Path(__file__).resolve().parents[2]
STAMP = re.compile(r"^koemorph_stamp<(\d+)>$")
RUNTIME_CALLS = ("cudaGraphLaunch", "cudaMemcpyAsync")
NONE = "koemorph.none"


# -- the run and the registry -----------------------------------------------

def run_args(argv=None) -> dict:
    """``workload`` and ``trace`` of this process's command line
    (``sys.argv[1:]`` unless ``argv`` is given), where it names them."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--workload")
    p.add_argument("--trace", nargs="?")
    got, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return {k: v for k, v in vars(got).items() if v is not None}


def spans_module():
    """The program's span registry, or None (a program without one)."""
    try:
        from koemorph_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def enable_for_traced_run(argv=None) -> bool:
    """Switch the program's registry on when this process is a traced run;
    returns whether it did."""
    if run_args(argv).get("trace") != "1":
        return False
    spans = spans_module()
    if spans is None:
        return False
    spans.enable()
    return True


def _kept(rec: dict) -> dict:
    """What the readers work out once per run, kept in its record."""
    return rec.setdefault("program", {})


def exported(rec: dict) -> Optional[dict]:
    """The registry's export, taken once after the window (None where the
    registry is absent or was never on)."""
    kept = _kept(rec)
    if "export" not in kept:
        spans = spans_module()
        data = spans.export() if spans is not None else None
        kept["export"] = data if data and (data["host"] or data["stages"]) \
            else None
    return kept["export"]


def slot_names() -> Optional[dict]:
    spans = spans_module()
    if spans is None or not hasattr(spans, "slot_names"):
        return None
    return spans.slot_names()


# -- host spans (host clock, after the window) ------------------------------

def host_rows(rec: dict, top: str) -> Optional[list]:
    """The registry's host spans inside the window: the window ends with
    the last ``top`` span and lasts ``rec["window_s"]``."""
    data = exported(rec)
    if not data or not rec.get("window_s"):
        return None
    ends = [r["end_ns"] for r in data["host"] if r["name"] == top]
    if not ends:
        return None
    hi = max(ends)
    lo = hi - rec["window_s"] * 1e9
    return [r for r in data["host"]
            if r["start_ns"] >= lo and r["end_ns"] <= hi]


def host_share(rec: dict, name: str, top: str) -> Optional[float]:
    """Percent of the window the host spent in spans ``name``."""
    rows = host_rows(rec, top)
    if rows is None:
        return None
    spent = sum(r["end_ns"] - r["start_ns"] for r in rows
                if r["name"] == name)
    return 100.0 * spent / (rec["window_s"] * 1e9)


def host_median_ms(rec: dict, name: str, top: str) -> Optional[float]:
    """Median ms of the spans ``name`` in the window, outside the profiled
    slice."""
    rows = host_rows(rec, top)
    durs = [r["end_ns"] - r["start_ns"] for r in rows or ()
            if r["name"] == name and not r["profiled"]]
    return statistics.median(durs) / 1e6 if durs else None


# -- stage stamps (device clock, in the slice) ------------------------------

def stage_steps(activities: list, slots: dict, track: str) -> list[dict]:
    """The steps of ``track`` among the slice's device activities
    (``(start, end, name)``, µs): for each step from its ``begin`` stamp to
    its last stage's, each stage's µs (a stage stamped more than once in a
    step, the serve's refresh once per due cohort, summed over its
    repeats), with the step's ``_start`` and ``_end`` (the last stamp's
    start)."""
    own = {i: stage for i, (t, stage) in slots.items() if t == track}
    if not own:
        return []
    last = own[max(own)]
    stamps = sorted((a, own[int(m.group(1))])
                    for a, _, name in activities
                    if (m := STAMP.match(name)) and int(m.group(1)) in own)
    steps, cur = [], None
    for t, stage in stamps:
        if stage == "begin":
            cur = {"_start": t, "_prev": t}
            continue
        if cur is None:
            continue
        cur[stage] = cur.get(stage, 0.0) + (t - cur["_prev"])
        cur["_prev"] = t
        if stage == last:
            cur["_end"] = cur.pop("_prev")
            steps.append(cur)
            cur = None
    return steps


def traced_steps(rec: dict, track: str) -> Optional[list]:
    """:func:`stage_steps` of the record's slice, or None."""
    tr, slots = rec.get("trace"), slot_names()
    if tr is None or not slots:
        return None
    report(rec)
    steps = stage_steps(tr.activities, slots, track)
    return steps or None


def median_stage_ms(rec: dict, track: str, stages: tuple,
                    only_with: Optional[str] = None) -> Optional[float]:
    """Median over the slice's steps of ``track`` (those that ran
    ``only_with``, if given) of the sum of ``stages``, in ms."""
    steps = traced_steps(rec, track)
    if not steps:
        return None
    if only_with is not None:
        steps = [s for s in steps if only_with in s]
    vals = [sum(s.get(k, 0.0) for k in stages) for s in steps
            if any(k in s for k in stages)]
    return statistics.median(vals) / 1e3 if vals else None


# -- the slice's program ranges and correlations -----------------------------

def _corr(e: dict):
    args = e.get("args") or {}
    return args.get("correlation")


class ProgramTrace:
    """The slice's ``koemorph.*`` ranges (of the thread that ran the
    slice), runtime calls and device activities by correlation id, and the
    window of ``result`` (the slice's :class:`TraceResult`): times in µs
    on the trace's clocks."""

    def __init__(self, events: list[dict], result):
        xs = [e for e in events if e.get("ph") == "X"]
        sl = next(e for e in xs if e.get("name") == SLICE)
        self.tid = sl.get("tid")
        s0, s1 = float(sl["ts"]), float(sl["ts"]) + float(sl["dur"])
        self.t0, self.t1 = result.t0, result.t1
        self.busy = self._merge(result.activities)
        first: dict = {}
        ends: dict = {}
        for e in xs:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                c = _corr(e)
                if c is None:
                    continue
                a = float(e["ts"])
                first[c] = min(first.get(c, a), a)
                ends[c] = max(ends.get(c, a), a + float(e["dur"]))
        #: (correlation, host start, first activity start, last end) of
        #: each graph launch or async copy the slice's host made
        self.calls = []
        for e in xs:
            if (e.get("cat") == "cuda_runtime"
                    and str(e.get("name", "")).startswith(RUNTIME_CALLS)
                    and s0 <= float(e["ts"]) <= s1):
                c = _corr(e)
                if c in first:
                    self.calls.append((str(e["name"]), c, float(e["ts"]),
                                       first[c], ends[c]))
        #: µs the host clock runs ahead of the device's: the largest
        #: amount by which a call seemed to start after its first activity
        self.offset_us = max([0.0] + [h - d for _, _, h, d, _ in self.calls])
        self.ranges = sorted(
            (float(e["ts"]) - self.offset_us,
             float(e["ts"]) + float(e["dur"]) - self.offset_us,
             str(e["name"]))
            for e in xs if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith("koemorph.")
            and e.get("tid") == self.tid)

    @staticmethod
    def _merge(acts) -> list:
        out: list = []
        for a, b, _ in sorted(acts):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def gaps(self) -> list:
        edges = [self.t0] + [min(x, self.t1) for ab in self.busy
                             for x in ab] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_by_span(self) -> dict:
        """µs of the window's idle time by the innermost ``koemorph.*``
        range the host was in (``koemorph.none`` outside any)."""
        out: dict = {}
        for a, b in self.gaps():
            inside = [r for r in self.ranges if r[0] < b and r[1] > a]
            cuts = sorted({a, b} | {x for r in inside for x in r[:2]
                                    if a < x < b})
            for p, q in zip(cuts, cuts[1:]):
                m = 0.5 * (p + q)
                over = [r for r in inside if r[0] <= m < r[1]]
                name = (max(over, key=lambda r: (r[0], -r[1]))[2]
                        if over else NONE)
                out[name] = out.get(name, 0.0) + (q - p)
        return out

    def count(self, name: str) -> int:
        return sum(1 for r in self.ranges if r[2] == name)

    def replays(self) -> list:
        """(first activity start, last activity end) of each graph launch
        in the slice, µs."""
        return [(d, e) for name, _, _, d, e in self.calls
                if name.startswith("cudaGraphLaunch")]


def trace_file(workload: Optional[str] = None) -> Optional[Path]:
    """The trace file of the slice that the run's driver wrote, named by
    the command line's workload."""
    workload = workload or run_args().get("workload")
    if not workload:
        return None
    path = ROOT / "build" / "perfbench" / f"{workload}.trace.json"
    return path if path.exists() else None


def program_trace(rec: dict) -> Optional[ProgramTrace]:
    """The :class:`ProgramTrace` of the record's slice (its trace file
    read once), or None."""
    kept = _kept(rec)
    if "trace" not in kept:
        tr, path = rec.get("trace"), trace_file()
        pt = None
        if tr is not None and path is not None:
            with open(path) as fh:
                data = json.load(fh)
            events = data.get("traceEvents", data) \
                if isinstance(data, dict) else data
            pt = ProgramTrace(events, tr)
        kept["trace"] = pt
    return kept["trace"]


def report(rec: dict) -> None:
    """Print, once, the slice's host clock offset and its idle time split
    by program span (stderr)."""
    kept = _kept(rec)
    if kept.get("reported"):
        return
    kept["reported"] = True
    pt = program_trace(rec)
    if pt is None:
        return
    split = {k: round(v / 1e3, 3) for k, v in sorted(
        pt.idle_by_span().items(), key=lambda kv: -kv[1])}
    print(f"perfbench: program trace: host clock offset "
          f"{pt.offset_us:.1f} us over {len(pt.calls)} calls; idle ms by "
          f"program span {json.dumps(split)}", file=sys.stderr)


def idle_per_span_ms(rec: dict, name: str, per: str) -> Optional[float]:
    """The slice's idle ms under program span ``name``, per range ``per``
    the slice holds."""
    pt = program_trace(rec)
    if pt is None or not pt.count(per):
        return None
    report(rec)
    return pt.idle_by_span().get(name, 0.0) / 1e3 / pt.count(per)
