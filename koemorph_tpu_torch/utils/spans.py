"""The port's spans, stage stamps and counters: one registry, off by
default.

- **Host spans.** ``with spans.host("koemorph.serve.launch"):`` records
  the span's name, start and end (``time.perf_counter_ns``), its parent
  span and the step id that every span under one top-level span shares,
  into a preallocated ring. While the profiler runs, the span also opens a
  ``torch.profiler.record_function`` range of the same name, so it lies on
  the trace's host clock beside the device activities.
- **Stage stamps.** ``with spans.track("serve", device, stages):`` marks
  one step of a track, whose ``stages`` (in order) the code that marks
  them declares: a stamp when the block starts, one at each
  ``spans.mark(stage)`` inside it, and one for the last stage when it
  ends. A stage marked more than once in a step (the serve's refresh, once
  per due cohort) keeps its last stamp, so it lasts from the stage before
  it to its last repeat. On a CUDA device a stamp is a one-thread kernel
  (``ops/cuda/stamp.cu``) that writes the device's global timer into the
  track's device ring at ``[step % capacity, slot]`` and, for the step's
  last stamp, advances the track's device step counter, so a stamp
  captured into a CUDA graph needs nothing from the host at replay. Its
  kernel's name carries its global slot id (``koemorph_stamp<7>``;
  :func:`slot_names`), given out in the order the tracks are first opened.
  On the CPU a stamp writes the host clock. A stage lasts from the stamp
  before it to its own.
- **Counters.** ``spans.count(name, n)``. Counters count whether the
  registry is on or off: they are a dict increment, and
  the launch and collective counts (``koemorph.kernels.launches.<name>``,
  ``koemorph.dist.collectives.<op>``) are read with the registry off.
- **Export.** :func:`export` returns the host spans, each track's stage
  durations per step (the device rings are read here, never per step) and
  the counters.

Off, :func:`host` and :func:`track` are one flag check that returns a
shared null context, and :func:`mark` one flag check: no clock read, no
``record_function``, no stamp. A CUDA graph captured while the registry
is off holds no stamp and never will; :func:`enable` must come before the
graphs are captured (it warns when a graph was captured before it), and
the export lists which graphs carry stamps.

The module imports torch only when the registry is switched on: the host
tools that import the data package (the feeder of ``serve --listen``)
start without it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time
from typing import Hashable

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["CAPACITY", "enable", "enabled", "paused", "reset", "host",
           "track", "mark", "count", "counters", "reset_counters",
           "note_capture", "slot_names", "export", "summary"]

#: steps of each track's stamps kept, and host spans per step
CAPACITY = 4096
_HOST_PER_STEP = 16
#: stamp.cu's kernel instantiations: the global slot ids there are
_MAX_SLOTS = 32

#: each opened track's slots: "begin", then its stages in order
_TRACKS: dict[str, tuple[str, ...]] = {}
#: each track's first global slot id
_BASE: dict[str, int] = {}

_ON = False
_clock = time.perf_counter_ns
#: torch's probe of a running profiler and its range, bound by enable()
_profiling = None
record_function = None
_TLS = threading.local()
_IDS = itertools.count()
_HOST: list = []
_RINGS: dict = {}
_GRAPHS: list = []
COUNTERS: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Switch the registry on, keeping :data:`CAPACITY` steps of each
    track's stamps and ``16 * CAPACITY`` host spans. Call it before any
    CUDA graph is captured: a graph captured while the registry was off
    replays without stamps."""
    global _ON, _HOST, _profiling, record_function
    import torch
    from torch.autograd.profiler import record_function
    _profiling = torch._C._autograd._profiler_enabled
    if not _HOST:
        _HOST = [None] * (CAPACITY * _HOST_PER_STEP)
    unstamped = [key for key, stamped in _GRAPHS if not stamped]
    if unstamped:
        logger.warning("span registry enabled after %d CUDA graph(s) were "
                       "captured; they replay without stage stamps: %s",
                       len(unstamped), unstamped[:4])
    _ON = True


@contextlib.contextmanager
def paused():
    """The registry off inside the block (an export traces no stamp)."""
    global _ON
    was, _ON = _ON, False
    try:
        yield
    finally:
        _ON = was


def reset() -> None:
    """Off, with every record, ring, track, counter and capture note
    dropped."""
    global _ON, _IDS, _HOST
    _ON = False
    _IDS = itertools.count()
    _HOST = []
    _RINGS.clear()
    _TRACKS.clear()
    _BASE.clear()
    _GRAPHS.clear()
    COUNTERS.clear()


# -- host spans ---------------------------------------------------------------

class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    try:
        return _TLS.stack
    except AttributeError:
        _TLS.stack = []
        return _TLS.stack


class _Span:
    __slots__ = ("name", "id", "parent", "step", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.id = next(_IDS)
        stack = _stack()
        if stack:
            self.parent, self.step = stack[-1].id, stack[-1].step
        else:
            self.parent, self.step = -1, self.id
        stack.append(self)
        if _profiling():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        ring = _HOST
        if ring:
            ring[self.id % len(ring)] = (
                self.id, self.name, self.t0, t1, self.parent, self.step,
                self.rf is not None)
        return False


def host(name: str):
    """A host span named ``name`` as a context manager; off, a shared null
    context."""
    if not _ON:
        return _NULL
    return _Span(name)


# -- stage stamps -------------------------------------------------------------

class _Rings:
    """One track's stamp ring and step counter on one device."""

    def __init__(self, name: str, device):
        import torch
        n = len(_TRACKS[name])
        self.base = _BASE[name]
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"the {name} track's first stamp on {device} is inside "
                    "a CUDA graph capture; run the step once before "
                    "capturing it (StepGraphs' warm-up does)")
            self.ring = torch.zeros((CAPACITY, n), dtype=torch.int64,
                                    device=device)
            self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        else:
            self.ring = np.zeros((CAPACITY, n), np.int64)
            self.counter = 0


def _stamp(rings: _Rings, slot: int, flags: int) -> None:
    """The stamp op: flags 1 opens the step's row, 2 closes it."""
    if rings.cuda:
        from koemorph_tpu_torch.ops import cuda as ck
        ck.stamp(rings.ring, rings.counter, rings.base + slot, slot, flags)
        return
    row = rings.ring[rings.counter % len(rings.ring)]
    if flags & 1:
        row[:] = 0
    row[slot] = _clock()
    if flags & 2:
        rings.counter += 1


def _register(name: str, stages: tuple) -> None:
    """Give track ``name`` its global slot ids at its first opening."""
    slots = ("begin",) + tuple(stages)
    have = _TRACKS.get(name)
    if have is not None:
        if have != slots:
            raise ValueError(f"track {name!r} was opened with stages "
                             f"{have[1:]}, now {tuple(stages)}")
        return
    base = sum(len(s) for s in _TRACKS.values())
    if base + len(slots) > _MAX_SLOTS:
        raise ValueError(f"track {name!r} needs slot ids up to "
                         f"{base + len(slots) - 1}; stamp.cu has "
                         f"{_MAX_SLOTS}")
    _TRACKS[name], _BASE[name] = slots, base


class _Track:
    __slots__ = ("rings", "marks", "last", "prev")

    def __init__(self, name: str, device, stages: tuple):
        _register(name, stages)
        rings = _RINGS.get((name, device))
        if rings is None:
            rings = _RINGS[(name, device)] = _Rings(name, device)
        self.rings = rings
        self.last = len(stages)
        #: the slots a mark stamps: every stage but the last, which the
        #: block's end stamps
        self.marks = {s: i for i, s in enumerate(stages[:-1], 1)}

    def __enter__(self):
        self.prev = getattr(_TLS, "track", None)
        _TLS.track = self
        _stamp(self.rings, 0, 1)
        return self

    def __exit__(self, exc_type, *exc):
        _TLS.track = self.prev
        if exc_type is None:
            _stamp(self.rings, self.last, 2)
        return False


def track(name: str, device, stages: tuple) -> object:
    """One step of track ``name`` on ``device``, whose ``stages`` end in
    this order, as a context manager: its first stamp on entry, the last
    stage's stamp on a clean exit, and the :func:`mark` calls inside stamp
    the others. A track keeps the stages it was first opened with. Off, a
    null context."""
    if not _ON:
        return _NULL
    import torch
    return _Track(name, torch.device(device), stages)


def mark(stage: str) -> None:
    """Stamp the end of ``stage`` in the step of the innermost open track
    (a repeat overwrites the stage's stamp); nothing where no track is
    open or the track has no such stage."""
    if not _ON:
        return
    t = getattr(_TLS, "track", None)
    if t is None:
        return
    slot = t.marks.get(stage)
    if slot is not None:
        _stamp(t.rings, slot, 0)


def slot_names() -> dict[int, tuple[str, str]]:
    """Global slot id (the stamp kernel's template argument) -> (track,
    stage), of the tracks opened so far."""
    return {_BASE[name] + i: (name, stage)
            for name, stages in _TRACKS.items()
            for i, stage in enumerate(stages)}


# -- counters and captures ----------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _COUNT_LOCK:
        COUNTERS[name] += n


def counters(prefix: str = "") -> dict[str, int]:
    """The counters whose names start with ``prefix``."""
    return {k: v for k, v in COUNTERS.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    with _COUNT_LOCK:
        for k in [k for k in COUNTERS if k.startswith(prefix)]:
            del COUNTERS[k]


def note_capture(key: Hashable) -> None:
    """Note a CUDA graph's capture: it carries stamps iff the registry is
    on now."""
    _GRAPHS.append((repr(key), _ON))


# -- export ---------------------------------------------------------------

def _stage_rows(name: str, rings: _Rings) -> list[dict]:
    if rings.cuda:
        ring = rings.ring.cpu().numpy()
        n_steps = int(rings.counter.item())
    else:
        ring, n_steps = rings.ring, rings.counter
    stages = _TRACKS[name]
    rows = []
    for step in range(max(0, n_steps - len(ring)), n_steps):
        row = ring[step % len(ring)]
        hit = sorted((int(t), i) for i, t in enumerate(row) if t)
        if not hit or hit[0][1] != 0:
            continue
        ns = {stages[i]: t1 - t0
              for (t0, _), (t1, i) in zip(hit, hit[1:])}
        rows.append({"step": step, "device": str(rings.device),
                     "start_ns": hit[0][0], "end_ns": hit[-1][0], "ns": ns})
    return rows


def export() -> dict:
    """Everything recorded: ``host`` (closed host spans in start order,
    each ``id``, ``name``, ``start_ns``, ``end_ns``, ``parent``, ``step``,
    ``profiled``), ``stages`` (per track, one entry per complete step with
    each stage's ``ns``), ``counters`` and ``graphs`` (captured graphs'
    keys with and without stamps)."""
    spans = sorted((e for e in _HOST if e is not None), key=lambda e: e[0])
    host_rows = [dict(zip(("id", "name", "start_ns", "end_ns", "parent",
                           "step", "profiled"), e))
                 for e in spans]
    stages: dict[str, list] = {}
    for (name, _), rings in _RINGS.items():
        stages.setdefault(name, []).extend(_stage_rows(name, rings))
    return {"host": host_rows, "stages": stages, "counters": dict(COUNTERS),
            "graphs": {"stamped": [k for k, s in _GRAPHS if s],
                       "unstamped": [k for k, s in _GRAPHS if not s]}}


def summary() -> dict:
    """What a stats line shows: per track the median ms of each stage over
    its last 300 steps (over those that ran it), the median ms of each host
    span name over its last 300 spans, and the counters."""
    data = export()
    stage_ms = {}
    for name, rows in data["stages"].items():
        rows = rows[-300:]
        names = sorted({s for r in rows for s in r["ns"]})
        stage_ms[name] = {s: float(np.median([r["ns"][s] for r in rows
                                              if s in r["ns"]])) / 1e6
                          for s in names}
    by_name: dict[str, list] = {}
    for row in data["host"]:
        by_name.setdefault(row["name"], []).append(row["end_ns"]
                                                   - row["start_ns"])
    host_ms = {k: float(np.median(v[-300:])) / 1e6
               for k, v in sorted(by_name.items())}
    return {"stage_ms": stage_ms, "host_ms": host_ms,
            "counters": dict(data["counters"])}
