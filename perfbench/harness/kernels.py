"""The hand-written kernels' launches inside the program's CUDA graphs,
and the least time each could take.

A graph replay runs the launches its capture recorded, with the same
argument buffers, so the benchmark records each kernel wrapper's
arguments while a graph is captured, by the graph's key. After a replay
the buffers hold that replay's values: :meth:`LaunchRecorder.snapshot`
copies the per-row inputs that the work depends on (the cycle starts,
periods and offsets of ``cycle_dsum``), and :func:`bounds` turns a
snapshot into the bound of each launch (:mod:`.roofline`).
"""

from __future__ import annotations

import contextlib
import functools

import torch

from perfbench.harness import roofline

KERNELS = ("cycle_dsum", "dk_roots", "logmel")


class LaunchRecorder:
    """Records ``(name, args, kwargs)`` of every kernel launch made while
    a graph of a wrapped :class:`StepGraphs` is captured, by its key."""

    def __init__(self):
        self.by_key: dict = {}
        self._key = None
        self.recording = False
        self.snapshots: list = []

    @contextlib.contextmanager
    def installed(self):
        from koemorph_tpu_torch.ops import cuda as ck
        real = {name: getattr(ck, name) for name in KERNELS}

        def wrap(name):
            def call(*args, **kw):
                if (self._key is not None
                        and torch.cuda.is_current_stream_capturing()):
                    self.by_key.setdefault(self._key, []).append(
                        (name, args, kw))
                return real[name](*args, **kw)
            return call

        for name in KERNELS:
            setattr(ck, name, wrap(name))
        try:
            yield self
        finally:
            for name, fn in real.items():
                setattr(ck, name, fn)

    def watch(self, step_graphs) -> None:
        """Tag the captures of ``step_graphs`` with their keys; while
        :attr:`recording`, append a snapshot of every replay's launches to
        :attr:`snapshots`."""
        capture, replay = step_graphs.capture, step_graphs.run

        @functools.wraps(capture)
        def tagged(key, *args, **kw):
            self._key = key
            try:
                return capture(key, *args, **kw)
            finally:
                self._key = None

        @functools.wraps(replay)
        def noted(key, *args, **kw):
            out = replay(key, *args, **kw)
            if self.recording:
                self.snapshots.append(self.snapshot(key))
            return out

        step_graphs.capture = tagged
        step_graphs.run = noted

    def snapshot(self, key) -> list:
        """The launches of graph ``key`` with copies of the inputs their
        work depends on, as they stand after its latest replay."""
        out = []
        for name, args, kw in self.by_key.get(key, []):
            if name == "cycle_dsum":
                frames, start, tau, off = args[:4]
                out.append((name, {
                    "layout": roofline.frame_layout(frames),
                    "n": frames.shape[-1], "rows": start.numel(),
                    "n_cycles": kw["n_cycles"], "half_lag": kw["half_lag"],
                    "start": start.clone(), "tau": tau.clone(),
                    "off": off.clone()}))
            elif name == "dk_roots":
                a = args[0]
                out.append((name, {"rows": a.numel() // a.shape[-1]}))
            else:
                frames = args[0]
                out.append((name, {"t": frames.numel() // frames.shape[-1]}))
        return out


def bounds(snapshots: list, live: int, nnz: int) -> dict:
    """Bound seconds, operations and launches of each kernel over a list
    of snapshots (one per replay)."""
    out = {name: {"bound_s": 0.0, "ops": 0.0, "launches": 0}
           for name in KERNELS}
    for snap in snapshots:
        for name, a in snap:
            e = out[name]
            e["launches"] += 1
            if name == "cycle_dsum":
                masked = roofline.cycle_masked(a["n"], a["start"], a["tau"],
                                               a["off"], a["n_cycles"],
                                               a["half_lag"])
                e["bound_s"] += roofline.k1_bound_s(
                    a["layout"], a["n"], masked, a["rows"], a["n_cycles"],
                    a["half_lag"])
                e["ops"] += roofline.k1_ops(masked, a["half_lag"])
            elif name == "dk_roots":
                e["bound_s"] += roofline.k2_bound_s(a["rows"])
                e["ops"] += roofline.k2_ops(a["rows"])
            else:
                e["bound_s"] += roofline.k3_bound_s(a["t"], live, nnz)
                e["ops"] += roofline.k3_ops(a["t"], live, nnz)
    return out
