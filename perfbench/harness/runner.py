"""One run of one cell: the driver's set-up, window and comparison, then
the metrics read from its record and the result line.

A driver's ``run(cell, t_start, device)`` returns a record (a dict):
``setup_s``, ``window_s``, ``attempted``, ``failed``, the work counts and
samples its metrics read, ``memory_peak_bytes``, ``compared`` (name ->
(value, limit)), and with ``--trace 1`` the profiled slice (``trace``, a
:class:`~perfbench.harness.trace.TraceResult`) with what the per-layer
readers take from it. The record is all a metric's reader sees.
"""

from __future__ import annotations

import sys

import torch

from perfbench.harness import spec

#: top-level module names that no run may hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "koemorph_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def execute(cell: spec.Cell, t_start: float, device: str = "cuda") -> dict:
    """Run ``cell`` once; returns the result line as a dict (``compared``
    last). Raises where a metric the cell must report is missing or a
    forbidden module was loaded."""
    if device == "cuda":
        # the configurations state float32: no TF32 products anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rec = spec.driver(cell).run(cell, t_start, device)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package were "
                           f"loaded: {found}")
    metrics = {}
    for m in cell.metrics:
        value = spec.reader(m.name).read(rec)
        if value is None:
            if not cell.trace:
                raise RuntimeError(f"end-to-end metric {m.name} read "
                                   "nothing")
            print(f"perfbench: per-layer metric {m.name} read nothing",
                  file=sys.stderr)
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    compared = {name: {"value": float(v), "limit": float(lim)}
                for name, (v, lim) in rec["compared"].items()}
    correct = (rec["failed"] == 0 and bool(compared)
               and all(c["value"] <= c["limit"] for c in compared.values()))
    dev = {"platform": "gpu" if device == "cuda" else str(device),
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else str(device)),
           "count": cell.chips,
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if cell.trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(10),
                             "idle_gaps": tr.idle_gaps(10)}
    line["compared"] = compared
    return line
