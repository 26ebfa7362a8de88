"""The benchmark's definition, read from ``BENCHMARK.json`` at the root of
the checkout, and the files each name leads to.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one ``configs`` gives; the traffic
mix is ``perfbench/traffic/<traffic>.json``, whose ``driver`` names the
module ``perfbench/drivers/<driver>.py`` that runs it; each metric is
read by ``perfbench/metrics/<name>.py``. So a new configuration, traffic
mix or metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple | None
    bound: float | None = None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    end_to_end: tuple
    per_layer: tuple
    root: Path

    @property
    def metrics(self) -> tuple:
        """The metrics this run reports: end-to-end without the trace,
        per-layer with it."""
        return self.per_layer if self.trace else self.end_to_end


def _metrics(entries: list, cell: str) -> tuple:
    out = []
    for e in entries:
        workloads = e.get("workloads")
        if workloads is not None and cell not in workloads:
            continue
        out.append(Metric(e["name"], e["unit"], e["better"], e["source"],
                          tuple(workloads) if workloads else None,
                          e.get("bound")))
    return tuple(out)


def load_cell(root: Path, workload: str, seed: int, seconds: float,
              trace: bool, traffic: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; ``traffic``
    replaces its traffic file (the tests' small sizes)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    if traffic is None:
        traffic = json.loads(
            (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, seed=int(seed),
                seconds=float(seconds), trace=bool(trace),
                end_to_end=_metrics(bench["end_to_end"], workload),
                per_layer=_metrics(bench["per_layer"], workload), root=root)


def driver(cell: Cell) -> ModuleType:
    name = cell.traffic["driver"]
    return importlib.import_module(f"perfbench.drivers.{name}")


def reader(name: str) -> ModuleType:
    """The module ``perfbench/metrics/<name>.py`` (names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
