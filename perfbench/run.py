"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the
program (``koemorph_tpu_torch``). The run makes its inputs and weights
from ``--seed``, sets up and warms the cell's path, measures for
``--seconds``, checks the outputs of the timed path against the plain
reference under ``perfbench/reference``, and prints one JSON line last
on standard output (with ``--trace 1`` the per-layer metrics of a
profiled slice of the window). The numbers compared for ``correct`` are
also the last lines on standard error. It needs a CUDA card: without one
(or with fewer than the cell asks for) it exits with 2 and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # one process with few threads: the host's noise stays out of the
    # numbers (the loop is single-threaded; the card does the work)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    # no library the program uses may bring JAX into the process
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the program's build caches stay at fixed paths inside the checkout
    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    sys.path.insert(0, str(ROOT))

    from perfbench.harness import spec
    cell = spec.load_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is "
              "False); the benchmark never falls back to the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    from perfbench.harness.runner import execute
    line = execute(cell, T_START, "cuda")
    for name, c in line["compared"].items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
