"""The lower-precision control of a cell: the plain reference computed in
TF32 (the precision below the configuration's float32) put in the
program's place, and the number its run compares, on each seed given.

    python3 perfbench/control.py --workload <name> --count <n> \
        --seeds <s> [<s> ...]

``--count`` is what one run of the cell compares: steps of the checked
lanes for a serving cell, checked calls for a decoding cell, checked
steps for a training cell. It needs a
CUDA card (TF32 exists only there) and prints one JSON line per seed.
The benchmark's runs never run it; a cell's limit lies below the least
reading it gives.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--count", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=("half", "state"), default="",
                   help="a training cell's fault instead of the control: "
                        "half of each batch left out, or the state left "
                        "unchanged")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import spec
    if not torch.cuda.is_available():
        print("perfbench: the control needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        cell = spec.load_cell(ROOT, args.workload, seed, 0.0, False)
        t0 = time.perf_counter()
        kw = {"fault": args.fault} if args.fault else {}
        readings = spec.driver(cell).control(cell, "cuda", args.count, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "count": args.count, "control": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
