"""Which short ``training_rehearsal`` passes its gate: the rehearsal's
training (device-resident scan epochs) at several file and epoch counts,
active weight 4, with its entry-point runs (``infer``, ``rt``,
``export_model``) stubbed to exit 0, so each variant costs its training
alone. The gate's other terms are the last epoch's correlation, F1 and
range ratio, which this prints.

Run from the repository root on a machine with a CUDA card:

    python3 port_runs/rehearsal_gate_probe.py

Prints one JSON line per variant (``rc`` 0: the gate passed).
"""

import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from koemorph_tpu_torch import training_rehearsal as tr  # noqa: E402

VARIANTS = [(4, 880), (2, 880), (4, 500), (8, 500), (8, 400), (4, 300),
            (2, 500)]


def main():
    tr.run_entry_points = lambda cmds, work: {
        name: {"rc": 0, "tail": ""} for name in cmds}
    work = ROOT / "build" / "rehearsal_gate_probe"
    for files, epochs in VARIANTS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tr.main(["--files", str(files), "--epochs", str(epochs),
                          "--active-weight", "4", "--no-diagnose-recall",
                          "--work-dir", str(work / f"{files}_{epochs}"),
                          "--report-dir", str(work / f"{files}_{epochs}_r")])
        d = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(json.dumps({"files": files, "epochs": epochs, "rc": rc,
                          **{k: d[k] for k in (
                              "steps_per_epoch", "correlation_last",
                              "f1_last", "range_ratio_first",
                              "range_ratio_last", "mae_last",
                              "train_seconds")}}), flush=True)


if __name__ == "__main__":
    main()
