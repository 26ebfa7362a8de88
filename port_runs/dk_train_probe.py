"""K2 (``dk_roots``) on every batch of the training run ``chip_smoke.py``
phase 10 drives: the rule ``chip_smoke.dk_train_agreement`` applies to one
batch, applied to all twelve, and the rows the plain form leaves
unconverged after 20, 30 and 40 Durand-Kerner iterations.

Run from the repository root on a machine with a CUDA card:

    python3 port_runs/dk_train_probe.py

Prints one JSON line per batch and a total line.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.train.__main__ import (build_model,
                                                   write_synthetic_dataset)
    from koemorph_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        print("dk_train_probe needs a CUDA card", file=sys.stderr)
        return 1
    ck.build()
    cfg = load_config(ROOT / "configs" / "dual_stream_config.yaml")
    synth = write_synthetic_dataset(
        ROOT / "build" / "dk_train_probe", cs.TRAIN_FILES,
        duration_s=cs.TRAIN_FILE_S, sample_rate=int(cfg.data.sample_rate),
        fps=float(cfg.data.target_fps))
    model, _ = build_model(cfg)
    model = model.cuda()
    loader, _ = create_sequential_dataloader(
        synth, batch_size=int(cfg.data.batch_size),
        window_frames=model.window_frames + 32,
        stride_frames=int(cfg.data.stride_frames),
        sample_rate=int(cfg.data.sample_rate),
        target_fps=float(cfg.data.target_fps))
    total = {"batches": 0, "rows": 0, "misses": 0, "plain_misses_mean": 0.0}
    for i, batch in enumerate(loader()):
        rec = {}
        with torch.no_grad(), cs.recording_kernels(rec, "probe"):
            model.emotion_raw(torch.from_numpy(batch["audio"]).cuda())
        (a,), _ = next(v for k, v in rec.items() if k[0] == "dk_roots")
        a = a.reshape(-1, a.shape[-1]).contiguous()
        r = cs.dk_train_agreement(a)
        exact = torch.linalg.eigvals(cs.companion(a.double()))
        for iters in (20, 30, 40):
            z = eg.poly_roots_plain(a, iters=iters).to(torch.complex128)
            r[f"plain_not_converged_{iters}"] = int(
                (cs.hausdorff(z, exact) >= cs.DK_MAX).sum())
        r.update(batch=i, ok=cs.dk_train_ok(r))
        print(json.dumps(r), flush=True)
        total["batches"] += 1
        total["rows"] += r["rows"]
        total["misses"] += r["misses"]
        total["plain_misses_mean"] += (sum(r["plain_misses_rounded"])
                                       / len(r["plain_misses_rounded"]))
    total["plain_misses_mean"] /= max(total["batches"], 1)
    print(json.dumps({"total": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
