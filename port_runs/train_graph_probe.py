"""The compiled train step against the eager one on the card, for the
three trainers: the flagship sequential trainer
(``configs/dual_stream_config.yaml``, batch 16, span 288), the legacy
``KoeMorphTrainer`` (``configs/config.yaml``, batch 16, 12 s) and the
emotion2vec trainer (batch 4), each from one start, then 5 back-to-back
steps of each between CUDA events; and ``train_epochs_scan`` over 3
flagship batches x 2 epochs against per-epoch ``train_epoch_scan`` in the
same orders, with the profiler's ``Memcpy HtoD`` count.

Run from the repository root on a machine with a CUDA card:

    python3 port_runs/train_graph_probe.py

Prints one JSON line per trainer and one for the scan.
"""

import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from koemorph_tpu_torch.ops import cuda as ck  # noqa: E402
from koemorph_tpu_torch.train.__main__ import build_model  # noqa: E402
from koemorph_tpu_torch.train.trainer import (KoeMorphTrainer,  # noqa: E402
                                              SequentialTrainer,
                                              scan_orders)
from koemorph_tpu_torch.utils.config import load_config, to_dict  # noqa: E402

WORK = ROOT / "build" / "train_graph_probe"


def state(tr):
    out = {f"p.{k}": v.detach().clone() for k, v in tr.params.items()}
    for n in ("mu", "nu", "trace", "acc"):
        for k, v in (getattr(tr.optimizer, n, None) or {}).items():
            out[f"{n}.{k}"] = v.clone()
    return out


def differ(a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


def batch(b, frames, hop, seed, key="blendshapes"):
    rng = np.random.default_rng(seed)
    t = np.arange(frames * hop) / 16000
    f0 = 120 + 60 * rng.random((b, 1))
    x = (0.3 * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) + 0.02 * rng.standard_normal(
        (b, frames * hop))).astype(np.float32)
    return {"audio": torch.from_numpy(x).cuda(),
            key: torch.from_numpy(rng.uniform(0, 0.3, (b, frames, 52))
                                  .astype(np.float32)).cuda(),
            "sample_mask": torch.ones(b, device="cuda")}


def run(name, make, batches, n):
    res = {"name": name}
    try:
        e, g = make(False), make(True)
        for i in range(n):
            b = batches[i % len(batches)]
            me = e.train_step(b)
            torch.cuda.synchronize()
            t1 = time.time()
            mg = g.compiled_step(b)
            torch.cuda.synchronize()
            if i == 0:
                res["first_s"] = time.time() - t1
            bad = [k for k in me if not torch.equal(me[k], mg[k])]
            if bad:
                res.setdefault("metric_diff", {})[i] = bad[:5]
        bad = differ(state(e), state(g))
        res["state_diff"], res["n_diff"] = bad[:10], len(bad)
        res["counts"] = (e.optimizer.count, g.optimizer.count)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for label, fn in (("graphed_ms", g.compiled_step),
                          ("eager_ms", e.train_step)):
            ev[0].record()
            for _ in range(5):
                fn(batches[0])
            ev[1].record()
            torch.cuda.synchronize()
            res[label] = ev[0].elapsed_time(ev[1]) / 5
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    except Exception:
        res["error"] = traceback.format_exc()[-3000:]
    print(json.dumps(res), flush=True)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ck.build()
    cfg = load_config(ROOT / "configs" / "dual_stream_config.yaml")

    def mk_seq(graphs, c=cfg):
        model, _ = build_model(c)
        return SequentialTrainer(
            model, to_dict(c), work_dir=WORK / f"s{graphs}",
            steps_per_epoch=12, span_frames=model.window_frames + 32,
            graphs=graphs)

    bs = [batch(16, 288, 533, s) for s in range(3)]
    run("sequential", mk_seq, bs, 4)
    lcfg = load_config(ROOT / "configs" / "config.yaml")

    def mk_leg(graphs):
        model, _ = build_model(lcfg)
        return KoeMorphTrainer(model, to_dict(lcfg),
                               work_dir=WORK / f"l{graphs}",
                               steps_per_epoch=12, graphs=graphs)

    lb = [batch(16, 361, 533, s, key="arkit") for s in range(2)]
    for b in lb:
        b["audio"] = b["audio"][:, :192000].contiguous()
    run("legacy", mk_leg, lb, 3)
    ecfg = load_config(ROOT / "configs" / "dual_stream_config.yaml",
                       overrides=["model.emotion_config.backend=emotion2vec",
                                  "data.batch_size=4"])
    run("e2v", lambda graphs: mk_seq(graphs, ecfg),
        [batch(4, 288, 533, s) for s in range(2)], 3)

    from torch.profiler import ProfilerActivity, profile
    host_b = [{k: v.cpu().numpy() for k, v in b.items()
               if k != "sample_mask"} for b in bs]
    a, r = mk_seq(None), mk_seq(None)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hist = a.train_epochs_scan(iter(host_b), n_epochs=2, shuffle_seed=3)
        torch.cuda.synchronize()
    for o in scan_orders(3, 2, 3):
        r.train_epoch_scan(iter([host_b[i] for i in o]))
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    print(json.dumps({"scan_diff": len(differ(state(a), state(r))),
                      "htod": sum("HtoD" in n for n in names),
                      "device_activities": len(names),
                      "epoch_losses": [h["loss"] for h in hist]}),
          flush=True)


if __name__ == "__main__":
    main()
