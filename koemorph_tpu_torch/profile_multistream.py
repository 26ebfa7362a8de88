"""Concurrent-session capacity sweep of the multi-stream server: the
counterpart of the JAX package's ``scripts/profile_multistream.py``.

Measures the sustained per-frame step latency of
:class:`koemorph_tpu_torch.runtime.MultiStreamInference` (the production
streaming config: d_model 256, eGeMAPS with the 3-window concatenation and
the incremental LLD ring, a refresh every 300 ms; random weights) across
session counts, and reports the largest count whose step stays inside the
``1000 / fps`` ms frame budget: concurrent avatars per card. The
reference serves one session per process. Each count prints one JSON line
(``sustained_stats``: warm-up scans, then one timed scan of ``--frames``
steps to a device synchronization; ``compile_s`` is the rest of the
count's wall time, the graphs' captures), then a summary line::

    python -m koemorph_tpu_torch.profile_multistream --sessions 8 32 64

Runs on the GPU (raises without CUDA) unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sessions", type=int, nargs="+",
                    default=[8, 32, 64, 128])
    ap.add_argument("--frames", type=int, default=120,
                    help="timed frames per measurement")
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--refresh-cohorts", type=int, default=1,
                    help="stagger the emotion refresh over N session "
                         "cohorts (uniform step cost instead of a spike "
                         "every 300 ms)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    from koemorph_tpu_torch.device import resolve_device
    from koemorph_tpu_torch.runtime import MultiStreamInference
    from koemorph_tpu_torch.runtime.engine import build_streaming_model

    device = resolve_device("cpu" if args.cpu else "cuda")
    t0 = time.perf_counter()
    model, cfg = build_streaming_model(fps=args.fps, device=device, seed=0)
    print(f"# init {time.perf_counter() - t0:.1f}s on {device.type}",
          file=sys.stderr)

    rows = []
    for s in args.sessions:
        server = MultiStreamInference(model, cfg, n_sessions=s,
                                      device=device,
                                      refresh_cohorts=args.refresh_cohorts)
        t0 = time.perf_counter()
        stats = server.sustained_stats(n_frames=args.frames)
        # every scan sustained_stats ran (warm-ups and the timed one) is
        # taken out, so warm steps are not booked as capture time
        stats["compile_s"] = round(
            time.perf_counter() - t0
            - stats["step_ms"] * args.frames * stats["scans_run"] / 1e3, 1)
        stats = {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in stats.items()}
        rows.append(stats)
        print(json.dumps(stats), flush=True)
        del server

    realtime = [r for r in rows if r["realtime"]]
    if realtime:
        best = max(realtime, key=lambda r: r["sessions"])
        print(json.dumps({
            "summary": "max_realtime_sessions_measured",
            "sessions": best["sessions"],
            "step_ms": best["step_ms"],
            "budget_ms": round(1000 / args.fps, 2),
            "headroom_x": round((1000 / args.fps) / best["step_ms"], 2),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
