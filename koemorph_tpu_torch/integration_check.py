"""End-to-end integration check: speech-like audio through the flagship
stream, the emotion extractor's fallback matrix, and the emotion backends'
latency, reported as one JSON object ending in ``"ok"``. The counterpart
of the JAX package's ``scripts/integration_check.py`` (the reference's
``test_realtime_dual_stream.py``, ``test_emotion_processing.py`` and
``test_egemaps_comparison.py`` in one command).

Runs on the GPU (raises without CUDA) unless ``--cpu`` is given. The
stream is the flagship model (d_model 256, 8 heads, 80 mels, a 256-frame
window, 3-window eGeMAPS) with random weights from seed 0.

Usage::

    python -m koemorph_tpu_torch.integration_check [--cpu] [--seconds 4]
        [--plot out/]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("integration")


def synth_speech(seconds: float, sr: int = 16000, seed: int = 0
                 ) -> np.ndarray:
    """Speech-like audio: an F0 glide with harmonics, a syllable-rate
    envelope and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = (np.sin(phase) + 0.4 * np.sin(2 * phase)
              + 0.2 * np.sin(3 * phase))
    am = 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t))          # syllable rate
    noise = 0.05 * rng.standard_normal(len(t))
    return (0.35 * voiced * am + noise).astype(np.float32)


def check_streaming(audio: np.ndarray, device: torch.device,
                    fps: int = 30) -> dict:
    from koemorph_tpu_torch.runtime.engine import build_streaming_model
    from koemorph_tpu_torch.runtime.streaming import StreamingInference

    model, cfg = build_streaming_model(fps=fps, device=device, seed=0)
    eng = StreamingInference(model, cfg, device=device)
    eng.warmup()
    frames = eng.process_audio(audio)
    stats = eng.performance_stats()
    arr = np.stack(frames)
    return {
        "frames": len(frames),
        "rtf": round(stats["rtf"], 5),
        "avg_frame_ms": round(stats["avg_frame_time_ms"], 3),
        "output_in_range": bool(arr.min() >= 0 and arr.max() <= 1),
        "output_varies": bool(arr.std() > 1e-6),
        "realtime_ok": stats["rtf"] < 1.0,
    }


def check_fallback_matrix(audio: np.ndarray, device: torch.device) -> dict:
    from koemorph_tpu_torch.features.emotion import EmotionExtractor

    results = {}
    for backend in ("emotion2vec", "egemaps", "basic"):
        ex = EmotionExtractor(backend=backend, enable_caching=False,
                              device=device)
        out = ex.extract_features(audio)
        emb = out["embeddings"]
        results[backend] = {
            "resolved_backend": out["metadata"]["backend_used"],
            "dim": int(emb.shape[-1]),
            "finite": bool(np.isfinite(emb).all()),
            "blendshapes_valid": bool(
                (out["blendshape_weights"] >= 0).all()
                and (out["blendshape_weights"] <= 1).all()),
        }
    # emotion2vec without weights must demote to egemaps
    results["fallback_demotion_ok"] = \
        results["emotion2vec"]["resolved_backend"] != "emotion2vec"
    return results


def check_backend_perf(audio: np.ndarray, device: torch.device,
                       plot_dir: str | None) -> dict:
    """ms per extraction of each backend's features, after a warm-up
    (host clock around 10 calls, synchronized on the card)."""
    from koemorph_tpu_torch.features.basic import basic_emotion_features
    from koemorph_tpu_torch.ops.egemaps import (EgemapsConfig,
                                                egemaps_functionals)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    a = torch.from_numpy(audio).to(device)
    timings = {}
    for name, fn in (
            ("egemaps", lambda x: egemaps_functionals(x, EgemapsConfig())),
            ("basic", basic_emotion_features)):
        with torch.no_grad():
            fn(a)
            sync()
            t0 = time.perf_counter()
            for _ in range(10):
                fn(a)
            sync()
        timings[name] = round((time.perf_counter() - t0) / 10 * 1e3, 3)

    if plot_dir:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            logger.warning("matplotlib unavailable; skipping the plot")
        else:
            fig, ax = plt.subplots(figsize=(5, 3))
            ax.bar(list(timings), list(timings.values()))
            ax.set_ylabel("ms / extraction")
            ax.set_title("emotion backend latency")
            Path(plot_dir).mkdir(parents=True, exist_ok=True)
            out_png = Path(plot_dir) / "egemaps_performance_comparison.png"
            fig.tight_layout()
            fig.savefig(out_png, dpi=100)
            plt.close(fig)
            timings["plot"] = str(out_png)
    return timings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--fps", type=int, default=30, choices=(30, 60))
    p.add_argument("--plot", default=None, help="directory for PNGs")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the GPU)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from koemorph_tpu_torch.device import device_label, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    audio = synth_speech(args.seconds)
    report = {
        "device": device_label(device),
        "streaming": check_streaming(audio, device, args.fps),
        "fallback_matrix": check_fallback_matrix(audio[:32000], device),
        "backend_perf_ms": check_backend_perf(audio[:32000], device,
                                              args.plot),
    }
    ok = (report["streaming"]["output_in_range"]
          and report["streaming"]["output_varies"]
          and report["fallback_matrix"]["fallback_demotion_ok"])
    report["ok"] = ok
    print(json.dumps(report, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
