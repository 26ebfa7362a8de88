"""Training throughput of the production sequential trainer on one card:
the counterpart of the JAX package's ``scripts/profile_training.py``.

Times the compiled train step (``SequentialTrainer.compiled_step``: the
forward over all windows, the gradients and the AdamW update, one CUDA
graph replay on the card) of the flagship model (d_model 256, eGeMAPS
with the 3-window concatenation, window 256, stride 4, dropout 0.1) at
several batch sizes, ``--steps`` replays back to back between CUDA events
with the round trip subtracted (``utils.profiling.scan_timed``). Reported
per batch size:

* ``ms_per_step``: one optimizer step (B spans of ``span_frames``);
* ``windows_per_s``: attention windows trained per second;
* ``audio_s_per_s``: seconds of training audio consumed per second;
* ``compile_s``: the first step, the graph's capture included.

Usage::

    python -m koemorph_tpu_torch.profile_training [--batches 4 8 16]
        [--span 288] [--steps 8] [--cpu]

Runs on the GPU (raises without CUDA) unless ``--cpu`` is given; prints
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time
from tempfile import TemporaryDirectory

import numpy as np
import torch


def profile_batch(trainer, batch_size: int, span_frames: int, hop: int,
                  rtt: float, n_steps: int = 8, reps: int = 3) -> dict:
    from koemorph_tpu_torch.utils.profiling import fetch_scalar, scan_timed

    rng = np.random.default_rng(0)
    dev = trainer.device
    batch = {
        "audio": torch.from_numpy(
            rng.standard_normal((batch_size, span_frames * hop)).astype(
                np.float32) * 0.1).to(dev),
        "blendshapes": torch.from_numpy(
            rng.random((batch_size, span_frames, 52)).astype(np.float32)
            * 0.2).to(dev),
        "sample_mask": torch.ones((batch_size,), device=dev),
    }
    t0 = time.perf_counter()
    fetch_scalar(trainer.compiled_step(batch)["loss"])
    compile_s = time.perf_counter() - t0
    ms, _ = scan_timed(lambda: trainer.compiled_step(batch)["loss"],
                       rtt=rtt, iters=n_steps, reps=reps, device=dev)
    step_s = ms / 1e3
    model = trainer.model
    n_out = (span_frames - model.window_frames) // model.stride_frames + 1
    return {
        "batch": batch_size,
        "ms_per_step": round(ms, 3),
        "windows_per_s": round(batch_size * n_out / step_s, 1),
        "audio_s_per_s": round(
            batch_size * span_frames / model.target_fps / step_s, 1),
        "compile_s": round(compile_s, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--span", type=int, default=288,
                    help="frames per training sample (window 256 + 32)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    from koemorph_tpu_torch.device import resolve_device
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel)
    from koemorph_tpu_torch.train.trainer import SequentialTrainer
    from koemorph_tpu_torch.utils.profiling import measure_rtt

    device = resolve_device("cpu" if args.cpu else "cuda")
    # the trainer runs in full fp32: cuDNN's TF32 off, as the train CLI
    torch.backends.cudnn.allow_tf32 = False
    model = SequentialDualStreamModel(
        d_model=256, num_heads=8, mel_sequence_length=256,
        emotion_backend="egemaps", use_concatenation=True,
        target_fps=30, dropout=0.1, stride_frames=4)
    hop = int(model.sample_rate / model.target_fps)

    rtt = measure_rtt(device)
    with TemporaryDirectory() as tmp:
        tcfg = {"training": {
            "optimizer": {"name": "adamw", "lr": 5e-4},
            "loss": {"mse_weight": 1.0, "l1_weight": 0.3,
                     "velocity_weight": 0.1},
            "logging": {"log_every_n_steps": 0,
                        "log_images_every_n_steps": 0,
                        "tensorboard": False},
        }}
        trainer = SequentialTrainer(model, tcfg, work_dir=tmp,
                                    span_frames=args.span, device=device)
        results = []
        for b in args.batches:
            results.append(profile_batch(trainer, b, args.span, hop, rtt,
                                         n_steps=args.steps))
            trainer.drop_graphs()
    print(json.dumps({"rtt_ms": round(rtt * 1e3, 3),
                      "span_frames": args.span,
                      "stride_frames": model.stride_frames,
                      "device": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                      "results": results}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
