"""Lip-sync learning demo: the sequential dual-stream model learns
audio energy -> jawOpen in a few steps. The counterpart of the JAX
package's ``scripts/demo_lipsync_learning.py``.

Amplitude-modulated voice whose jawOpen target (with the other mouth
channels) tracks the per-frame RMS envelope; the model (d_model 128, a
64-frame window, the ``basic`` emotion backend) trains ``--steps`` eager
steps over a pool of 16 batches, and the prediction/target correlation of
jawOpen on a held-out batch is reported before and after (the reference's
lip-sync metric), with the first and last training loss.

Runs on the GPU (raises without CUDA) unless ``--cpu`` is given. Prints
one JSON line.

Usage: ``python -m koemorph_tpu_torch.demo_lipsync_learning [--cpu]
[--steps 120] [--batch 8]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SPAN, HOP = 96, 533


def make_batch(b: int, seed: int) -> dict:
    """``b`` utterances of ``SPAN`` frames: an enveloped carrier with
    mouth targets driven by its RMS, expressions at a constant."""
    from koemorph_tpu_torch.blendshapes import (EXPRESSION_INDICES,
                                                MOUTH_INDICES)

    r = np.random.default_rng(seed)
    t = np.arange(SPAN * HOP) / 16000
    audio = np.zeros((b, SPAN * HOP), np.float32)
    bs = np.zeros((b, SPAN, 52), np.float32)
    mouth = np.asarray(MOUTH_INDICES)
    expr = np.asarray(EXPRESSION_INDICES)
    for i in range(b):
        rate = 1.5 + 2 * r.random()
        env = 0.5 * (1 + np.sin(2 * np.pi * rate * t + r.random() * 6.28))
        carrier = np.sin(2 * np.pi * (120 + 60 * r.random()) * t)
        audio[i] = (0.5 * env * carrier
                    + 0.01 * r.standard_normal(len(t))).astype(np.float32)
        rms = np.sqrt((audio[i].reshape(SPAN, HOP) ** 2).mean(-1))
        drive = np.clip(rms / (rms.max() + 1e-6), 0, 1)
        # targets within the fusion-reachable range: the stream-weight
        # softmax normalizes across the 52 blendshapes, bounding each near
        # 1/52 scale; dense activation keeps the shared sigmoid head off
        # all-zero targets
        bs[i][:, mouth] = 0.005 + np.outer(drive,
                                           np.full(len(mouth), 0.010))
        bs[i][:, expr] = 0.008
    return {"audio": audio, "blendshapes": bs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--work-dir", default="outputs/lipsync_demo")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the GPU)")
    args = p.parse_args(argv)
    # the port trains in full fp32: cuDNN's convolutions too, which
    # PyTorch runs in TF32 by default (the trainer refuses them)
    torch.backends.cudnn.allow_tf32 = False

    from koemorph_tpu_torch.blendshapes import ARKIT_BLENDSHAPES
    from koemorph_tpu_torch.device import device_label, resolve_device
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel)
    from koemorph_tpu_torch.train.trainer import (SequentialTrainer,
                                                  sequence_targets)

    device = resolve_device("cpu" if args.cpu else None)
    jaw = ARKIT_BLENDSHAPES.index("jawOpen")
    cfg = {
        "optimizer": {"name": "adamw", "lr": 1e-3},
        "lr_scheduler": {"name": "constant"},
        "loss": {"mse_weight": 1.0, "l1_weight": 0.1,
                 "velocity_weight": 0.05},
        "gradient_clip_val": 1.0,
        "logging": {"log_every_n_steps": 10000, "tensorboard": False},
        "checkpoint": {"keep_epoch_every": 10000},
    }
    model = SequentialDualStreamModel(
        d_model=128, num_heads=4, mel_sequence_length=64,
        emotion_backend="basic", use_concatenation=False,
        stride_frames=2, dropout=0.0)
    trainer = SequentialTrainer(
        model, {"training": cfg, "data": {"window_frames": SPAN}},
        work_dir=args.work_dir, steps_per_epoch=args.steps, device=device)

    @torch.no_grad()
    def eval_corr(seed=999):
        batch = make_batch(args.batch, seed)
        trainer.model.eval()
        pred = trainer.model(torch.from_numpy(batch["audio"]).to(device))[
            "blendshapes"].cpu()
        tgt = sequence_targets(torch.from_numpy(batch["blendshapes"]),
                               model.window_frames, model.stride_frames,
                               pred.shape[1])
        return float(np.corrcoef(pred[..., jaw].numpy().ravel(),
                                 tgt[..., jaw].numpy().ravel())[0, 1])

    before = eval_corr()
    # a pool of prepared batches on the device, so the loop is the steps
    pool = [trainer._prepare(make_batch(args.batch, s)) for s in range(16)]
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        losses.append(trainer.train_step(pool[step % len(pool)])["loss"])
    losses = [float(v) for v in losses]       # one sync, after the loop
    train_s = time.perf_counter() - t0
    after = eval_corr()
    print(json.dumps({
        "jaw_corr_before": round(before, 4),
        "jaw_corr_after": round(after, 4),
        "loss_first": losses[0] if losses else float("nan"),
        "loss_last": losses[-1] if losses else float("nan"),
        "steps": args.steps,
        "train_s": round(train_s, 3),
        "device": device_label(device),
        "learned": after > before + 0.3,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
