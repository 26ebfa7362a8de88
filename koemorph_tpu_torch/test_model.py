"""Offline evaluation CLI: a checkpoint and a test split -> one JSON line
of ``BlendshapeMetrics``.

Usage:
    python -m koemorph_tpu_torch.test_model --data-dir data/test \\
        [--model CKPT] [--model-name simplified|simplified_dual_stream|
        sequential_dual_stream] [--device cuda]

The split is read in windows of the model's span (256 frames, 512 at 60
fps; the sequential model's span is 32 frames longer), one batch of
``--batch-size`` windows at a time. ``simplified`` and
``simplified_dual_stream`` predict each window's last frame,
``sequential_dual_stream`` every output frame against its aligned target.
``--model`` loads a checkpoint the trainer wrote (``<work>/checkpoints/
last``) or a ``.pth`` state dict; without it the weights are random, drawn
from ``--seed``. Runs on the GPU (``--device cuda``, the default) and fails
when there is none; ``--device cpu`` runs on the CPU. The last line of
standard output is the metrics (``batches`` among them).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("test_model")


def build_model(args, **fixed_by_state):
    """The model ``--model-name`` names, at the flags' width, for
    evaluation (dropout 0); a dual-stream model takes the keywords
    ``read_model_state`` gives for the checkpoint it will load."""
    from koemorph_tpu_torch.models import (SequentialDualStreamModel,
                                           SimplifiedDualStreamModel,
                                           SimplifiedKoeMorphModel)

    window = 512 if args.fps == 60 else 256
    if args.model_name == "simplified":
        return SimplifiedKoeMorphModel(
            d_model=args.d_model, num_heads=args.num_heads,
            target_fps=args.fps, dropout=0.0), window
    common = dict(d_model=args.d_model, num_heads=args.num_heads,
                  mel_sequence_length=window, target_fps=args.fps,
                  emotion_backend=args.emotion_backend,
                  use_concatenation=args.emotion_backend == "egemaps",
                  dropout=0.0, **fixed_by_state)
    if args.model_name == "simplified_dual_stream":
        return SimplifiedDualStreamModel(**common), window
    return SequentialDualStreamModel(**common, stride_frames=1), window + 32


def predict(model, model_name: str, window: int, batch: dict, device):
    """(predictions, targets) of one batch as ``(N, 52)`` numpy arrays."""
    from koemorph_tpu_torch.train.trainer import sequence_targets

    audio = torch.from_numpy(np.ascontiguousarray(batch["audio"])).to(device)
    with torch.inference_mode():
        out = model(audio)
        if model_name == "simplified":
            return out.cpu().numpy(), batch["blendshapes"][:, -1, :]
        pred = out["blendshapes"].cpu().numpy()
    if model_name == "simplified_dual_stream":
        return pred, batch["blendshapes"][:, -1, :]
    tgt = sequence_targets(torch.from_numpy(batch["blendshapes"]), window,
                           1, pred.shape[1]).numpy()
    b, t, _ = pred.shape
    return pred.reshape(b * t, -1), tgt.reshape(b * t, -1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--model", help="checkpoint directory (with state.pth) "
                   "or .pth state dict; default: random weights")
    p.add_argument("--model-name", default="sequential_dual_stream",
                   choices=["simplified", "simplified_dual_stream",
                            "sequential_dual_stream"])
    p.add_argument("--fps", type=int, default=30, choices=[30, 60])
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--emotion-backend", default="egemaps",
                   choices=["egemaps", "basic"])
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--output", help="write metrics JSON here")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.device import resolve_device
    from koemorph_tpu_torch.models.losses import BlendshapeMetrics
    from koemorph_tpu_torch.utils.params import (load_model_state,
                                                 read_model_state)

    device = resolve_device(args.device)
    sd, fixed_by_state = read_model_state(args.model)
    model, span = build_model(args, **fixed_by_state)
    if args.model:
        load_model_state(model, sd, f"checkpoint {args.model}")
        logger.info("Loaded %s", args.model)
    else:
        model.init_random(torch.Generator().manual_seed(args.seed))
        logger.warning("No --model; evaluating random weights")
    model = model.eval().to(device)
    window = 512 if args.fps == 60 else 256

    loader_fn, _ = create_sequential_dataloader(
        args.data_dir, batch_size=args.batch_size, window_frames=span,
        stride_frames=span, target_fps=float(args.fps), drop_last=True)
    metrics = BlendshapeMetrics()
    n = 0
    for batch in loader_fn():
        pred, target = predict(model, args.model_name, window, batch, device)
        metrics.update(pred, np.asarray(target))
        n += 1
        if args.max_batches and n >= args.max_batches:
            break
    result = {k: float(v) for k, v in metrics.compute().items()}
    result["batches"] = float(n)
    logger.info("metrics: %s", {k: round(v, 5) for k, v in result.items()})
    print(json.dumps(result))
    if args.output:
        Path(args.output).write_text(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
