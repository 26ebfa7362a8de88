"""Convert a checkpoint of the reference PyTorch repository (``.pth``) into
a port checkpoint directory.

The reference's trained ``SimplifiedDualStreamModel`` /
``SequentialDualStreamModel`` files (a trainer checkpoint with
``model_state_dict``, or a bare state dict) become usable by ``rt``,
``infer``, ``serve``, ``test_model`` and ``train --resume``. The model is
built at the flags' architecture with weights drawn from seed 0, the
reference's attention and ``smoothing_alpha`` replace its own (the emotion
projection keeps its initialization), and the result is loaded into the
model on ``--device`` before it is written.

Usage::

    python -m koemorph_tpu_torch.import_torch_checkpoint best_model.pth \\
        --output checkpoints/imported --d-model 256 [--fixed-fusion]
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("pth", help="reference .pth checkpoint")
    p.add_argument("--output", required=True,
                   help="port checkpoint directory to write")
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--mel-sequence-length", type=int, default=256)
    p.add_argument("--fps", type=int, default=30, choices=[30, 60])
    p.add_argument("--emotion-backend", default="egemaps",
                   choices=["egemaps", "basic"])
    p.add_argument("--fixed-fusion", action="store_true",
                   help="the checkpoint was trained with fixed (hard "
                        "mouth/expression) stream fusion instead of "
                        "learnable weights")
    p.add_argument("--device", default=None,
                   help="device the imported model is loaded on (default "
                        "cuda; raises without CUDA; 'cpu' for the CPU)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from koemorph_tpu_torch.device import resolve_device
    from koemorph_tpu_torch.models.dual_stream_model import (
        SimplifiedDualStreamModel)
    from koemorph_tpu_torch.utils.torch_import import import_torch_checkpoint

    device = resolve_device(args.device)
    model = SimplifiedDualStreamModel(
        d_model=args.d_model, num_heads=args.num_heads,
        mel_sequence_length=args.mel_sequence_length,
        emotion_backend=args.emotion_backend, use_concatenation=True,
        target_fps=args.fps, dropout=0.0,
        use_learnable_weights=not args.fixed_fusion)
    model.init_random(torch.Generator().manual_seed(0))
    print(import_torch_checkpoint(args.pth, model.to(device), args.output))
    return 0


if __name__ == "__main__":
    sys.exit(main())
