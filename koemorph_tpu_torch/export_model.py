"""Export CLI: a checkpoint's frame function -> a ``torch.export``
program (``.pt2``) with a parity gate.

Usage:
    python -m koemorph_tpu_torch.export_model [--model CKPT] \\
        [--output exports] [--format pt2] [--fps 30|60] [--d-model 256] \\
        [--num-heads 8] [--emotion-backend egemaps|basic] [--benchmark] \\
        [--device cuda]

The exported function is one frame of
:class:`~koemorph_tpu_torch.models.dual_stream_model.
SimplifiedDualStreamModel` at flagship width (256-frame window, 512 at 60
fps): ``(audio (1, window * hop), prev (1, 52), initialized (1,) bool) ->
(blendshapes, prev, initialized)``, the EMA carry an explicit input and
output, so the program is the whole model, smoothing included. It holds
the ``cycle_dsum``, ``dk_roots`` and ``logmel`` kernels as the custom
operators of :mod:`koemorph_tpu_torch.ops.library`. ``--model`` takes a
checkpoint directory the trainer wrote, a ``.pth`` of the port, or a
reference ``.pth`` (imported through
:mod:`koemorph_tpu_torch.utils.torch_import`); without it the weights are
random, drawn from seed 0. The artifact, ``<output>/model.pt2``, is
loaded back and held within 1e-5 of the live model on a seeded input;
``--benchmark`` times the program and the live model in the same process
(CUDA events on the card), in rounds that alternate which goes first, and
reports each side's median and every round. Prints the reports as JSON;
exits 1 when the gate fails. Runs on the GPU (``--device cuda``, the
default) and fails when there is none; ``--device cpu`` exports for the
CPU.

Reload: ``koemorph_tpu_torch.export.load_program(path).module()(audio,
prev, initialized)`` on the device the program was exported on.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("export")

#: formats of the JAX package's exporter (TensorFlow's) that have no
#: counterpart here
_TF_FORMATS = ("saved_model", "tflite", "all")
#: ``--benchmark``'s rounds of 20 calls of each side (the exported
#: program and the live model), alternating which goes first
BENCHMARK_ROUNDS = 6


def build_frame_function(args, device: torch.device):
    """The :class:`~koemorph_tpu_torch.export.FrameFunction` of the model
    ``args`` describes, on ``device``, in eval mode."""
    from koemorph_tpu_torch.export import FrameFunction
    from koemorph_tpu_torch.models.dual_stream_model import (
        SimplifiedDualStreamModel)
    from koemorph_tpu_torch.utils.params import (load_model_state,
                                                 read_model_state)
    from koemorph_tpu_torch.utils.torch_import import (
        model_state_from_reference)

    sd, fixed_by_state = read_model_state(args.model)
    model = SimplifiedDualStreamModel(
        d_model=args.d_model, num_heads=args.num_heads,
        mel_sequence_length=512 if args.fps == 60 else 256,
        target_fps=args.fps, emotion_backend=args.emotion_backend,
        use_concatenation=args.emotion_backend == "egemaps",
        dropout=0.0, **fixed_by_state)
    model.init_random(torch.Generator().manual_seed(0))
    if sd is not None:
        if "emotion_projection.weight" not in sd:
            # a reference checkpoint: its attention and smoothing, the
            # initialized projection (the reference's was untrained)
            sd = model_state_from_reference(sd, model)
        load_model_state(model, sd, f"checkpoint {args.model}")
        logger.info("Loaded %s", args.model)
    else:
        logger.warning("No --model; exporting randomly initialized weights")
    return FrameFunction(model.eval().to(device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", help="checkpoint directory (with state.pth) "
                   "or .pth state dict, the port's or the reference's; "
                   "default: random weights")
    p.add_argument("--output", default="exports",
                   help="directory of model.pt2")
    p.add_argument("--format", default="pt2",
                   help="pt2 (torch.export); the JAX exporter's "
                        "saved_model and tflite are TensorFlow formats and "
                        "are refused")
    p.add_argument("--quantize", default=None,
                   help="refused: TFLite's dynamic-range int8 and float16 "
                        "modes have no torch counterpart in this image, "
                        "so the exporter writes float32 programs only")
    p.add_argument("--fps", type=int, default=30, choices=[30, 60])
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--emotion-backend", default="egemaps",
                   choices=["egemaps", "basic"])
    p.add_argument("--benchmark", action="store_true",
                   help="time the program and the live model, in "
                        "alternating rounds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.format in _TF_FORMATS:
        p.error(f"--format {args.format} is the JAX exporter's (TensorFlow "
                "SavedModel / TFLite); this exporter writes pt2 "
                "(torch.export)")
    if args.format != "pt2":
        p.error(f"unknown --format {args.format!r}: the format is pt2")
    if args.quantize is not None:
        p.error("--quantize is not available: TFLite's quantization modes "
                "have no torch counterpart in this image; export pt2 "
                "without it")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from koemorph_tpu_torch.device import device_label, resolve_device
    from koemorph_tpu_torch.export import (benchmark_rounds, export_program,
                                           load_program)

    device = resolve_device(args.device)
    frame = build_frame_function(args, device)
    model = frame.model
    length = model.mel_sequence_length * model.hop_length
    rng = np.random.default_rng(0)
    example = (
        torch.from_numpy((0.1 * rng.standard_normal((1, length)))
                         .astype(np.float32)).to(device),
        torch.zeros((1, 52), device=device),
        torch.zeros((1,), dtype=torch.bool, device=device))
    out_dir = Path(args.output)
    report = export_program(frame, example, out_dir / "model.pt2")
    if args.benchmark:
        rounds = benchmark_rounds(
            {"exported": load_program(report.path).module(), "live": frame},
            example, rounds=BENCHMARK_ROUNDS, warmup=5, iters=20)
        report.latency_ms = float(np.median(rounds["exported"]))
        report.live_latency_ms = float(np.median(rounds["live"]))
        report.latency_rounds_ms = rounds
        report.device = device_label(device)
        logger.info("frame latency on %s, median of %d rounds: exported "
                    "%.3f ms, live %.3f ms", report.device, BENCHMARK_ROUNDS,
                    report.latency_ms, report.live_latency_ms)
    print(json.dumps([report.as_dict()], indent=2))
    return 0 if report.passed else 1


if __name__ == "__main__":
    sys.exit(main())
