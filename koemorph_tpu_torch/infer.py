"""Offline file inference CLI: mono WAV -> blendshape JSONL.

Usage:
    python -m koemorph_tpu_torch.infer --input speech.wav \\
        --output frames.jsonl [--model CKPT] [--fps 30|60] \\
        [--stride-frames N] [--decode-mode parallel|chunked|scan] \\
        [--d-model 256] [--num-heads 8] [--emotion-backend egemaps|basic] \\
        [--seed 0] [--device cuda]

Full-utterance decoding with
:class:`~koemorph_tpu_torch.models.dual_stream_model.SequentialDualStreamModel`
at flagship width (256-frame window, 512 at 60 fps). Line ``i`` of the
output is window ``i``, stamped at the window's last frame,
``(window - 1 + i * stride) / fps`` seconds. ``--model`` loads a checkpoint
(a directory the trainer wrote, such as ``<work>/checkpoints/last``, or a
``.pth`` state dict in the reference's names); without it the weights are
random, drawn from ``--seed``. Runs on the GPU (``--device cuda``, the
default) and fails when there is none; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("infer")


def load_audio(path: str, sample_rate: int, window: int, hop: int
               ) -> np.ndarray:
    """A mono WAV resampled to ``sample_rate``, padded to at least
    ``window + 1`` hops and cut to whole hops. Raises ``ValueError`` on a
    file with more than one channel."""
    from koemorph_tpu_torch.data.wav import read_wav, resample_linear

    audio, sr = read_wav(path)
    if audio.ndim != 1:
        raise ValueError(f"{path}: {audio.shape[1]} channels; the decoder "
                         "takes mono audio")
    if sr != sample_rate:
        audio = resample_linear(audio, sr, sample_rate)
    min_len = (window + 1) * hop
    if len(audio) < min_len:
        audio = np.pad(audio, (0, min_len - len(audio)))
    usable = (len(audio) // hop) * hop
    return np.asarray(audio[:usable], np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input", required=True, help="mono WAV file")
    p.add_argument("--output", default="blendshapes.jsonl")
    p.add_argument("--model", help="checkpoint directory (with state.pth) "
                   "or .pth state dict; default: random weights")
    p.add_argument("--fps", type=int, default=30, choices=[30, 60])
    p.add_argument("--stride-frames", type=int, default=1)
    p.add_argument("--decode-mode", default="parallel",
                   choices=["parallel", "chunked", "scan"],
                   help="'scan' is an alias for 'chunked'")
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--emotion-backend", default="egemaps",
                   choices=["egemaps", "basic"])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from koemorph_tpu_torch.device import resolve_device
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel)
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    from koemorph_tpu_torch.utils.params import (load_model_state,
                                                 read_model_state)

    device = resolve_device(args.device)
    window = 512 if args.fps == 60 else 256
    sd, fixed_by_state = read_model_state(args.model)
    model = SequentialDualStreamModel(
        d_model=args.d_model, num_heads=args.num_heads,
        mel_sequence_length=window, target_fps=args.fps,
        emotion_backend=args.emotion_backend,
        use_concatenation=args.emotion_backend == "egemaps",
        stride_frames=args.stride_frames, decode_mode=args.decode_mode,
        dropout=0.0, **fixed_by_state)
    if args.model:
        load_model_state(model, sd, f"checkpoint {args.model}")
        logger.info("Loaded %s", args.model)
    else:
        model.init_random(torch.Generator().manual_seed(args.seed))
        logger.warning("No checkpoint given; decoding with random weights")
    decoder = BatchedSequentialDecoder(model, device)

    audio = load_audio(args.input, model.sample_rate, window,
                       model.hop_length)
    audio_s = len(audio) / model.sample_rate
    times = []
    # the first call builds the kernels and caches (and on the card
    # captures the decode's CUDA graph); the second replays it
    for _ in range(2):
        t0 = time.perf_counter()
        seq = decoder(audio[None])[0].cpu().numpy()      # (T_out, 52)
        times.append(time.perf_counter() - t0)
    logger.info("decoded %d frames from %.2f s audio on %s: first call "
                "%.3f s, then %.3f s (RTF %.5f excluding the first call)",
                seq.shape[0], audio_s, device, times[0], times[1],
                times[1] / audio_s)

    with open(args.output, "w") as f:
        for i, frame in enumerate(seq):
            t = (window - 1 + i * args.stride_frames) / args.fps
            f.write(json.dumps({
                "timestamp": round(t, 6),
                "blendshapes": frame.round(6).tolist()}) + "\n")
    logger.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
