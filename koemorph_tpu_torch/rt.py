"""Real-time streaming inference CLI: WAV file -> blendshape stream.

Usage:
    python -m koemorph_tpu_torch.rt --input speech.wav --output file \\
        --output-file frames.jsonl --no-realtime --max-frames 300

Runs on the GPU (``--device cuda``, the default) and fails when there is
none; ``--device cpu`` runs the same step on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys

logger = logging.getLogger("rt")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input", required=True, help="WAV file to stream")
    p.add_argument("--model", help="checkpoint (not supported yet)")
    p.add_argument("--output", default="file",
                   choices=["udp", "osc", "file", "none"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9001)
    p.add_argument("--osc-address", default="/blendshapes")
    p.add_argument("--output-file", default="blendshapes.jsonl")
    p.add_argument("--fps", type=int, default=30, choices=[30, 60])
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--emotion-backend", default="egemaps",
                   choices=["egemaps", "basic"])
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--no-realtime", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from koemorph_tpu_torch.runtime.audio import AudioFileReader
    from koemorph_tpu_torch.runtime.engine import (build_streaming_model,
                                                   run_realtime_loop)
    from koemorph_tpu_torch.runtime.streamers import BlendshapeStreamer
    from koemorph_tpu_torch.runtime.streaming import StreamingInference

    model, cfg = build_streaming_model(
        d_model=args.d_model, num_heads=args.num_heads, fps=args.fps,
        emotion_backend=args.emotion_backend, sample_rate=args.sample_rate,
        checkpoint=args.model, device=args.device, seed=args.seed)
    engine = StreamingInference(model, cfg, device=args.device)
    source = AudioFileReader(args.input, args.sample_rate, cfg.hop_length,
                             realtime=not args.no_realtime)
    streamer = None
    if args.output != "none":
        streamer = BlendshapeStreamer(
            args.output, host=args.host, port=args.port,
            osc_address=args.osc_address,
            output_file=args.output_file if args.output == "file" else None)
    source.start()
    try:
        stats = run_realtime_loop(engine, source, streamer,
                                  max_frames=args.max_frames)
    finally:
        source.stop()
        if streamer is not None:
            streamer.close()
    logger.info("done: %s", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
