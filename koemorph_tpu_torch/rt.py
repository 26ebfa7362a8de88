"""Real-time streaming inference CLI: WAV file -> blendshape stream.

Usage:
    python -m koemorph_tpu_torch.rt --input speech.wav --output file \\
        --output-file frames.jsonl --no-realtime --max-frames 300
    python -m koemorph_tpu_torch.rt --mic --output udp
    python -m koemorph_tpu_torch.rt --list-devices

Runs on the GPU (``--device cuda``, the default) and fails when there is
none; ``--device cpu`` runs the same step on the CPU. ``--model`` loads a
checkpoint the trainer wrote (``<work>/checkpoints/last``) or a ``.pth``
state dict; without it the weights are random, drawn from ``--seed``.
``--mic`` streams from a microphone through the optional ``pyaudio``
(without it the run fails naming it); ``--list-devices`` prints the input
devices, one per line (none without ``pyaudio``), and exits.
"""

from __future__ import annotations

import argparse
import logging
import sys

logger = logging.getLogger("rt")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--input", help="WAV file to stream (omit for --mic)")
    p.add_argument("--mic", action="store_true",
                   help="capture the microphone (needs pyaudio)")
    p.add_argument("--model", help="checkpoint directory (with state.pth) "
                   "or .pth state dict; default: random weights")
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
    p.add_argument("--list-devices", action="store_true",
                   help="list audio input devices and exit")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from koemorph_tpu_torch.runtime.audio import (AudioFileReader,
                                                  MicCapture,
                                                  list_audio_devices)
    from koemorph_tpu_torch.runtime.engine import (build_streaming_model,
                                                   run_realtime_loop)
    from koemorph_tpu_torch.runtime.streamers import BlendshapeStreamer
    from koemorph_tpu_torch.runtime.streaming import StreamingInference

    if args.list_devices:
        for d in list_audio_devices():
            print(d)
        return 0
    if not (args.mic or args.input):
        p.error("--input or --mic required")

    model, cfg = build_streaming_model(
        d_model=args.d_model, num_heads=args.num_heads, fps=args.fps,
        emotion_backend=args.emotion_backend, sample_rate=args.sample_rate,
        checkpoint=args.model, device=args.device, seed=args.seed)
    engine = StreamingInference(model, cfg, device=args.device)
    if args.mic:
        source = MicCapture(args.sample_rate, cfg.hop_length)
    else:
        source = AudioFileReader(args.input, args.sample_rate,
                                 cfg.hop_length,
                                 realtime=not args.no_realtime)
        source.start()
    streamer = None
    if args.output != "none":
        streamer = BlendshapeStreamer(
            args.output, host=args.host, port=args.port,
            osc_address=args.osc_address,
            output_file=args.output_file if args.output == "file" else None)
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
