"""Real-time mel-only inference CLI: a 1 s audio window ->
``SimplifiedKoeMorphModel`` -> one blendshape frame per hop.

Usage:
    python -m koemorph_tpu_torch.rt_simplified --input speech.wav \\
        --output file --output-file frames.jsonl --no-realtime

The 1 s window rolls on the host, one hop of audio per frame, and is
copied into a static input buffer on the device; the frame step (the
model's forward, its log-mel in the fused ``logmel`` kernel) is one CUDA
graph replay on the card. ``--no-graphs`` runs the same step eagerly, with
the same result bit for bit. The log line at the end gives the frames,
the average and the largest frame time and the real-time factor. Runs on
the GPU (``--device cuda``, the default) and fails when there is none;
``--device cpu`` runs the step on the CPU. ``--model`` loads a checkpoint
the trainer wrote for ``model.name: simplified``
(``<work>/checkpoints/last``) or a ``.pth`` state dict; without it the
weights are random, drawn from ``--seed``. ``--mic`` streams from a
microphone through the optional ``pyaudio`` (without it the run fails
naming it).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Optional

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.runtime.audio import EOS
from koemorph_tpu_torch.runtime.graphs import StepGraphs

logger = logging.getLogger("rt_simplified")

__all__ = ["FrameStep", "build_model", "run_stream", "main"]


def build_model(*, d_model: int = 256, num_heads: int = 8, fps: int = 30,
                checkpoint: Optional[str] = None, device: DeviceLike = None,
                seed: int = 0):
    """The simplified model for serving (dropout 0) on ``device``, with a
    checkpoint's weights or random ones drawn from ``seed``."""
    from koemorph_tpu_torch.models.simplified import SimplifiedKoeMorphModel
    from koemorph_tpu_torch.utils.params import (load_model_state,
                                                 read_state_dict)

    dev = resolve_device(device)
    model = SimplifiedKoeMorphModel(d_model=d_model, num_heads=num_heads,
                                    target_fps=fps, dropout=0.0)
    if checkpoint:
        load_model_state(model, read_state_dict(checkpoint),
                         f"checkpoint {checkpoint}")
        logger.info("Loaded checkpoint %s", checkpoint)
    else:
        model.init_random(torch.Generator().manual_seed(seed))
        logger.warning("No --model given; using randomly initialized weights")
    return model.eval().to(dev)


class FrameStep:
    """One frame of the real-time loop: ``step(window)`` copies the host's
    ``(window,)`` float32 audio into the static input buffer and returns
    the model's ``(52,)`` blendshapes as numpy. On the card the forward
    is one CUDA graph (captured by :meth:`warmup` or at the first step),
    unless ``graphs=False``; the CPU runs it eagerly."""

    def __init__(self, model, window: int, device: DeviceLike = None,
                 graphs: Optional[bool] = None):
        self.model = model
        self.device = resolve_device(device)
        self.window = window
        self.audio = torch.zeros((1, window), device=self.device)
        self.step_graphs = StepGraphs(self.device, graphs)

    def _body(self) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(self.audio)[0]

    def warmup(self) -> None:
        """Capture the step's graph (on the card) after a warm-up run;
        eager steps run once to build the kernels and constants."""
        if not self.step_graphs.enabled:
            self._body()
        elif "frame" not in self.step_graphs:
            self.step_graphs.capture("frame", self._body, warm=self._body)

    def __call__(self, window: np.ndarray) -> np.ndarray:
        self.audio.copy_(torch.from_numpy(
            np.ascontiguousarray(window, np.float32))[None])
        if self.step_graphs.enabled and "frame" not in self.step_graphs:
            self.warmup()
        return self.step_graphs.run("frame", self._body).cpu().numpy()


def run_stream(step: FrameStep, source, streamer=None, *, fps: int = 30,
               max_frames: Optional[int] = None,
               max_idle_reads: int = 10) -> dict:
    """Roll the 1 s window over ``source``'s hops and step it per hop
    until the source ends or ``max_frames``; each frame goes to
    ``streamer``. Returns ``frames``, ``avg_frame_ms``, ``max_frame_ms``,
    ``rtf`` (the average frame time over ``1 / fps``) and the frames
    themselves (``blendshapes``)."""
    step.warmup()
    buf = np.zeros(step.window, np.float32)
    times, out = [], []
    idle = 0
    while max_frames is None or len(out) < max_frames:
        chunk = source.read()
        if chunk is EOS:
            break
        if chunk is None:           # a transient stall
            idle += 1
            if idle >= max_idle_reads:
                logger.warning("source idle; stopping")
                break
            continue
        idle = 0
        t0 = time.perf_counter()
        buf = np.concatenate([buf[len(chunk):], chunk])
        bs = step(buf)
        times.append(time.perf_counter() - t0)
        if streamer is not None:
            streamer.send(bs, time.time())
        out.append(bs)
    t = np.asarray(times) if times else np.zeros(1)
    return {"frames": len(out), "avg_frame_ms": float(t.mean() * 1e3),
            "max_frame_ms": float(t.max() * 1e3),
            "rtf": float(t.mean() * fps),
            "blendshapes": np.stack(out) if out else np.zeros((0, 52))}


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
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--no-realtime", action="store_true",
                   help="process the file as fast as possible")
    p.add_argument("--no-graphs", action="store_true",
                   help="run the frame step eagerly on the card")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from koemorph_tpu_torch.runtime.audio import AudioFileReader, MicCapture
    from koemorph_tpu_torch.runtime.streamers import BlendshapeStreamer

    if not (args.mic or args.input):
        p.error("--input or --mic required")
    model = build_model(d_model=args.d_model, num_heads=args.num_heads,
                        fps=args.fps, checkpoint=args.model,
                        device=args.device, seed=args.seed)
    # the 1 s window of the reference's real-time script
    step = FrameStep(model, args.sample_rate, args.device,
                     graphs=False if args.no_graphs else None)
    step.warmup()
    logger.info("Frame step ready (%s); starting stream",
                "CUDA graph" if step.step_graphs.enabled else "eager")
    hop = int(args.sample_rate / args.fps)
    if args.mic:
        source = MicCapture(args.sample_rate, hop)
    else:
        source = AudioFileReader(args.input, args.sample_rate, hop,
                                 realtime=not args.no_realtime)
        source.start()
    streamer = None
    if args.output != "none":
        streamer = BlendshapeStreamer(
            args.output, host=args.host, port=args.port,
            osc_address=args.osc_address,
            output_file=args.output_file if args.output == "file" else None)
    try:
        stats = run_stream(step, source, streamer, fps=args.fps,
                           max_frames=args.max_frames)
    finally:
        source.stop()
        if streamer is not None:
            streamer.close()
    if stats["frames"]:
        logger.info("frames=%d avg=%.2fms max=%.2fms RTF=%.4f",
                    stats["frames"], stats["avg_frame_ms"],
                    stats["max_frame_ms"], stats["rtf"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
