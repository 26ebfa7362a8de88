"""The flagship streaming recipe and the paced real-time loop."""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.runtime.audio import EOS
from koemorph_tpu_torch.runtime.streamers import BlendshapeStreamer
from koemorph_tpu_torch.runtime.streaming import (StreamingConfig,
                                                  StreamingInference,
                                                  model_for_config)

logger = logging.getLogger(__name__)

__all__ = ["build_streaming_model", "run_realtime_loop"]


def build_streaming_model(
    *,
    d_model: int = 256,
    num_heads: int = 8,
    fps: int = 30,
    emotion_backend: str = "egemaps",
    sample_rate: int = 16000,
    checkpoint: Optional[str] = None,
    device: DeviceLike = None,
    seed: int = 0,
):
    """The flagship streaming model and its config: 256-frame window (512
    at 60 fps), 80 mels, 3-window eGeMAPS (264-D), 20 s emotion ring, a
    refresh every 0.3 s. Weights are random, drawn from ``seed`` with an
    explicit ``torch.Generator``. Returns ``(model, cfg)`` with the model
    on ``device`` (``cuda`` by default; raises when CUDA is absent)."""
    dev = resolve_device(device)
    if checkpoint:
        raise NotImplementedError("checkpoint loading is not ported")
    cfg = StreamingConfig(
        sample_rate=sample_rate, target_fps=fps,
        window_frames=512 if fps == 60 else 256,
        d_model=d_model, num_heads=num_heads,
        emotion_backend=emotion_backend,
        use_concatenation=emotion_backend == "egemaps",
        emotion_update_frames=max(1, int(0.3 * fps)))
    model = model_for_config(cfg)
    model.init_random(torch.Generator().manual_seed(seed))
    logger.warning("No checkpoint given; using randomly initialized weights")
    return model.to(dev), cfg


def run_realtime_loop(
    engine: StreamingInference,
    source,
    streamer: Optional[BlendshapeStreamer] = None,
    *,
    max_frames: Optional[int] = None,
    on_frame: Optional[Callable[[np.ndarray, float], None]] = None,
    log_every: int = 150,
    max_idle_reads: int = 10,
) -> dict:
    """Drain ``source`` (which paces delivery) through ``engine`` until it
    ends or ``max_frames``; returns the perf stats. A ``None`` read is a
    transient stall, retried up to ``max_idle_reads`` times; end of stream
    is the ``EOS`` sentinel. ``on_frame(blendshapes, t)`` runs per frame
    after the streamer send, with the wall-clock time."""
    engine.warmup()
    frames = 0
    idle_reads = 0
    done = False
    t_start = time.perf_counter()
    while not done:
        chunk = source.read()
        if chunk is EOS:
            break
        if chunk is None:
            idle_reads += 1
            if idle_reads >= max_idle_reads:
                logger.warning("source idle for %d reads; stopping",
                               idle_reads)
                break
            continue
        idle_reads = 0
        for bs in engine.process_audio(chunk):
            now = time.time()
            if streamer is not None:
                streamer.send(bs, now)
            if on_frame is not None:
                on_frame(bs, now)
            frames += 1
            if log_every and frames % log_every == 0:
                stats = engine.performance_stats()
                logger.info("frame %d: avg %.2f ms, max %.2f ms, RTF %.4f",
                            frames, stats["avg_frame_time_ms"],
                            stats["max_frame_time_ms"], stats["rtf"])
            if max_frames is not None and frames >= max_frames:
                done = True
                break
    stats = engine.performance_stats()
    stats["wall_s"] = time.perf_counter() - t_start
    return stats
