"""Host-facing sliding-window mel extractor API.

The reference's ``mel_sliding_window`` module: :class:`MelAudioBuffer`, a
thread-safe circular buffer of the 8.5 s mel context written one hop at a
time; :class:`MelSlidingWindowExtractor`, which recomputes the whole
window's mel at most once per 30% of the frame interval and serves the
cached window in between, with its statistics; and
:func:`create_mel_extractor`. The audio ring stays on the host in numpy;
each recompute is :func:`koemorph_tpu_torch.ops.frontend.
mel_with_temporal_detail` with the librosa style, the fused ``logmel``
kernel on the card. The production real-time path is
:mod:`koemorph_tpu_torch.runtime.streaming`, which keeps the ring and the
mel rows on the device.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.ops.cuda import KernelError
from koemorph_tpu_torch.ops.frontend import (LogMelFrontend,
                                             mel_with_temporal_detail)

logger = logging.getLogger(__name__)

__all__ = ["MelAudioBuffer", "MelSlidingWindowExtractor",
           "create_mel_extractor"]


class MelAudioBuffer:
    """Thread-safe circular audio buffer holding the mel context window."""

    def __init__(self, sample_rate: int = 16000, window_duration: float = 8.5,
                 frame_hop: int = 533):
        self.sample_rate = sample_rate
        self.window_samples = int(window_duration * sample_rate)
        self.frame_hop = frame_hop
        self._buf = np.zeros(self.window_samples, np.float32)
        self._lock = threading.Lock()
        self.total_written = 0
        self.frames_written = 0
        self.size_warnings = 0

    def add_audio_frame(self, audio_frame: np.ndarray) -> bool:
        """Append about one hop of samples; a write shorter than the hop
        by more than one sample is counted in ``size_warnings``, and a
        longer one advances the window further."""
        frame = np.asarray(audio_frame, np.float32).reshape(-1)
        if len(frame) < self.frame_hop - 1:
            self.size_warnings += 1
            logger.debug("unexpected frame size %d (hop %d)",
                         len(frame), self.frame_hop)
        n = min(len(frame), self.window_samples)
        with self._lock:
            if n:
                self._buf = np.concatenate([self._buf[n:], frame[-n:]])
            self.total_written += len(frame)
            self.frames_written += 1
        return True

    def get_current_audio(self) -> Optional[np.ndarray]:
        """The window, oldest sample first; ``None`` before any write."""
        with self._lock:
            if self.total_written == 0:
                return None
            return self._buf.copy()

    def get_stats(self) -> Dict[str, Any]:
        return {
            "window_samples": self.window_samples,
            "total_written": self.total_written,
            "frames_written": self.frames_written,
            "size_warnings": self.size_warnings,
            "fill_ratio": min(1.0, self.total_written
                              / self.window_samples),
        }

    def reset(self) -> None:
        with self._lock:
            self._buf[:] = 0.0
            self.total_written = 0
            self.frames_written = 0


class MelSlidingWindowExtractor:
    """Per-frame ``(window_frames, n_mels)`` mel windows, recomputed at
    most once per ``update_ratio`` of the frame interval, on ``device``
    (``cuda`` unless the caller asks for another)."""

    def __init__(
        self,
        sample_rate: int = 16000,
        target_fps: float = 30.0,
        window_frames: int = 256,
        n_mels: int = 80,
        n_fft: int = 1024,
        update_ratio: float = 0.3,
        device: DeviceLike = None,
    ):
        self.sample_rate = sample_rate
        self.target_fps = target_fps
        self.window_frames = window_frames
        self.n_mels = n_mels
        self.frame_hop = int(sample_rate / target_fps)
        self.device = resolve_device(device)
        self.buffer = MelAudioBuffer(
            sample_rate, window_frames * self.frame_hop / sample_rate,
            self.frame_hop)
        self.update_interval = update_ratio / target_fps
        self.frontend = LogMelFrontend(
            sample_rate=sample_rate, target_fps=target_fps, n_fft=n_fft,
            n_mels=n_mels, f_min=80.0, f_max=8000.0, style="librosa")
        self._cached: Optional[np.ndarray] = None
        self._cached_detail: Optional[np.ndarray] = None
        self._last_update = 0.0
        self.extraction_times: deque[float] = deque(maxlen=100)
        self.cache_hits = 0
        self.extractions = 0
        self.failures = 0

    @property
    def feature_dim(self) -> int:
        return self.n_mels

    def _compute(self, audio: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
            mel, detail = mel_with_temporal_detail(x, self.frontend)
            return mel.cpu().numpy(), detail.cpu().numpy()

    def process_audio_frame(self, audio_frame: np.ndarray
                            ) -> Optional[np.ndarray]:
        """Add one hop of audio; return the ``(window_frames, n_mels)``
        window, the cached one between throttled updates. An extraction
        that fails on the CPU serves the cache and counts in ``failures``;
        on the card, or when a kernel fails to build or launch, it
        raises."""
        self.buffer.add_audio_frame(audio_frame)
        now = time.perf_counter()
        if (self._cached is not None
                and now - self._last_update < self.update_interval):
            self.cache_hits += 1
            return self._cached
        audio = self.buffer.get_current_audio()
        if audio is None:
            return self._cached
        try:
            t0 = time.perf_counter()
            mel, detail = self._compute(audio)
            # pad or trim to the fixed window
            if mel.shape[0] < self.window_frames:
                mel = np.pad(mel,
                             ((self.window_frames - mel.shape[0], 0), (0, 0)))
            else:
                mel = mel[-self.window_frames:]
            self.extraction_times.append(time.perf_counter() - t0)
            self.extractions += 1
            self._cached = mel
            self._cached_detail = detail
            self._last_update = now
            return mel
        except Exception as exc:
            # on the card a fault poisons the context, so every later
            # extraction would fail the same way behind a stale cache
            if isinstance(exc, KernelError) or self.device.type != "cpu":
                raise
            self.failures += 1
            logger.warning("mel extraction failed, reusing the cache",
                           exc_info=True)
            return self._cached

    def process_audio_batch(self, audio: np.ndarray) -> np.ndarray:
        """Whole-utterance path: ``(B, L)`` or ``(L,)`` -> ``(B, T,
        n_mels)``."""
        a = np.asarray(audio, np.float32)
        if a.ndim == 1:
            a = a[None]
        return self._compute(a)[0]

    def get_current_features(self) -> Optional[np.ndarray]:
        return self._cached

    def get_temporal_detail(self) -> Optional[np.ndarray]:
        """The last 3 frames of the last extraction (the detail tensor)."""
        return self._cached_detail

    def reset(self) -> None:
        self.buffer.reset()
        self._cached = None
        self._cached_detail = None
        self._last_update = 0.0

    def get_stats(self) -> Dict[str, Any]:
        times = np.asarray(self.extraction_times) if self.extraction_times \
            else np.zeros(1)
        return {
            "extractions": self.extractions,
            "cache_hits": self.cache_hits,
            "failures": self.failures,
            "avg_extraction_ms": float(times.mean() * 1e3),
            "max_extraction_ms": float(times.max() * 1e3),
            "buffer": self.buffer.get_stats(),
        }


def create_mel_extractor(config: Optional[dict] = None
                         ) -> MelSlidingWindowExtractor:
    """:class:`MelSlidingWindowExtractor` from a config dict (the
    reference's keys, ``mel_sequence_length`` for ``window_frames``, and
    ``device``)."""
    config = config or {}
    return MelSlidingWindowExtractor(
        sample_rate=config.get("sample_rate", 16000),
        target_fps=config.get("target_fps", 30.0),
        window_frames=config.get("window_frames",
                                 config.get("mel_sequence_length", 256)),
        n_mels=config.get("n_mels", 80),
        n_fft=config.get("n_fft", 1024),
        device=config.get("device"),
    )
