"""Host-facing streaming eGeMAPS extractor API.

The reference's ``opensmile_extractor`` module, with OpenSMILE replaced by
:func:`koemorph_tpu_torch.ops.egemaps.egemaps_functionals` on the device
(the ``cycle_dsum`` kernel twice and ``dk_roots`` once per window on the
card): :class:`AudioBuffer`, a thread-safe circular buffer of the 20 s
context plus a margin, read at time offsets;
:class:`EgemapsStreamingExtractor`, the 88 functionals refreshed every
300 ms and cached between, each window peak-normalized and scrubbed of
NaN on the host, with a history and the 3-window concatenation at
offsets 0, 0.3 and 0.6 s; the reference-named
:class:`OpenSMILEeGeMAPSExtractor`; and the factories. The reference built
an untrained ``Linear(264, 256)`` inside its extractor;
:meth:`EgemapsStreamingExtractor.get_concatenated_features` returns the
raw 264-D vector, and the trained projection lives in the model.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.ops.cuda import KernelError
from koemorph_tpu_torch.ops.egemaps import (NUM_FEATURES, EgemapsConfig,
                                            apply_calibration,
                                            egemaps_functionals,
                                            feature_names)

logger = logging.getLogger(__name__)

__all__ = ["AudioBuffer", "EgemapsStreamingExtractor",
           "OpenSMILEeGeMAPSExtractor",
           "create_opensmile_extractor", "create_egemaps_extractor"]


class AudioBuffer:
    """Thread-safe circular audio buffer with time-offset reads."""

    def __init__(self, sample_rate: int = 16000, duration: float = 20.0,
                 margin: float = 2.0):
        self.sample_rate = sample_rate
        self.capacity = int((duration + margin) * sample_rate)
        self.duration = duration
        self._buf = np.zeros(self.capacity, np.float32)
        self._lock = threading.Lock()
        self.total_written = 0

    def append(self, audio_data: np.ndarray) -> None:
        x = np.asarray(audio_data, np.float32).reshape(-1)
        n = min(len(x), self.capacity)
        with self._lock:
            if n:
                self._buf = np.concatenate([self._buf[n:], x[-n:]])
            self.total_written += len(x)

    def get_window(self, duration: Optional[float] = None,
                   time_offset: float = 0.0) -> np.ndarray:
        """The most recent ``duration`` seconds ending ``time_offset``
        seconds ago, oldest sample first."""
        duration = duration if duration is not None else self.duration
        n = int(duration * self.sample_rate)
        off = int(time_offset * self.sample_rate)
        with self._lock:
            end = self.capacity - off
            start = max(0, end - n)
            return self._buf[start:end].copy()

    def get_stats(self) -> Dict[str, int]:
        return {"capacity": self.capacity,
                "total_written": self.total_written,
                "fill": min(self.capacity, self.total_written)}

    def reset(self) -> None:
        with self._lock:
            self._buf[:] = 0.0
            self.total_written = 0


class EgemapsStreamingExtractor:
    """Streaming 88-D eGeMAPS functionals with the 3-window
    concatenation, computed on ``device`` (``cuda`` unless the caller asks
    for another). ``calibrate=True`` maps the features onto the OpenSMILE
    scale by :func:`koemorph_tpu_torch.ops.egemaps.apply_calibration`."""

    def __init__(
        self,
        sample_rate: int = 16000,
        context_window: float = 20.0,
        update_interval: float = 0.3,
        temporal_history_frames: int = 30,
        use_concatenation: bool = True,
        window_intervals: tuple[float, ...] = (0.0, 0.3, 0.6),
        normalize_audio: bool = True,
        calibrate: bool = False,
        device: DeviceLike = None,
    ):
        self.sample_rate = sample_rate
        self.context_window = context_window
        self.update_interval = update_interval
        self.use_concatenation = use_concatenation
        self.window_intervals = tuple(window_intervals)
        self.normalize_audio = normalize_audio
        self.calibrate = calibrate
        self.device = resolve_device(device)
        self.buffer = AudioBuffer(sample_rate, context_window,
                                  max(self.window_intervals) + 2.0)
        self.egemaps_config = EgemapsConfig(sample_rate=sample_rate)
        self._cached: Optional[np.ndarray] = None
        self._cached_concat: Optional[np.ndarray] = None
        self._last_update = -1e9
        self.temporal_history: deque[np.ndarray] = deque(
            maxlen=temporal_history_frames)
        self.extraction_times: deque[float] = deque(maxlen=100)
        self.extractions = 0
        self.failures = 0

    @property
    def feature_dim(self) -> int:
        return (NUM_FEATURES * len(self.window_intervals)
                if self.use_concatenation else NUM_FEATURES)

    def _extract(self, audio: np.ndarray, calibrate: bool = False
                 ) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
            feats = egemaps_functionals(x, self.egemaps_config)
            if calibrate:
                feats = apply_calibration(feats)
            return feats.cpu().numpy()

    def _window_features(self, time_offset: float) -> np.ndarray:
        audio = self.buffer.get_window(self.context_window, time_offset)
        if self.normalize_audio:
            peak = np.abs(audio).max()
            if peak > 1e-8:
                audio = audio / peak * 0.95
        feats = self._extract(audio, self.calibrate)
        return np.nan_to_num(feats, nan=0.0, posinf=0.0, neginf=0.0)

    def process_audio_frame(self, audio_frame: np.ndarray,
                            timestamp: Optional[float] = None
                            ) -> Optional[np.ndarray]:
        """Append audio; return the 88-D vector, refreshed every
        ``update_interval`` seconds (of ``timestamp``, else the host clock)
        and cached between. An extraction that fails on the CPU serves the
        cache and counts in ``failures``; on the card, or when a kernel
        fails to build or launch, it raises."""
        self.buffer.append(audio_frame)
        now = timestamp if timestamp is not None else time.perf_counter()
        if self._cached is not None and \
                now - self._last_update < self.update_interval:
            return self._cached
        try:
            t0 = time.perf_counter()
            feats = self._window_features(0.0)
            if self.use_concatenation:
                self._cached_concat = np.concatenate(
                    [feats] + [self._window_features(off)
                               for off in self.window_intervals[1:]])
            self.extraction_times.append(time.perf_counter() - t0)
            self.extractions += 1
            self._cached = feats
            self.temporal_history.append(feats)
            self._last_update = now
            return feats
        except Exception as exc:
            # on the card a fault poisons the context, so every later
            # extraction would fail the same way behind a stale cache
            if isinstance(exc, KernelError) or self.device.type != "cpu":
                raise
            self.failures += 1
            logger.warning("eGeMAPS extraction failed, reusing the cache",
                           exc_info=True)
            return self._cached

    def process_audio_batch(self, audio: np.ndarray) -> np.ndarray:
        """Whole-utterance path: ``(B, L)`` or ``(L,)`` -> ``(B, 88)``."""
        a = np.asarray(audio, np.float32)
        if a.ndim == 1:
            a = a[None]
        if self.normalize_audio:
            peak = np.abs(a).max(axis=-1, keepdims=True)
            a = np.where(peak > 1e-8, a / np.maximum(peak, 1e-8) * 0.95, a)
        return np.nan_to_num(self._extract(a))

    def get_temporal_features(self) -> Optional[np.ndarray]:
        """``(history, 88)``: the recent extractions stacked."""
        if not self.temporal_history:
            return None
        return np.stack(self.temporal_history)

    def get_concatenated_features(self) -> Optional[np.ndarray]:
        """The raw 3 x 88 = 264-D concatenated vector."""
        return self._cached_concat

    def get_feature_names(self) -> List[str]:
        return list(feature_names())

    def get_stats(self) -> Dict[str, Any]:
        times = np.asarray(self.extraction_times) if self.extraction_times \
            else np.zeros(1)
        return {
            "extractions": self.extractions,
            "failures": self.failures,
            "avg_extraction_ms": float(times.mean() * 1e3),
            "history_len": len(self.temporal_history),
            "buffer": self.buffer.get_stats(),
        }

    def reset(self) -> None:
        self.buffer.reset()
        self._cached = None
        self._cached_concat = None
        self.temporal_history.clear()
        self._last_update = -1e9

    def set_context_window(self, duration: float) -> None:
        self.context_window = duration
        self.buffer = AudioBuffer(self.sample_rate, duration,
                                  max(self.window_intervals) + 2.0)

    def set_update_interval(self, interval: float) -> None:
        self.update_interval = interval


def create_egemaps_extractor(config: Optional[dict] = None
                             ) -> EgemapsStreamingExtractor:
    """:class:`EgemapsStreamingExtractor` from a config dict (the
    reference's keys, and ``device``)."""
    config = config or {}
    return EgemapsStreamingExtractor(
        sample_rate=config.get("sample_rate", 16000),
        context_window=config.get("context_window", 20.0),
        update_interval=config.get("update_interval", 0.3),
        temporal_history_frames=config.get("temporal_history_frames", 30),
        use_concatenation=config.get("use_concatenation", True),
        window_intervals=tuple(config.get("window_intervals",
                                          (0.0, 0.3, 0.6))),
        device=config.get("device"),
    )


#: the reference's name of the factory
create_opensmile_extractor = create_egemaps_extractor


class OpenSMILEeGeMAPSExtractor(EgemapsStreamingExtractor):
    """The reference's constructor surface over the on-device extractor
    (no OpenSMILE binary). ``feature_set`` and ``feature_level`` must name
    what is implemented (eGeMAPSv02 functionals); ``enable_caching`` and
    ``cache_dir`` are accepted and unused (the features are recomputed at
    the update cadence, there is no host cache). ``device`` is where the
    features are computed: ``cuda`` unless the caller asks for another
    (the reference's default was its CPU). The reference's default
    ``use_concatenation=False`` (88-D) is kept."""

    def __init__(
        self,
        sample_rate: int = 16000,
        context_window: float = 20.0,
        update_interval: float = 0.3,
        feature_set: str = "eGeMAPSv02",
        feature_level: str = "Functionals",
        enable_caching: bool = True,
        cache_dir: Optional[str] = None,
        device: DeviceLike = None,
        temporal_history_frames: int = 30,
        use_concatenation: bool = False,
    ):
        if feature_set != "eGeMAPSv02":
            raise ValueError(
                f"unsupported feature_set {feature_set!r}: this framework "
                "implements eGeMAPSv02 (88 functionals)")
        if feature_level != "Functionals":
            raise ValueError(
                f"unsupported feature_level {feature_level!r}: only "
                "'Functionals' is implemented (LLDs are available via "
                "koemorph_tpu_torch.ops.compute_llds)")
        del enable_caching, cache_dir
        super().__init__(
            sample_rate=sample_rate, context_window=context_window,
            update_interval=update_interval,
            temporal_history_frames=temporal_history_frames,
            use_concatenation=use_concatenation, device=device)
