"""Synchronized ARKit blendshape (JSONL) + audio (WAV) loading, on the
host in numpy: 52-coefficient validation, [0, 1]-range warning,
monotonic-timestamp warning, audio/blendshape duration-drift gate, fps
detection and resampling. The counterpart of ``koemorph_tpu.data.io``:
the loader reads through the native parsers (``data/native.py``) and
leaves a file they decline to the strict Python readers.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Union

import numpy as np

from koemorph_tpu_torch.data.wav import read_wav

PathLike = Union[str, Path]


class ARKitDataLoader:
    """Loader for synchronized ARKit blendshape and audio data."""

    def __init__(
        self,
        sample_rate: int = 16000,
        target_fps: float = 30.0,
        max_time_drift: float = 1.0,
    ):
        self.sample_rate = sample_rate
        self.target_fps = target_fps
        self.max_time_drift = max_time_drift

    def load_sample(self, jsonl_path: PathLike,
                    wav_path: PathLike) -> dict[str, np.ndarray]:
        """Load one synchronized sample.

        Returns dict with ``wav`` (L,) float32 and ``arkit`` (T, 52) float32.
        Raises FileNotFoundError / ValueError mirroring the reference
        semantics (src/data/io.py:44-96).
        """
        jsonl_path, wav_path = Path(jsonl_path), Path(wav_path)
        if not jsonl_path.exists():
            raise FileNotFoundError(f"ARKit file not found: {jsonl_path}")
        if not wav_path.exists():
            raise FileNotFoundError(f"Audio file not found: {wav_path}")

        audio, audio_sr = read_wav(wav_path, mono=True)
        if audio_sr != self.sample_rate:
            warnings.warn(
                f"Audio sample rate {audio_sr} != target {self.sample_rate}. "
                "Consider resampling for best results."
            )

        blendshapes = self._load_blendshapes(jsonl_path)

        audio_duration = len(audio) / audio_sr
        bs_duration = len(blendshapes) / self.target_fps
        drift = abs(audio_duration - bs_duration)
        if drift > self.max_time_drift:
            raise ValueError(
                f"Time drift {drift:.3f}s exceeds threshold "
                f"{self.max_time_drift}s. Audio: {audio_duration:.3f}s, "
                f"Blendshapes: {bs_duration:.3f}s"
            )
        return {"wav": audio.astype(np.float32),
                "arkit": blendshapes.astype(np.float32)}

    def _load_blendshapes(self, jsonl_path: Path) -> np.ndarray:
        """The ``(T, 52)`` rows through the native parser; a file it
        declines (any irregular line) goes through
        :func:`load_blendshapes_python`, which raises its errors."""
        from koemorph_tpu_torch.data.native import (
            parse_blendshape_jsonl_native)

        parsed = parse_blendshape_jsonl_native(
            Path(jsonl_path).read_bytes(), n_coeffs=52)
        if parsed is None:
            return load_blendshapes_python(jsonl_path)
        arr, ts = parsed
        if not np.all((arr >= 0) & (arr <= 1)):
            warnings.warn("Blendshape values outside [0,1] range")
        if len(ts) > 1 and not np.all(np.diff(ts) > 0):
            warnings.warn("Non-monotonic timestamps detected")
        return arr

    def load_batch(self, file_pairs) -> list[dict[str, np.ndarray]]:
        samples = []
        for jsonl_path, wav_path in file_pairs:
            try:
                samples.append(self.load_sample(jsonl_path, wav_path))
            except (FileNotFoundError, ValueError) as e:
                warnings.warn(f"Failed to load {jsonl_path}, {wav_path}: {e}")
        return samples


def load_blendshapes_python(jsonl_path: PathLike) -> np.ndarray:
    """The strict pure-Python JSONL reader: ``(T, 52)`` float32 rows;
    ``ValueError`` naming the line on invalid JSON, a missing field or
    another count, a warning per line outside [0, 1] and one for
    non-monotonic timestamps."""
    blendshapes: list[np.ndarray] = []
    timestamps: list[float] = []
    with open(jsonl_path) as f:
        for line_no, line in enumerate(f, 1):
            try:
                data = json.loads(line.strip())
            except json.JSONDecodeError as e:
                raise ValueError(f"Invalid JSON at line {line_no}: {e}")
            if "timestamp" not in data:
                raise ValueError(
                    f"Missing 'timestamp' field at line {line_no}")
            if "blendshapes" not in data:
                raise ValueError(
                    f"Missing 'blendshapes' field at line {line_no}")
            values = data["blendshapes"]
            if len(values) != 52:
                raise ValueError(
                    f"Expected 52 blendshapes, got {len(values)} at "
                    f"line {line_no}")
            arr = np.asarray(values, dtype=np.float32)
            if not np.all((arr >= 0) & (arr <= 1)):
                warnings.warn(
                    f"Blendshape values outside [0,1] range at "
                    f"line {line_no}")
            timestamps.append(data["timestamp"])
            blendshapes.append(arr)
    if not blendshapes:
        raise ValueError("No blendshape data found in file")
    stacked = np.stack(blendshapes, axis=0)
    ts = np.asarray(timestamps)
    if len(ts) > 1 and not np.all(np.diff(ts) > 0):
        warnings.warn("Non-monotonic timestamps detected")
    return stacked


def detect_fps(timestamps: np.ndarray) -> float:
    """Detect source frame rate from JSONL timestamps, snapping to 30/60
    (reference src/data/sequential_dataset.py:122-133)."""
    if len(timestamps) < 2:
        return 30.0
    avg_delta = float(np.mean(np.diff(timestamps)))
    if avg_delta <= 0:
        return 30.0
    fps = 1.0 / avg_delta
    if abs(fps - 30) < 2:
        return 30.0
    if abs(fps - 60) < 2:
        return 60.0
    return fps


def load_blendshapes_with_fps(jsonl_path: PathLike) -> tuple[np.ndarray, float]:
    """Lenient JSONL load + fps detection for the sequential datasets
    (reference src/data/sequential_dataset.py:108-134)."""
    blendshapes, timestamps = [], []
    with open(jsonl_path) as f:
        for line in f:
            data = json.loads(line.strip())
            blendshapes.append(data["blendshapes"])
            if "timestamp" in data:
                timestamps.append(data["timestamp"])
    arr = np.asarray(blendshapes, dtype=np.float32)
    return arr, detect_fps(np.asarray(timestamps))


def resample_blendshapes(blendshapes: np.ndarray, source_fps: float,
                         target_fps: float) -> np.ndarray:
    """Linear-interpolation 30<->60 fps blendshape resampling
    (reference src/data/sequential_dataset.py:136-154)."""
    if abs(source_fps - target_fps) < 0.1:
        return blendshapes
    ratio = target_fps / source_fps
    source_len = len(blendshapes)
    target_len = int(source_len * ratio)
    idx = np.linspace(0, source_len - 1, target_len)
    out = np.empty((target_len, blendshapes.shape[1]), dtype=np.float32)
    base = np.arange(source_len)
    for i in range(blendshapes.shape[1]):
        out[:, i] = np.interp(idx, base, blendshapes[:, i])
    return out


def validate_data_consistency(samples, tolerance: float = 0.05) -> dict:
    """Cross-sample consistency checks
    (reference src/data/io.py:180-218)."""
    if not samples:
        return {"valid": False, "reason": "No samples provided"}
    results: dict = {"valid": True, "issues": []}
    if not all(s["arkit"].shape[1] == 52 for s in samples):
        results["valid"] = False
        results["issues"].append("Inconsistent blendshape dimensions")
    for i, s in enumerate(samples):
        audio_duration = len(s["wav"]) / 16000
        bs_duration = len(s["arkit"]) / 30.0
        rel = abs(audio_duration - bs_duration) / max(audio_duration,
                                                      bs_duration)
        if rel > tolerance:
            results["valid"] = False
            results["issues"].append(
                f"Sample {i}: duration mismatch {rel:.3f} > {tolerance}")
    return results
