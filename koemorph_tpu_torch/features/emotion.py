"""The emotion frontend: its configuration, the device-side feature
vector of an utterance (the ``egemaps`` and ``basic`` backends; the
``emotion2vec`` backend's encoder carries trained parameters and runs
through the model), and precomputed emotion2vec features on disk."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Union

import numpy as np
import torch

from koemorph_tpu_torch.features.basic import (BASIC_DIM,
                                               basic_emotion_features)
from koemorph_tpu_torch.ops.egemaps import NUM_FEATURES as EGEMAPS_DIM
from koemorph_tpu_torch.ops.egemaps import (EgemapsConfig,
                                            egemaps_concat_windows,
                                            egemaps_functionals)

CONCAT_DIM = EGEMAPS_DIM * 3  # 264: functionals over 3 offset windows


@dataclasses.dataclass(frozen=True)
class EmotionFrontendConfig:
    """Static emotion-frontend configuration: the ``egemaps``, ``basic``
    and ``emotion2vec`` backends."""

    backend: str = "egemaps"
    use_concatenation: bool = True   # 3-window concatenation (production)
    sample_rate: int = 16000
    window_offsets: tuple[float, ...] = (0.0, 0.3, 0.6)
    # egemaps backend: False selects the frame-level jitter and shimmer
    # (EgemapsConfig.per_period_voice_quality)
    egemaps_per_period: bool = True

    def __post_init__(self):
        if self.backend not in ("egemaps", "basic", "emotion2vec"):
            raise ValueError(f"Unknown emotion backend: {self.backend}")

    @property
    def feature_dim(self) -> int:
        if self.backend == "emotion2vec":
            return 1024
        if self.backend == "basic":
            return BASIC_DIM
        return CONCAT_DIM if self.use_concatenation else EGEMAPS_DIM


def emotion_features(audio: torch.Tensor,
                     cfg: EmotionFrontendConfig = EmotionFrontendConfig(),
                     *, egemaps_cfg: EgemapsConfig | None = None
                     ) -> torch.Tensor:
    """Emotion feature vector ``(..., L) -> (..., D)``: the 3-offset
    concatenated eGeMAPS functionals (264-D), the 88-D functionals of the
    whole audio without concatenation, or the 9-D ``basic`` features.
    The ``emotion2vec`` backend has trained parameters: it raises here and
    runs through the model's encoder."""
    if cfg.backend == "basic":
        return basic_emotion_features(audio, cfg.sample_rate)
    if cfg.backend == "emotion2vec":
        raise ValueError(
            f"Backend {cfg.backend!r} has trained parameters; call it "
            "through the model, not this function")
    ecfg = egemaps_cfg or EgemapsConfig(
        sample_rate=cfg.sample_rate,
        per_period_voice_quality=cfg.egemaps_per_period)
    if cfg.use_concatenation:
        return egemaps_concat_windows(audio, ecfg, cfg.window_offsets)
    return egemaps_functionals(audio, ecfg)


class PrecomputedEmotionFeatures:
    """1024-D emotion2vec features computed offline and stored as ``.npy``
    files ``<dir>/<audio_hash>.npy``, keyed by
    :meth:`~koemorph_tpu_torch.features.emotion2vec.Emotion2VecCache.
    compute_audio_hash` of the float32 audio; each file is ``(1024,)`` (an
    utterance) or ``(T, 1024)`` (a sequence, mean-pooled at lookup)."""

    def __init__(self, directory: Union[str, Path]):
        self.directory = Path(directory)
        if not self.directory.is_dir():
            raise FileNotFoundError(
                f"precomputed emotion feature dir missing: {directory}")

    @staticmethod
    def save(directory: Union[str, Path], audio: np.ndarray,
             features: np.ndarray) -> Path:
        """Record the features of an utterance; returns the file."""
        from koemorph_tpu_torch.features.emotion2vec import Emotion2VecCache

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        key = Emotion2VecCache.compute_audio_hash(
            np.asarray(audio, np.float32))
        path = directory / f"{key}.npy"
        np.save(path, np.asarray(features, np.float32))
        return path

    def lookup(self, audio: np.ndarray) -> np.ndarray:
        """The ``(1024,)`` features of ``audio``; ``KeyError`` when none
        were recorded."""
        from koemorph_tpu_torch.features.emotion2vec import Emotion2VecCache

        key = Emotion2VecCache.compute_audio_hash(
            np.asarray(audio, np.float32))
        path = self.directory / f"{key}.npy"
        if not path.exists():
            raise KeyError(f"no precomputed emotion features for {key}")
        feats = np.load(path)
        if feats.ndim == 2:
            feats = feats.mean(axis=0)
        return feats.astype(np.float32)
