"""The emotion frontend: its configuration and the device-side feature
vector of an utterance (the ``egemaps`` and ``basic`` backends)."""

from __future__ import annotations

import dataclasses

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
    """Static emotion-frontend configuration; the port has the ``egemaps``
    and ``basic`` backends (``emotion2vec`` raises)."""

    backend: str = "egemaps"
    use_concatenation: bool = True   # 3-window concatenation (production)
    sample_rate: int = 16000
    window_offsets: tuple[float, ...] = (0.0, 0.3, 0.6)

    def __post_init__(self):
        if self.backend not in ("egemaps", "basic"):
            raise NotImplementedError(
                f"emotion backend {self.backend!r} is not ported; only "
                "'egemaps' and 'basic' are")

    @property
    def feature_dim(self) -> int:
        if self.backend == "basic":
            return BASIC_DIM
        return CONCAT_DIM if self.use_concatenation else EGEMAPS_DIM


def emotion_features(audio: torch.Tensor,
                     cfg: EmotionFrontendConfig = EmotionFrontendConfig(),
                     *, egemaps_cfg: EgemapsConfig | None = None
                     ) -> torch.Tensor:
    """Emotion feature vector ``(..., L) -> (..., D)``: the 3-offset
    concatenated eGeMAPS functionals (264-D), the 88-D functionals of the
    whole audio without concatenation, or the 9-D ``basic`` features."""
    if cfg.backend == "basic":
        return basic_emotion_features(audio, cfg.sample_rate)
    ecfg = egemaps_cfg or EgemapsConfig(sample_rate=cfg.sample_rate)
    if cfg.use_concatenation:
        return egemaps_concat_windows(audio, ecfg, cfg.window_offsets)
    return egemaps_functionals(audio, ecfg)
