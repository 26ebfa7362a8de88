"""The eGeMAPS emotion frontend's configuration and feature vector."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.egemaps import NUM_FEATURES as EGEMAPS_DIM
from perfbench.reference.egemaps import (EgemapsConfig,
                                         egemaps_concat_windows,
                                         egemaps_functionals)

CONCAT_DIM = EGEMAPS_DIM * 3  # 264: functionals over 3 offset windows


@dataclasses.dataclass(frozen=True)
class EmotionFrontendConfig:
    """The ``egemaps`` backend's static configuration."""

    backend: str = "egemaps"
    use_concatenation: bool = True
    sample_rate: int = 16000
    window_offsets: tuple[float, ...] = (0.0, 0.3, 0.6)
    egemaps_per_period: bool = True

    def __post_init__(self):
        if self.backend != "egemaps":
            raise ValueError(f"the reference has the egemaps backend only, "
                             f"got {self.backend!r}")

    @property
    def feature_dim(self) -> int:
        return CONCAT_DIM if self.use_concatenation else EGEMAPS_DIM


def emotion_features(audio: torch.Tensor,
                     cfg: EmotionFrontendConfig = EmotionFrontendConfig()
                     ) -> torch.Tensor:
    """``(..., L) -> (..., D)``: the 3-offset concatenated eGeMAPS
    functionals (264-D), or the 88-D functionals of the whole audio."""
    ecfg = EgemapsConfig(sample_rate=cfg.sample_rate,
                         per_period_voice_quality=cfg.egemaps_per_period)
    if cfg.use_concatenation:
        return egemaps_concat_windows(audio, ecfg, cfg.window_offsets)
    return egemaps_functionals(audio, ecfg)
