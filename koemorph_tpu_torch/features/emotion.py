"""The emotion frontend: its configuration and the device-side feature
vector of an utterance (the ``egemaps`` backend)."""

from __future__ import annotations

import dataclasses

import torch

from koemorph_tpu_torch.ops.egemaps import NUM_FEATURES as EGEMAPS_DIM
from koemorph_tpu_torch.ops.egemaps import (EgemapsConfig,
                                            egemaps_concat_windows,
                                            egemaps_functionals)

CONCAT_DIM = EGEMAPS_DIM * 3  # 264: functionals over 3 offset windows


@dataclasses.dataclass(frozen=True)
class EmotionFrontendConfig:
    """Static emotion-frontend configuration; the port has the ``egemaps``
    backend only (``basic`` and ``emotion2vec`` raise)."""

    backend: str = "egemaps"
    use_concatenation: bool = True   # 3-window concatenation (production)
    sample_rate: int = 16000
    window_offsets: tuple[float, ...] = (0.0, 0.3, 0.6)

    def __post_init__(self):
        if self.backend != "egemaps":
            raise NotImplementedError(
                f"emotion backend {self.backend!r} is not ported; only "
                "'egemaps' is")

    @property
    def feature_dim(self) -> int:
        return CONCAT_DIM if self.use_concatenation else EGEMAPS_DIM


def emotion_features(audio: torch.Tensor,
                     cfg: EmotionFrontendConfig = EmotionFrontendConfig(),
                     *, egemaps_cfg: EgemapsConfig | None = None
                     ) -> torch.Tensor:
    """Emotion feature vector ``(..., L) -> (..., D)``: the 3-offset
    concatenated eGeMAPS functionals (264-D), or the 88-D functionals of
    the whole audio without concatenation."""
    ecfg = egemaps_cfg or EgemapsConfig(sample_rate=cfg.sample_rate)
    if cfg.use_concatenation:
        return egemaps_concat_windows(audio, ecfg, cfg.window_offsets)
    return egemaps_functionals(audio, ecfg)
