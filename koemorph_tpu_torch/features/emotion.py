"""Emotion-frontend configuration read by the streaming runtime."""

from __future__ import annotations

import dataclasses

from koemorph_tpu_torch.ops.egemaps import NUM_FEATURES as EGEMAPS_DIM

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
