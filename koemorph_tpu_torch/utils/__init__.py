"""Cross-cutting utilities: config composition, observability."""

from koemorph_tpu_torch.utils.config import (Config, apply_overrides,
                                             load_config, to_dict)
from koemorph_tpu_torch.utils.emotion_monitor import (
    EmotionProcessingMonitor,
    get_monitor,
    initialize_monitor,
)

__all__ = [
    "Config", "load_config", "apply_overrides", "to_dict",
    "EmotionProcessingMonitor", "get_monitor", "initialize_monitor",
]
