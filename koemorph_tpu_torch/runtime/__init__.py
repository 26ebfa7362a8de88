"""Real-time streaming runtime (PyTorch port): one session per engine, or
many sessions in one batched step."""

from koemorph_tpu_torch.runtime.multistream import MultiStreamInference
from koemorph_tpu_torch.runtime.streaming import (StreamingConfig,
                                                  StreamingInference)

__all__ = ["MultiStreamInference", "StreamingConfig", "StreamingInference"]
