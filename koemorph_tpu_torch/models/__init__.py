"""Model layer: the dual-stream models, the legacy KoeMorph family, losses
and metrics, under the JAX package's names."""

from koemorph_tpu_torch.models.attention import (BlendshapeQueryEmbedding,
                                                 MultiHeadCrossAttention,
                                                 MultiStreamAudioEncoder,
                                                 PositionalEncoding,
                                                 TransformerEncoderLayer,
                                                 create_attention_mask)
from koemorph_tpu_torch.models.decoder import (BlendshapeConstraints,
                                               BlendshapeDecoder,
                                               ConstraintState,
                                               SmootherState,
                                               TemporalSmoother,
                                               validate_blendshape_output)
from koemorph_tpu_torch.models.dual_stream import (DualStreamCrossAttention,
                                                   DualStreamEncoder)
from koemorph_tpu_torch.models.dual_stream_model import (
    SequentialDualStreamModel, SimplifiedDualStreamModel, TemporalState)
from koemorph_tpu_torch.models.legacy import (KoeMorphModel,
                                              KoeMorphModelState,
                                              create_koemorph_model)
from koemorph_tpu_torch.models.losses import (BlendshapeMetrics,
                                              KoeMorphLoss,
                                              KoeMorphLossConfig,
                                              LandmarkConsistencyLoss,
                                              PerceptualBlendshapeLoss,
                                              compute_lip_sync_metrics,
                                              dual_stream_loss,
                                              koemorph_loss,
                                              sequence_koemorph_loss)
from koemorph_tpu_torch.models.simplified import SimplifiedKoeMorphModel

__all__ = [
    "BlendshapeQueryEmbedding", "MultiHeadCrossAttention",
    "MultiStreamAudioEncoder", "PositionalEncoding",
    "TransformerEncoderLayer", "create_attention_mask",
    "BlendshapeConstraints", "BlendshapeDecoder", "ConstraintState",
    "SmootherState", "TemporalSmoother", "validate_blendshape_output",
    "DualStreamCrossAttention", "DualStreamEncoder",
    "SequentialDualStreamModel", "SimplifiedDualStreamModel",
    "TemporalState",
    "KoeMorphModel", "KoeMorphModelState", "create_koemorph_model",
    "BlendshapeMetrics", "KoeMorphLoss", "KoeMorphLossConfig",
    "LandmarkConsistencyLoss", "PerceptualBlendshapeLoss",
    "compute_lip_sync_metrics",
    "dual_stream_loss", "koemorph_loss", "sequence_koemorph_loss",
    "SimplifiedKoeMorphModel",
]
