"""The streaming model's parameters and its EMA smoothing carry."""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from koemorph_tpu_torch.models.dual_stream import DualStreamCrossAttention


@dataclasses.dataclass
class TemporalState:
    """EMA smoothing carry."""

    prev: torch.Tensor         # (B, 52)
    initialized: torch.Tensor  # (B,) bool, False until a frame has passed

    @classmethod
    def create(cls, batch_size: int, num_blendshapes: int = 52,
               device=None) -> "TemporalState":
        return cls(prev=torch.zeros((batch_size, num_blendshapes),
                                    device=device),
                   initialized=torch.zeros((batch_size,), dtype=torch.bool,
                                           device=device))


def _ema_step(blendshapes: torch.Tensor, state: TemporalState,
              alpha: torch.Tensor) -> tuple[torch.Tensor, TemporalState]:
    """One EMA step; the first frame passes through unsmoothed."""
    smoothed = alpha * blendshapes + (1 - alpha) * state.prev
    smoothed = torch.where(state.initialized[:, None], smoothed, blendshapes)
    return smoothed, TemporalState(prev=smoothed.detach(),
                                   initialized=torch.ones_like(
                                       state.initialized))


class StreamingDualStreamModel(nn.Module):
    """What the streaming step reads of a trained model: the raw-emotion
    projection (e.g. 264 -> d_model), the dual-stream attention, and the
    learnable EMA coefficient ``sigmoid(smoothing_alpha)``. Its state dict
    is what :func:`koemorph_tpu_torch.utils.params.state_dict_from_flax`
    makes of a ``SimplifiedDualStreamModel`` parameter tree."""

    def __init__(self, *, d_model: int = 256, num_heads: int = 8,
                 window_frames: int = 256, n_mels: int = 80,
                 num_blendshapes: int = 52, emotion_raw_dim: int = 264,
                 use_learnable_weights: bool = True,
                 temperature: float = 1.0):
        super().__init__()
        self.emotion_projection = nn.Linear(emotion_raw_dim, d_model)
        self.dual_stream_attention = DualStreamCrossAttention(
            d_model=d_model, num_heads=num_heads, num_mel_channels=n_mels,
            mel_sequence_length=window_frames, mel_temporal_frames=3,
            emotion_dim=d_model, dropout=0.0,
            num_blendshapes=num_blendshapes,
            use_learnable_weights=use_learnable_weights,
            temperature=temperature)
        self.smoothing_alpha = nn.Parameter(torch.tensor(0.8))

    def forward(self, mel: torch.Tensor, detail: torch.Tensor,
                emotion_raw: torch.Tensor) -> torch.Tensor:
        """(B, W, n_mels), (B, 3, n_mels), (B, D_raw) -> (B, 52) unsmoothed
        blendshapes."""
        emotion = self.emotion_projection(emotion_raw)
        return self.dual_stream_attention(mel, detail, emotion)["blendshapes"]

    def alpha(self) -> torch.Tensor:
        return torch.sigmoid(self.smoothing_alpha)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights with the Flax initializers' distributions: LeCun
        truncated normal for dense kernels, N(0, 0.02) for the learned
        queries, Xavier uniform for the packed in-projections, zero biases,
        unit norms, stream weights 2.0 / 0.5 toward their own stream, and
        ``smoothing_alpha`` 0.8. Drawn on the CPU from ``generator``."""
        def trunc_normal(shape, std):
            # inverse CDF of a normal truncated at +/- 2 std
            lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
            u = lo + (1.0 - 2.0 * lo) * torch.rand(shape,
                                                   generator=generator)
            return torch.special.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0)
                                                          * std)

        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                fan_in = mod.in_features
                # Flax's lecun_normal: unit variance after truncation
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                mod.weight.copy_(trunc_normal(mod.weight.shape, std))
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        att = self.dual_stream_attention
        for q in (att.mouth_queries, att.expression_queries):
            q.copy_(0.02 * torch.randn(q.shape, generator=generator))
        for mha in (att.mel_attention, att.emotion_attention):
            w = mha.in_proj_weight
            limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
            w.copy_((2.0 * torch.rand(w.shape, generator=generator) - 1.0)
                    * limit)
            mha.in_proj_bias.zero_()
        self.smoothing_alpha.fill_(0.8)
