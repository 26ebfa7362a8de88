"""Dual-stream cross-attention decoder.

Two attention streams over one set of 52 learned ARKit queries:

- mel stream (mouth): the 80 mel channels are the tokens; each channel's
  long context plus a 3-frame detail is encoded per channel
  (259 -> d_model) and 28 mouth queries attend over those 80 tokens;
- emotion stream (expression): one compressed eGeMAPS token, attended by
  24 expression queries.

A shared sigmoid head decodes both; learnable per-blendshape stream weights
fuse them. The stream-weight softmax normalizes ACROSS the 52 blendshapes,
so ``final = (softmax(w_mel) + softmax(w_emo)) / 2 * sigmoid(head)``, a
quirk of the reference model kept so trained weights mean the same.
Parameter names follow the reference PyTorch module, so its state dicts
map one to one (``blendshape_decoder.0`` / ``.3`` are the head's layers).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from koemorph_tpu_torch.blendshapes import (EXPRESSION_INDICES,
                                            MOUTH_INDICES, NUM_BLENDSHAPES)
from koemorph_tpu_torch.models.attention import TorchStyleMHA
from koemorph_tpu_torch.models.dropout import Dropout

#: Flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


def _stream_weights(mouth_val: float, expr_val: float, n: int
                    ) -> torch.Tensor:
    w = torch.ones(n)
    w[list(MOUTH_INDICES)] = mouth_val
    w[list(EXPRESSION_INDICES)] = expr_val
    return w


class DualStreamCrossAttention(nn.Module):

    def __init__(self, d_model: int = 256, num_heads: int = 8,
                 num_mel_channels: int = 80, mel_sequence_length: int = 256,
                 mel_temporal_frames: int = 3, emotion_dim: int = 256,
                 dropout: float = 0.0,
                 num_blendshapes: int = NUM_BLENDSHAPES,
                 use_learnable_weights: bool = True,
                 temperature: float = 1.0):
        super().__init__()
        self.mel_sequence_length = mel_sequence_length
        self.num_blendshapes = num_blendshapes
        self.temperature = temperature
        n_mouth, n_expr = len(MOUTH_INDICES), len(EXPRESSION_INDICES)
        self.mel_channel_encoder = nn.Linear(
            mel_sequence_length + mel_temporal_frames, d_model)
        self.mel_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.emotion_encoder = nn.Linear(emotion_dim, d_model)
        self.emotion_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mouth_queries = nn.Parameter(torch.zeros(n_mouth, d_model))
        self.expression_queries = nn.Parameter(torch.zeros(n_expr, d_model))
        self.mel_attention = TorchStyleMHA(d_model, num_heads, dropout)
        self.emotion_attention = TorchStyleMHA(d_model, num_heads, dropout)
        self.mel_output_proj = nn.Linear(d_model, d_model)
        self.emotion_output_proj = nn.Linear(d_model, d_model)
        self.blendshape_decoder = nn.Sequential(
            nn.Linear(d_model, d_model // 2), nn.ReLU(), Dropout(dropout),
            nn.Linear(d_model // 2, 1))
        if use_learnable_weights:
            self.mel_weights = nn.Parameter(
                _stream_weights(2.0, 0.5, num_blendshapes))
            self.emotion_weights = nn.Parameter(
                _stream_weights(0.5, 2.0, num_blendshapes))
        else:   # fixed binary masks
            self.register_buffer("mel_weights",
                                 _stream_weights(1.0, 0.0, num_blendshapes),
                                 persistent=False)
            self.register_buffer("emotion_weights",
                                 _stream_weights(0.0, 1.0, num_blendshapes),
                                 persistent=False)
        self.register_buffer("_mouth_idx", torch.tensor(MOUTH_INDICES),
                             persistent=False)
        self.register_buffer("_expr_idx", torch.tensor(EXPRESSION_INDICES),
                             persistent=False)

    def _head(self, x: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        hidden, relu, dropout, out = self.blendshape_decoder
        return torch.sigmoid(out(dropout(relu(hidden(x)), generator))
                             ).squeeze(-1)

    def forward(self, mel_features: torch.Tensor,
                mel_temporal_features: torch.Tensor,
                emotion_features: torch.Tensor,
                return_attention: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> dict[str, torch.Tensor]:
        """``mel_features (B, T, 80)``, ``mel_temporal_features (B, 3, 80)``,
        ``emotion_features (Be, emotion_dim)`` -> ``{"blendshapes": (B, 52)}``
        in [0, 1]. With ``B = Be * r`` (``r`` windows per utterance,
        utterance-major) the emotion branch runs at ``Be`` rows and its
        outputs repeat over each utterance's ``r`` rows. In training mode a
        ``generator`` turns on dropout (attention weights and the head).

        ``return_attention`` adds the head-averaged attention weights,
        taken before dropout: ``mel_attention_weights`` (B, 28, 80) and
        ``emotion_attention_weights`` (B, 24, 1), and the blendshapes of
        each stream's own set, zero elsewhere: ``mel_blendshapes`` and
        ``emotion_blendshapes`` (B, 52). ``blendshapes`` is the same
        either way."""
        b = mel_features.shape[0]
        be = emotion_features.shape[0]
        if be == 0 or b % be:
            raise ValueError(f"mel batch {b} not a multiple of emotion "
                             f"batch {be}")
        mel = mel_features.transpose(1, 2)                    # (B, 80, T)
        t = mel.shape[2]
        if t < self.mel_sequence_length:
            mel = nn.functional.pad(mel, (0, self.mel_sequence_length - t))
        elif t > self.mel_sequence_length:
            mel = mel[:, :, : self.mel_sequence_length]
        enhanced = torch.cat([mel, mel_temporal_features.transpose(1, 2)], 2)
        mel_encoded = self.mel_norm(self.mel_channel_encoder(enhanced))
        emo_encoded = self.emotion_norm(
            self.emotion_encoder(emotion_features)[:, None, :])

        mel_out = self.mel_attention(self.mouth_queries[None], mel_encoded,
                                     mel_encoded, generator, return_attention)
        emo_out = self.emotion_attention(self.expression_queries[None],
                                         emo_encoded, emo_encoded, generator,
                                         return_attention)
        if return_attention:
            (mel_out, mel_attn), (emo_out, emo_attn) = mel_out, emo_out
        mouth_bs = self._head(self.mel_output_proj(mel_out),
                              generator)                            # (B, 28)
        expr_bs = self._head(self.emotion_output_proj(emo_out),
                             generator)                             # (Be, 24)
        if b != be:
            expr_bs = expr_bs.repeat_interleave(b // be, 0)
            if return_attention:
                emo_attn = emo_attn.repeat_interleave(b // be, 0)

        blendshapes = mouth_bs.new_zeros((b, self.num_blendshapes))
        blendshapes = blendshapes.index_copy(1, self._mouth_idx, mouth_bs)
        blendshapes = blendshapes.index_copy(1, self._expr_idx, expr_bs)

        norm_mel_w = torch.softmax(self.mel_weights / self.temperature, -1)
        norm_emo_w = torch.softmax(self.emotion_weights / self.temperature,
                                   -1)
        final = (norm_mel_w * blendshapes * 0.5
                 + norm_emo_w * blendshapes * 0.5)
        out = {"blendshapes": torch.clamp(final, 0.0, 1.0)}
        if return_attention:
            out["mel_attention_weights"] = mel_attn
            out["emotion_attention_weights"] = emo_attn
            zero = torch.zeros_like(blendshapes)
            out["mel_blendshapes"] = zero.index_copy(
                1, self._mouth_idx, mouth_bs)
            out["emotion_blendshapes"] = zero.index_copy(
                1, self._expr_idx, expr_bs)
        return out
