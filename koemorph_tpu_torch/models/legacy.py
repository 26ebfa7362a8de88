"""The legacy assembled model: the encoder pair -> 4 cross-attention
layers -> the decoder -> the smoother -> the constraints.

The encoder pair's outputs are averaged (the reference model's fusion);
the production path is the dual-stream model. The smoother's and the
constraints' state is an explicit carry (:class:`KoeMorphModelState`)
that the forward takes and returns.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import torch
from torch import nn

from koemorph_tpu_torch.models.attention import (LN_EPS,
                                                 BlendshapeQueryEmbedding,
                                                 MultiHeadCrossAttention)
from koemorph_tpu_torch.models.decoder import (BlendshapeConstraints,
                                               BlendshapeDecoder,
                                               ConstraintState,
                                               SmootherState,
                                               TemporalSmoother)
from koemorph_tpu_torch.models.dual_stream import DualStreamEncoder
from koemorph_tpu_torch.models.init import init_like_flax, xavier_uniform

__all__ = ["KoeMorphModelState", "KoeMorphModel", "create_koemorph_model"]


@dataclasses.dataclass
class KoeMorphModelState:
    """The legacy model's carried temporal state."""

    smoother: SmootherState
    constraints: ConstraintState

    @classmethod
    def create(cls, batch_size: int, num_blendshapes: int = 52,
               window_size: int = 5, device=None) -> "KoeMorphModelState":
        return cls(
            smoother=SmootherState.create(batch_size, num_blendshapes,
                                          window_size, device=device),
            constraints=ConstraintState.create(batch_size, num_blendshapes,
                                               device=device))


class KoeMorphModel(nn.Module):
    """The complete legacy model. ``forward(mel_features (B, T, mel_dim),
    emotion_features (B, T, emotion_dim), state=None, ...)`` returns
    ``({"blendshapes", "raw_blendshapes"[, "attention_weights"]},
    new_state)``: the decoder's output, smoothed (when a ``state`` is
    given) and constrained. ``audio_mask (B, T)``, True = valid, masks the
    padded frames in the encoders and the cross-attention;
    ``prev_blendshapes (B, 52)`` conditions the queries and the decoder.
    ``attention_weights`` is the list of each layer's ``(B, H, 52, T)``
    weights. Dropout acts in training mode on calls given a
    ``generator``."""

    def __init__(self, mel_dim: int = 80, emotion_dim: int = 256,
                 d_model: int = 256, d_query: int = 128, num_heads: int = 8,
                 num_encoder_layers: int = 2, num_attention_layers: int = 4,
                 attention_dropout: float = 0.1,
                 decoder_hidden_dim: int = 128, decoder_layers: int = 2,
                 decoder_activation: str = "gelu",
                 output_activation: str = "sigmoid",
                 use_temporal_smoothing: bool = True,
                 smoothing_method: str = "exponential",
                 smoothing_alpha: float = 0.8, use_constraints: bool = True,
                 causal: bool = True, window_size: Optional[int] = 30,
                 num_blendshapes: int = 52, dropout: float = 0.1):
        super().__init__()
        self.d_query, self.d_model = d_query, d_model
        self.num_attention_layers = num_attention_layers
        self.use_temporal_smoothing = use_temporal_smoothing
        self.use_constraints = use_constraints
        self.smoothing_alpha = smoothing_alpha
        self.audio_encoder = DualStreamEncoder(
            mel_dim=mel_dim, emotion_dim=emotion_dim, d_model=d_model,
            num_layers=num_encoder_layers, dropout=dropout)
        self.query_embeddings = BlendshapeQueryEmbedding(
            num_blendshapes=num_blendshapes, d_query=d_query,
            use_conditioning=True, dropout=dropout)
        for i in range(num_attention_layers):
            self.add_module(f"cross_attention_{i}", MultiHeadCrossAttention(
                d_query=d_query if i == 0 else d_model, d_key=d_model,
                d_value=d_model, d_model=d_model, num_heads=num_heads,
                dropout=attention_dropout, causal=causal,
                window_size=window_size))
            self.add_module(f"attention_norm_{i}",
                            nn.LayerNorm(d_model, eps=LN_EPS))
        if d_query != d_model:
            self.query_up_proj = nn.Linear(d_query, d_model)
        self.decoder = BlendshapeDecoder(
            d_model=d_model, hidden_dim=decoder_hidden_dim,
            num_blendshapes=num_blendshapes, num_layers=decoder_layers,
            activation=decoder_activation,
            output_activation=output_activation, dropout=dropout)
        if use_temporal_smoothing:
            self.temporal_smoother = TemporalSmoother(
                num_blendshapes=num_blendshapes,
                smoothing_method=smoothing_method, alpha=smoothing_alpha,
                learnable=True)
        if use_constraints:
            self.constraints = BlendshapeConstraints(
                num_blendshapes=num_blendshapes)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights with the Flax initializers' distributions: Xavier
        uniform for the cross-attention's and the decoder's dense kernels,
        the packed in-projections and the query embeddings, LeCun
        truncated normal for the other dense kernels, zero biases, unit
        norms; the smoother's ``alpha`` at ``smoothing_alpha`` (its
        sigmoid is applied), Gaussian weights uniform. Drawn on the
        CPU."""
        init_like_flax(self, generator, xavier=(
            "q_proj", "k_proj", "v_proj",
            *(f"cross_attention_{i}.out_proj"
              for i in range(self.num_attention_layers)),
            "decoder.input_proj", "decoder.output_proj",
            *(f"decoder.hidden_{i}"
              for i in range(self.decoder.num_layers))),
            queries=[(self.query_embeddings.query_embeddings,
                      xavier_uniform)])
        sm = getattr(self, "temporal_smoother", None)
        if sm is not None and sm.smoothing_method == "exponential":
            sm.alpha.fill_(self.smoothing_alpha)
        elif sm is not None and sm.smoothing_method == "gaussian":
            sm.gaussian_weights.fill_(1.0 / sm.window_size)

    def forward(self, mel_features: torch.Tensor,
                emotion_features: torch.Tensor,
                state: Optional[KoeMorphModelState] = None,
                audio_mask: Optional[torch.Tensor] = None,
                prev_blendshapes: Optional[torch.Tensor] = None,
                apply_smoothing: bool = True,
                apply_constraints: bool = True,
                return_attention: bool = False,
                generator: Optional[torch.Generator] = None):
        b = mel_features.shape[0]
        mel_enc, emo_enc = self.audio_encoder(
            mel_features, emotion_features, mel_mask=audio_mask,
            emotion_mask=audio_mask, generator=generator)
        encoded = (mel_enc + emo_enc) / 2

        attention_output = self.query_embeddings(b, prev_blendshapes,
                                                 generator)
        weights = []
        for i in range(self.num_attention_layers):
            attn_out, attn_w = getattr(self, f"cross_attention_{i}")(
                attention_output, encoded, encoded,
                key_padding_mask=audio_mask,
                return_attention=return_attention, generator=generator)
            if i == 0 and self.d_query != self.d_model:
                # the query residual, projected up to d_model
                attention_output = self.query_up_proj(attention_output)
            attention_output = getattr(self, f"attention_norm_{i}")(
                attn_out + attention_output)
            if return_attention:
                weights.append(attn_w)

        raw = self.decoder(attention_output, prev_blendshapes, generator)
        new_state, smoothed = state, raw
        if apply_smoothing and self.use_temporal_smoothing \
                and state is not None:
            smoothed, sm_state = self.temporal_smoother(raw, state.smoother)
            new_state = dataclasses.replace(state, smoother=sm_state)
        final = smoothed
        if apply_constraints and self.use_constraints:
            if new_state is not None:
                final, _, c_state = self.constraints(smoothed,
                                                     new_state.constraints)
                new_state = dataclasses.replace(new_state,
                                                constraints=c_state)
            else:
                final, _ = self.constraints(smoothed)
        out = {"blendshapes": final, "raw_blendshapes": raw}
        if return_attention and weights:
            out["attention_weights"] = weights
        return out, new_state


def create_koemorph_model(config: dict) -> KoeMorphModel:
    """A legacy model from a flat config dict (the constructor's argument
    names; each missing one takes its default)."""
    names = inspect.signature(KoeMorphModel.__init__).parameters
    return KoeMorphModel(**{k: v for k, v in config.items() if k in names})
