"""Attention modules.

:class:`TorchStyleMHA` has ``torch.nn.MultiheadAttention``'s parameters
and semantics; the dual-stream models use it. The rest is the legacy
model family's: :class:`MultiHeadCrossAttention` (separate q/k/v
projections, a temperature-scaled score, causal and window masks on the
key axis, a key padding mask), :class:`PositionalEncoding`,
:class:`TransformerEncoderLayer`, :class:`MultiStreamAudioEncoder` and
:class:`BlendshapeQueryEmbedding`, with the masks
(:func:`causal_mask`, :func:`window_mask`,
:func:`create_attention_mask`).

A masked score is ``NEG_INF = -1e9``, never ``-inf``: a query row whose
keys are all masked comes out uniform, not NaN. The masks are numpy
constants, cached on the device. LayerNorms use Flax's epsilon
(``LN_EPS``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from koemorph_tpu_torch.models.dropout import Dropout
from koemorph_tpu_torch.ops.device_cache import device_cache

__all__ = ["NEG_INF", "causal_mask", "window_mask", "create_attention_mask",
           "TorchStyleMHA", "MultiHeadCrossAttention", "PositionalEncoding",
           "TransformerEncoderLayer", "MultiStreamAudioEncoder",
           "BlendshapeQueryEmbedding"]

#: the logit of a masked score (safe under softmax and its gradient)
NEG_INF = -1e9
#: Flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


def causal_mask(q_len: int, k_len: int) -> np.ndarray:
    """Boolean ``(q_len, k_len)``, True = masked out: the upper
    triangle."""
    return np.triu(np.ones((q_len, k_len), dtype=bool), k=1)


def window_mask(q_len: int, k_len: int, window_size: int) -> np.ndarray:
    """Local-attention mask, True = masked: query ``i`` maps to key
    ``int(i * k_len / q_len)`` and attends within +-``window_size // 2``
    of it."""
    mask = np.ones((q_len, k_len), dtype=bool)
    for i in range(q_len):
        key_pos = int(i * k_len / q_len) if q_len > 0 else 0
        start = max(0, key_pos - window_size // 2)
        end = min(k_len, key_pos + window_size // 2 + 1)
        mask[i, start:end] = False
    return mask


def create_attention_mask(seq_length: int,
                          window_size: Optional[int] = None,
                          causal: bool = False) -> np.ndarray:
    """Self-attention mask of the causal and window constraints (True =
    masked)."""
    mask = np.zeros((seq_length, seq_length), dtype=bool)
    if causal:
        mask = causal_mask(seq_length, seq_length)
    if window_size is not None:
        mask = mask | window_mask(seq_length, seq_length, window_size)
    return mask


@device_cache(32)
def _key_mask(q_len: int, k_len: int, causal: bool,
              window_size: Optional[int], device: torch.device
              ) -> Optional[torch.Tensor]:
    """The causal and window masks of a cross-attention, combined, on
    ``device`` (None when neither applies)."""
    mask = np.zeros((q_len, k_len), dtype=bool)
    if causal:
        mask |= causal_mask(q_len, k_len)
    if window_size is not None:
        mask |= window_mask(q_len, k_len, window_size)
    return torch.from_numpy(mask).to(device) if mask.any() else None


def _apply_masks(scores: torch.Tensor,
                 key_padding_mask: Optional[torch.Tensor],
                 attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``scores (B, H, Q, T)``; ``key_padding_mask (B, T)`` True = valid;
    ``attn_mask (Q, T)`` or ``(B, Q, T)`` True = masked."""
    if key_padding_mask is not None:
        scores = scores.masked_fill(~key_padding_mask[:, None, None, :],
                                    NEG_INF)
    if attn_mask is not None:
        m = attn_mask[None, None] if attn_mask.dim() == 2 \
            else attn_mask[:, None]
        scores = scores.masked_fill(m, NEG_INF)
    return scores


class TorchStyleMHA(nn.Module):
    """Packed (3E, E) in-projection, scale ``head_dim ** -0.5``, output
    projection; parameter names match ``nn.MultiheadAttention``.

    A query batch of 1 against a larger key batch is projected once and
    broadcast (learned-query callers pass ``(1, Q, E)``). ``dropout`` drops
    attention weights in training when the call passes a ``generator``.
    With ``need_weights`` the call returns ``(out, weights)``, the
    attention weights averaged over heads ``(B, Q, T)`` (as
    ``nn.MultiheadAttention`` averages them), taken before dropout.
    ``key_padding_mask (B, T)``, True = valid, excludes the padded keys.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.attn_dropout = Dropout(dropout)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                need_weights: bool = False,
                key_padding_mask: Optional[torch.Tensor] = None):
        e = self.embed_dim
        h = self.num_heads
        hd = e // h
        bq, q_len, _ = query.shape
        b, t = key.shape[0], key.shape[1]
        if bq not in (1, b):
            raise ValueError(
                f"query batch {bq} must be 1 or match key batch {b}")
        wq, wk, wv = self.in_proj_weight.split(e, 0)
        bq_bias, bk, bv = self.in_proj_bias.split(e, 0)
        q = query @ wq.T + bq_bias
        k = key @ wk.T + bk
        v = value @ wv.T + bv

        q = q.reshape(bq, q_len, h, hd).transpose(1, 2).expand(b, h, q_len,
                                                                hd)
        k = k.reshape(b, t, h, hd).transpose(1, 2)
        v = v.reshape(b, t, h, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        scores = _apply_masks(scores, key_padding_mask, None)
        attn = torch.softmax(scores, -1)
        dropped = self.attn_dropout(attn, generator)
        out = torch.matmul(dropped, v).transpose(1, 2).reshape(b, q_len, e)
        out = self.out_proj(out)
        if need_weights:
            return out, attn.mean(1)
        return out


class MultiHeadCrossAttention(nn.Module):
    """The legacy cross-attention: queries ``(B, Q, d_query)`` over keys
    ``(B, T, d_key)`` and values ``(B, T, d_value)``, each projected to
    ``d_model`` (``q_proj``, ``k_proj``, ``v_proj``), scores scaled by
    ``(head_dim * temperature) ** -0.5``, the causal and window masks
    applied on the key axis, then ``key_padding_mask (B, T)`` (True =
    valid) and ``attn_mask`` ((Q, T) or (B, Q, T), True = masked).
    Returns ``(out, weights)``: ``weights (B, H, Q, T)`` after dropout
    when ``return_attention``, else None. Dropout (the weights and the
    output) acts in training mode on calls given a ``generator``."""

    def __init__(self, d_query: int = 128, d_key: int = 256,
                 d_value: int = 256, d_model: int = 256, num_heads: int = 8,
                 dropout: float = 0.1, causal: bool = True,
                 window_size: Optional[int] = None,
                 temperature: float = 1.0, qkv_bias: bool = True):
        super().__init__()
        if d_model % num_heads != 0:
            raise ValueError(f"d_model ({d_model}) must be divisible by "
                             f"num_heads ({num_heads})")
        self.d_model, self.num_heads = d_model, num_heads
        self.causal, self.window_size = causal, window_size
        self.scale = (d_model // num_heads * temperature) ** -0.5
        self.q_proj = nn.Linear(d_query, d_model, bias=qkv_bias)
        self.k_proj = nn.Linear(d_key, d_model, bias=qkv_bias)
        self.v_proj = nn.Linear(d_value, d_model, bias=qkv_bias)
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                return_attention: bool = False,
                generator: Optional[torch.Generator] = None):
        b, q_len, _ = query.shape
        t = key.shape[1]
        if key.shape[0] != b:
            raise ValueError(
                f"Batch size mismatch: query {b}, key {key.shape[0]}")
        h, hd = self.num_heads, self.d_model // self.num_heads

        def split(x, n):
            return x.reshape(b, n, h, hd).transpose(1, 2)

        q = split(self.q_proj(query), q_len)
        k = split(self.k_proj(key), t)
        v = split(self.v_proj(value), t)
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        mask = _key_mask(q_len, t, self.causal, self.window_size,
                         scores.device)
        if mask is not None:
            scores = scores.masked_fill(mask, NEG_INF)
        scores = _apply_masks(scores, key_padding_mask, attn_mask)
        attn = self.dropout(torch.softmax(scores, -1), generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, q_len,
                                                            self.d_model)
        out = self.dropout(self.out_proj(out), generator)
        return out, (attn if return_attention else None)


@functools.lru_cache(maxsize=8)
def _sinusoids(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


@device_cache(8)
def _sinusoid_table(max_len: int, d_model: int, device: torch.device
                    ) -> torch.Tensor:
    return torch.from_numpy(_sinusoids(max_len, d_model)).to(device)


class PositionalEncoding(nn.Module):
    """Sinusoidal positional encoding added to ``(B, T, d_model)``, then
    dropout."""

    def __init__(self, d_model: int, dropout: float = 0.1,
                 max_len: int = 5000):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        pe = _sinusoid_table(self.max_len, self.d_model, x.device)
        return self.dropout(x + pe[: x.shape[1]][None], generator)


class TransformerEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer (``nn.TransformerEncoderLayer``'s
    defaults, batch first) with the tanh-approximated GELU in its
    feed-forward block, as Flax's ``nn.gelu`` computes it. Parameter
    names follow ``nn.TransformerEncoderLayer`` (``self_attn``,
    ``linear1``, ``linear2``, ``norm1``, ``norm2``)."""

    def __init__(self, d_model: int, num_heads: int = 8,
                 dim_feedforward: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.self_attn = TorchStyleMHA(d_model, num_heads, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = functools.partial(self.dropout, generator=generator)
        attn_out = self.self_attn(x, x, x, generator,
                                  key_padding_mask=key_padding_mask)
        x = self.norm1(x + drop(attn_out))
        h = drop(F.gelu(self.linear1(x), approximate="tanh"))
        return self.norm2(x + drop(self.linear2(h)))


class MultiStreamAudioEncoder(nn.Module):
    """Mel, prosody and emotion per-frame MLPs fused by ``concat`` (a
    projection of the three), ``add`` or ``gate`` (sigmoid gates
    normalized to sum 1), with an optional positional encoding, a stack of
    :class:`TransformerEncoderLayer` and a final LayerNorm. ``mask (B,
    T)``, True = valid, is the layers' key padding mask."""

    def __init__(self, mel_dim: int = 80, prosody_dim: int = 4,
                 emotion_dim: int = 256, d_model: int = 256,
                 num_layers: int = 2, dropout: float = 0.1,
                 fusion_method: str = "concat",
                 use_positional_encoding: bool = True):
        super().__init__()
        if fusion_method not in ("concat", "add", "gate"):
            raise ValueError(f"Unknown fusion method: {fusion_method}")
        self.fusion_method = fusion_method
        self.mel_hidden = nn.Linear(mel_dim, d_model // 2)
        self.mel_out = nn.Linear(d_model // 2, d_model)
        self.prosody_hidden = nn.Linear(prosody_dim, d_model // 4)
        self.prosody_out = nn.Linear(d_model // 4, d_model)
        self.emotion_proj = nn.Linear(emotion_dim, d_model)
        if fusion_method == "concat":
            self.fusion = nn.Linear(3 * d_model, d_model)
        elif fusion_method == "gate":
            self.gate_mel = nn.Linear(d_model, 1)
            self.gate_prosody = nn.Linear(d_model, 1)
            self.gate_emotion = nn.Linear(d_model, 1)
        self.positional = (PositionalEncoding(d_model, dropout)
                           if use_positional_encoding else None)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, dim_feedforward=d_model * 4,
                                    dropout=dropout)
            for _ in range(num_layers)])
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, mel_features: torch.Tensor,
                prosody_features: torch.Tensor,
                emotion_features: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        drop = functools.partial(self.dropout, generator=generator)
        mel = self.mel_out(drop(F.relu(self.mel_hidden(mel_features))))
        pros = self.prosody_out(drop(F.relu(
            self.prosody_hidden(prosody_features))))
        emo = drop(F.relu(self.emotion_proj(emotion_features)))
        if self.fusion_method == "concat":
            fused = self.fusion(torch.cat([mel, pros, emo], -1))
        elif self.fusion_method == "add":
            fused = mel + pros + emo
        else:
            gm = torch.sigmoid(self.gate_mel(mel))
            gp = torch.sigmoid(self.gate_prosody(pros))
            ge = torch.sigmoid(self.gate_emotion(emo))
            s = gm + gp + ge + 1e-8
            fused = (gm / s) * mel + (gp / s) * pros + (ge / s) * emo
        if self.positional is not None:
            fused = self.positional(fused, generator)
        x = fused
        for layer in self.layers:
            x = layer(x, key_padding_mask=mask, generator=generator)
        return self.norm(x)


class BlendshapeQueryEmbedding(nn.Module):
    """52 learned query vectors ``(52, d_query)``, broadcast over the batch;
    with ``use_conditioning`` and ``prev_blendshapes (B, 52)`` given, a
    two-layer net of the previous frame (``cond_hidden``, ``cond_out``)
    is added to every query. Dropout on the queries."""

    def __init__(self, num_blendshapes: int = 52, d_query: int = 128,
                 use_conditioning: bool = True, dropout: float = 0.1):
        super().__init__()
        self.num_blendshapes, self.d_query = num_blendshapes, d_query
        self.use_conditioning = use_conditioning
        self.query_embeddings = nn.Parameter(
            torch.zeros(num_blendshapes, d_query))
        if use_conditioning:
            self.cond_hidden = nn.Linear(num_blendshapes, d_query // 2)
            self.cond_out = nn.Linear(d_query // 2, d_query)
        self.dropout = Dropout(dropout)

    def forward(self, batch_size: int,
                prev_blendshapes: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        queries = self.query_embeddings[None].expand(
            batch_size, self.num_blendshapes, self.d_query)
        if self.use_conditioning and prev_blendshapes is not None:
            h = self.dropout(F.relu(self.cond_hidden(prev_blendshapes)),
                             generator)
            queries = queries + self.cond_out(h)[:, None, :]
        return self.dropout(queries, generator)
