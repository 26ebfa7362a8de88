"""Multi-head attention with ``torch.nn.MultiheadAttention``'s parameters."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from koemorph_tpu_torch.models.dropout import Dropout


class TorchStyleMHA(nn.Module):
    """Packed (3E, E) in-projection, scale ``head_dim ** -0.5``, output
    projection; parameter names match ``nn.MultiheadAttention``.

    A query batch of 1 against a larger key batch is projected once and
    broadcast (learned-query callers pass ``(1, Q, E)``). ``dropout`` drops
    attention weights in training when the call passes a ``generator``.
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
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
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
        attn = self.attn_dropout(torch.softmax(scores, -1), generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, q_len, e)
        return self.out_proj(out)
