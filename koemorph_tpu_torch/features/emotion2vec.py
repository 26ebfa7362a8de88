"""A trainable conv emotion encoder with the 1024-D emotion2vec contract,
temporal pooling of encoder frames to the blendshape rate, the utterance
embedding, and a host-side LRU cache of embeddings keyed by a content
hash of the audio.

:class:`ConvEmotionEncoder` keeps the Flax module's defaults where PyTorch
has others: ``SAME`` padding of each strided conv (``lo = total // 2``,
``total = max((ceil(L / s) - 1) * s + k - L, 0)``), LayerNorm eps 1e-6 and
the tanh-approximated GELU.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["EMBED_DIM", "ConvEmotionEncoder", "pool_to_fps",
           "utterance_embedding", "Emotion2VecCache"]

EMBED_DIM = 1024
_WIDTHS = (512,) * 7
_STRIDES = (5, 2, 2, 2, 2, 2, 2)
_KERNELS = (10, 3, 3, 3, 3, 2, 2)
_EPS = 1e-6            # Flax LayerNorm's default


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad the last axis of ``x`` as Flax's ``padding="SAME"``."""
    n = x.shape[-1]
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return F.pad(x, (total // 2, total - total // 2))


class ConvEmotionEncoder(nn.Module):
    """Raw 16 kHz audio ``(B, L)`` -> ``(B, T, embed_dim)`` at ~1/320 of
    the sample rate: a strided conv ladder (strides 5, 2, ..., 2), a
    projection, and
    ``num_fusion_layers`` residual feed-forward layers whose LayerNormed
    outputs are fused by softmax weights."""

    def __init__(self, embed_dim: int = EMBED_DIM,
                 num_fusion_layers: int = 4):
        super().__init__()
        dims = (1,) + _WIDTHS
        for i, (k, s) in enumerate(zip(_KERNELS, _STRIDES)):
            self.add_module(f"conv_{i}", nn.Conv1d(dims[i], dims[i + 1], k,
                                                   stride=s))
            self.add_module(f"norm_{i}", nn.LayerNorm(dims[i + 1], eps=_EPS))
        self.proj = nn.Linear(_WIDTHS[-1], embed_dim)
        for i in range(num_fusion_layers):
            self.add_module(f"ff_{i}", nn.Linear(embed_dim, embed_dim))
            self.add_module(f"lnorm_{i}", nn.LayerNorm(embed_dim, eps=_EPS))
        self.num_fusion_layers = num_fusion_layers
        self.layer_fusion_weights = nn.Parameter(
            torch.full((num_fusion_layers,), 1.0 / num_fusion_layers))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = audio[:, None, :]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            for i, (k, s) in enumerate(zip(_KERNELS, _STRIDES)):
                h = getattr(self, f"conv_{i}")(_same_pad(x, k, s))
                h = getattr(self, f"norm_{i}")(h.transpose(1, 2))
                x = F.gelu(h, approximate="tanh").transpose(1, 2)
        h = self.proj(x.transpose(1, 2))
        outs = []
        for i in range(self.num_fusion_layers):
            h = h + getattr(self, f"ff_{i}")(F.gelu(h, approximate="tanh"))
            outs.append(getattr(self, f"lnorm_{i}")(h))
        w = torch.softmax(self.layer_fusion_weights, 0)
        return torch.einsum("l,lbtd->btd", w, torch.stack(outs, 0))


def pool_to_fps(features: torch.Tensor, audio_len: int, sample_rate: int,
                target_fps: float, method: str = "linear") -> torch.Tensor:
    """Encoder frames ``(B, T_in, D)`` -> ``(B, T_out, D)`` at the
    blendshape rate, ``T_out = max(1, int(audio_len / sample_rate *
    target_fps))``: ``adaptive`` means over equal chunks, ``linear``
    interpolation, or ``conv`` (strided means over ``ceil(T_in / T_out)``
    frames, then ``linear`` to exactly ``T_out``)."""
    b, t_in, d = features.shape
    t_out = max(1, int(audio_len / sample_rate * target_fps))
    if method == "adaptive":
        edges = np.linspace(0, t_in, t_out + 1).astype(int)
        return torch.stack(
            [features[:, lo:hi].mean(1) if hi > lo
             else features[:, min(lo, t_in - 1)]
             for lo, hi in zip(edges[:-1], edges[1:])], 1)
    if method == "linear":
        src = _linspace(t_in - 1.0, t_out, features.device)
        lo = torch.clamp(torch.floor(src).to(torch.int64), 0, t_in - 1)
        hi = torch.clamp(lo + 1, 0, t_in - 1)
        w = (src - lo.to(src.dtype))[None, :, None]
        return features[:, lo] * (1 - w) + features[:, hi] * w
    if method == "conv":
        k = max(1, math.ceil(t_in / t_out))
        t_trim = (t_in // k) * k
        pooled = features[:, :t_trim].reshape(b, t_trim // k, k, d).mean(2)
        if pooled.shape[1] == t_out:
            return pooled
        return pool_to_fps(pooled, audio_len, sample_rate, target_fps,
                           method="linear")
    raise ValueError(f"Unknown pooling method: {method}")


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """``num`` float32 points from 0 to ``stop``, rounded as the JAX
    package's compiled ``jnp.linspace`` rounds them: point ``i`` is ``i *
    c`` with ``c = (1 / (num - 1)) * stop`` in float32 (XLA folds the
    constants so), the last point ``stop``."""
    if num == 1:
        return torch.zeros(1, device=device)
    c = np.float32(np.float32(1.0) / np.float32(num - 1)) * np.float32(stop)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    return torch.cat([i * float(c), torch.full((1,), float(stop),
                                               device=device)])


def utterance_embedding(features: torch.Tensor) -> torch.Tensor:
    """``(B, T, D) -> (B, D)``: the mean over time."""
    return features.mean(1)


class Emotion2VecCache:
    """Host-side LRU cache of utterance embeddings keyed by the SHA-1 of
    the audio's bytes (stable across processes)."""

    def __init__(self, max_size: int = 100):
        self.max_size = max_size
        self._store: OrderedDict[str, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def compute_audio_hash(audio: np.ndarray) -> str:
        return hashlib.sha1(
            np.ascontiguousarray(audio).tobytes()).hexdigest()

    def get(self, audio: np.ndarray) -> Optional[np.ndarray]:
        key = self.compute_audio_hash(audio)
        if key in self._store:
            self._store.move_to_end(key)
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def put(self, audio: np.ndarray, embedding: np.ndarray) -> None:
        key = self.compute_audio_hash(audio)
        self._store[key] = embedding
        self._store.move_to_end(key)
        while len(self._store) > self.max_size:
            self._store.popitem(last=False)

    def __len__(self) -> int:
        return len(self._store)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"size": len(self._store), "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}
