"""The minimal legacy model: audio -> log-mel -> 52 learned queries
attending over the encoded frames -> 52 coefficients per clip.

The mel frontend is the librosa-style ``log_mel_spectrogram``: on a CUDA
tensor its STFT -> mel -> dB runs in the fused ``logmel`` kernel, reading
the frames in place; on the CPU in the kernel's plain form.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from koemorph_tpu_torch.models.attention import TorchStyleMHA
from koemorph_tpu_torch.models.dropout import Dropout
from koemorph_tpu_torch.models.init import init_like_flax
from koemorph_tpu_torch.ops.frontend import (LogMelFrontend,
                                             log_mel_spectrogram)

__all__ = ["SimplifiedKoeMorphModel"]


class SimplifiedKoeMorphModel(nn.Module):
    """Mel-only single-stream model producing one ``(B, 52)`` frame per
    clip: two ReLU dense layers (``enc_0``, ``enc_1``) over the mel
    frames, the learned queries ``blendshape_queries (52, d_model)``
    attending over them (``attention``, :class:`TorchStyleMHA`), a decoder
    MLP (``dec_0``, ``dec_1``, ``dec_out``), a sigmoid and the mean over
    the 52 query tokens. Dropout acts in training mode on calls given a
    ``generator``."""

    def __init__(self, d_model: int = 256, num_heads: int = 8,
                 num_blendshapes: int = 52, decoder_hidden: int = 128,
                 dropout: float = 0.1, sample_rate: int = 16000,
                 target_fps: int = 30, n_mels: int = 80):
        super().__init__()
        self.d_model, self.num_blendshapes = d_model, num_blendshapes
        self.sample_rate, self.target_fps = sample_rate, target_fps
        self.frontend = LogMelFrontend(
            sample_rate=sample_rate, target_fps=float(target_fps),
            n_fft=1024, n_mels=n_mels, f_min=80.0, f_max=8000.0,
            style="librosa")
        self.enc_0 = nn.Linear(n_mels, d_model)
        self.enc_1 = nn.Linear(d_model, d_model)
        self.blendshape_queries = nn.Parameter(
            torch.zeros(num_blendshapes, d_model))
        self.attention = TorchStyleMHA(d_model, num_heads, dropout)
        self.dec_0 = nn.Linear(d_model, decoder_hidden)
        self.dec_1 = nn.Linear(decoder_hidden, decoder_hidden)
        self.dec_out = nn.Linear(decoder_hidden, num_blendshapes)
        self.dropout = Dropout(dropout)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate / self.target_fps)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights with the Flax initializers' distributions: LeCun
        truncated normal dense kernels, Xavier uniform in-projection,
        zero biases, queries from N(0, 0.1). Drawn on the CPU."""
        init_like_flax(self, generator, queries=[(
            self.blendshape_queries,
            lambda shape, g: 0.1 * torch.randn(shape, generator=g))])

    def forward(self, audio: Optional[torch.Tensor] = None,
                mel_features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``audio (B, L)`` or ``mel_features (B, T, n_mels)`` -> ``(B,
        52)`` in (0, 1)."""
        if mel_features is None:
            if audio is None:
                raise ValueError("Provide audio or mel_features")
            mel_features = log_mel_spectrogram(audio, self.frontend)
        drop = self.dropout
        h = drop(torch.relu(self.enc_0(mel_features)), generator)
        h = drop(torch.relu(self.enc_1(h)), generator)
        attn_out = self.attention(self.blendshape_queries[None], h, h,
                                  generator)
        d = drop(torch.relu(self.dec_0(attn_out)), generator)
        d = drop(torch.relu(self.dec_1(d)), generator)
        return torch.sigmoid(self.dec_out(d)).mean(1)
