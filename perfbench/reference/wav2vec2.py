"""The wav2vec 2.0 encoder of the ``emotion2vec`` backend in plain float32
``torch``: the large family's architecture as published (arXiv:2006.11477;
``facebook/wav2vec2-large-lv60``'s ``config.json``: ``feat_extract_norm
"layer"``, ``do_stable_layer_norm``, ``hidden_act "gelu"``), written from
that description and not from the program.

- Feature encoder: 7 strided temporal convolutions over the raw 16 kHz
  waveform, each followed by a LayerNorm over its channels and an exact
  GELU.
- Feature projection: a LayerNorm over the last conv's channels and a
  dense layer to the hidden width.
- Relative positional embedding: a grouped convolution over time (kernel
  128, 16 groups, padding 64; an even kernel's extra last column dropped)
  and a GELU, added to the projected features.
- Transformer: stable-layer-norm layers (LayerNorm, multi-head
  self-attention, residual; LayerNorm, GELU feed-forward, residual), then
  a final LayerNorm.
- emotion2vec's use: a softmax-weighted sum of the 25 hidden states (the
  input of each layer, and the last one after the final LayerNorm, as
  HuggingFace's ``output_hidden_states`` gives them), then the mean over
  time.

Departures from the published model, each deliberate:
- the positional convolution holds a plain weight; the published one is
  weight-normed (``weight_g``, ``weight_v``), which at inference is the
  same plain weight ``g * v / ||v||``;
- no feature masking, dropout or layer drop (inference);
- no attention mask: every lane encodes the same number of samples;
- the softmax fusion of the hidden states and the time mean are
  emotion2vec's read-out, not part of wav2vec 2.0.

Module names follow HuggingFace's ``Wav2Vec2Model``, so the state dict's
keys are the checkpoint's (without the ``wav2vec2.`` prefix), and the
fusion logits are ``layer_fusion_weights``. Nothing here imports the
program or JAX.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """The published ``Wav2Vec2Config`` fields the encoder's shapes read
    (defaults: ``facebook/wav2vec2-large-lv60``)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple = (512,) * 7
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: dict) -> "EncoderConfig":
        """The fields of ``d`` this class has (lists as tuples)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names})

    def frames(self, samples: int) -> int:
        """Output frames of the feature encoder over ``samples``."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            samples = (samples - k) // s + 1
        return samples


def _channel_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm over the channels of ``(B, C, T)``."""
    return norm(x.transpose(1, 2)).transpose(1, 2)


class _ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, bias: bool,
                 eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(_channel_norm(self.layer_norm, self.conv(x)))


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        chans = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvBlock(chans[i], chans[i + 1], cfg.conv_kernel[i],
                       cfg.conv_stride[i], cfg.conv_bias, cfg.layer_norm_eps)
            for i in range(len(cfg.conv_dim)))

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, C, T)."""
        x = wave.unsqueeze(1)
        for block in self.conv_layers:
            x = block(x)
        return x


class _Projection(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, T, hidden)."""
        return self.projection(self.layer_norm(feats.transpose(1, 2)))


class _PositionalConv(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.kernel = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, D): the embedding to add."""
        h = self.conv(x.transpose(1, 2))[:, :, :x.shape[1]]
        return F.gelu(h).transpose(1, 2)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        hd = d // h

        def heads(y):
            return y.view(b, t, h, hd).permute(0, 2, 1, 3)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        ctx = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(ctx.permute(0, 2, 1, 3).reshape(b, t, d))


class _FeedForward(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _Layer(nn.Module):
    """A stable-layer-norm layer: pre-norm attention and feed-forward,
    each with its residual."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.attention = _SelfAttention(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layer_norm(x))
        return x + self.feed_forward(self.final_layer_norm(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.pos_conv_embed = _PositionalConv(cfg)
        self.layers = nn.ModuleList(_Layer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)


class Encoder(nn.Module):
    """``(B, L)`` 16 kHz audio -> ``(B, T, hidden)``, the softmax fusion
    of the hidden states (:meth:`hidden_states`)."""

    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _Projection(cfg)
        self.encoder = _Transformer(cfg)
        self.layer_fusion_weights = nn.Parameter(
            torch.zeros(cfg.num_hidden_layers + 1))

    def front(self, wave: torch.Tensor) -> torch.Tensor:
        """The feature encoder, the projection and the positional
        embedding added: the first layer's input ``(B, T, hidden)``."""
        x = self.feature_projection(self.feature_extractor(wave))
        return x + self.encoder.pos_conv_embed(x)

    def hidden_states(self, wave: torch.Tensor) -> list[torch.Tensor]:
        """The ``num_hidden_layers + 1`` hidden states: each layer's input,
        then the last layer's output after the final LayerNorm."""
        x = self.front(wave)
        states = [x]
        for layer in self.encoder.layers:
            x = layer(x)
            states.append(x)
        states[-1] = self.encoder.layer_norm(x)
        return states

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        states = self.hidden_states(wave)
        w = torch.softmax(self.layer_fusion_weights, dim=0)
        out = torch.zeros_like(states[0])
        for wi, h in zip(w, states):
            out = out + wi * h
        return out

    def pooled(self, wave: torch.Tensor) -> torch.Tensor:
        """emotion2vec's utterance vector: the fused states' mean over
        time, ``(B, L) -> (B, hidden)``."""
        return self(wave).mean(dim=1)
