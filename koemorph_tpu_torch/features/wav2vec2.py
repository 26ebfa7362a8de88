"""The wav2vec2 encoder of the ``emotion2vec`` backend, and a loader of
HuggingFace wav2vec2 checkpoints.

The architecture is the large family's (``feat_extract_norm="layer"``,
``do_stable_layer_norm=True``, as wav2vec2-large and
emotion2vec_plus_large): a 7-layer strided conv ladder with a LayerNorm
and an exact GELU after each conv, a LayerNorm and a projection to the
hidden width, a grouped positional convolution, stable-layer-norm
transformer layers, a final LayerNorm, and a softmax-weighted fusion of
all hidden states.

Module names follow HuggingFace's ``Wav2Vec2Model``, so loading a
checkpoint is a prefix strip plus resolving the positional convolution's
weight norm (:func:`load_hf_checkpoint`); the fusion logits are
``layer_fusion_weights``. The positional convolution keeps a plain
weight.

Every linear projection (the feature projection, the attention's q, k,
v and out, the feed-forward's two) goes through
:func:`koemorph_tpu_torch.ops.linear.linear`: on the card, where autograd
does not record the call, the 3xTF32 tensor-core kernel (q, k and v as
one grouped launch, the intermediate GELU in its epilogue); on the CPU,
and under autograd, ``F.linear`` as before.

On the card the convolutions run inside ``torch.backends.cudnn.flags``
with TF32 off (the rest of the port runs every product in full fp32), no
autotuning (a search inside a CUDA graph capture would allocate and sync)
and deterministic algorithms (a resumed training run is bit for bit the
uninterrupted one); the flags are scoped to the encoder's forward, and
the trainer scopes the same around the backward, which picks its
algorithms outside the forward.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from koemorph_tpu_torch.ops import linear as lin
from koemorph_tpu_torch.utils import spans

__all__ = ["Wav2Vec2Config", "Wav2Vec2Encoder", "load_hf_checkpoint",
           "hf_state_dict", "read_safetensors"]


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The fields of ``transformers.Wav2Vec2Config`` this encoder reads."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_dim: tuple[int, ...] = (512,) * 7
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf_config(cls, path) -> "Wav2Vec2Config":
        cfg = json.loads(Path(path).read_text())
        return cls(
            hidden_size=cfg["hidden_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            conv_dim=tuple(cfg["conv_dim"]),
            conv_stride=tuple(cfg["conv_stride"]),
            conv_kernel=tuple(cfg["conv_kernel"]),
            conv_bias=cfg.get("conv_bias", True),
            num_conv_pos_embeddings=cfg["num_conv_pos_embeddings"],
            num_conv_pos_embedding_groups=cfg[
                "num_conv_pos_embedding_groups"],
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5))

    def frames(self, samples: int) -> int:
        """Encoder frames of ``samples`` samples of audio."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            samples = (samples - k) // s + 1
        return samples


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int, bias: bool,
                 eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, L) -> (B, C_out, L')."""
        h = self.layer_norm(self.conv(x).transpose(1, 2))
        return F.gelu(h).transpose(1, 2)


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, cfg.conv_bias,
                       cfg.layer_norm_eps)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel,
                                           cfg.conv_stride)))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T, conv_dim[-1])."""
        x = audio[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lin.linear(self.layer_norm(x), self.projection)[0]


class _PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.drop_last = k % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, D)."""
        h = self.conv(x.transpose(1, 2))
        if self.drop_last:          # the extra column of an even kernel
            h = h[:, :, :-1]
        return F.gelu(h).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads

        def split(y):                           # (B, T, D) -> (B, H, T, hd)
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        q, k, v = lin.linear(x, self.q_proj, self.k_proj, self.v_proj)
        q = split(q * (hd ** -0.5))
        scores = torch.matmul(q, split(k).transpose(-1, -2))
        ctx = torch.matmul(torch.softmax(scores, -1), split(v))
        return lin.linear(ctx.transpose(1, 2).reshape(b, t, d),
                          self.out_proj)[0]


class _FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = lin.linear(x, self.intermediate_dense, gelu=True)[0]
        return lin.linear(h, self.output_dense)[0]


class _EncoderLayer(nn.Module):
    """Stable-layer-norm layer: LayerNorm before attention and before the
    feed-forward, residual after each."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.attention = _Attention(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.feed_forward = _FeedForward(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layer_norm(x))
        return x + self.feed_forward(self.final_layer_norm(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = _PositionalConvEmbedding(cfg)
        self.layers = nn.ModuleList(_EncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)


class Wav2Vec2Encoder(nn.Module):
    """Raw 16 kHz audio ``(B, L)`` -> ``(B, T, hidden)``: the softmax
    fusion of the ``num_hidden_layers + 1`` hidden states (the last one
    after the encoder's LayerNorm, the others before it) when
    ``use_layer_fusion``, else the last hidden state.

    Inside an open span-registry track that declares them (the ``serve``
    track, :data:`koemorph_tpu_torch.runtime.streaming.STAGES`) the
    forward stamps the ends of ``e2v_front`` (conv ladder, feature
    projection, positional convolution) and ``e2v_layers`` (the layers
    and the final LayerNorm); elsewhere the marks do nothing."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 use_layer_fusion: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_layer_fusion = use_layer_fusion
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)
        if use_layer_fusion:
            self.layer_fusion_weights = nn.Parameter(
                torch.zeros(cfg.num_hidden_layers + 1))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=False,
                deterministic=True, allow_tf32=False):
            x = self.feature_projection(self.feature_extractor(audio))
            enc = self.encoder
            x = x + enc.pos_conv_embed(x)
        spans.mark("e2v_front")
        hidden = [x]
        for i, layer in enumerate(enc.layers):
            x = layer(x)
            if i < len(enc.layers) - 1:
                hidden.append(x)
        x = enc.layer_norm(x)
        hidden.append(x)
        spans.mark("e2v_layers")
        if not self.use_layer_fusion:
            return x
        w = torch.softmax(self.layer_fusion_weights, 0)
        return torch.einsum("l,lbtd->btd", w.to(x.dtype),
                            torch.stack(hidden, 0))

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Flax's initializers: LeCun normal kernels (truncated at 2 std,
        fan-in over the kernel's receptive field and input channels of a
        group), zero biases, unit LayerNorm scales, zero fusion logits.
        Drawn on the CPU from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                w = mod.weight
                mod.weight.copy_(lecun_normal(
                    tuple(w.shape), w[0].numel(), generator).to(w.device))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        if self.use_layer_fusion:
            self.layer_fusion_weights.zero_()


def lecun_normal(shape: tuple, fan_in: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at +/- 2 std (by its
    inverse CDF), scaled to variance ``1 / fan_in`` after truncation;
    drawn on the CPU."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator)
    return torch.special.erfinv(2.0 * u - 1.0) * (math.sqrt(2.0) * std)


# ---------------------------------------------------------------------------
# HuggingFace checkpoints
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path) -> dict[str, np.ndarray]:
    """The tensors of a ``.safetensors`` file: an 8-byte little-endian
    header length, a JSON header of ``{name: {dtype, shape,
    data_offsets}}`` (and an optional ``__metadata__``), then the raw
    little-endian data. ``BF16`` is widened to float32."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(data[lo:hi], "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(data[lo:hi], np.dtype(
                _ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: unsupported dtype {info['dtype']} "
                             f"of {name}")
        out[name] = arr.reshape(shape).copy()
    return out


def _weight_norm_weight(sd: dict, prefix: str) -> np.ndarray:
    """A weight-normed conv weight from the legacy (``weight_g`` /
    ``weight_v``) or the parametrized (``original0`` / ``original1``)
    layout, resolved in float64: ``g * v / ||v||`` with the norm over
    every axis but the kernel's."""
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    else:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    g = np.asarray(g, np.float64)
    v = np.asarray(v, np.float64)
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)


def hf_state_dict(sd: dict, cfg: Wav2Vec2Config,
                  layer_fusion_weights: Optional[np.ndarray] = None
                  ) -> dict[str, torch.Tensor]:
    """A HuggingFace ``Wav2Vec2Model`` state dict (numpy or torch values,
    with or without the ``wav2vec2.`` prefix) -> the state dict of
    :class:`Wav2Vec2Encoder` with fusion: the prefix stripped, the
    weight norm resolved, keys the encoder has no use for (a CTC head,
    masking or quantizer weights) left out. ``layer_fusion_weights`` seeds
    the fusion logits (zeros, a uniform fusion, when None)."""
    sd = {k.removeprefix("wav2vec2."): np.asarray(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
        for k, v in sd.items()}
    want = Wav2Vec2Encoder(cfg).state_dict().keys()
    pos = "encoder.pos_conv_embed.conv"
    out = {}
    for k in want:
        if k == f"{pos}.weight":
            out[k] = _weight_norm_weight(sd, pos)
        elif k == "layer_fusion_weights":
            n = cfg.num_hidden_layers + 1
            fw = (np.zeros((n,), np.float32) if layer_fusion_weights is None
                  else np.asarray(layer_fusion_weights, np.float32))
            if fw.shape != (n,):
                raise ValueError(f"layer_fusion_weights must be ({n},), "
                                 f"got {fw.shape}")
            out[k] = fw
        elif k in sd:
            out[k] = sd[k]
        else:
            raise ValueError(f"the checkpoint lacks {k!r}")
    return {k: torch.from_numpy(np.array(v, np.float32, copy=True))
            for k, v in out.items()}


def load_hf_checkpoint(path, *, layer_fusion_weights=None
                       ) -> tuple[Wav2Vec2Config, dict]:
    """``(config, state dict)`` of a local HuggingFace checkpoint
    directory: ``config.json`` beside ``model.safetensors`` (read here, no
    ``safetensors`` package needed) or ``pytorch_model.bin``. The state
    dict loads into ``Wav2Vec2Encoder(config)``."""
    path = Path(path)
    cfg = Wav2Vec2Config.from_hf_config(path / "config.json")
    st_path, pt_path = path / "model.safetensors", path / "pytorch_model.bin"
    if st_path.exists():
        sd = read_safetensors(st_path)
    elif pt_path.exists():
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"no model.safetensors or pytorch_model.bin under {path}")
    return cfg, hf_state_dict(sd, cfg, layer_fusion_weights)
