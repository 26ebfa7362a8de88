"""The dual-stream models: the streaming step's parameters, the
single-window model and the full-utterance sequential decode.

:class:`SequentialDualStreamModel` decodes ``(B, L)`` audio to ``(B, T_out,
52)`` blendshapes: the emotion vector once per utterance, one global
STFT -> mel -> dB of every utterance (the fused frontend), windows of
``W + 1`` dB rows gathered from it at ``stride_frames`` (or per-utterance
``window_starts``), each normalized to its own max, all windows decoded in
one attention batch, then the EMA across windows. With
``window_edge="reflect"`` the first and last ``n_edge`` rows of every
window are replaced by the rows the reference's per-window reflect-padded
STFT gives there: their mirrored frames go through the same fused frontend.
``exact_window_stft=True`` runs that per-window STFT on every window
instead.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from koemorph_tpu_torch.features.emotion import (EmotionFrontendConfig,
                                                 emotion_features)
from koemorph_tpu_torch.features.wav2vec2 import (Wav2Vec2Config,
                                                  Wav2Vec2Encoder,
                                                  lecun_normal)
from koemorph_tpu_torch.models.dual_stream import DualStreamCrossAttention
from koemorph_tpu_torch.ops import frontend
from koemorph_tpu_torch.ops.device_cache import device_cache


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


#: the in-model encoder of the ``emotion2vec`` backend: a compact
#: trainable wav2vec2 with the 1024-D contract (a checkpoint's config
#: replaces it when pretrained weights are loaded)
EMOTION2VEC_CONFIG = Wav2Vec2Config(hidden_size=1024, num_hidden_layers=2,
                                    num_attention_heads=16,
                                    intermediate_size=2048)


class StreamingDualStreamModel(nn.Module):
    """What the streaming step reads of a trained model: the raw-emotion
    projection (e.g. 264 -> d_model), the dual-stream attention, the
    learnable EMA coefficient ``sigmoid(smoothing_alpha)``, and for the
    ``emotion2vec`` backend the wav2vec2 encoder ``emotion2vec`` (its
    fused features' time mean is the raw emotion vector, ``hidden_size``
    wide). Its state dict is what
    :func:`koemorph_tpu_torch.utils.params.state_dict_from_flax` makes of
    a ``SimplifiedDualStreamModel`` parameter tree. ``dropout`` is 0 for
    serving; the trainable models pass theirs. ``egemaps_per_period``
    (no parameter) records the eGeMAPS voice-quality tier the model was
    trained with, which a stream of it must use
    (:meth:`~koemorph_tpu_torch.runtime.streaming.StreamingConfig.
    from_model`)."""

    def __init__(self, *, d_model: int = 256, num_heads: int = 8,
                 window_frames: int = 256, n_mels: int = 80,
                 num_blendshapes: int = 52, emotion_raw_dim: int = 264,
                 use_learnable_weights: bool = True,
                 temperature: float = 1.0, dropout: float = 0.0,
                 smoothing_alpha_init: float = 0.8,
                 emotion_backend: str = "egemaps",
                 emotion2vec_config: Wav2Vec2Config = EMOTION2VEC_CONFIG,
                 egemaps_per_period: bool = True):
        super().__init__()
        self.smoothing_alpha_init = smoothing_alpha_init
        self.egemaps_per_period = egemaps_per_period
        self.emotion_backend = emotion_backend
        self.emotion2vec_config = emotion2vec_config
        self.d_model, self.num_heads = d_model, num_heads
        self.num_blendshapes = num_blendshapes
        self.use_learnable_weights = use_learnable_weights
        self.fusion_temperature = temperature
        if emotion_backend == "emotion2vec":
            self.emotion2vec = Wav2Vec2Encoder(emotion2vec_config,
                                               use_layer_fusion=True)
            emotion_raw_dim = emotion2vec_config.hidden_size
        self.emotion_projection = nn.Linear(emotion_raw_dim, d_model)
        self.dual_stream_attention = DualStreamCrossAttention(
            d_model=d_model, num_heads=num_heads, num_mel_channels=n_mels,
            mel_sequence_length=window_frames, mel_temporal_frames=3,
            emotion_dim=d_model, dropout=dropout,
            num_blendshapes=num_blendshapes,
            use_learnable_weights=use_learnable_weights,
            temperature=temperature)
        self.smoothing_alpha = nn.Parameter(torch.tensor(smoothing_alpha_init))

    def forward(self, mel: torch.Tensor, detail: torch.Tensor,
                emotion_raw: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, W, n_mels), (B, 3, n_mels), (B, D_raw) -> (B, 52) unsmoothed
        blendshapes; a ``generator`` turns on dropout in training mode."""
        return self.decode(mel, detail, emotion_raw,
                           generator=generator)["blendshapes"]

    def decode(self, mel: torch.Tensor, detail: torch.Tensor,
               emotion_raw: torch.Tensor, return_attention: bool = False,
               generator: Optional[torch.Generator] = None) -> dict:
        """The attention's output dict (:class:`DualStreamCrossAttention`)
        for (B, W, n_mels), (B, 3, n_mels) and (Be, D_raw) inputs."""
        emotion = self.emotion_projection(emotion_raw)
        return self.dual_stream_attention(
            mel, detail, emotion, return_attention=return_attention,
            generator=generator)

    def alpha(self) -> torch.Tensor:
        return torch.sigmoid(self.smoothing_alpha)

    def encode_emotion(self, audio: torch.Tensor) -> torch.Tensor:
        """The ``emotion2vec`` backend's raw emotion vector: the time mean
        of the encoder's fused features, ``(B, L) -> (B, hidden)``."""
        return self.emotion2vec(audio).mean(-2)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights with the Flax initializers' distributions: LeCun
        truncated normal for dense kernels, N(0, 0.02) for the learned
        queries, Xavier uniform for the packed in-projections, zero biases,
        unit norms, stream weights 2.0 / 0.5 toward their own stream, and
        ``smoothing_alpha`` at ``smoothing_alpha_init``; then the
        ``emotion2vec`` encoder's (:meth:`Wav2Vec2Encoder.init_random`).
        Drawn on the CPU from ``generator``."""
        for name, mod in self.named_modules():
            if name.startswith("emotion2vec"):
                continue
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(lecun_normal(tuple(mod.weight.shape),
                                              mod.in_features, generator))
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
        self.smoothing_alpha.fill_(self.smoothing_alpha_init)
        if self.emotion_backend == "emotion2vec":
            self.emotion2vec.init_random(generator)


class SimplifiedDualStreamModel(StreamingDualStreamModel):
    """Single-window model: ``(B, L)`` audio -> ``(B, 52)`` blendshapes, the
    mel and emotion frontends inside the forward. Its state dict is that of
    :class:`StreamingDualStreamModel`. ``dropout`` (attention weights and
    the decoder head) acts in training mode on calls given a
    ``generator``. With ``emotion_backend="emotion2vec"`` the raw emotion
    vector comes from the model's own encoder (``emotion2vec_config``),
    trained with the rest. ``egemaps_per_period=False`` selects the
    eGeMAPS frame-level jitter and shimmer; ``stft_method`` ``"rfft"`` the
    ``torch.fft.rfft`` mel frontend (the default ``"matmul"`` runs the
    fused kernel)."""

    def __init__(self, *, d_model: int = 256, num_heads: int = 8,
                 num_blendshapes: int = 52, sample_rate: int = 16000,
                 target_fps: int = 30, mel_sequence_length: int = 256,
                 emotion_backend: str = "egemaps",
                 use_concatenation: bool = True,
                 egemaps_per_period: bool = True,
                 stft_method: str = "matmul",
                 use_learnable_weights: bool = True,
                 fusion_temperature: float = 1.0, dropout: float = 0.1,
                 smoothing_alpha_init: float = 0.8,
                 emotion2vec_config: Wav2Vec2Config = EMOTION2VEC_CONFIG):
        emotion_cfg = EmotionFrontendConfig(
            backend=emotion_backend, use_concatenation=use_concatenation,
            sample_rate=sample_rate, egemaps_per_period=egemaps_per_period)
        mel_frontend = frontend.LogMelFrontend(
            sample_rate=sample_rate, target_fps=float(target_fps),
            n_fft=1024, n_mels=80, f_min=80.0, f_max=8000.0,
            stft_method=stft_method)
        super().__init__(d_model=d_model, num_heads=num_heads,
                         window_frames=mel_sequence_length, n_mels=80,
                         num_blendshapes=num_blendshapes,
                         emotion_raw_dim=emotion_cfg.feature_dim,
                         use_learnable_weights=use_learnable_weights,
                         temperature=fusion_temperature, dropout=dropout,
                         smoothing_alpha_init=smoothing_alpha_init,
                         emotion_backend=emotion_backend,
                         emotion2vec_config=emotion2vec_config,
                         egemaps_per_period=egemaps_per_period)
        self.emotion_config = emotion_cfg
        self.stft_method = stft_method
        self.mel_frontend = mel_frontend
        self.sample_rate = sample_rate
        self.target_fps = target_fps
        self.mel_sequence_length = mel_sequence_length

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate / self.target_fps)

    def emotion_raw(self, audio: torch.Tensor) -> torch.Tensor:
        """Raw emotion features of ``audio (B, L)``: ``(B, D_raw)``."""
        if self.emotion_backend == "emotion2vec":
            return self.encode_emotion(audio)
        return emotion_features(audio, self.emotion_config)

    def forward(self, audio: torch.Tensor,
                state: Optional[TemporalState] = None,
                emotion_features_raw: Optional[torch.Tensor] = None,
                return_attention: bool = False,
                generator: Optional[torch.Generator] = None):
        """``{"blendshapes": (B, 52)}``, and the new EMA state when
        ``state`` is given (then the blendshapes are smoothed). In training
        mode a ``generator`` draws the dropout masks. ``return_attention``
        adds the attention's head-averaged weights and per-stream
        blendshapes (:class:`DualStreamCrossAttention`)."""
        mel, detail = frontend.mel_with_temporal_detail(audio,
                                                        self.mel_frontend)
        if emotion_features_raw is None:
            emotion_features_raw = self.emotion_raw(audio)
        out = self.decode(mel, detail, emotion_features_raw,
                          return_attention=return_attention,
                          generator=generator)
        if state is not None:
            out["blendshapes"], state = _ema_step(out["blendshapes"], state,
                                                  self.alpha())
            return out, state
        return out


def _n_edge_frames(n_fft: int, hop: int) -> int:
    """Frames at each window end whose reflect-padded support differs from
    the global STFT: frame ``f`` reaches before the window start while
    ``f * hop < n_fft // 2`` (symmetrically at the end)."""
    return -(-(n_fft // 2) // hop)


@functools.lru_cache(maxsize=8)
def _edge_offsets_np(n_fft: int, hop: int, w_hop: int) -> np.ndarray:
    """Sample offsets, from the window start, of the reflect-padded edge
    frames of a ``w_hop``-sample window: ``(2 * n_edge, n_fft)``, head
    frames ``0..n_edge-1`` then tail frames ``W-n_edge+1..W``. librosa
    reflects without repeating the edge sample."""
    half = n_fft // 2
    n_edge = _n_edge_frames(n_fft, hop)
    i = np.arange(n_fft)
    rows = []
    for f in range(n_edge):                      # head: about sample 0
        rows.append(np.abs(f * hop - half + i))
    for f in range(n_edge):                      # tail: about w_hop - 1
        r = w_hop - (n_edge - 1 - f) * hop - half + i
        rows.append(np.where(r >= w_hop, 2 * (w_hop - 1) - r, r))
    return np.stack(rows).astype(np.int64)


@device_cache(8)
def _edge_offsets(n_fft: int, hop: int, w_hop: int, device: torch.device
                  ) -> torch.Tensor:
    return torch.from_numpy(_edge_offsets_np(n_fft, hop, w_hop)).to(device)


@device_cache(32)
def _index_grid(first: int, n: int, step: int, width: int,
                device: torch.device) -> torch.Tensor:
    """``(n, width)`` int64 on ``device``, row ``i`` ``(first + i) * step +
    arange(width)``: built once per key, so a decode copies no index grid
    from the host (a copy that waits for the device, and that a CUDA graph
    cannot capture)."""
    rows = (first + np.arange(n, dtype=np.int64)) * step
    return torch.from_numpy(rows[:, None] + np.arange(width)[None, :]).to(
        device)


def _reflect_edge_rows(audio: torch.Tensor, p, w_hop: int, n_fft: int,
                       hop: int, *, sample_rate: int = 16000,
                       n_mels: int = 80, f_min: float = 80.0,
                       f_max: float = 8000.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reflect-padded dB mel rows of each window's two edges.

    ``audio`` is ``(B, L)``; ``p`` the window starts in samples, an
    ``(n,)`` grid shared by the batch (numpy, or a tensor on the audio's
    device) or a ``(B, n)`` integer tensor. The
    mirrored ``(n_fft,)`` edge frames are gathered from the audio and sent,
    heads and tails together, through ``frontend.frames_to_logmel`` (one
    launch of the fused frontend on the GPU). Returns ``(head_db,
    tail_db)``, each ``(B, n, n_edge, n_mels)``, for window frames
    ``0..n_edge-1`` and ``W-n_edge+1..W``."""
    b = audio.shape[0]
    n_edge = _n_edge_frames(n_fft, hop)
    offs = _edge_offsets(n_fft, hop, w_hop, audio.device)
    if isinstance(p, np.ndarray):
        p = torch.from_numpy(p.astype(np.int64)).to(audio.device)
    if p.dim() == 1:
        frames = audio[:, p[:, None, None] + offs]     # (B, n, 2ne, n_fft)
    else:
        n = p.shape[1]
        idx = p.to(torch.int64)[:, :, None, None] + offs
        frames = torch.gather(audio, 1, idx.reshape(b, -1)).reshape(
            b, n, 2 * n_edge, n_fft)
    db = frontend.frames_to_logmel(frames, sample_rate=sample_rate,
                                   n_mels=n_mels, f_min=f_min, f_max=f_max)
    return db[:, :, :n_edge], db[:, :, n_edge:]


_EMA_MATMUL_MAX_T = 2048


def _ema_associative(x_seq: torch.Tensor, alpha: torch.Tensor
                     ) -> torch.Tensor:
    """EMA ``s_t = alpha x_t + (1 - alpha) s_{t-1}``, ``s_0 = x_0``, over
    axis 0. Up to ``_EMA_MATMUL_MAX_T`` steps as one lower-triangular decay
    product; longer sequences as a log-depth scan of the affine maps."""
    t = x_seq.shape[0]
    dt = x_seq.dtype
    a = alpha.to(dt)
    if t <= _EMA_MATMUL_MAX_T:
        idx = torch.arange(t, device=x_seq.device)
        diff = idx[:, None] - idx[None, :]
        decay = torch.pow(1.0 - a, torch.clamp_min(diff, 0).to(dt))
        w = torch.where(diff >= 0, decay * a, torch.zeros((), dtype=dt,
                                                          device=a.device))
        # column 0 carries s_0 = x_0 (no alpha factor on the first frame)
        w = torch.cat([decay[:, :1], w[:, 1:]], 1)
        return torch.matmul(w, x_seq.reshape(t, -1)).reshape(x_seq.shape)
    # inclusive scan of the maps s -> a_t s + b_t, earlier map first
    shape = (t,) + (1,) * (x_seq.ndim - 1)
    mul = (1.0 - a).expand(shape).clone()
    mul[0] = 0.0
    add = torch.cat([x_seq[:1], a * x_seq[1:]], 0)
    mul = mul.expand(x_seq.shape)
    d = 1
    while d < t:
        add = torch.cat([add[:d], add[:-d] * mul[d:] + add[d:]], 0)
        mul = torch.cat([mul[:d], mul[:-d] * mul[d:]], 0)
        d *= 2
    return add


def _ema_smooth(raw_seq: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The decode's smoothing tail over ``(n, ..., 52)`` window outputs:
    the EMA values from :func:`_ema_associative`, then each step recomputed
    in one-step form from the detached previous value; the first window
    passes through."""
    s = _ema_associative(raw_seq, alpha)
    s_prev = torch.cat([raw_seq[:1], s[:-1]], 0).detach()
    smoothed = alpha * raw_seq + (1 - alpha) * s_prev
    return torch.cat([raw_seq[:1], smoothed[1:]], 0)


class SequentialDualStreamModel(SimplifiedDualStreamModel):
    """Full-utterance decoding: ``(B, L)`` audio -> ``(B, T_out, 52)``.

    ``decode_mode`` ``"parallel"`` decodes every window in one attention
    batch; ``"chunked"`` (alias ``"scan"``) in batches of ``window_chunk``
    windows. ``window_edge`` ``"reflect"`` splices the reference's
    reflect-padded window-edge rows into the global-STFT windows;
    ``"interior"`` keeps the global rows."""

    def __init__(self, *, stride_frames: int = 1,
                 decode_mode: str = "parallel", window_chunk: int = 512,
                 exact_window_stft: bool = False,
                 window_edge: str = "reflect", **kw):
        super().__init__(**kw)
        if stride_frames < 1:
            raise ValueError(f"stride_frames must be >= 1, got "
                             f"{stride_frames}")
        if decode_mode not in ("parallel", "chunked", "scan"):
            raise ValueError(f"decode_mode must be 'parallel', 'chunked' or "
                             f"'scan', got {decode_mode!r}")
        if window_edge not in ("reflect", "interior"):
            raise ValueError(f"window_edge must be 'reflect' or 'interior', "
                             f"got {window_edge!r}")
        self.stride_frames = stride_frames
        self.decode_mode = decode_mode
        self.window_chunk = window_chunk
        self.exact_window_stft = exact_window_stft
        self.window_edge = window_edge

    @property
    def window_frames(self) -> int:
        return self.mel_sequence_length

    def forward(self, audio: torch.Tensor,
                emotion_features_raw: Optional[torch.Tensor] = None,
                return_attention: bool = False,
                window_starts=None, return_raw: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        """``window_starts`` (``(n,)`` or per-utterance ``(B, n)`` frame
        indices, each ``<= L // hop - window_frames``, rows in time order)
        overrides the ``stride_frames`` grid; it needs the global STFT.
        ``return_raw`` adds the pre-smoothing window outputs as
        ``raw_blendshapes``; ``return_attention`` each window's
        head-averaged attention weights, ``mel_attention_weights`` (B,
        T_out, 28, n_mels) and ``emotion_attention_weights`` (B, T_out,
        24, 1), taken before dropout. In training mode a ``generator``
        draws the dropout masks, and each window then gets its own row of
        the emotion vector, so no two windows share a mask. The mel
        frontend here is the fused kernel whatever ``stft_method`` says
        (as in the reference, whose decode ignores it)."""
        b, audio_len = audio.shape
        hop = self.hop_length
        num_frames = audio_len // hop
        w = self.window_frames
        stride = self.stride_frames
        dev = audio.device
        if window_starts is not None and self.exact_window_stft:
            raise ValueError("window_starts requires the global-STFT path "
                             "(exact_window_stft=False)")
        ws = None
        if window_starts is not None:
            # a tensor on the device is used in place (no host copy: a
            # captured decode reads its starts from a static buffer)
            ws = (window_starts.to(dev, torch.int64)
                  if isinstance(window_starts, torch.Tensor)
                  else torch.as_tensor(window_starts, dtype=torch.int64,
                                       device=dev))
            if ws.dim() == 1:
                ws = ws[None].expand(b, -1)
            n_out = ws.shape[-1]
        else:
            n_out = max(1, (num_frames - w) // stride + 1)

        if emotion_features_raw is None:
            emotion_features_raw = self.emotion_raw(audio)
        emotion = self.emotion_projection(emotion_features_raw)   # (B, d)

        # pad so the last window has a full frame count
        if ws is None:
            needed = ((n_out - 1) * stride + w) * hop
            if needed > audio_len:
                audio = nn.functional.pad(audio, (0, needed - audio_len))
        cfg = self.mel_frontend
        mel_kw = cfg.logmel_kwargs()
        if self.exact_window_stft:
            # every window STFT'd on its own, reflect-padded at its edges
            g = (torch.arange(n_out, device=dev)[:, None] * (stride * hop)
                 + torch.arange(w * hop, device=dev)[None, :])
            win_audio = audio[:, g].reshape(b * n_out, w * hop)
            log_mel = frontend.fused_log_mel_frontend(
                win_audio, n_fft=cfg.n_fft, hop_length=hop, **mel_kw
            ).reshape(b, n_out, w + 1, cfg.n_mels)
        else:
            log_mel = frontend.fused_log_mel_frontend(
                audio, n_fft=cfg.n_fft, hop_length=hop, **mel_kw)

        def splice(windows, starts_samples):
            """Replace each window's first/last n_edge rows (in place, in
            the freshly gathered windows) by the reflect-padded rows. The
            windows are a function of the audio alone and never require
            grad, so the in-place write is safe in training too."""
            e0, ew = _reflect_edge_rows(audio, starts_samples, w * hop,
                                        cfg.n_fft, hop, **mel_kw)
            ne = e0.shape[2]
            windows[:, :, :ne] = e0
            windows[:, :, w + 1 - ne:] = ew
            return windows

        dropping = generator is not None and self.training
        weight_keys = ("mel_attention_weights", "emotion_attention_weights")

        def attend(windows):
            """(B, n, W+1, n_mels) raw dB -> (n, B, 52) raw outputs, and
            with ``return_attention`` the weights, (B, n, queries, keys)."""
            n = windows.shape[1]
            wmax = windows.amax(dim=(-2, -1), keepdim=True)
            norm = (torch.clamp_min(windows - wmax, -80.0) + 80.0) / 80.0
            out = self.dual_stream_attention(
                norm[:, :, :w].reshape(b * n, w, cfg.n_mels),
                norm[:, :, -3:].reshape(b * n, 3, cfg.n_mels),
                emotion.repeat_interleave(n, 0) if dropping else emotion,
                return_attention=return_attention, generator=generator)
            raw = out["blendshapes"].reshape(b, n, -1).transpose(0, 1)
            return raw, {k: out[k].reshape((b, n) + out[k].shape[1:])
                         for k in weight_keys if k in out}

        def decode_windows(first: int, n: int):
            """Windows ``first .. first + n - 1`` of the stride grid."""
            if self.exact_window_stft:
                return attend(log_mel[:, first:first + n])
            g = _index_grid(first, n, stride, w + 1, dev)
            windows = log_mel[:, g]                      # (B, n, W+1, 80)
            if self.window_edge == "reflect":
                windows = splice(
                    windows, _index_grid(first, n, stride * hop, 1, dev)[:, 0])
            return attend(windows)

        if ws is not None:
            n = ws.shape[1]
            g = ws[:, :, None] + torch.arange(w + 1, device=dev)
            windows = torch.gather(
                log_mel, 1,
                g.reshape(b, -1, 1).expand(-1, -1, cfg.n_mels)
            ).reshape(b, n, w + 1, cfg.n_mels)
            if self.window_edge == "reflect":
                windows = splice(windows, ws * hop)
            raw_seq, extras = attend(windows)
        elif self.decode_mode == "parallel" or n_out <= self.window_chunk:
            raw_seq, extras = decode_windows(0, n_out)
        else:
            chunk = self.window_chunk
            parts = [decode_windows(lo, min(chunk, n_out - lo))
                     for lo in range(0, n_out, chunk)]
            raw_seq = torch.cat([r for r, _ in parts], 0)
            extras = {k: torch.cat([ex[k] for _, ex in parts], 1)
                      for k in parts[0][1]}

        smoothed = _ema_smooth(raw_seq, self.alpha())
        results = {"blendshapes": smoothed.transpose(0, 1),
                   "num_frames": n_out, "fps": self.target_fps}
        if return_raw:
            results["raw_blendshapes"] = raw_seq.transpose(0, 1)
        results.update(extras)
        return results
