"""The streaming step of one or more sessions, as a function: new state
tensors every frame, in plain PyTorch. Every field of the state may carry
leading lane dims, and the refresh decision is the caller's."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from perfbench.reference import frontend
from perfbench.reference.egemaps import (EgemapsConfig, LldCarry,
                                         compute_lld_block,
                                         functionals_multi_offset,
                                         init_lld_ring, offset_masks,
                                         roll_lld_ring, silence_lld_carry)
from perfbench.reference.emotion import (EmotionFrontendConfig,
                                         emotion_features)
from perfbench.reference.model import (StreamingDualStreamModel,
                                       TemporalState, _ema_step)


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Static streaming parameters (must match the trained model)."""

    sample_rate: int = 16000
    target_fps: int = 30
    window_frames: int = 256          # mel context (8.53 s at 30 fps)
    n_fft: int = 1024
    n_mels: int = 80
    f_min: float = 80.0
    f_max: float = 8000.0
    d_model: int = 256
    num_heads: int = 8
    num_blendshapes: int = 52
    emotion_backend: str = "egemaps"
    use_concatenation: bool = True
    emotion_context_s: float = 20.0   # emotion audio ring length
    emotion_update_frames: int = 9    # ~300 ms at 30 fps
    # incremental eGeMAPS: an LLD ring on the device; each refresh computes
    # only the LLD rows its interval made available. False recomputes the
    # whole context's features at every refresh
    incremental_lld: bool = True
    use_learnable_weights: bool = True
    fusion_temperature: float = 1.0
    # the egemaps refresh's voice quality, as the model's
    # egemaps_per_period: False selects the frame-level jitter and shimmer
    # (no cycle_dsum; the LLD carry holds the last frame's period, voicing
    # and RMS)
    egemaps_per_period: bool = True

    def __post_init__(self):
        if self.emotion_backend != "egemaps" or not self.incremental_lld:
            raise ValueError("the reference streams the incremental egemaps "
                             "refresh only")

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate / self.target_fps)

    @property
    def emotion_config(self) -> EmotionFrontendConfig:
        return EmotionFrontendConfig(
            backend=self.emotion_backend,
            use_concatenation=self.use_concatenation,
            sample_rate=self.sample_rate,
            egemaps_per_period=self.egemaps_per_period)

    @property
    def emotion_margin_samples(self) -> int:
        """Extra ring length for the shifted-window offsets."""
        return int(max(self.emotion_config.window_offsets)
                   * self.sample_rate)

    @property
    def emotion_ring_len(self) -> int:
        n = int(self.emotion_context_s * self.sample_rate) \
            + self.emotion_margin_samples
        return ((n + self.hop_length - 1) // self.hop_length) \
            * self.hop_length

    @property
    def emotion_raw_dim(self) -> int:
        """Width of the cached raw emotion vector."""
        return self.emotion_config.feature_dim

    @property
    def use_lld_ring(self) -> bool:
        """Whether the refresh rolls new LLD rows into an LLD ring (the
        incremental ``egemaps`` refresh) rather than recomputing the
        context's vector."""
        return self.incremental_lld and self.emotion_backend == "egemaps"

    @property
    def emotion_context_samples(self) -> int:
        """Samples a full-context refresh reads: context plus margin."""
        return (int(self.emotion_context_s * self.sample_rate)
                + self.emotion_margin_samples)

    @property
    def egemaps_config(self) -> EgemapsConfig:
        return EgemapsConfig(
            sample_rate=self.sample_rate,
            per_period_voice_quality=self.egemaps_per_period)

    @property
    def lld_ring_rows(self) -> int:
        """LLD rows covering the emotion audio ring (10 ms hop)."""
        return self.emotion_ring_len // self.egemaps_config.hop_length

    @property
    def lld_block_rows(self) -> int:
        """New LLD rows per refresh: the refresh interval in LLD hops."""
        interval = self.emotion_update_frames * self.hop_length
        return max(1, int(round(interval / self.egemaps_config.hop_length)))


@dataclasses.dataclass
class StreamState:
    """All streaming state. ``frame_count`` lives on the host."""

    audio_ring: torch.Tensor     # (ring_len,) newest sample last
    mel_db: torch.Tensor         # (W+1, n_mels) raw dB rows, newest last
    emotion_raw: torch.Tensor    # (D_raw,) cached raw emotion features
    frame_count: int
    temporal: TemporalState      # EMA carry (B=1)
    # the incremental eGeMAPS refresh's state (None unless use_lld_ring)
    lld_ring: Optional[dict]     # {name: (rows, ...)} newest last
    lld_carry: Optional[LldCarry]


def init_stream_state(cfg: StreamingConfig, device=None,
                      lanes: Optional[int] = None) -> StreamState:
    """A fresh stream's state; with ``lanes``, that of ``lanes`` fresh
    streams, every field but ``frame_count`` with a leading lane dim (the
    EMA carry ``(lanes, 52)``). Without ``cfg.use_lld_ring`` the LLD
    ring and carry are ``None``."""
    lead = () if lanes is None else (lanes,)
    ring = cfg.use_lld_ring
    return StreamState(
        audio_ring=torch.zeros(lead + (cfg.emotion_ring_len,), device=device),
        mel_db=torch.full(lead + (cfg.window_frames + 1, cfg.n_mels), -100.0,
                          device=device),
        emotion_raw=torch.zeros(lead + (cfg.emotion_raw_dim,), device=device),
        frame_count=0,
        temporal=TemporalState.create(lanes or 1, cfg.num_blendshapes,
                                      device),
        lld_ring=(init_lld_ring(cfg.lld_ring_rows, device, lanes)
                  if ring else None),
        lld_carry=(silence_lld_carry(cfg.egemaps_config, device, lanes)
                   if ring else None))


def _new_mel_row(cfg: StreamingConfig, ring: torch.Tensor) -> torch.Tensor:
    """dB mel row of the newest computable centered frame of each ring
    ``(..., ring_len)`` -> ``(..., n_mels)``: after exactly ``hop`` samples
    per step its window ends ``(-(n_fft//2)) mod hop`` samples before the
    ring end. One launch of the fused frontend on the GPU, over a view of
    the rings (T = the number of rings; no copy)."""
    offset = (-(cfg.n_fft // 2)) % cfg.hop_length
    end = ring.shape[-1] - offset
    frames = ring[..., end - cfg.n_fft: end]
    db = frontend.frames_to_logmel(frames.reshape(-1, cfg.n_fft),
                                   sample_rate=cfg.sample_rate,
                                   n_mels=cfg.n_mels, f_min=cfg.f_min,
                                   f_max=cfg.f_max)
    return db.reshape(frames.shape[:-1] + (cfg.n_mels,))


def _map_carry(fn, carry: Optional[LldCarry]) -> Optional[LldCarry]:
    if carry is None:
        return None
    return LldCarry(*(None if f is None else fn(f) for f in carry))


def _map_ring(fn, ring: Optional[dict]) -> Optional[dict]:
    return None if ring is None else {k: fn(v) for k, v in ring.items()}


def _stream_pre(state: StreamState, hop_audio: torch.Tensor,
                cfg: StreamingConfig, out=None):
    """Ring shift, one new mel row, per-window ref=max normalization, each
    over the leading (lane) dims of the state: the max is each window's
    own. Returns the new ring and dB rows (written into ``out``, a (ring,
    dB rows) pair of buffers, when given), and ``mel (B, W, n_mels)`` and
    ``detail (B, 3, n_mels)`` (B = 1 for an unbatched state)."""
    ring_out, mel_out = (None, None) if out is None else out
    ring = torch.cat([state.audio_ring[..., cfg.hop_length:], hop_audio], -1,
                     out=ring_out)
    row = _new_mel_row(cfg, ring)
    mel_db = torch.cat([state.mel_db[..., 1:, :], row[..., None, :]], -2,
                       out=mel_out)
    mel, detail = window_from_db(mel_db, cfg)
    return ring, mel_db, mel, detail


def window_from_db(mel_db: torch.Tensor, cfg: StreamingConfig):
    """The model's inputs from the dB rows ``(..., W+1, n_mels)``: each
    window normalized by its own max (ref=max, 80 dB floor), ``mel (B, W,
    n_mels)`` and ``detail (B, 3, n_mels)``."""
    wmax = mel_db.amax(dim=(-2, -1), keepdim=True)
    norm = (torch.clamp_min(mel_db - wmax, -80.0) + 80.0) / 80.0
    norm = norm.reshape((-1,) + norm.shape[-2:])
    mel = norm[:, : cfg.window_frames, :]             # (B, W, n_mels)
    detail = norm[:, -3:, :]                          # (B, 3, n_mels)
    return mel, detail


def head_step(model: StreamingDualStreamModel, mel_db: torch.Tensor,
              emotion_raw: torch.Tensor, prev: torch.Tensor,
              cfg: StreamingConfig) -> torch.Tensor:
    """One step of the model and the EMA from a given state: the dB rows
    after the step ``(B, W+1, n_mels)``, the emotion vector after it ``(B,
    D_raw)`` and the previous step's smoothed blendshapes ``(B, 52)``
    (every lane past its first frame) -> the step's ``(B, 52)``."""
    mel, detail = window_from_db(mel_db, cfg)
    init = torch.ones(prev.shape[0], dtype=torch.bool, device=prev.device)
    out, _ = _ema_step(model(mel, detail, emotion_raw), TemporalState(
        prev=prev, initialized=init), model.alpha())
    return out


def _refresh_tail_len(cfg: StreamingConfig) -> int:
    """Samples at the end of the post-hop audio ring that a refresh
    reads: the LLD block's chunk (its low-pitch left context comes from
    the carry), or the whole context without the LLD ring."""
    if cfg.use_lld_ring:
        return (cfg.lld_block_rows - 1) * cfg.egemaps_config.hop_length \
            + 512
    return cfg.emotion_context_samples


def _stream_refresh(state: StreamState, ring: torch.Tensor,
                    cfg: StreamingConfig, do_refresh: bool,
                    model: Optional[StreamingDualStreamModel] = None):
    """The emotion refresh on refresh frames; otherwise the cached vector.
    ``ring`` is the post-hop audio ring ``(..., ring_len)``, or any view
    of it whose last ``_refresh_tail_len(cfg)`` samples are its end; only
    ``emotion_raw``, ``lld_ring`` and ``lld_carry`` of ``state`` are read,
    with the same leading (lane) dims. Returns
    (emotion_raw, lld_ring, lld_carry)."""
    if not do_refresh:
        return state.emotion_raw, state.lld_ring, state.lld_carry
    if not cfg.use_lld_ring:
        ctx = ring[..., -_refresh_tail_len(cfg):]
        feats = emotion_features(ctx, cfg.emotion_config)
        return feats, state.lld_ring, state.lld_carry
    ecfg = cfg.egemaps_config
    rows = cfg.lld_ring_rows
    block, carry = compute_lld_block(ring[..., -_refresh_tail_len(cfg):],
                                     ecfg, state.lld_carry)
    lld_ring = roll_lld_ring(state.lld_ring, block)
    fp = ecfg.hop_length / ecfg.sample_rate
    offsets = (cfg.emotion_config.window_offsets
               if cfg.use_concatenation else (0.0,))
    cuts = tuple(rows - int(round(off / fp)) for off in offsets)
    masks = offset_masks(rows, cuts, ring.device)
    return functionals_multi_offset(lld_ring, ecfg, masks), lld_ring, carry


def _stream_post(model: StreamingDualStreamModel, mel: torch.Tensor,
                 detail: torch.Tensor, emotion_raw: torch.Tensor,
                 temporal: TemporalState):
    """Emotion projection, dual-stream attention, EMA over ``B`` windows
    (``emotion_raw`` ``(D_raw,)`` for B = 1, or ``(B, D_raw)``). Returns
    the ``(B, 52)`` smoothed blendshapes and the new EMA carry."""
    out = model(mel, detail, emotion_raw.reshape(-1, emotion_raw.shape[-1]))
    return _ema_step(out, temporal, model.alpha())


def stream_frame(model: StreamingDualStreamModel, state: StreamState,
                 hop_audio: torch.Tensor, cfg: StreamingConfig,
                 refresh: bool) -> tuple[torch.Tensor, StreamState]:
    """One frame of every lane of ``state`` (``hop_audio`` ``(B, hop)``):
    ``((B, 52) smoothed blendshapes, new state)``; ``refresh`` runs the
    emotion refresh on every lane."""
    ring, mel_db, mel, detail = _stream_pre(state, hop_audio, cfg)
    emotion_raw, lld_ring, lld_carry = _stream_refresh(state, ring, cfg,
                                                       refresh, model)
    smoothed, temporal = _stream_post(model, mel, detail, emotion_raw,
                                      state.temporal)
    return smoothed, StreamState(
        audio_ring=ring, mel_db=mel_db, emotion_raw=emotion_raw,
        frame_count=state.frame_count + 1, temporal=temporal,
        lld_ring=lld_ring, lld_carry=lld_carry)


def stream_frame_lanes(model: StreamingDualStreamModel, state: StreamState,
                       hop_audio: torch.Tensor, cfg: StreamingConfig,
                       refresh: list) -> tuple[torch.Tensor, StreamState]:
    """:func:`stream_frame` over lanes ``(B, ...)`` of which those in
    ``refresh`` (a list of lane indices) run the emotion refresh."""
    if not refresh:
        return stream_frame(model, state, hop_audio, cfg, False)
    ring, mel_db, mel, detail = _stream_pre(state, hop_audio, cfg)
    idx = torch.tensor(refresh, device=ring.device)
    sub = dataclasses.replace(
        state, emotion_raw=state.emotion_raw[idx],
        lld_ring=_map_ring(lambda v: v[idx], state.lld_ring),
        lld_carry=_map_carry(lambda f: f[idx], state.lld_carry))
    feats, sub_ring, sub_carry = _stream_refresh(sub, ring[idx], cfg, True,
                                                 model)
    emotion_raw = state.emotion_raw.index_copy(0, idx, feats)
    lld_ring = {k: v.index_copy(0, idx, sub_ring[k])
                for k, v in state.lld_ring.items()}
    lld_carry = LldCarry(*(None if f is None else f.index_copy(0, idx, s)
                           for f, s in zip(state.lld_carry, sub_carry)))
    smoothed, temporal = _stream_post(model, mel, detail, emotion_raw,
                                      state.temporal)
    return smoothed, StreamState(
        audio_ring=ring, mel_db=mel_db, emotion_raw=emotion_raw,
        frame_count=state.frame_count + 1, temporal=temporal,
        lld_ring=lld_ring, lld_carry=lld_carry)


def model_for_config(cfg: StreamingConfig) -> StreamingDualStreamModel:
    """A model with the shapes ``cfg`` streams."""
    return StreamingDualStreamModel(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        window_frames=cfg.window_frames, n_mels=cfg.n_mels,
        num_blendshapes=cfg.num_blendshapes,
        emotion_raw_dim=cfg.emotion_raw_dim,
        use_learnable_weights=cfg.use_learnable_weights,
        temperature=cfg.fusion_temperature,
        egemaps_per_period=cfg.egemaps_per_period)
