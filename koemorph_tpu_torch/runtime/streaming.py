"""Real-time streaming inference: one frame per hop, state on the device.

Each 33 ms frame (:func:`stream_frame`):

1. shifts ``hop`` new samples into the audio ring (the emotion context),
2. computes the ONE new mel row the hop makes available (the fused
   STFT -> mel -> dB function at T = 1) and rolls it into the raw-dB ring,
3. normalizes the window (``power_to_db ref=max``: subtract the window
   max, so keeping raw dB rows makes the incremental update exact),
4. every ``emotion_update_frames`` frames refreshes the emotion vector:
   for ``egemaps`` (incremental, the default) LLD rows for the newest
   audio only, rolled into an LLD ring, then functionals over the ring
   under three offset masks (264-D); otherwise, for ``basic``,
   ``emotion2vec`` and ``egemaps`` with ``incremental_lld=False``, the
   vector of the ring's last 20.6 s (context plus the offsets' margin)
   computed anew: the emotion features, or the time mean of the model's
   wav2vec2 encoder over it,
5. runs the dual-stream attention decode and the learnable-alpha EMA.

The refresh decision is a host-side branch on a host-side frame counter,
so no frame reads anything back from the device to decide it.

:func:`stream_frame` is the functional step (new state tensors each
frame). :class:`StreamingInference` runs the same function in place on
static buffers (:class:`StaticStream`, :func:`stream_step_`), so that on
the card each frame is one replay of a CUDA graph
(:mod:`koemorph_tpu_torch.runtime.graphs`), one graph per branch (refresh
or not) and buffer parity.

Mel row ``t`` is the STFT frame centered at ``t*hop`` from real samples
only (no reflect padding), so the stream runs one frame behind the newest
audio.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.features.emotion import (EmotionFrontendConfig,
                                                 emotion_features)
from koemorph_tpu_torch.features.wav2vec2 import Wav2Vec2Config
from koemorph_tpu_torch.models.dual_stream_model import (
    EMOTION2VEC_CONFIG, StreamingDualStreamModel, TemporalState, _ema_step)
from koemorph_tpu_torch.ops.egemaps import (EgemapsConfig, LldCarry,
                                            compute_lld_block,
                                            functionals_multi_offset,
                                            init_lld_ring, offset_masks,
                                            roll_lld_ring, silence_lld_carry)
from koemorph_tpu_torch.ops import frontend
from koemorph_tpu_torch.runtime.graphs import StepGraphs
from koemorph_tpu_torch.utils import spans

logger = logging.getLogger(__name__)

__all__ = ["STAGES", "StreamingConfig", "StreamState", "StaticStream",
           "StreamingInference", "init_stream_state", "stream_frame",
           "stream_step_", "model_for_config"]


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
    # the emotion2vec backend's encoder: it re-runs over the whole context
    # at every refresh (bidirectional, so no incremental form); must match
    # the trained model's
    emotion2vec_config: Wav2Vec2Config = EMOTION2VEC_CONFIG
    # the egemaps refresh's voice quality, as the model's
    # egemaps_per_period: False selects the frame-level jitter and shimmer
    # (no cycle_dsum; the LLD carry holds the last frame's period, voicing
    # and RMS)
    egemaps_per_period: bool = True

    def __post_init__(self):
        if self.emotion_backend not in ("egemaps", "basic", "emotion2vec"):
            raise ValueError(
                f"streaming supports emotion_backend 'egemaps', 'basic' "
                f"or 'emotion2vec', got {self.emotion_backend!r}")

    @classmethod
    def from_model(cls, model, **overrides) -> "StreamingConfig":
        """The config that streams a ``SimplifiedDualStreamModel``'s
        settings (its fusion knobs, encoder and eGeMAPS voice-quality tier
        included)."""
        kw = dict(
            sample_rate=model.sample_rate, target_fps=model.target_fps,
            window_frames=model.mel_sequence_length,
            d_model=model.d_model, num_heads=model.num_heads,
            num_blendshapes=model.num_blendshapes,
            emotion_backend=model.emotion_backend,
            use_concatenation=model.emotion_config.use_concatenation,
            use_learnable_weights=model.use_learnable_weights,
            fusion_temperature=model.fusion_temperature,
            emotion2vec_config=model.emotion2vec_config,
            egemaps_per_period=model.egemaps_per_period)
        kw.update(overrides)
        return cls(**kw)

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
        if self.emotion_backend == "emotion2vec":
            return self.emotion2vec_config.hidden_size
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


def model_for_config(cfg: StreamingConfig) -> StreamingDualStreamModel:
    """An (uninitialized) model with the shapes ``cfg`` streams."""
    return StreamingDualStreamModel(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        window_frames=cfg.window_frames, n_mels=cfg.n_mels,
        num_blendshapes=cfg.num_blendshapes,
        emotion_raw_dim=cfg.emotion_raw_dim,
        use_learnable_weights=cfg.use_learnable_weights,
        temperature=cfg.fusion_temperature,
        emotion_backend=cfg.emotion_backend,
        emotion2vec_config=cfg.emotion2vec_config,
        egemaps_per_period=cfg.egemaps_per_period)


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
    spans.mark("ring")
    row = _new_mel_row(cfg, ring)
    mel_db = torch.cat([state.mel_db[..., 1:, :], row[..., None, :]], -2,
                       out=mel_out)
    wmax = mel_db.amax(dim=(-2, -1), keepdim=True)
    norm = (torch.clamp_min(mel_db - wmax, -80.0) + 80.0) / 80.0
    spans.mark("mel")
    norm = norm.reshape((-1,) + norm.shape[-2:])
    mel = norm[:, : cfg.window_frames, :]             # (B, W, n_mels)
    detail = norm[:, -3:, :]                          # (B, 3, n_mels)
    return ring, mel_db, mel, detail


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
    with the same leading (lane) dims. The ``emotion2vec`` backend runs
    ``model``'s encoder once over every lane's context. Returns
    (emotion_raw, lld_ring, lld_carry)."""
    if not do_refresh:
        return state.emotion_raw, state.lld_ring, state.lld_carry
    if not cfg.use_lld_ring:
        ctx = ring[..., -_refresh_tail_len(cfg):]
        if cfg.emotion_backend == "emotion2vec":
            feats = model.encode_emotion(ctx.reshape(-1, ctx.shape[-1]))
            feats = feats.reshape(ctx.shape[:-1] + feats.shape[-1:])
        else:
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
                 update_every: Optional[int] = None
                 ) -> tuple[dict, StreamState]:
    """One frame: ``({"blendshapes": (52,)}, new state)``.

    ``update_every`` overrides the refresh cadence; ``0`` disables the
    refresh. With the LLD ring each refresh rolls a block sized for
    ``cfg.emotion_update_frames``, so any other cadence than 0, 1 or that
    one would gap or overlap the ring's timeline and is rejected.
    """
    if update_every is None:
        update_every = cfg.emotion_update_frames
    elif cfg.use_lld_ring and update_every not in (
            0, 1, cfg.emotion_update_frames):
        raise ValueError(
            f"update_every={update_every} would corrupt the incremental "
            f"LLD ring timeline (block geometry is fixed by "
            f"cfg.emotion_update_frames={cfg.emotion_update_frames}); "
            "set the cadence in StreamingConfig instead")
    do_refresh = (update_every > 0
                  and state.frame_count % update_every == 0)
    ring, mel_db, mel, detail = _stream_pre(state, hop_audio, cfg)
    emotion_raw, lld_ring, lld_carry = _stream_refresh(state, ring, cfg,
                                                       do_refresh, model)
    smoothed, temporal = _stream_post(model, mel, detail, emotion_raw,
                                      state.temporal)
    return {"blendshapes": smoothed[0]}, StreamState(
        audio_ring=ring, mel_db=mel_db, emotion_raw=emotion_raw,
        frame_count=state.frame_count + 1, temporal=temporal,
        lld_ring=lld_ring, lld_carry=lld_carry)


#: the stages of a step in the span registry's ``serve`` track: int16 to
#: float (the server's), the audio ring's shift, the mel row with the
#: dB rows' shift and normalisation, the due cohorts' refresh, and the
#: model with the EMA carry (the track's end)
STAGES = ("ingest", "ring", "mel", "refresh", "model")


def stream_step_(model: StreamingDualStreamModel, state: StreamState,
                 out: tuple, hop_audio: torch.Tensor, cfg: StreamingConfig,
                 refresh: Sequence = ()) -> torch.Tensor:
    """One frame of ``state``'s stream (or lanes) in place: the function
    of :func:`stream_frame`, in a form a CUDA graph can replay. The new
    audio ring and dB rows go to ``out``, a (ring, dB rows) pair of
    buffers (a shift cannot run in place); the lanes indexed by each entry
    of ``refresh`` (``...`` for all of them) run the emotion refresh, and
    their results are written back into ``state``'s refresh fields in
    place, as the new EMA carry is into ``state.temporal``.
    ``state.frame_count`` is neither read nor advanced. Returns the
    ``(B, 52)`` blendshapes. Inside an open ``serve`` track of the span
    registry (:data:`STAGES`) it stamps the ends of ``ring``, ``mel`` and
    each cohort's ``refresh``; the track's end stamps ``model``."""
    ring, _, mel, detail = _stream_pre(state, hop_audio, cfg, out)
    for lanes in refresh:
        cohort = dataclasses.replace(
            state, emotion_raw=state.emotion_raw[lanes],
            lld_ring=_map_ring(lambda v: v[lanes], state.lld_ring),
            lld_carry=_map_carry(lambda f: f[lanes], state.lld_carry))
        feats, lld_ring, carry = _stream_refresh(cohort, ring[lanes], cfg,
                                                 True, model)
        state.emotion_raw[lanes] = feats
        if lld_ring is not None:
            for k, v in lld_ring.items():
                state.lld_ring[k][lanes] = v
            for dst, src in zip(state.lld_carry, carry):
                if dst is not None:
                    dst[lanes] = src
        spans.mark("refresh")
    smoothed, temporal = _stream_post(model, mel, detail, state.emotion_raw,
                                      state.temporal)
    state.temporal.prev.copy_(temporal.prev)
    state.temporal.initialized.copy_(temporal.initialized)
    return smoothed


class StaticStream:
    """A stream's state (or a server's lanes) in static buffers, stepped
    in place by :func:`stream_step_`.

    ``state`` holds the current buffers; its ``frame_count`` lives on the
    host. A shift cannot run in place (its source and destination
    overlap), so the audio ring and the dB rows have two buffers each: a
    step of parity ``p`` reads buffer ``p`` and writes buffer ``1 - p``,
    and no step copies a ring (84 MB at 64 sessions) a second time. Every
    other field has one buffer, written in place."""

    def __init__(self, state: StreamState):
        self.state = state
        self.parity = 0
        rings = (state.audio_ring, state.audio_ring.clone())
        mels = (state.mel_db, state.mel_db.clone())
        self._rings, self._mels = rings, mels
        self._views = tuple(
            (dataclasses.replace(state, audio_ring=rings[p], mel_db=mels[p]),
             (rings[1 - p], mels[1 - p])) for p in (0, 1))

    def buffers(self, parity: int) -> tuple[StreamState, tuple]:
        """``(state, out)`` of a step of ``parity``: the state it reads
        (and whose other fields it writes) and the (ring, dB rows) pair it
        writes."""
        return self._views[parity]

    def scratch(self) -> tuple[StreamState, tuple]:
        """``(state, out)`` for a warm-up step that leaves this stream as
        it was: it reads the current ring and dB rows, and every buffer it
        writes is a copy."""
        st = self.state
        return (dataclasses.replace(
            st, emotion_raw=st.emotion_raw.clone(),
            temporal=TemporalState(prev=st.temporal.prev.clone(),
                                   initialized=st.temporal.initialized.clone()),
            lld_ring=_map_ring(torch.clone, st.lld_ring),
            lld_carry=_map_carry(torch.clone, st.lld_carry)),
            (st.audio_ring.clone(), st.mel_db.clone()))

    def advance(self) -> None:
        """After a step: its output buffers become the current ones."""
        self.parity ^= 1
        self.state.audio_ring = self._rings[self.parity]
        self.state.mel_db = self._mels[self.parity]
        self.state.frame_count += 1

    def write_fresh(self, fresh: StreamState, lanes=...) -> None:
        """Write ``fresh``'s fields into the current buffers at ``lanes``
        (``...``: all; or an index of lanes, ``fresh`` with one lane
        broadcast over them), in place."""
        st = self.state
        pairs = [(st.audio_ring, fresh.audio_ring), (st.mel_db, fresh.mel_db),
                 (st.emotion_raw, fresh.emotion_raw),
                 (st.temporal.prev, fresh.temporal.prev),
                 (st.temporal.initialized, fresh.temporal.initialized),
                 *((st.lld_ring[k], fresh.lld_ring[k])
                   for k in st.lld_ring or ()),
                 *((d, s) for d, s in zip(st.lld_carry or (),
                                          fresh.lld_carry or ())
                   if d is not None)]
        for dst, src in pairs:
            dst[lanes] = src


class StreamingInference:
    """Host-facing real-time engine: hop-sized re-chunking, the device
    step, and frame-time accounting (avg/max frame time, realtime factor).

    The step runs in place on static buffers (:class:`StaticStream`). On
    the card it is one CUDA graph replay per frame, a graph per branch
    (refresh or not) and buffer parity, captured by :meth:`warmup` or at
    the first frame; ``graphs=False`` runs it eagerly, and the CPU has no
    graphs (``graphs=True`` there raises ``ValueError``). Each returned
    frame is a fresh tensor that no later step writes. Runs on ``cuda``
    unless ``device`` says otherwise; raises when CUDA is asked for and
    absent.
    """

    def __init__(self, model: StreamingDualStreamModel,
                 cfg: StreamingConfig = StreamingConfig(),
                 device: DeviceLike = None, graphs: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.step_graphs = StepGraphs(self.device, graphs)
        with torch.inference_mode():
            self._static = StaticStream(init_stream_state(cfg, self.device))
            self._hop = torch.zeros((cfg.hop_length,), device=self.device)
        self._pending = np.zeros((0,), np.float32)
        self.frame_times: deque[float] = deque(maxlen=300)
        self.frames_emitted = 0

    @property
    def state(self) -> StreamState:
        """The current state (static buffers, ``frame_count`` on the
        host)."""
        return self._static.state

    def reset(self) -> None:
        with torch.inference_mode():
            self._static.write_fresh(init_stream_state(self.cfg,
                                                       self.device))
        self.state.frame_count = 0
        self._pending = np.zeros((0,), np.float32)
        self.frames_emitted = 0

    def _body(self, state: StreamState, out: tuple, refresh: bool):
        with spans.track("serve", self.device, STAGES):
            return stream_step_(self.model, state, out, self._hop, self.cfg,
                                (...,) if refresh else ())

    @torch.inference_mode()
    def step(self, hop_audio: np.ndarray) -> torch.Tensor:
        """Advance one frame on ``hop`` samples; returns the (52,) device
        tensor without waiting for it."""
        self._hop.copy_(torch.from_numpy(
            np.ascontiguousarray(hop_audio, np.float32)))
        k = self.cfg.emotion_update_frames
        refresh = k > 0 and self.state.frame_count % k == 0
        key = (refresh, self._static.parity)
        if self.step_graphs.enabled and key not in self.step_graphs:
            logger.info("capturing the stream's CUDA graphs at first use")
            self.warmup()
        out = self.step_graphs.run(key, functools.partial(
            self._body, *self._static.buffers(key[1]), refresh))
        self._static.advance()
        return out[0]

    @torch.inference_mode()
    def warmup(self) -> None:
        """Capture the step's graphs (on the card), or run each branch once
        (eagerly), warming up on a scratch copy of the state: kernel builds
        and first-call costs land before the real-time loop, and the state
        stays as it was."""
        for refresh in (True, False):
            warm = functools.partial(self._body, *self._static.scratch(),
                                     refresh)
            if not self.step_graphs.enabled:
                warm()
                continue
            for p in (0, 1):
                self.step_graphs.capture(
                    (refresh, p), functools.partial(
                        self._body, *self._static.buffers(p), refresh),
                    warm if p == 0 else None)

    def process_audio(self, samples: np.ndarray) -> list[np.ndarray]:
        """Feed audio of any length; returns one (52,) frame per full hop
        now available."""
        hop = self.cfg.hop_length
        buf = np.concatenate([self._pending,
                              np.asarray(samples, np.float32).reshape(-1)])
        frames: list[np.ndarray] = []
        n_full = len(buf) // hop
        for i in range(n_full):
            t0 = time.perf_counter()
            bs = self.step(buf[i * hop:(i + 1) * hop]).cpu().numpy()
            self.frame_times.append(time.perf_counter() - t0)
            self.frames_emitted += 1
            frames.append(bs)
        self._pending = buf[n_full * hop:]
        return frames

    def performance_stats(self) -> dict:
        """avg/max frame time and realtime factor."""
        if not self.frame_times:
            return {"frames": 0}
        times = np.asarray(self.frame_times)
        budget = 1.0 / self.cfg.target_fps
        return {
            "frames": self.frames_emitted,
            "avg_frame_time_ms": float(times.mean() * 1e3),
            "max_frame_time_ms": float(times.max() * 1e3),
            "rtf": float(times.mean() / budget),
            "target_fps": self.cfg.target_fps,
        }
