"""The streaming step of the ``emotion2vec`` variant, as a function of lanes,
in plain PyTorch: every frame the audio ring's shift, one mel row and the
window (:mod:`perfbench.reference.stream`'s frame path), on the lanes
due a refresh the encoder's pooled vector over the ring's last ``context +
margin`` samples (:class:`perfbench.reference.wav2vec2.Encoder`), then the
emotion projection, the dual-stream attention and the EMA
(:func:`perfbench.reference.stream.head_step` works on this model too).

The model's state-dict keys are the program's: the head's
(``emotion_projection``, ``dual_stream_attention``, ``smoothing_alpha``)
and the encoder's under ``emotion2vec``."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.model import StreamingDualStreamModel, TemporalState
from perfbench.reference.stream import StreamState, _stream_post, _stream_pre
from perfbench.reference.wav2vec2 import Encoder, EncoderConfig


@dataclasses.dataclass(frozen=True)
class E2VStreamConfig:
    """What the variant's stream reads of its configuration."""

    sample_rate: int = 16000
    target_fps: int = 30
    window_frames: int = 256
    n_fft: int = 1024
    n_mels: int = 80
    f_min: float = 80.0
    f_max: float = 8000.0
    d_model: int = 256
    num_heads: int = 8
    num_blendshapes: int = 52
    use_learnable_weights: bool = True
    fusion_temperature: float = 1.0
    emotion_context_s: float = 20.0
    #: the emotion windows' largest offset (s): the ring's margin
    emotion_margin_s: float = 0.6
    emotion_update_frames: int = 9
    encoder: EncoderConfig = EncoderConfig()

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate / self.target_fps)

    @property
    def context_samples(self) -> int:
        """Samples a refresh encodes: the context and the margin."""
        return int(self.emotion_context_s * self.sample_rate) \
            + int(self.emotion_margin_s * self.sample_rate)

    @property
    def ring_len(self) -> int:
        """The audio ring: the context in whole hops."""
        hop = self.hop_length
        return -(-self.context_samples // hop) * hop


class StreamingE2VModel(StreamingDualStreamModel):
    """The head of :class:`~perfbench.reference.model.
    StreamingDualStreamModel` over a ``hidden_size``-wide emotion vector,
    and the encoder ``emotion2vec``."""

    def __init__(self, cfg: E2VStreamConfig):
        super().__init__(
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            window_frames=cfg.window_frames, n_mels=cfg.n_mels,
            num_blendshapes=cfg.num_blendshapes,
            emotion_raw_dim=cfg.encoder.hidden_size,
            use_learnable_weights=cfg.use_learnable_weights,
            temperature=cfg.fusion_temperature)
        self.emotion2vec = Encoder(cfg.encoder)


def init_state(cfg: E2VStreamConfig, device, lanes: int) -> StreamState:
    """``lanes`` fresh streams: silent rings, -100 dB rows, zero vectors."""
    return StreamState(
        audio_ring=torch.zeros((lanes, cfg.ring_len), device=device),
        mel_db=torch.full((lanes, cfg.window_frames + 1, cfg.n_mels),
                          -100.0, device=device),
        emotion_raw=torch.zeros((lanes, cfg.encoder.hidden_size),
                                device=device),
        frame_count=0,
        temporal=TemporalState.create(lanes, cfg.num_blendshapes, device),
        lld_ring=None, lld_carry=None)


def stream_frame_lanes(model: StreamingE2VModel, state: StreamState,
                       hop_audio: torch.Tensor, cfg: E2VStreamConfig,
                       refresh: list) -> tuple[torch.Tensor, StreamState]:
    """One frame of every lane (``hop_audio`` ``(B, hop)``): ``((B, 52)
    smoothed blendshapes, new state)``; the lanes in ``refresh`` (indices)
    encode their rings' last :attr:`E2VStreamConfig.context_samples`
    first."""
    ring, mel_db, mel, detail = _stream_pre(state, hop_audio, cfg)
    emotion_raw = state.emotion_raw
    if refresh:
        idx = torch.tensor(refresh, device=ring.device)
        ctx = ring[idx][:, -cfg.context_samples:]
        emotion_raw = emotion_raw.index_copy(0, idx,
                                             model.emotion2vec.pooled(ctx))
    smoothed, temporal = _stream_post(model, mel, detail, emotion_raw,
                                      state.temporal)
    return smoothed, StreamState(
        audio_ring=ring, mel_db=mel_db, emotion_raw=emotion_raw,
        frame_count=state.frame_count + 1, temporal=temporal,
        lld_ring=None, lld_carry=None)
