"""Prosodic features: F0, log energy, VAD and voicing -> ``(..., T, 4)``.

The reference's ``ProsodyExtractor`` / ``ProsodyNormalizer``:
pre-emphasis, YIN F0 (:func:`koemorph_tpu_torch.ops.f0.yin_f0`), RMS
log-energy, an energy-threshold VAD with median smoothing, F0 interpolated
across unvoiced gaps, and linear resampling to the target fps. Every step
is a tensor operation on the audio's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from koemorph_tpu_torch.device import scalar_like
from koemorph_tpu_torch.ops.f0 import yin_f0
from koemorph_tpu_torch.ops.window import frame_signal

__all__ = ["ProsodyConfig", "preemphasis", "median3",
           "interpolate_unvoiced", "extract_prosody", "normalize_prosody",
           "denormalize_prosody"]


def preemphasis(x: torch.Tensor, coeff: float = 0.97) -> torch.Tensor:
    """First-order pre-emphasis ``y[n] = x[n] - coeff * x[n-1]``."""
    return torch.cat([x[..., :1], x[..., 1:] - coeff * x[..., :-1]], -1)


def median3(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Median filter along the last axis with odd kernel ``k``, the ends
    padded with their edge values."""
    pad = k // 2
    n = x.shape[-1]
    lead = x.shape[:-1]
    xp = torch.cat([x[..., :1].expand(lead + (pad,)), x,
                    x[..., -1:].expand(lead + (pad,))], -1)
    stacked = torch.stack([xp[..., i:i + n] for i in range(k)], 0)
    return torch.median(stacked, 0).values


def interpolate_unvoiced(f0: torch.Tensor, voiced: torch.Tensor
                         ) -> torch.Tensor:
    """F0 linearly interpolated across unvoiced gaps between voiced frames
    (frames before the first and after the last voiced one keep their
    values)."""
    t = f0.shape[-1]
    idx = torch.arange(t, dtype=f0.dtype, device=f0.device).expand(f0.shape)
    # the nearest voiced index to the left (running max), to the right
    # (running min from the end)
    left_pos = torch.cummax(torch.where(voiced, idx, -1.0), -1).values
    right_pos = torch.flip(torch.cummin(torch.flip(
        torch.where(voiced, idx, float(t + 1)), [-1]), -1).values, [-1])

    def take(pos):
        return torch.gather(f0, -1, torch.clamp(pos, 0, t - 1).to(
            torch.int64))

    w = (idx - left_pos) / torch.clamp_min(right_pos - left_pos, 1.0)
    interp = take(left_pos) * (1 - w) + take(right_pos) * w
    interior = (left_pos >= 0) & (right_pos <= t - 1) & ~voiced
    return torch.where(interior, interp, f0)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """``jnp.interp`` along the last axis of ``fp (..., len(xp))``, at the
    points ``x``: linear between the two neighbouring ``xp``, the end
    values outside them."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    f_lo, f_hi = fp[..., i - 1], fp[..., i]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, f_lo,
                    f_lo + (delta / torch.where(dx0, 1.0, dx)) * (f_hi - f_lo))
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


@dataclasses.dataclass(frozen=True)
class ProsodyConfig:
    sample_rate: int = 16000
    target_fps: float = 30.0
    frame_length: float = 0.025   # analysis frame (s)
    frame_shift: float = 0.010    # analysis hop (s)
    f0_min: float = 80.0
    f0_max: float = 400.0
    energy_floor: float = 1e-8
    vad_threshold: float = 0.01
    interpolate_unvoiced: bool = True

    @property
    def frame_length_samples(self) -> int:
        return int(self.frame_length * self.sample_rate)

    @property
    def frame_shift_samples(self) -> int:
        return int(self.frame_shift * self.sample_rate)


def extract_prosody(audio: torch.Tensor,
                    cfg: ProsodyConfig = ProsodyConfig()) -> torch.Tensor:
    """Prosodic features of ``audio (..., L)`` -> ``(..., T_fps, 4)``,
    columns [F0 Hz, log-energy, VAD, voicing probability] at the target
    fps."""
    x = preemphasis(audio)
    # YIN needs a frame longer than its largest lag (sr / f0_min = 200
    # samples at 80 Hz): 512 samples
    res = yin_f0(x, sample_rate=cfg.sample_rate,
                 frame_length=max(512, cfg.frame_length_samples + 1),
                 hop_length=cfg.frame_shift_samples, f0_min=cfg.f0_min,
                 f0_max=cfg.f0_max)
    f0 = res.f0_hz

    # log RMS energy on uncentered analysis frames
    frames = frame_signal(x, cfg.frame_length_samples,
                          cfg.frame_shift_samples, center=False)
    log_energy = torch.log(torch.sqrt(torch.mean(frames * frames, -1))
                           + cfg.energy_floor)

    # energy-threshold VAD on the min-max normalized energy, smoothed
    e_min = log_energy.amin(-1, keepdim=True)
    e_max = log_energy.amax(-1, keepdim=True)
    e_norm = (log_energy - e_min) / (e_max - e_min + 1e-8)
    vad = median3((e_norm > cfg.vad_threshold).to(torch.float32), k=5)

    if cfg.interpolate_unvoiced:
        f0 = interpolate_unvoiced(f0, res.voiced_flag)

    # the uncentered energy framing gives fewer frames
    t = min(f0.shape[-1], log_energy.shape[-1])
    feats = (f0[..., :t], log_energy[..., :t], vad[..., :t],
             res.voiced_prob[..., :t])

    # linear resampling from the analysis rate to the target fps
    n_out = int(audio.shape[-1] / cfg.sample_rate * cfg.target_fps)
    src = torch.arange(t, dtype=torch.float32,
                       device=audio.device) * cfg.frame_shift
    dst = torch.arange(n_out, dtype=torch.float32, device=audio.device)
    dst = dst / scalar_like(cfg.target_fps, dst)
    return torch.stack([_interp(dst, src, f) for f in feats], -1)


def normalize_prosody(features: torch.Tensor, *,
                      f0_log_transform: bool = True, f0_mean: float = 150.0,
                      f0_std: float = 50.0, energy_mean: float = -5.0,
                      energy_std: float = 2.0, eps: float = 1e-8
                      ) -> torch.Tensor:
    """Speaker normalization: F0 (optionally log-transformed; 0 stays 0)
    and energy z-scored, VAD and voicing passed through."""
    f0, energy, vad, voicing = features.unbind(-1)
    if f0_log_transform:
        ref = float(np.log(np.float32(f0_mean)))
        scale = f0_std / f0_mean          # delta-method std of log-F0
        f0n = torch.where(f0 > 0, (torch.log(f0 + eps) - ref)
                          / (scale + eps), 0.0)
    else:
        f0n = torch.where(f0 > 0, (f0 - f0_mean) / (f0_std + eps), 0.0)
    en = (energy - energy_mean) / (energy_std + eps)
    return torch.stack([f0n, en, vad, voicing], -1)


def denormalize_prosody(features: torch.Tensor, *,
                        f0_log_transform: bool = True,
                        f0_mean: float = 150.0, f0_std: float = 50.0,
                        energy_mean: float = -5.0, energy_std: float = 2.0
                        ) -> torch.Tensor:
    """Inverse of :func:`normalize_prosody`."""
    f0n, en, vad, voicing = features.unbind(-1)
    if f0_log_transform:
        ref = float(np.log(np.float32(f0_mean)))
        scale = f0_std / f0_mean
        f0 = torch.where(f0n != 0, torch.exp(f0n * scale + ref), 0.0)
    else:
        f0 = torch.where(f0n != 0, f0n * f0_std + f0_mean, 0.0)
    energy = en * energy_std + energy_mean
    return torch.stack([f0, energy, vad, voicing], -1)
