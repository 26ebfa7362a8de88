"""The reference's class-based mel extractor API.

:class:`MelSpectrogramExtractor` is the torchaudio-style log-mel at the
target fps (HTK mel, window-normalized power, ``log(mel + eps)``, padded
or cut to ``duration * fps`` frames), over
:class:`koemorph_tpu_torch.ops.frontend.LogMelFrontend` (plain PyTorch, no
kernel). :class:`InverseMelSpectrogram` turns such a log-mel back into
audio by :mod:`koemorph_tpu_torch.ops.reconstruct` (pseudo-inverse mel and
Griffin-Lim), for reconstruction checks. Both run on ``cuda`` unless the
caller asks for another device.
"""

from __future__ import annotations

from typing import Optional

import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.ops.frontend import (LogMelFrontend,
                                             log_mel_spectrogram)
from koemorph_tpu_torch.ops.reconstruct import (compute_reconstruction_snr,
                                                griffin_lim, mel_to_linear,
                                                validate_mel_parameters)
from koemorph_tpu_torch.ops.window import hann_window

__all__ = ["MelSpectrogramExtractor", "InverseMelSpectrogram",
           "compute_reconstruction_snr", "validate_mel_parameters"]


class MelSpectrogramExtractor:
    """Audio ``(B, L)`` or ``(L,)`` -> log-mel ``(B, T, n_mels)`` at
    ``target_fps``, ``T = int(L / sr * fps)``."""

    def __init__(
        self,
        sample_rate: int = 16000,
        target_fps: float = 30.0,
        n_fft: int = 512,
        n_mels: int = 80,
        f_min: float = 80.0,
        f_max: Optional[float] = None,
        power: float = 2.0,
        normalized: bool = True,
        center: bool = True,
        pad_mode: str = "reflect",
        eps: float = 1e-8,
        device: DeviceLike = None,
    ):
        if power != 2.0:
            raise ValueError("only power=2.0 is supported (the reference "
                             "default; magnitude mel was unused)")
        if pad_mode != "reflect" or not center or not normalized:
            raise ValueError("only the reference defaults center=True, "
                             "pad_mode='reflect', normalized=True are "
                             "supported")
        hop = int(sample_rate / target_fps)
        if hop <= 0:
            raise ValueError(
                f"Invalid hop_length {hop} for sr={sample_rate}, "
                f"fps={target_fps}")
        self.cfg = LogMelFrontend(
            sample_rate=sample_rate, target_fps=float(target_fps),
            n_fft=n_fft, n_mels=n_mels, f_min=f_min,
            f_max=f_max if f_max is not None else sample_rate / 2.0,
            style="torchaudio", eps=eps)
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.target_fps = target_fps
        self.n_fft = n_fft
        self.n_mels = n_mels
        self.hop_length = hop

    def __call__(self, waveform) -> torch.Tensor:
        x = torch.as_tensor(waveform, dtype=torch.float32, device=self.device)
        if x.dim() == 1:
            x = x[None]
        if x.dim() != 2:
            raise ValueError(f"Expected 1D or 2D input, got {x.dim()}D")
        return log_mel_spectrogram(x, self.cfg)

    def get_output_length(self, input_length: int) -> int:
        return int(input_length / self.sample_rate * self.target_fps)


class InverseMelSpectrogram:
    """Log-mel ``(B, T, n_mels)`` -> waveform by the pseudo-inverse mel and
    Griffin-Lim, for reconstruction checks rather than production audio.

    Takes either the reference's calling convention,
    ``InverseMelSpectrogram(mel_extractor, n_iter=32)`` (everything, the
    device included, from the extractor), or explicit parameters."""

    def __init__(
        self,
        mel_extractor: Optional[MelSpectrogramExtractor] = None,
        *,
        sample_rate: int = 16000,
        target_fps: float = 30.0,
        n_fft: int = 512,
        n_mels: int = 80,
        f_min: float = 80.0,
        f_max: Optional[float] = None,
        n_iter: int = 32,
        momentum: float = 0.99,
        length: Optional[int] = None,
        eps: float = 1e-8,
        device: DeviceLike = None,
    ):
        if mel_extractor is not None:
            self.cfg = mel_extractor.cfg
            eps = mel_extractor.cfg.eps
            self.device = mel_extractor.device
        else:
            self.cfg = LogMelFrontend(
                sample_rate=sample_rate, target_fps=float(target_fps),
                n_fft=n_fft, n_mels=n_mels, f_min=f_min,
                f_max=f_max if f_max is not None else sample_rate / 2.0,
                style="torchaudio", eps=eps)
            self.device = resolve_device(device)
        self.n_iter = n_iter
        self.momentum = momentum
        self.length = length
        self.eps = eps

    def __call__(self, log_mel,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """``generator`` draws Griffin-Lim's initial phase (seed 0 when
        none is given)."""
        log_mel = torch.as_tensor(log_mel, dtype=torch.float32,
                                  device=self.device)
        mel_power = torch.clamp_min(torch.exp(log_mel) - self.eps, 0.0)
        cfg = self.cfg
        linear = mel_to_linear(
            mel_power, sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
            n_mels=cfg.n_mels, f_min=cfg.f_min, f_max=cfg.effective_f_max)
        # the analysis divided the power by the window's energy
        # (torchaudio normalized=True): Griffin-Lim needs physical
        # magnitudes
        w = hann_window(cfg.n_fft, device=self.device)
        magnitude = torch.sqrt(linear) * torch.sqrt(torch.sum(w * w))
        length = self.length or mel_power.shape[-2] * cfg.hop_length
        return griffin_lim(magnitude, n_fft=cfg.n_fft,
                           hop_length=cfg.hop_length, length=length,
                           n_iter=self.n_iter, momentum=self.momentum,
                           generator=generator)
