"""Mel inversion and Griffin-Lim reconstruction (the test and analysis
path of the reference's ``InverseMelSpectrogram``).

:func:`mel_to_linear` maps a mel power spectrogram back to linear bins by
the filterbank's pseudo-inverse, clamped at 0. :func:`griffin_lim` recovers
a phase for a magnitude spectrogram by the momentum variant of Griffin-Lim
(Perraudin et al.; torchaudio's default momentum 0.99): inverse STFT by
windowed overlap-add, forward STFT by DFT products, the magnitude snapped
back, ``n_iter`` times after one first projection. The overlap-add is
``torch.nn.functional.fold``, which sums each output sample's frames in a
fixed order on every device (``index_add_`` accumulates with atomics on
CUDA, so two runs would differ in the last bits). Every product runs in
full float32.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from koemorph_tpu_torch.ops.device_cache import device_cache
from koemorph_tpu_torch.ops.mel import _mel_filterbank_np, mel_filterbank
from koemorph_tpu_torch.ops.stft import dft_matrices
from koemorph_tpu_torch.ops.window import frame_signal, hann_window

__all__ = ["mel_to_linear", "griffin_lim", "reconstruct_audio",
           "compute_reconstruction_snr", "validate_mel_parameters"]


@device_cache(16)
def _pinv(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
          f_max: float, htk: bool, norm: Optional[str],
          device: torch.device) -> torch.Tensor:
    fb = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max, htk=htk,
                        norm=norm)                          # (bins, n_mels)
    # jnp.linalg.pinv's cutoff, 10 * max(M, N) * eps of the largest
    # singular value (torch's default is ten times smaller, which keeps the
    # near-zero singular values of filterbanks with empty filters)
    rtol = 10 * max(fb.shape) * torch.finfo(torch.float32).eps
    return torch.linalg.pinv(fb, rtol=rtol).to(device)     # (n_mels, bins)


def mel_to_linear(mel_power: torch.Tensor, *, sample_rate: int, n_fft: int,
                  n_mels: int, f_min: float = 0.0,
                  f_max: Optional[float] = None, htk: bool = True,
                  norm: Optional[str] = None) -> torch.Tensor:
    """Approximate inverse mel: ``(..., T, n_mels) -> (..., T, bins)``
    power, the least-squares pseudo-inverse of the filterbank clamped at
    0."""
    pinv = _pinv(int(sample_rate), int(n_fft), int(n_mels), float(f_min),
                 float(f_max if f_max is not None else sample_rate / 2),
                 bool(htk), norm, mel_power.device)
    return torch.clamp_min(torch.matmul(mel_power, pinv), 0.0)


@device_cache(16)
def _window_sum(n_fft: int, hop: int, t: int, device: torch.device
                ) -> torch.Tensor:
    """The overlap-added squared window of ``t`` frames, floored at
    1e-8: ``(total,)``."""
    w = hann_window(n_fft, device=device)
    cols = (w * w)[:, None].expand(n_fft, t)[None]
    total = (t - 1) * hop + n_fft
    wsum = F.fold(cols, (1, total), (1, n_fft), stride=(1, hop))
    return torch.clamp_min(wsum.reshape(total), 1e-8)


def _istft_overlap_add(spec: torch.Tensor, n_fft: int, hop: int,
                       length: int) -> torch.Tensor:
    """Inverse STFT by overlap-add with window-square normalization:
    complex ``(..., T, bins)`` -> ``(..., length)``."""
    window = hann_window(n_fft, device=spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # (..., T, n)
    lead, t = frames.shape[:-2], frames.shape[-2]
    total = (t - 1) * hop + n_fft
    cols = frames.reshape(-1, t, n_fft).transpose(1, 2)     # (B, n, T)
    full = F.fold(cols, (1, total), (1, n_fft), stride=(1, hop))
    full = full.reshape(lead + (total,)) / _window_sum(n_fft, hop, t,
                                                       spec.device)
    # center=True framing put sample 0 at n_fft // 2
    start = n_fft // 2
    return full[..., start:start + length]


def _stft_complex(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    frames = frame_signal(x, n_fft, hop, center=True) * hann_window(
        n_fft, device=x.device)
    cos_m, sin_m = dft_matrices(n_fft, x.device)
    return torch.complex(torch.matmul(frames, cos_m),
                         torch.matmul(frames, sin_m))


def _griffin_lim_iterate(spec: torch.Tensor, magnitude: torch.Tensor, *,
                         n_fft: int, hop_length: int, length: int,
                         n_iter: int, momentum: float) -> torch.Tensor:
    """Griffin-Lim from the initial complex spectrum ``spec`` (..., T,
    bins): one projection, then ``n_iter`` momentum steps; the audio of
    the last spectrum."""
    t = magnitude.shape[-2]

    def project(s):
        audio = _istft_overlap_add(s, n_fft, hop_length, length)
        rebuilt = _stft_complex(audio, n_fft, hop_length)[..., :t, :]
        return magnitude * (rebuilt / torch.clamp_min(rebuilt.abs(), 1e-16))

    cur, prev = project(spec), spec
    for _ in range(n_iter):
        cur, prev = project(cur + momentum * (cur - prev)), cur
    return _istft_overlap_add(cur, n_fft, hop_length, length)


def griffin_lim(magnitude: torch.Tensor, *, n_fft: int, hop_length: int,
                length: int, n_iter: int = 32, momentum: float = 0.99,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Griffin-Lim phase reconstruction: magnitude ``(..., T, bins)`` ->
    audio ``(..., length)``. The initial phase is uniform in ``[-pi,
    pi)``, drawn on the CPU from ``generator`` (seed 0 when none is
    given)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.rand(magnitude.shape, generator=generator, dtype=torch.float32)
    phase = (u * (2 * np.pi) - np.pi).to(magnitude.device)
    spec = magnitude * torch.polar(torch.ones_like(phase), phase)
    return _griffin_lim_iterate(spec, magnitude, n_fft=n_fft,
                                hop_length=hop_length, length=length,
                                n_iter=n_iter, momentum=momentum)


def reconstruct_audio(mel_power: torch.Tensor, *, sample_rate: int,
                      n_fft: int, hop_length: int, length: int,
                      f_min: float = 0.0, f_max: Optional[float] = None,
                      htk: bool = True, norm: Optional[str] = None,
                      n_iter: int = 32,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Mel power spectrogram -> audio: :func:`mel_to_linear`, then
    :func:`griffin_lim` on its square root."""
    linear = mel_to_linear(
        mel_power, sample_rate=sample_rate, n_fft=n_fft,
        n_mels=mel_power.shape[-1], f_min=f_min, f_max=f_max, htk=htk,
        norm=norm)
    return griffin_lim(torch.sqrt(linear), n_fft=n_fft,
                       hop_length=hop_length, length=length, n_iter=n_iter,
                       generator=generator)


def compute_reconstruction_snr(original: torch.Tensor,
                               reconstructed: torch.Tensor) -> torch.Tensor:
    """SNR in dB of ``reconstructed`` against ``original``, over their
    common length."""
    n = min(original.shape[-1], reconstructed.shape[-1])
    o = original[..., :n]
    noise = o - reconstructed[..., :n]
    return 10.0 * torch.log10(
        torch.sum(o * o, -1)
        / torch.clamp_min(torch.sum(noise * noise, -1), 1e-12))


def validate_mel_parameters(sample_rate: int, n_fft: int, n_mels: int,
                            f_min: float, f_max: Optional[float],
                            target_fps: float) -> dict:
    """Sanity checks of frontend parameters: ``{"valid", "warnings",
    "errors"}``; each warning is also issued with :func:`warnings.warn`."""
    results: dict = {"valid": True, "warnings": [], "errors": []}
    nyquist = sample_rate / 2.0
    f_max = f_max if f_max is not None else nyquist
    if f_max > nyquist:
        results["errors"].append(
            f"f_max {f_max} exceeds Nyquist {nyquist}")
    if f_min >= f_max:
        results["errors"].append(f"f_min {f_min} >= f_max {f_max}")
    if n_fft & (n_fft - 1):
        results["warnings"].append(f"n_fft {n_fft} is not a power of 2")
    hop = int(sample_rate / target_fps)
    if hop > n_fft:
        results["warnings"].append(
            f"hop {hop} exceeds n_fft {n_fft}: frames don't overlap")
    if n_mels > n_fft // 2 + 1:
        results["errors"].append(
            f"n_mels {n_mels} exceeds bin count {n_fft // 2 + 1}")
    # does every mel filter see at least one bin?
    fb = _mel_filterbank_np(int(sample_rate), int(n_fft), int(n_mels),
                            float(f_min), float(f_max), False, "slaney")
    empty = int(np.sum(fb.sum(axis=1) <= 0))
    if empty:
        results["warnings"].append(
            f"{empty} mel filters are empty (n_fft too small for n_mels)")
    results["valid"] = not results["errors"]
    for w in results["warnings"]:
        warnings.warn(w)
    return results
