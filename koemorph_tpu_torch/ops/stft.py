"""Power spectra and autocorrelations as DFT matrix products.

The real DFT is two products against cos / -sin matrices, and every
autocorrelation is the Wiener-Khinchin inverse of such a power spectrum,
one more product against a cosine matrix. All products run in full
float32 (TF32 is never enabled): the YIN and LPC chains downstream pick
discrete lags from these values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from koemorph_tpu_torch.ops.device_cache import device_cache
from koemorph_tpu_torch.ops.window import frame_signal, hann_window


@functools.lru_cache(maxsize=8)
def _dft_matrices_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _iacf_matrix_np(n_fft: int, n_lags: int) -> np.ndarray:
    """Power spectrum (n_fft//2+1 bins) -> autocorrelation lags [0, n_lags):
    ``acf(tau) = (1/N) [P_0 + 2 sum_k P_k cos(2 pi k tau / N) + (-1)^tau P_{N/2}]``.
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[:, None]
    tau = np.arange(n_lags, dtype=np.float64)[None, :]
    m = np.cos(2.0 * np.pi * k * tau / n_fft)
    coef = np.full((n_bins, 1), 2.0)
    coef[0, 0] = 1.0
    if n_fft % 2 == 0:
        coef[-1, 0] = 1.0
    return (m * coef / n_fft).astype(np.float32)


@device_cache(32)
def _dft_tensors(n_fft: int, rows: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    c, s = _dft_matrices_np(n_fft)
    return (torch.from_numpy(c[:rows].copy()).to(device),
            torch.from_numpy(s[:rows].copy()).to(device))


@device_cache(32)
def _iacf_tensor(n_fft: int, n_lags: int, device: torch.device
                 ) -> torch.Tensor:
    return torch.from_numpy(_iacf_matrix_np(n_fft, n_lags)).to(device)


def dft_matrices(n_fft: int, device=None, rows: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real-DFT bases ``(cos, -sin)`` of shape ``(rows or n_fft, n_fft//2+1)``;
    fewer rows is the DFT of a zero-padded shorter frame."""
    return _dft_tensors(n_fft, rows or n_fft, torch.device(device or "cpu"))


def power_spectrum_matmul(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """``|rfft(frames, n_fft)|^2``; frames shorter than ``n_fft`` are
    implicitly zero-padded."""
    n = frames.shape[-1]
    c, s = dft_matrices(n_fft, frames.device, rows=min(n, n_fft))
    re = torch.matmul(frames, c)
    im = torch.matmul(frames, s)
    return re * re + im * im


def acf_from_power(power: torch.Tensor, n_fft: int, n_lags: int
                   ) -> torch.Tensor:
    """Autocorrelation lags ``[0, n_lags)`` from an ``n_fft``-point power
    spectrum; exact (non-circular) when ``n_fft >= n + n_lags``."""
    return torch.matmul(power, _iacf_tensor(n_fft, n_lags, power.device))


def autocorr_matmul(frames: torch.Tensor, n_lags: int,
                    n_fft: int | None = None) -> torch.Tensor:
    """Frame autocorrelation ``acf(tau), tau in [0, n_lags)``."""
    if n_fft is None:
        n_fft = ((frames.shape[-1] + n_lags + 7) // 8) * 8
    return acf_from_power(power_spectrum_matmul(frames, n_fft), n_fft, n_lags)


def stft_power(x: torch.Tensor, *, n_fft: int, hop_length: int,
               win_length: int | None = None,
               window: torch.Tensor | None = None, center: bool = True,
               power: float = 2.0, normalized: bool = False,
               method: str = "matmul") -> torch.Tensor:
    """Spectrogram ``(..., n_frames, n_fft // 2 + 1)`` of ``x (..., L)``,
    time-major: windowed frames (librosa reflect centering when
    ``center``) against the DFT bases. ``win_length`` shorter than
    ``n_fft`` centre-pads the window; ``normalized`` divides by
    ``sum(window ** 2)``; ``power`` 1 gives the magnitude. ``method``
    ``"matmul"`` takes products against the DFT bases, ``"rfft"``
    ``torch.fft.rfft`` (cuFFT on the card, which does not use TF32)."""
    if method not in ("matmul", "rfft"):
        raise ValueError(f"Unknown stft method: {method!r}")
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length, device=x.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(
            window, (lpad, n_fft - win_length - lpad))
    frames = frame_signal(x, n_fft, hop_length, center=center) * window
    if method == "matmul":
        c, s = dft_matrices(n_fft, x.device)
        re = torch.matmul(frames, c)
        im = torch.matmul(frames, s)
    else:
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
        re, im = spec.real, spec.imag
    sq = re * re + im * im
    if normalized:
        sq = sq / torch.sum(window * window)
    if power == 2.0:
        return sq
    if power == 1.0:
        return torch.sqrt(sq)
    return torch.pow(sq, power / 2.0)
