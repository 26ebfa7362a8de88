"""Mel scales and triangular filterbanks (librosa- and HTK-compatible)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from perfbench.reference.device_cache import device_cache


def hz_to_mel(freq, *, htk: bool = False):
    """Hz -> mels, Slaney (librosa default) or HTK."""
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz)
        / logstep,
        mels)


def mel_to_hz(mels, *, htk: bool = False):
    """Mels -> Hz (inverse of :func:`hz_to_mel`)."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=16)
def _mel_filterbank_np(sample_rate: int, n_fft: int, n_mels: int,
                       f_min: float, f_max: float, htk: bool,
                       norm: str | None) -> np.ndarray:
    """(n_mels, n_bins) float32 triangles."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(f_min, htk=htk),
                                    hz_to_mel(f_max, htk=htk), n_mels + 2),
                        htk=htk)
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        fb = fb * (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    elif norm is not None:
        raise ValueError(f"Unsupported mel norm: {norm!r}")
    return fb.astype(np.float32)


@device_cache(32)
def _fb_tensor(key: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_mel_filterbank_np(*key).T.copy()).to(device)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int = 80,
                   f_min: float = 0.0, f_max: float | None = None, *,
                   htk: bool = False, norm: str | None = "slaney",
                   device=None) -> torch.Tensor:
    """Bins-major ``(n_fft // 2 + 1, n_mels)`` float32 filterbank, so the
    mel projection is ``power @ fb``. Defaults match
    ``librosa.filters.mel``; ``htk=True, norm=None`` matches torchaudio."""
    if f_max is None:
        f_max = sample_rate / 2.0
    key = (int(sample_rate), int(n_fft), int(n_mels), float(f_min),
           float(f_max), bool(htk), norm)
    return _fb_tensor(key, torch.device(device or "cpu"))


def power_to_db(s: torch.Tensor, *, ref=1.0, amin: float = 1e-10,
                top_db: float | None = 80.0,
                ref_axes: tuple[int, ...] | None = None) -> torch.Tensor:
    """``librosa.power_to_db``: ``10 log10(max(s, amin))`` relative to
    ``ref`` (a number, a tensor, or ``"max"``: the max over ``ref_axes``,
    default all), clipped to ``top_db`` below its peak over the same axes."""
    log_spec = 10.0 * torch.log10(torch.clamp_min(s, amin))

    def amax(x):
        if ref_axes is None:
            return x.amax()
        return x.amax(dim=ref_axes, keepdim=True)

    if isinstance(ref, str):
        if ref != "max":
            raise ValueError(f"Unsupported ref: {ref!r}")
        ref_val = amax(s)
    else:
        ref_val = torch.as_tensor(ref, dtype=s.dtype, device=s.device)
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp_min(ref_val, amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, amax(log_spec) - top_db)
    return log_spec


def normalize_log_mel(mel_db: torch.Tensor) -> torch.Tensor:
    """KoeMorph's ``(db + 80) / 80`` normalization to ~[0, 1]."""
    return (mel_db + 80.0) / 80.0
