"""Analysis windows and signal framing."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from koemorph_tpu_torch.ops.device_cache import device_cache


@device_cache(32)
def _hann_tensor(win_length: int, device: torch.device) -> torch.Tensor:
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def hann_window(win_length: int, *, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window``'s and librosa's
    default), float32 computed in float64 and rounded once; cached per
    device."""
    return _hann_tensor(win_length, torch.device(device or "cpu"))


def num_frames(length: int, n_fft: int, hop_length: int,
               *, center: bool = True) -> int:
    """STFT frames of a ``length``-sample signal: ``1 + length // hop``
    centered, ``1 + (length - n_fft) // hop`` otherwise."""
    if center:
        return 1 + length // hop_length
    return 1 + (length - n_fft) // hop_length


def pad_center_reflect(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``n_fft // 2`` on both sides (librosa
    ``center=True``, ``torch.stft(pad_mode="reflect")``)."""
    pad = n_fft // 2
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return x.reshape(lead + (x.shape[-1],))


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 *, center: bool = True) -> torch.Tensor:
    """Overlapping frames ``(..., L) -> (..., n_frames, n_fft)``.

    ``center=True`` reflect-pads by ``n_fft // 2`` so frame ``t`` is
    centered on sample ``t * hop_length`` (librosa semantics); otherwise
    frames hold real samples only, ``1 + (L - n_fft) // hop`` of them.
    """
    if center:
        x = pad_center_reflect(x, n_fft)
    return x.unfold(-1, n_fft, hop_length)
