"""The 9-D ``basic`` prosodic emotion features, on the device.

``[energy, zcr, spectral_centroid, f0_mean, f0_std, mean, std, max, min]``
of the clip: the counterpart of ``koemorph_tpu.features.basic``.
"""

from __future__ import annotations

import numpy as np
import torch

from koemorph_tpu_torch.ops.device_cache import device_cache
from koemorph_tpu_torch.ops.f0 import yin_core
from koemorph_tpu_torch.ops.window import frame_signal, hann_window

BASIC_DIM = 9


@device_cache(8)
def _bin_freqs(n_fft: int, sample_rate: int,
               device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.linspace(
        0, sample_rate / 2, n_fft // 2 + 1, dtype=np.float32)).to(device)


def basic_emotion_features(audio: torch.Tensor,
                           sample_rate: int = 16000) -> torch.Tensor:
    """9-D basic prosodic features of ``audio (..., L)`` -> ``(..., 9)``."""
    energy = torch.mean(audio * audio, -1)

    # zero-crossing rate over the whole clip
    sign = torch.sign(audio)
    crossings = torch.abs(sign[..., 1:] - sign[..., :-1]) > 0
    zcr = torch.mean(crossings.to(torch.float32), -1)

    # spectral centroid over 2048-sample frames
    n_fft = 2048
    frames = frame_signal(audio, n_fft, 512, center=True)
    spec = torch.abs(torch.fft.rfft(
        frames * hann_window(n_fft, device=audio.device), dim=-1))
    freqs = _bin_freqs(n_fft, sample_rate, audio.device)
    centroid = (torch.sum(spec * freqs, -1)
                / (torch.sum(spec, -1) + 1e-10)).mean(-1)

    # F0 statistics over voiced frames (YIN, 50-400 Hz)
    res = yin_core(audio, sample_rate=sample_rate, f0_min=50.0,
                   f0_max=400.0).result
    voiced = res.voiced_flag.to(torch.float32)
    denom = torch.sum(voiced, -1) + 1e-8
    f0_mean = torch.sum(res.f0_hz * voiced, -1) / denom
    f0_var = torch.sum((res.f0_hz - f0_mean[..., None]) ** 2 * voiced,
                       -1) / denom
    f0_std = torch.sqrt(torch.clamp_min(f0_var, 0.0))

    return torch.stack(
        [energy, zcr, centroid, f0_mean, f0_std,
         torch.mean(audio, -1), torch.std(audio, -1, correction=0),
         torch.amax(audio, -1), torch.amin(audio, -1)], -1)
