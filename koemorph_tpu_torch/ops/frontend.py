"""The fused STFT -> mel -> dB frontend and the librosa-style log-mel.

:func:`frames_to_logmel` maps un-windowed frames ``(..., T, n_fft)`` to dB
mel rows ``10 log10(max(((f Wc)^2 + (f Ws)^2) FB, 1e-10))``, with the Hann
window folded into the DFT bases ``Wc``, ``Ws``: a CUDA kernel for CUDA
tensors (:func:`koemorph_tpu_torch.ops.cuda.logmel`), the plain PyTorch
form :func:`frames_to_logmel_plain` for CPU tensors. Framing stays outside
the kernel. The librosa-style frontend (:class:`LogMelFrontend`,
:func:`log_mel_spectrogram`, :func:`mel_with_temporal_detail`) is that
function followed by the per-utterance ``ref=max``, the 80 dB clip and
``(db + 80) / 80``; with ``stft_method="rfft"`` its power spectrum comes
from ``torch.fft.rfft`` instead, then the same mel, dB and normalization in
plain PyTorch. The torchaudio style (``style="torchaudio"``) is plain
PyTorch too: the window-normalized power spectrum, the HTK filterbank
without norm, ``log(mel + eps)``, padded with its last frame or cut to
``int(L / sr * fps)`` frames.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from koemorph_tpu_torch.ops import cuda as cuda_kernels
from koemorph_tpu_torch.ops.device_cache import device_cache
from koemorph_tpu_torch.ops.mel import (_mel_filterbank_np, mel_filterbank,
                                        normalize_log_mel, power_to_db)
from koemorph_tpu_torch.ops.stft import stft_power
from koemorph_tpu_torch.ops.window import frame_signal

__all__ = ["LogMelFrontend", "LogmelKernelConstants", "frames_to_logmel",
           "frames_to_logmel_plain", "fused_log_mel_frontend",
           "log_mel_spectrogram", "logmel_constants",
           "logmel_kernel_constants", "logmel_live_bins",
           "mel_with_temporal_detail", "tf32_split"]


@functools.lru_cache(maxsize=8)
def _folded_bases_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Bins-major ``(n_bins, n_fft)`` bases ``hann * cos`` and
    ``hann * -sin``, computed in float64 and rounded once."""
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    return ((win * np.cos(ang)).astype(np.float32),
            (win * -np.sin(ang)).astype(np.float32))


@device_cache(32)
def _constants(n_fft: int, sample_rate: int, n_mels: int, f_min: float,
               f_max: float, device: torch.device):
    wc, ws = _folded_bases_np(n_fft)
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, f_min, f_max, False,
                            "slaney").T
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (wc, ws, fb))


def logmel_constants(n_fft: int, sample_rate: int, n_mels: int,
                     f_min: float, f_max: float, device
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(Wc, Ws, FB)``: the Hann-folded bases, bins-major
    ``(n_fft // 2 + 1, n_fft)``, and the Slaney filterbank
    ``(n_fft // 2 + 1, n_mels)``, float32, cached per device."""
    return _constants(int(n_fft), int(sample_rate), int(n_mels),
                      float(f_min), float(f_max), torch.device(device))


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` with ``big = tf32(x)`` and ``small = tf32(x - big)``,
    float32 with the low 13 mantissa bits zero: rounded to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds. ``big + small`` is
    ``x`` to within ``2**-21 |x|``; the ``logmel`` kernel's tensor-core
    products are ``big*big + big*small + small*big`` (3xTF32)."""
    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x.to(torch.float32))
    return big, rna(x.to(torch.float32) - big)


@functools.lru_cache(maxsize=32)
def logmel_live_bins(n_fft: int, sample_rate: int, n_mels: int,
                     f_min: float, f_max: float) -> tuple[int, int]:
    """``[lo, hi)``: the DFT bins with a nonzero weight in the Slaney
    filterbank (``[6, 512)`` at n_fft 1024, 16 kHz, 80 mels, 80-8000 Hz).
    Every other bin adds exactly +0 to every mel sum of finite frames."""
    fb = _mel_filterbank_np(int(sample_rate), int(n_fft), int(n_mels),
                            float(f_min), float(f_max), False, "slaney")
    live = np.flatnonzero(fb.any(axis=0))
    return int(live[0]), int(live[-1]) + 1


@dataclasses.dataclass(frozen=True)
class LogmelKernelConstants:
    """What the ``logmel`` kernel reads, restricted to the live bins
    ``[lo, hi)`` and padded with zero rows to ``groups`` x 64 bins.

    ``bases`` (4, groups*64, n_fft): the TF32 split of the folded bases,
    ``Wc`` big, ``Wc`` small, ``Ws`` big, ``Ws`` small (batch path);
    ``fb`` (groups*64, n_mels) the filterbank rows of those bins; for
    single frames ``wc``, ``ws`` (hi-lo, n_fft), the float32 bases,
    ``fb_nz`` each mel's nonzero weights in bin order, mel after mel, and
    ``spans`` (n_mels, 3) int32 on the CPU (the kernel gets them by value):
    each mel's nonzero bins ``[first, last + 1)`` counted from ``lo``, and
    the offset of its weights in ``fb_nz``."""

    lo: int
    hi: int
    groups: int
    bases: torch.Tensor
    fb: torch.Tensor
    wc: torch.Tensor
    ws: torch.Tensor
    fb_nz: torch.Tensor
    spans: torch.Tensor


@device_cache(32)
def _kernel_constants(n_fft: int, sample_rate: int, n_mels: int,
                      f_min: float, f_max: float, device: torch.device
                      ) -> LogmelKernelConstants:
    lo, hi = logmel_live_bins(n_fft, sample_rate, n_mels, f_min, f_max)
    groups = -(-(hi - lo) // 64)
    wc, ws, fb = _constants(n_fft, sample_rate, n_mels, f_min, f_max,
                            torch.device("cpu"))
    rows = groups * 64
    bases = torch.zeros((4, rows, n_fft), dtype=torch.float32)
    for q, basis in enumerate((wc, ws)):
        big, small = tf32_split(basis[lo:hi])
        bases[2 * q, :hi - lo] = big
        bases[2 * q + 1, :hi - lo] = small
    fb_pad = torch.zeros((rows, n_mels), dtype=torch.float32)
    fb_pad[:hi - lo] = fb[lo:hi]
    fb_t = fb[lo:hi].T
    spans = torch.zeros((n_mels, 3), dtype=torch.int32)
    weights = []
    for m in range(n_mels):
        nz = torch.nonzero(fb_t[m]).flatten()
        first, last = (int(nz[0]), int(nz[-1]) + 1) if nz.numel() else (0, 0)
        spans[m] = torch.tensor([first, last, sum(map(len, weights))])
        weights.append(fb_t[m, first:last])
    return LogmelKernelConstants(
        lo, hi, groups, *(t.to(device) for t in (
            bases, fb_pad, wc[lo:hi].contiguous(), ws[lo:hi].contiguous(),
            torch.cat(weights).contiguous())), spans)


def logmel_kernel_constants(n_fft: int, sample_rate: int, n_mels: int,
                            f_min: float, f_max: float, device
                            ) -> LogmelKernelConstants:
    """The ``logmel`` kernel's constants (:class:`LogmelKernelConstants`),
    cached per device."""
    return _kernel_constants(int(n_fft), int(sample_rate), int(n_mels),
                             float(f_min), float(f_max),
                             torch.device(device))


def frames_to_logmel_plain(frames: torch.Tensor, *, sample_rate: int = 16000,
                           n_mels: int = 80, f_min: float = 80.0,
                           f_max: float = 8000.0) -> torch.Tensor:
    """``(..., T, n_fft)`` un-windowed frames -> ``(..., T, n_mels)`` dB.
    Plain PyTorch form of the ``logmel`` kernel."""
    wc, ws, fb = logmel_constants(frames.shape[-1], sample_rate, n_mels,
                                  f_min, f_max, frames.device)
    re = torch.matmul(frames, wc.T)
    im = torch.matmul(frames, ws.T)
    mel = torch.matmul(re * re + im * im, fb)
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))


def frames_to_logmel(frames: torch.Tensor, *, sample_rate: int = 16000,
                     n_mels: int = 80, f_min: float = 80.0,
                     f_max: float = 8000.0) -> torch.Tensor:
    """:func:`frames_to_logmel_plain`'s function: the CUDA kernel for CUDA
    tensors (the frames read in place), the plain form for CPU tensors;
    the custom operator ``koemorph_torch::logmel`` while a program is
    being exported."""
    if torch.compiler.is_exporting():
        return torch.ops.koemorph_torch.logmel(
            frames, int(sample_rate), int(n_mels), float(f_min),
            float(f_max))
    kw = dict(sample_rate=sample_rate, n_mels=n_mels, f_min=f_min,
              f_max=f_max)
    if frames.device.type == "cuda":
        return cuda_kernels.logmel(frames, **kw)
    if frames.device.type == "cpu":
        return frames_to_logmel_plain(frames, **kw)
    raise ValueError(f"frames_to_logmel: unsupported device {frames.device}")


def fused_log_mel_frontend(audio: torch.Tensor, *, sample_rate: int = 16000,
                           n_fft: int = 1024, hop_length: int = 533,
                           n_mels: int = 80, f_min: float = 80.0,
                           f_max: float = 8000.0, center: bool = True
                           ) -> torch.Tensor:
    """Audio ``(..., L)`` -> ``(..., T, n_mels)`` dB: framing, then
    :func:`frames_to_logmel`."""
    frames = frame_signal(audio, n_fft, hop_length, center=center)
    return frames_to_logmel(frames, sample_rate=sample_rate, n_mels=n_mels,
                            f_min=f_min, f_max=f_max)


@dataclasses.dataclass(frozen=True)
class LogMelFrontend:
    """Log-mel configuration. ``style="librosa"`` (the models' frontend):
    n_fft 1024, hop ``int(sr / fps)``, Slaney mel, per-utterance
    ``ref=max``, ``top_db`` 80, ``(db + 80) / 80``. ``style="torchaudio"``
    (the reference's legacy frontend, usually at n_fft 512): the
    window-normalized power spectrum, HTK mel without norm, ``log(mel +
    eps)``, ``int(L / sr * fps)`` frames. ``stft_method`` ``"matmul"``
    (the librosa style's fused kernel; DFT products for the torchaudio
    style) or ``"rfft"`` (``torch.fft.rfft``)."""

    sample_rate: int = 16000
    target_fps: float = 30.0
    n_fft: int = 1024
    n_mels: int = 80
    f_min: float = 80.0
    f_max: float | None = 8000.0
    style: str = "librosa"
    stft_method: str = "matmul"
    eps: float = 1e-8

    def __post_init__(self):
        if self.style not in ("librosa", "torchaudio"):
            raise ValueError(f"style must be 'librosa' or 'torchaudio', "
                             f"got {self.style!r}")
        if self.stft_method not in ("matmul", "rfft"):
            raise ValueError(f"stft_method must be 'matmul' or 'rfft', "
                             f"got {self.stft_method!r}")

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate / self.target_fps)

    @property
    def effective_f_max(self) -> float:
        return self.f_max if self.f_max is not None else self.sample_rate / 2.0

    def filterbank(self, device=None) -> torch.Tensor:
        """Bins-major ``(n_fft // 2 + 1, n_mels)``: Slaney for the librosa
        style, HTK without norm for the torchaudio style."""
        htk = self.style == "torchaudio"
        return mel_filterbank(self.sample_rate, self.n_fft, self.n_mels,
                              self.f_min, self.effective_f_max, htk=htk,
                              norm=None if htk else "slaney", device=device)

    def logmel_kwargs(self) -> dict:
        return dict(sample_rate=self.sample_rate, n_mels=self.n_mels,
                    f_min=self.f_min, f_max=self.effective_f_max)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        return log_mel_spectrogram(audio, self)


def log_mel_spectrogram(audio: torch.Tensor, cfg: LogMelFrontend
                        ) -> torch.Tensor:
    """Log-mel ``(..., T, n_mels)`` of ``audio (..., L)``. librosa style:
    dB relative to the utterance's max, clipped at -80 dB, mapped to [0,
    1] (through the fused kernel for ``stft_method="matmul"``). torchaudio
    style: natural-log mel, padded with its last frame or cut to
    ``int(L / sr * fps)`` frames."""
    if cfg.style == "librosa" and cfg.stft_method == "matmul":
        db = fused_log_mel_frontend(audio, n_fft=cfg.n_fft,
                                    hop_length=cfg.hop_length,
                                    **cfg.logmel_kwargs())
        ref = db.amax(dim=(-2, -1), keepdim=True)
        return (torch.clamp_min(db - ref, -80.0) + 80.0) / 80.0
    spec = stft_power(audio, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                      center=True, power=2.0,
                      normalized=cfg.style == "torchaudio",
                      method=cfg.stft_method)
    mel = torch.matmul(spec, cfg.filterbank(audio.device))
    if cfg.style == "librosa":
        return normalize_log_mel(power_to_db(mel, ref="max", top_db=80.0,
                                             ref_axes=(-2, -1)))
    log_mel = torch.log(mel + cfg.eps)
    expected = int(audio.shape[-1] / cfg.sample_rate * cfg.target_fps)
    t = log_mel.shape[-2]
    if t > expected:
        return log_mel[..., :expected, :]
    if t < expected:
        last = log_mel[..., -1:, :]
        return torch.cat([log_mel, last.expand(
            last.shape[:-2] + (expected - t, last.shape[-1]))], -2)
    return log_mel


def mel_with_temporal_detail(audio: torch.Tensor, cfg: LogMelFrontend
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mel (..., T, 80), detail (..., 3, 80))``: the detail is the last 3
    frames of the whole spectrogram, before any cut to the model window."""
    mel = log_mel_spectrogram(audio, cfg)
    return mel, mel[..., -3:, :]
