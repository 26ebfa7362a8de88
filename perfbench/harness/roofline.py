"""The card's peaks and the work of each hand-written kernel, counted from
its inputs.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity): 3.35
TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores, 495 TFLOP/s
in TF32 on them; 3xTF32 (the logmel kernel's ``wgmma`` path, which keeps
float32 accuracy) does three TF32 products per float32 product.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the rate of the units it runs on. Bytes count each input
byte once and each output byte once; operations count what these inputs
need (the samples the cycle masks select), not the most they could.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
PEAK_3XTF32_PER_S = PEAK_TF32_PER_S / 3.0
#: the logmel kernel runs its product on the tensor cores above this T
LOGMEL_WGMMA_MIN_T = 9

#: the profiler's kernel names of each hand-written kernel, and the device
#: kernels one launch of its wrapper runs (logmel: its product pass and
#: its mel pass)
KERNEL_PATTERNS = {"cycle_dsum": "cycle_dsum_kernel",
                   "dk_roots": "dk_roots_kernel", "logmel": "logmel_"}
KERNELS_PER_LAUNCH = {"cycle_dsum": 1, "dk_roots": 1, "logmel": 2}


def bound_s(nbytes: float, ops: float, rate: float) -> float:
    """The least time the card can take over ``nbytes`` and ``ops``."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / rate)


class Layout(NamedTuple):
    frame_stride: int
    frames: int
    batches: int


def frame_layout(frames: torch.Tensor) -> Layout:
    """Where the frames of a ``(..., T, n)`` view lie in its storage: the
    kernels read a frame view in place."""
    t, n = frames.shape[-2], frames.shape[-1]
    return Layout(frame_stride=frames.stride(-2) if t > 1 else n, frames=t,
                  batches=math.prod(frames.shape[:-2]))


def k1_bytes(layout: Layout, n: int, rows: int, n_out: int) -> float:
    """cycle_dsum: the distinct samples the frame view covers, read once,
    the per-row start, tau and offset, the output."""
    per_batch = ((layout.frames - 1) * layout.frame_stride + n
                 if layout.frame_stride <= n else layout.frames * n)
    return 4.0 * layout.batches * per_batch + rows * (4.0 * n_out + 12)


def cycle_masked(n: int, start: torch.Tensor, tau: torch.Tensor,
                 off: torch.Tensor, n_cycles: int, half_lag: int) -> float:
    """The samples the cycle masks select over all rows: sample ``j`` of
    row ``r`` is in cycle ``k`` where ``off + k tau <= j < off + (k+1)
    tau`` and ``j <= n - 1 - 2 half_lag - start``."""
    start, tau, off = (v.reshape(-1).to(torch.float64)
                       for v in (start, tau, off))
    lim = (n - 1.0 - 2.0 * half_lag) - start          # last j allowed
    span = n - 2 * half_lag
    total = torch.zeros((), dtype=torch.float64, device=tau.device)
    for k in range(n_cycles):
        lo = torch.clamp(torch.ceil(off + k * tau), min=0.0)
        hi_excl = torch.ceil(off + (k + 1.0) * tau)
        hi = torch.minimum(torch.minimum(hi_excl - 1.0, lim),
                           torch.full_like(lim, span - 1.0))
        count = torch.clamp(hi - lo + 1.0, min=0.0)
        total = total + torch.nan_to_num(count, nan=0.0, posinf=0.0,
                                         neginf=0.0).sum()
    return float(total)


def k1_bound_s(layout: Layout, n: int, masked: float, rows: int,
               n_cycles: int, half_lag: int) -> float:
    lags = 2 * half_lag + 1
    return bound_s(k1_bytes(layout, n, rows, n_cycles * lags),
                   3.0 * lags * masked, PEAK_FP32_PER_S)


def k1_ops(masked: float, half_lag: int) -> float:
    return 3.0 * (2 * half_lag + 1) * masked


def k2_bytes(rows: int) -> float:
    """dk_roots: 11 float32 coefficients in, 10 complex64 roots out per
    row, and the 10 starting points."""
    return rows * 11 * 4 + rows * 10 * 8 + 10 * 8


def k2_ops(rows: int, iters: int = 20) -> float:
    """Durand-Kerner: per iteration and root, a Horner evaluation (10
    complex multiply-adds), 10 differences and products and the update."""
    return iters * 10.0 * (10 * 11 + 10 * 10 + 14) * rows


def k2_bound_s(rows: int) -> float:
    return bound_s(k2_bytes(rows), k2_ops(rows), PEAK_FP32_PER_S)


def k3_bytes(t: int, live: int, nnz: int, n_fft: int = 1024,
             n_mels: int = 80) -> float:
    """logmel: the frames, the live bins' two bases, the nonzero filter
    weights, the dB rows."""
    return 4.0 * (t * n_fft + 2 * n_fft * live + nnz + t * n_mels)


def k3_ops(t: int, live: int, nnz: int, n_fft: int = 1024) -> float:
    """Two DFT products over the live bins and the mel product over the
    nonzero weights (every other bin adds exactly 0)."""
    return t * (2.0 * n_fft * live * 2 + 2.0 * nnz)


def k3_bound_s(t: int, live: int, nnz: int) -> float:
    rate = PEAK_3XTF32_PER_S if t >= LOGMEL_WGMMA_MIN_T else PEAK_FP32_PER_S
    return bound_s(k3_bytes(t, live, nnz), k3_ops(t, live, nnz), rate)


def logmel_live(n_fft: int = 1024, sample_rate: int = 16000,
                n_mels: int = 80, f_min: float = 80.0, f_max: float = 8000.0
                ) -> tuple[int, int]:
    """(live bins, nonzero filter weights) of the mel filterbank: the
    bins some filter reads, from the first to the last."""
    from perfbench.reference.mel import mel_filterbank
    fb = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max,
                        device=torch.device("cpu"))
    rows = torch.nonzero(fb.abs().sum(1) > 0).reshape(-1)
    return int(rows[-1] - rows[0] + 1), int((fb != 0).sum())
