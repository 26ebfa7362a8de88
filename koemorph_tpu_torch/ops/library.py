"""The three hand-written kernels as ``torch.library`` custom operators,
so that a program exported by ``torch.export`` holds them as single nodes:

- ``koemorph_torch::cycle_dsum`` (K1, :func:`..f0.cycle_dsum_plain`),
- ``koemorph_torch::dk_roots`` (K2, :func:`..egemaps.poly_roots_plain`;
  its output is complex64),
- ``koemorph_torch::logmel`` (K3, :func:`..frontend.frames_to_logmel_plain`).

Each operator's CUDA implementation is the kernel's launch wrapper in
:mod:`koemorph_tpu_torch.ops.cuda` (which builds the kernel at its first
launch and counts every launch), its CPU implementation the plain form,
and its fake implementation gives the output's shape and dtype for
tracing. Registering them, which importing this module does, builds no
kernel and touches no CUDA. The dispatchers ``f0.cycle_dsum``,
``egemaps.poly_roots`` and ``frontend.frames_to_logmel`` call these
operators only while a program is being exported
(``torch.compiler.is_exporting()``); live calls reach the wrappers and
plain forms directly, which spares the eager paths the operators'
dispatch on the host (a live frame through the operators is timed against
the direct route in ``chip_smoke.py``'s ``export`` phase).
"""

from __future__ import annotations

import torch
from torch.library import custom_op

from koemorph_tpu_torch.ops import cuda as cuda_kernels
from koemorph_tpu_torch.ops.egemaps import poly_roots_plain
from koemorph_tpu_torch.ops.f0 import cycle_dsum_plain
from koemorph_tpu_torch.ops.frontend import frames_to_logmel_plain

__all__ = ["NAMESPACE", "OPS", "cycle_dsum", "dk_roots", "logmel"]

NAMESPACE = "koemorph_torch"
#: the operators' names in an exported graph
OPS = tuple(f"{NAMESPACE}.{name}" for name in
            ("cycle_dsum", "dk_roots", "logmel"))


@custom_op(f"{NAMESPACE}::cycle_dsum", mutates_args=())
def cycle_dsum(frames: torch.Tensor, start: torch.Tensor, tau: torch.Tensor,
               off: torch.Tensor, n_cycles: int, half_lag: int
               ) -> torch.Tensor:
    """``(..., T, n)`` frames, ``(..., T)`` int32 starts, float32 periods
    and offsets -> ``(..., T, n_cycles, 2*half_lag+1)`` float32."""
    return cycle_dsum_plain(frames, start, tau, off, n_cycles=n_cycles,
                            half_lag=half_lag)


@cycle_dsum.register_kernel("cuda")
def _(frames, start, tau, off, n_cycles, half_lag):
    return cuda_kernels.cycle_dsum(frames, start, tau, off,
                                   n_cycles=n_cycles, half_lag=half_lag)


@cycle_dsum.register_fake
def _(frames, start, tau, off, n_cycles, half_lag):
    return frames.new_empty(frames.shape[:-1]
                            + (n_cycles, 2 * half_lag + 1))


@custom_op(f"{NAMESPACE}::dk_roots", mutates_args=())
def dk_roots(a: torch.Tensor) -> torch.Tensor:
    """``(..., p+1)`` float32 coefficients -> ``(..., p)`` complex64
    roots."""
    return poly_roots_plain(a)


@dk_roots.register_kernel("cuda")
def _(a):
    return cuda_kernels.dk_roots(a.contiguous())


@dk_roots.register_fake
def _(a):
    return a.new_empty(a.shape[:-1] + (a.shape[-1] - 1,),
                       dtype=torch.complex64)


@custom_op(f"{NAMESPACE}::logmel", mutates_args=())
def logmel(frames: torch.Tensor, sample_rate: int, n_mels: int,
           f_min: float, f_max: float) -> torch.Tensor:
    """``(..., T, n_fft)`` un-windowed frames -> ``(..., T, n_mels)``
    float32 dB."""
    return frames_to_logmel_plain(frames, sample_rate=sample_rate,
                                  n_mels=n_mels, f_min=f_min, f_max=f_max)


@logmel.register_kernel("cuda")
def _(frames, sample_rate, n_mels, f_min, f_max):
    return cuda_kernels.logmel(frames, sample_rate=sample_rate,
                               n_mels=n_mels, f_min=f_min, f_max=f_max)


@logmel.register_fake
def _(frames, sample_rate, n_mels, f_min, f_max):
    return frames.new_empty(frames.shape[:-1] + (n_mels,))
