"""The floating-point work of a step, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products
(and convolutions) a function runs. The three functions the program runs
as hand-written kernels are counted by :mod:`.roofline` from their
inputs instead, so while counting they are replaced by stubs that return
zeros of their output's shape (the reference's shapes never depend on
values)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def kernels_stubbed():
    from perfbench.reference import egemaps, f0, frontend

    def logmel(frames, *, sample_rate=16000, n_mels=80, f_min=80.0,
               f_max=8000.0):
        return torch.zeros(frames.shape[:-1] + (n_mels,),
                           device=frames.device)

    def cycle_dsum(frames, start, tau, off, *, n_cycles, half_lag):
        return torch.zeros(frames.shape[:-1] + (n_cycles, 2 * half_lag + 1),
                           device=frames.device)

    def poly_roots(a):
        return torch.zeros(a.shape[:-1] + (a.shape[-1] - 1,),
                           dtype=torch.complex64, device=a.device)

    saved = (frontend.frames_to_logmel, f0.cycle_dsum, egemaps.poly_roots)
    frontend.frames_to_logmel, f0.cycle_dsum, egemaps.poly_roots = (
        logmel, cycle_dsum, poly_roots)
    try:
        yield
    finally:
        (frontend.frames_to_logmel, f0.cycle_dsum,
         egemaps.poly_roots) = saved


def count_flops(fn) -> float:
    """Floating-point operations of ``fn()`` outside the kernels."""
    from torch.utils.flop_counter import FlopCounterMode
    # with autograd on: the counter's module hooks need the graph
    with kernels_stubbed(), torch.enable_grad(), \
            FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
