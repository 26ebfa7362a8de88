"""Dropout whose masks come from an explicit ``torch.Generator``."""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class BatchBlock:
    """The dropout generator of one data-parallel rank: ``generator``
    draws every site's mask for the global batch of ``total`` rows, and the
    rank keeps the rows of its block ``[start, stop)``. A site whose
    leading dim is ``k`` rows per utterance (the windows of a sequence,
    utterance-major) keeps ``[start * k, stop * k)``. The masks are then
    the ones one process draws for the whole batch."""

    generator: torch.Generator
    start: int
    stop: int
    total: int

    def uniform(self, x: torch.Tensor) -> torch.Tensor:
        """Uniform draws for ``x``'s elements: the rank's rows of the
        global batch's draws."""
        rows = self.stop - self.start
        if x.dim() == 0 or x.shape[0] % rows:
            raise ValueError(f"a dropout site of shape {tuple(x.shape)} is "
                             f"not {rows} utterances' rows")
        k = x.shape[0] // rows
        u = torch.rand((self.total * k,) + tuple(x.shape[1:]),
                       generator=self.generator, device=x.device,
                       dtype=x.dtype)
        return u[self.start * k:self.stop * k]


class Dropout(nn.Module):
    """Inverted dropout at ``rate``: each element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, as Flax's ``Dropout``.

    It acts only in training mode and only when the call passes a
    ``generator``, which draws the mask on the input's device; without one
    (or in eval mode, or at rate 0) it returns its input unchanged, as a
    Flax module does under ``deterministic=True``. The global RNG is never
    used, so a run that seeds its generators from ``(seed, step)`` draws
    the same masks after a resume. A :class:`BatchBlock` in place of the
    generator draws a data-parallel rank's rows of the global batch's
    masks."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Union[torch.Generator, BatchBlock, None] = None
                ) -> torch.Tensor:
        if generator is None or not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if isinstance(generator, BatchBlock):
            keep = generator.uniform(x) < keep_prob
        else:
            keep = torch.rand(x.shape, generator=generator, device=x.device,
                              dtype=x.dtype) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
