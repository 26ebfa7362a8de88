"""Dropout whose masks come from an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):
    """Inverted dropout at ``rate``: each element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, as Flax's ``Dropout``.

    It acts only in training mode and only when the call passes a
    ``generator``, which draws the mask on the input's device; without one
    (or in eval mode, or at rate 0) it returns its input unchanged, as a
    Flax module does under ``deterministic=True``. The global RNG is never
    used, so a run that seeds its generators from ``(seed, step)`` draws
    the same masks after a resume."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
