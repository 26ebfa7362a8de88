"""Random weights drawn with the Flax initializers' distributions, on the
CPU from an explicit ``torch.Generator``."""

from __future__ import annotations

import math

import torch
from torch import nn

from koemorph_tpu_torch.features.wav2vec2 import lecun_normal

__all__ = ["xavier_uniform", "init_like_flax"]


def xavier_uniform(shape: tuple, generator: torch.Generator
                   ) -> torch.Tensor:
    """Flax's ``xavier_uniform`` of a 2-D shape: uniform in +-sqrt(6 /
    (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (2.0 * torch.rand(shape, generator=generator) - 1.0) * limit


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator, *,
                   xavier: tuple = (), skip: tuple = (),
                   queries: tuple = ()) -> None:
    """Random weights with the Flax initializers' distributions, drawn in
    three passes: every ``nn.Linear`` of ``module`` gets a LeCun truncated
    normal weight (Flax's Dense default), or Xavier uniform where its name
    ends with one of ``xavier``, and a zero bias; every LayerNorm a unit
    weight and a zero bias. Then each ``(tensor, draw)`` of ``queries``
    takes ``draw(shape, generator)``. Then every packed in-projection
    (``in_proj_weight``) takes Xavier uniform and a zero bias. Modules
    whose name starts with one of ``skip`` are left alone."""
    mods = [(name, mod) for name, mod in module.named_modules()
            if not (skip and name.startswith(tuple(skip)))]
    for name, mod in mods:
        if isinstance(mod, nn.Linear):
            shape = tuple(mod.weight.shape)
            w = (xavier_uniform(shape, generator)
                 if name.endswith(tuple(xavier))
                 else lecun_normal(shape, mod.in_features, generator))
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for q, draw in queries:
        q.copy_(draw(tuple(q.shape), generator))
    for _, mod in mods:
        if hasattr(mod, "in_proj_weight"):
            w = mod.in_proj_weight
            w.copy_(xavier_uniform(tuple(w.shape), generator))
            mod.in_proj_bias.zero_()
