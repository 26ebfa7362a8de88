"""Model weights from a seed, made on the device in one draw.

One ``torch.rand`` call on the card gives a uniform number for every
element of every parameter; each leaf maps its slice to its distribution
(Flax's initializers, as the port's ``init_random`` draws them): LeCun
truncated normal for dense kernels, Xavier uniform for the packed
attention in-projections, N(0, 0.02) for the learned queries. Biases and
norm gains, which the Flax initializers set to 0 and 1, are drawn as 0 +
N(0, 0.02) and 1 + N(0, 0.02) instead, so that a comparison with the
reference reads every parameter. Leaves that the model's constructor
sets to constants (the per-stream fusion weights, the EMA coefficient)
keep them. The same state dict is loaded into the program and handed to
the reference."""

from __future__ import annotations

import math

import torch

#: Flax's LeCun truncated normal: the std of a unit normal cut at +-2
TRUNC_STD = 0.87962566103423978
_CONSTANT = ("mel_weights", "emotion_weights", "smoothing_alpha")


def _normal(u: torch.Tensor) -> torch.Tensor:
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


def _truncated_normal(u: torch.Tensor) -> torch.Tensor:
    """A unit normal cut at +-2, by its inverse distribution function."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    return _normal(lo + u * (1.0 - 2.0 * lo))


def seeded_state(template: torch.nn.Module, seed: int, device
                 ) -> dict[str, torch.Tensor]:
    """A state dict for ``template``'s parameters and buffers on
    ``device``, drawn from ``seed``."""
    state = template.state_dict()
    total = sum(v.numel() for k, v in state.items()
                if v.is_floating_point() and not k.endswith(_CONSTANT))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    u = u.clamp(1e-12, 1.0 - 1e-12)
    out, pos = {}, 0
    for key, ref in state.items():
        if not ref.is_floating_point() or key.endswith(_CONSTANT):
            out[key] = ref.detach().to(device, copy=True)
            continue
        x = u[pos: pos + ref.numel()].reshape(ref.shape)
        pos += ref.numel()
        if key.endswith("in_proj_weight"):
            limit = math.sqrt(6.0 / (ref.shape[0] + ref.shape[1]))
            w = (2.0 * x - 1.0) * limit
        elif key.endswith("queries"):
            w = 0.02 * _normal(x)
        elif key.endswith("weight") and ref.dim() == 2:
            w = _truncated_normal(x) / math.sqrt(ref.shape[1]) / TRUNC_STD
        elif key.endswith("weight"):
            w = 1.0 + 0.02 * _normal(x)
        else:
            w = 0.02 * _normal(x)
        out[key] = w.to(ref.dtype)
    return out
