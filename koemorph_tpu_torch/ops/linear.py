"""The wav2vec2 encoder's linear projections, through one dispatcher.

:func:`linear` applies one to three ``nn.Linear`` layers to the same input
(three: the attention's q, k and v projections, as one grouped launch on
the card), optionally followed by the exact GELU. Which form runs is read
off the call itself:

- a CPU tensor, a tensor that is not float32 (a float64 copy of the
  encoder), or a layer that is not a plain ``nn.Linear`` (a sharded layer
  of :mod:`koemorph_tpu_torch.parallel.tp`): :func:`linear_plain`, each
  layer's own forward (``F.linear``), then ``F.gelu``;
- a CUDA tensor while autograd records the call (the trainers: the input
  or a parameter requires a gradient under grad mode): the same plain
  form, since the kernel has no backward;
- a float32 CUDA tensor otherwise (serving under ``inference_mode``,
  the decode, the emotion extractor): the 3xTF32 kernel
  :func:`koemorph_tpu_torch.ops.cuda.linear_3xtf32`, bias and GELU in its
  epilogue.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from koemorph_tpu_torch.ops import cuda as cuda_kernels

__all__ = ["linear", "linear_plain"]


def linear_plain(x: torch.Tensor, *layers: nn.Module, gelu: bool = False
                 ) -> tuple[torch.Tensor, ...]:
    """``layer(x)`` for each layer (``F.gelu`` of it with ``gelu``)."""
    outs = tuple(layer(x) for layer in layers)
    return tuple(F.gelu(y) for y in outs) if gelu else outs


def _records(x: torch.Tensor, layers) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        p.requires_grad for layer in layers for p in layer.parameters()))


def linear(x: torch.Tensor, *layers: nn.Module, gelu: bool = False
           ) -> tuple[torch.Tensor, ...]:
    """:func:`linear_plain`'s function: the kernel for a float32 CUDA
    input that autograd does not record and plain float32 ``nn.Linear``
    layers, else the plain form (see the module's docstring)."""
    if (x.device.type == "cuda" and x.dtype == torch.float32
            and all(type(m) is nn.Linear and m.weight.dtype == torch.float32
                    for m in layers)
            and not _records(x, layers)):
        return tuple(cuda_kernels.linear_3xtf32(
            x, [m.weight for m in layers], [m.bias for m in layers],
            gelu=gelu))
    return linear_plain(x, *layers, gelu=gelu)
