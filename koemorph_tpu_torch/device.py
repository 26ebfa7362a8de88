"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device.
A missing GPU is an error, never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def scalar_like(value: float, like: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A 0-dim tensor on ``like``'s device.

    Dividing by it is a true IEEE division on every device. Dividing by a
    Python number is not: CUDA multiplies by the rounded reciprocal, and
    ``number / tensor`` is ``tensor.reciprocal() * number`` everywhere. Both
    can move a value across a rounding or flooring boundary.
    """
    return torch.full((), value, dtype=dtype or like.dtype, device=like.device)
