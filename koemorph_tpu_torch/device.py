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


def device_label(device: DeviceLike = None) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit`` gives them (the name alone where
    ``nvidia-smi`` cannot be run): every time measured on the card is
    reported beside it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    import subprocess

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(dev)
    out = proc.stdout.strip()
    return out if proc.returncode == 0 and out else \
        torch.cuda.get_device_name(dev)
