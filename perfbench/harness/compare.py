"""The comparisons that decide ``correct``, and the precision of the
control.

Each number compared is a gap between what the program produced and
what the plain reference works out again from the same inputs; a cell's
traffic file holds each number's limit."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def tf32():
    """Matrix products and convolutions in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def widest(got, want, columns=None) -> float:
    """The widest absolute gap, over the last axis's ``columns`` (all
    where None)."""
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return float((gap if columns is None else gap[..., list(columns)]).max())


def relative_gaps(got, want) -> np.ndarray:
    """Each element's gap relative to the reference's magnitude (floored
    at 1e-6)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-6)


def feature_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The median over features (last axis) of each feature's widest
    relative gap over the rows."""
    rel = relative_gaps(got, want)
    return float(np.median(rel.reshape(-1, rel.shape[-1]).max(axis=0)))


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    ref = {k: float(torch.linalg.vector_norm(v.double()))
           for k, v in want.items()}
    med = float(np.median(list(ref.values())))
    return {k: abs(float(torch.linalg.vector_norm(got[k].double()))
                   - ref[k]) / max(ref[k], med) for k in want}
