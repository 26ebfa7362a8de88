"""Blendshape decoder, temporal smoothing and output constraints of the
legacy model family.

Every piece of state the smoother and the constraints carry from one frame
to the next is an explicit object (:class:`SmootherState`,
:class:`ConstraintState`) that the call takes and returns, as the port's
``TemporalState`` is: nothing is kept in a module buffer. The smoother's
circular history pointer is a device scalar, so a step never reads it on
the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from koemorph_tpu_torch.models.attention import LN_EPS
from koemorph_tpu_torch.models.dropout import Dropout

__all__ = ["BlendshapeDecoder", "SmootherState", "TemporalSmoother",
           "ConstraintState", "BlendshapeConstraints",
           "validate_blendshape_output"]


def _activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":          # the exact (erf) form
        return F.gelu
    if name == "swish":
        return F.silu
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, negative_slope=0.1)
    raise ValueError(f"Unknown activation: {name}")


class BlendshapeDecoder(nn.Module):
    """MLP decoder ``(B, 52, d_model) -> (B, 52)``: an input projection,
    ``num_layers`` residual hidden layers (each with an optional
    LayerNorm), a projection to 52 per query token, of which blendshape
    ``i`` keeps token ``i``'s own output (the diagonal), then the output
    activation (``sigmoid``, ``tanh`` or ``none``). Given
    ``prev_blendshapes``, and with ``use_residual``, the output moves 10%
    toward them. Dropout acts in training mode on calls given a
    ``generator``."""

    def __init__(self, d_model: int = 256, hidden_dim: int = 128,
                 num_blendshapes: int = 52, num_layers: int = 2,
                 activation: str = "gelu", dropout: float = 0.1,
                 output_activation: str = "sigmoid",
                 use_residual: bool = True, use_layer_norm: bool = True,
                 bias: bool = True):
        super().__init__()
        if output_activation not in ("sigmoid", "tanh", "none"):
            raise ValueError(
                f"Unknown output activation: {output_activation}")
        self.num_blendshapes = num_blendshapes
        self.use_residual = use_residual
        self.output_activation = output_activation
        self.act = _activation(activation)
        self.input_proj = nn.Linear(d_model, hidden_dim, bias=bias)
        for i in range(num_layers):
            self.add_module(f"hidden_{i}",
                            nn.Linear(hidden_dim, hidden_dim, bias=bias))
            if use_layer_norm:
                self.add_module(f"norm_{i}",
                                nn.LayerNorm(hidden_dim, eps=LN_EPS))
        self.num_layers = num_layers
        self.use_layer_norm = use_layer_norm
        self.output_proj = nn.Linear(hidden_dim, num_blendshapes, bias=bias)
        self.dropout = Dropout(dropout)

    def forward(self, attention_output: torch.Tensor,
                prev_blendshapes: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if attention_output.shape[1] != self.num_blendshapes:
            raise ValueError(f"Expected {self.num_blendshapes} blendshapes, "
                             f"got {attention_output.shape[1]}")
        x = self.dropout(self.act(self.input_proj(attention_output)),
                         generator)
        for i in range(self.num_layers):
            residual = x
            x = getattr(self, f"hidden_{i}")(x)
            if self.use_layer_norm:
                x = getattr(self, f"norm_{i}")(x)
            x = self.dropout(self.act(x), generator)
            if self.use_residual:
                x = x + residual
        x = self.output_proj(x)                               # (B, 52, 52)
        blendshapes = torch.diagonal(x, dim1=1, dim2=2)       # (B, 52)
        if self.output_activation == "sigmoid":
            blendshapes = torch.sigmoid(blendshapes)
        elif self.output_activation == "tanh":
            blendshapes = torch.tanh(blendshapes)
        if prev_blendshapes is not None and self.use_residual:
            alpha = 0.1     # a small stabilizing pull toward the last frame
            blendshapes = (1 - alpha) * blendshapes + alpha * prev_blendshapes
        return blendshapes


@dataclasses.dataclass
class SmootherState:
    """Carry of :class:`TemporalSmoother`: the last output, the circular
    history ``(window, B, 52)`` and its write pointer (an int32 device
    scalar)."""

    prev_output: torch.Tensor
    history: torch.Tensor
    history_ptr: torch.Tensor

    @classmethod
    def create(cls, batch_size: int, num_blendshapes: int = 52,
               window_size: int = 5, device=None) -> "SmootherState":
        return cls(
            prev_output=torch.zeros((batch_size, num_blendshapes),
                                    device=device),
            history=torch.zeros((window_size, batch_size, num_blendshapes),
                                device=device),
            history_ptr=torch.zeros((), dtype=torch.int32, device=device))


def _gaussian_weights(window_size: int) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float32)
    center = (window_size - 1) / 2
    sigma = window_size / 6     # a 3-sigma window
    w = np.exp(-0.5 * ((x - center) / sigma) ** 2)
    return (w / w.sum()).astype(np.float32)


class TemporalSmoother(nn.Module):
    """Exponential, Gaussian-window or median smoothing:
    ``smoothed, new_state = smoother(blendshapes, state)``.

    Exponential: ``alpha * prev + (1 - alpha) * x`` with ``alpha`` fixed or,
    when ``learnable``, ``sigmoid`` of a parameter that starts at
    ``alpha``. The windowed methods write ``x`` into the circular history
    at the pointer first; Gaussian then weights the history (fixed 3-sigma
    weights, or the softmax of learnable ones that start uniform), median
    takes its middle (the mean of the two middle values of an even
    window). The state's tensors are detached."""

    def __init__(self, num_blendshapes: int = 52,
                 smoothing_method: str = "exponential", alpha: float = 0.8,
                 window_size: int = 5, learnable: bool = False):
        super().__init__()
        if smoothing_method not in ("exponential", "gaussian", "median"):
            raise ValueError(f"Unknown smoothing method: {smoothing_method}")
        self.smoothing_method = smoothing_method
        self.window_size = window_size
        self.learnable = learnable
        if smoothing_method == "exponential":
            if learnable:
                self.alpha = nn.Parameter(torch.tensor(alpha))
            else:
                self.register_buffer("alpha", torch.tensor(alpha),
                                     persistent=False)
        elif smoothing_method == "gaussian":
            if learnable:
                self.gaussian_weights = nn.Parameter(
                    torch.full((window_size,), 1.0 / window_size))
            else:
                self.register_buffer(
                    "gaussian_weights",
                    torch.from_numpy(_gaussian_weights(window_size)),
                    persistent=False)

    def forward(self, blendshapes: torch.Tensor, state: SmootherState
                ) -> tuple[torch.Tensor, SmootherState]:
        if self.smoothing_method == "exponential":
            alpha = torch.sigmoid(self.alpha) if self.learnable \
                else self.alpha
            smoothed = alpha * state.prev_output + (1 - alpha) * blendshapes
            return smoothed, dataclasses.replace(
                state, prev_output=smoothed.detach())

        history = state.history.index_copy(
            0, state.history_ptr.reshape(1).long(),
            blendshapes.detach()[None])
        ptr = torch.remainder(state.history_ptr + 1, self.window_size)
        if self.smoothing_method == "gaussian":
            w = torch.softmax(self.gaussian_weights, 0) if self.learnable \
                else self.gaussian_weights
            smoothed = torch.sum(w[:, None, None] * history, 0)
        else:
            ordered = torch.sort(history, 0).values
            n = self.window_size
            smoothed = (ordered[(n - 1) // 2] + ordered[n // 2]) * 0.5
        return smoothed, dataclasses.replace(state, history=history,
                                             history_ptr=ptr)


@dataclasses.dataclass
class ConstraintState:
    """The previous frame, for the temporal-smoothness report; ``valid``
    (a bool device scalar) is False until a frame has passed."""

    prev_blendshapes: torch.Tensor
    valid: torch.Tensor

    @classmethod
    def create(cls, batch_size: int, num_blendshapes: int = 52,
               device=None) -> "ConstraintState":
        return cls(prev_blendshapes=torch.zeros(
            (batch_size, num_blendshapes), device=device),
            valid=torch.zeros((), dtype=torch.bool, device=device))


class BlendshapeConstraints(nn.Module):
    """Value-range clamp, soft mutual exclusion of blendshape pairs (each
    pair divided by its sum) and violation reports. Returns
    ``(constrained, violations)``, or ``(constrained, violations,
    new_state)`` when given a state; ``violations`` is None unless asked
    for: ``range_violations``, ``exclusion_{i}_{j}`` (the pair's mean
    overlap) and, with a state, ``temporal_smoothness`` (0 on the first
    frame)."""

    def __init__(self, num_blendshapes: int = 52,
                 mutual_exclusions: tuple = ((25, 26), (20, 21)),
                 min_values: Optional[tuple] = None,
                 max_values: Optional[tuple] = None):
        super().__init__()
        self.num_blendshapes = num_blendshapes
        self.mutual_exclusions = tuple(tuple(p) for p in mutual_exclusions)
        mins = torch.zeros(num_blendshapes) if min_values is None \
            else torch.tensor(min_values, dtype=torch.float32)
        maxs = torch.ones(num_blendshapes) if max_values is None \
            else torch.tensor(max_values, dtype=torch.float32)
        self.register_buffer("mins", mins, persistent=False)
        self.register_buffer("maxs", maxs, persistent=False)
        for i, pair in enumerate(self.mutual_exclusions):
            self.register_buffer(f"_pair_{i}", torch.tensor(pair),
                                 persistent=False)

    def forward(self, blendshapes: torch.Tensor,
                state: Optional[ConstraintState] = None,
                apply_constraints: bool = True,
                return_violations: bool = False):
        constrained = blendshapes
        violations: dict[str, torch.Tensor] = {}
        if apply_constraints:
            constrained = torch.clamp(constrained, self.mins, self.maxs)
        if return_violations:
            violations["range_violations"] = torch.mean(
                ((blendshapes < self.mins) | (blendshapes > self.maxs)).to(
                    torch.float32))
        for i, (a, b) in enumerate(self.mutual_exclusions):
            if apply_constraints:
                combined = constrained[:, a] + constrained[:, b] + 1e-8
                pair = getattr(self, f"_pair_{i}")
                constrained = constrained.index_copy(
                    1, pair, constrained[:, pair] / combined[:, None])
            if return_violations:
                violations[f"exclusion_{a}_{b}"] = torch.minimum(
                    blendshapes[:, a], blendshapes[:, b]).mean()
        out_violations = violations if return_violations else None
        if state is None:
            return constrained, out_violations
        if return_violations:
            diff = torch.abs(blendshapes - state.prev_blendshapes)
            violations["temporal_smoothness"] = torch.where(
                state.valid, diff.mean(), torch.zeros((), device=diff.device))
        new_state = ConstraintState(
            prev_blendshapes=blendshapes.detach(),
            valid=torch.ones_like(state.valid))
        return constrained, out_violations, new_state


def validate_blendshape_output(blendshapes) -> dict:
    """Host-side check of a ``(B, 52)`` blendshape array: shape, range,
    NaN and Inf, activation statistics, dead and saturated blendshapes."""
    if isinstance(blendshapes, torch.Tensor):
        blendshapes = blendshapes.detach().cpu().numpy()
    bs = np.asarray(blendshapes)
    results: dict = {"valid": True, "warnings": [], "stats": {}}
    if bs.ndim != 2 or bs.shape[1] != 52:
        results["valid"] = False
        results["warnings"].append(f"Expected shape (B, 52), got {bs.shape}")
        return results

    mn, mx = float(bs.min()), float(bs.max())
    results["stats"]["value_range"] = (mn, mx)
    if mn < 0:
        results["warnings"].append(f"Negative values detected: {mn:.3f}")
    if mx > 1:
        results["warnings"].append(f"Values above 1 detected: {mx:.3f}")
    if np.isnan(bs).any():
        results["valid"] = False
        results["warnings"].append("NaN values detected")
    if np.isinf(bs).any():
        results["valid"] = False
        results["warnings"].append("Infinite values detected")

    mean_act = bs.mean(axis=0)
    results["stats"]["mean_activation"] = float(mean_act.mean())
    results["stats"]["std_activation"] = float(bs.std(axis=0).mean())
    results["stats"]["active_blendshapes"] = int((mean_act > 0.1).sum())
    dead = int((bs.max(axis=0) < 0.01).sum())
    results["stats"]["dead_blendshapes"] = dead
    if dead > 10:
        results["warnings"].append(f"Many inactive blendshapes: {dead}/52")
    saturated = int((bs.min(axis=0) > 0.9).sum())
    results["stats"]["saturated_blendshapes"] = saturated
    if saturated > 5:
        results["warnings"].append(
            f"Many saturated blendshapes: {saturated}/52")
    return results
