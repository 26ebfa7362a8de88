"""The sequence trainer's loss: the combined frame loss over every output
frame plus the temporal and velocity terms (copied from the program's
plain loss functions)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from perfbench.reference.device_cache import device_cache


#: perceptual group index ranges
PERCEPTUAL_GROUPS: dict[str, tuple[int, int]] = {
    "eye": (0, 12),
    "mouth": (12, 32),
    "brow": (32, 44),
    "jaw": (44, 52),
}
PERCEPTUAL_GROUP_WEIGHTS: dict[str, float] = {
    "mouth": 2.0, "eye": 1.0, "brow": 1.0, "jaw": 1.5,
}


@dataclasses.dataclass(frozen=True)
class KoeMorphLossConfig:
    """Weights of the combined loss. ``active_weight`` weights the MSE/L1
    elements whose target exceeds ``active_threshold`` (weights
    renormalized to mean 1); 1.0 gives plain means."""

    mse_weight: float = 1.0
    l1_weight: float = 0.1
    perceptual_weight: float = 0.5
    temporal_weight: float = 0.2
    sparsity_weight: float = 0.01
    smoothness_weight: float = 0.1
    landmark_weight: float = 0.3
    velocity_weight: float = 0.05
    active_weight: float = 1.0
    active_threshold: float = 0.1
    eps: float = 1e-8


def _landmark_projection(num_landmarks: int = 68, seed: int = 0
                         ) -> np.ndarray:
    """Fixed random 52 -> 2*num_landmarks projection (a placeholder
    mapping), deterministic by seed so train and eval agree."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((num_landmarks * 2, 52)) * 0.01).astype(
        np.float32)


_LANDMARK_W = _landmark_projection()


def perceptual_loss(pred: torch.Tensor, target: torch.Tensor,
                    audio_features: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Group-weighted MSE, plus the cosine consistency of the audio energy
    with the mouth activation when ``audio_features`` are given."""
    total = 0.0
    for name, (lo, hi) in PERCEPTUAL_GROUPS.items():
        g = torch.mean((pred[:, lo:hi] - target[:, lo:hi]) ** 2)
        total = total + PERCEPTUAL_GROUP_WEIGHTS[name] * g

    if audio_features is not None:
        lo, hi = PERCEPTUAL_GROUPS["mouth"]
        mouth_act = pred[:, lo:hi].mean(1)                     # (B,)
        if audio_features.dim() == 3:                          # (B, T, D)
            energy = torch.linalg.vector_norm(audio_features, dim=2).mean(1)
        else:
            energy = torch.linalg.vector_norm(audio_features, dim=1)
        m = mouth_act / (torch.linalg.vector_norm(mouth_act) + 1e-8)
        e = energy / (torch.linalg.vector_norm(energy) + 1e-8)
        total = total + 0.5 * (1.0 - torch.sum(m * e))
    return total


@device_cache(8)
def _landmark_w(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_LANDMARK_W).to(device, dtype)


def landmark_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L2 on approximate landmark positions (the fixed projection)."""
    w = _landmark_w(pred.device, pred.dtype)
    pl = (pred @ w.T).reshape(pred.shape[0], -1, 2)
    tl = (target @ w.T).reshape(target.shape[0], -1, 2)
    return torch.mean((pl - tl) ** 2)


def koemorph_loss(pred: torch.Tensor, target: torch.Tensor, *,
                  prev_pred: Optional[torch.Tensor] = None,
                  prev_target: Optional[torch.Tensor] = None,
                  audio_features: Optional[torch.Tensor] = None,
                  config: KoeMorphLossConfig = KoeMorphLossConfig()
                  ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Reconstruction + perceptual + temporal + regularization loss over
    ``(B, 52)`` frames. The metrics hold the unweighted terms."""
    c = config
    losses: dict[str, torch.Tensor] = {}
    metrics: dict[str, torch.Tensor] = {}

    if c.active_weight != 1.0:
        w = 1.0 + (c.active_weight - 1.0) * (
            target > c.active_threshold).to(pred.dtype)
        w = w / (torch.mean(w) + c.eps)
    else:
        w = None
    if c.mse_weight > 0:
        mse_plain = torch.mean((pred - target) ** 2)
        mse = mse_plain if w is None else torch.mean(w * (pred - target) ** 2)
        losses["mse"] = c.mse_weight * mse
        metrics["mse"] = mse_plain
    if c.l1_weight > 0:
        l1_plain = torch.mean(torch.abs(pred - target))
        l1 = l1_plain if w is None else torch.mean(
            w * torch.abs(pred - target))
        losses["l1"] = c.l1_weight * l1
        metrics["l1"] = l1_plain
    if c.perceptual_weight > 0:
        p = perceptual_loss(pred, target, audio_features)
        losses["perceptual"] = c.perceptual_weight * p
        metrics["perceptual"] = p
    if c.temporal_weight > 0 and prev_pred is not None \
            and prev_target is not None:
        t = torch.mean(((pred - prev_pred) - (target - prev_target)) ** 2)
        losses["temporal"] = c.temporal_weight * t
        metrics["temporal"] = t
    if c.velocity_weight > 0 and prev_pred is not None \
            and prev_target is not None:
        v = torch.mean(torch.abs((pred - prev_pred)
                                 - (target - prev_target)))
        losses["velocity"] = c.velocity_weight * v
        metrics["velocity"] = v
    if c.sparsity_weight > 0:
        s = torch.mean(torch.abs(pred))
        losses["sparsity"] = c.sparsity_weight * s
        metrics["sparsity"] = s
    if c.smoothness_weight > 0:
        # total variation across the blendshape axis
        sm = torch.mean(torch.abs(torch.diff(pred, dim=1)))
        losses["smoothness"] = c.smoothness_weight * sm
        metrics["smoothness"] = sm
    if c.landmark_weight > 0:
        lm = landmark_loss(pred, target)
        losses["landmark"] = c.landmark_weight * lm
        metrics["landmark"] = lm

    total = sum(losses.values())
    metrics.update(frame_metrics(pred, target, eps=c.eps))
    return total, metrics


def frame_metrics(pred: torch.Tensor, target: torch.Tensor,
                  eps: float = 1e-8) -> dict[str, torch.Tensor]:
    """MAE, RMSE, per-row correlation, active-blendshape precision, recall
    and F1 (threshold 0.1), and the range ratio."""
    out: dict[str, torch.Tensor] = {}
    out["mae"] = torch.mean(torch.abs(pred - target))
    out["rmse"] = torch.sqrt(torch.mean((pred - target) ** 2))

    p = pred - pred.mean(-1, keepdim=True)
    t = target - target.mean(-1, keepdim=True)
    denom = torch.sqrt(torch.sum(p * p, -1) * torch.sum(t * t, -1)) + eps
    out["correlation"] = torch.mean(torch.sum(p * t, -1) / denom)

    thr = 0.1
    pa = (pred > thr).to(torch.float32)
    ta = (target > thr).to(torch.float32)
    tp = torch.sum(pa * ta)
    fp = torch.sum(pa * (1 - ta))
    fn = torch.sum((1 - pa) * ta)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    out["precision"] = precision
    out["recall"] = recall
    out["f1_score"] = 2 * precision * recall / (precision + recall + eps)

    pr = pred.max() - pred.min()
    tr = target.max() - target.min()
    out["range_ratio"] = pr / (tr + eps)
    return out


def sequence_koemorph_loss(pred_seq: torch.Tensor, target_seq: torch.Tensor,
                           *, config: KoeMorphLossConfig = KoeMorphLossConfig()
                           ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Sequence variant over ``(B, T, 52)``: the frame terms over all
    frames, the temporal and velocity terms from consecutive frames."""
    c = config
    b, t, _ = pred_seq.shape
    total, metrics = koemorph_loss(
        pred_seq.reshape(b * t, -1), target_seq.reshape(b * t, -1),
        config=dataclasses.replace(config, temporal_weight=0.0,
                                   velocity_weight=0.0))
    if t > 1 and (c.temporal_weight > 0 or c.velocity_weight > 0):
        dp = pred_seq[:, 1:] - pred_seq[:, :-1]
        dt = target_seq[:, 1:] - target_seq[:, :-1]
        if c.temporal_weight > 0:
            tl = torch.mean((dp - dt) ** 2)
            total = total + c.temporal_weight * tl
            metrics["temporal"] = tl
        if c.velocity_weight > 0:
            vl = torch.mean(torch.abs(dp - dt))
            total = total + c.velocity_weight * vl
            metrics["velocity"] = vl
    return total, metrics
