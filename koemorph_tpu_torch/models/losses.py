"""Loss functions and metrics for blendshape generation: the counterpart
of ``koemorph_tpu.models.losses``.

The losses are functions of tensors returning ``(total, metrics)`` and
differentiate through autograd; the metrics accumulator and the lip-sync
metrics run on the host in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from koemorph_tpu_torch.blendshapes import EXPRESSION_INDICES, MOUTH_INDICES
from koemorph_tpu_torch.ops.device_cache import device_cache, index_constant

__all__ = ["PERCEPTUAL_GROUPS", "PERCEPTUAL_GROUP_WEIGHTS",
           "KoeMorphLossConfig", "perceptual_loss", "landmark_loss",
           "koemorph_loss", "frame_metrics", "sequence_koemorph_loss",
           "dual_stream_loss", "BlendshapeMetrics",
           "compute_lip_sync_metrics", "KoeMorphLoss",
           "PerceptualBlendshapeLoss", "LandmarkConsistencyLoss"]

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


def dual_stream_loss(pred: torch.Tensor, target: torch.Tensor, *,
                     prev_pred: Optional[torch.Tensor] = None,
                     prev_target: Optional[torch.Tensor] = None,
                     mel_weights: Optional[torch.Tensor] = None,
                     emotion_weights: Optional[torch.Tensor] = None,
                     l1_weight: float = 1.0, l2_weight: float = 0.5,
                     velocity_weight: float = 0.1,
                     separation_weight: float = 0.01
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """L1 + L2 + velocity, plus the stream-separation regularizer, which
    penalizes mel-stream weight mass on the expressions and emotion-stream
    mass on the mouth."""
    losses: dict[str, torch.Tensor] = {}
    l1 = torch.mean(torch.abs(pred - target))
    l2 = torch.mean((pred - target) ** 2)
    losses["l1"] = l1_weight * l1
    losses["l2"] = l2_weight * l2
    metrics = {"l1": l1, "l2": l2}

    if prev_pred is not None and prev_target is not None:
        v = torch.mean(torch.abs((pred - prev_pred)
                                 - (target - prev_target)))
        losses["velocity"] = velocity_weight * v
        metrics["velocity"] = v

    if mel_weights is not None and emotion_weights is not None:
        mouth = index_constant(tuple(MOUTH_INDICES), mel_weights.device)
        expr = index_constant(tuple(EXPRESSION_INDICES), mel_weights.device)
        sep = (torch.mean(torch.softmax(mel_weights, -1)[expr])
               + torch.mean(torch.softmax(emotion_weights, -1)[mouth]))
        losses["separation"] = separation_weight * sep
        metrics["separation"] = sep

    total = sum(losses.values())
    metrics.update(frame_metrics(pred, target))
    return total, metrics


class BlendshapeMetrics:
    """Host-side accumulator of predictions and targets over batches."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.predictions: list[np.ndarray] = []
        self.targets: list[np.ndarray] = []

    def update(self, pred, target, audio_features=None):
        del audio_features
        self.predictions.append(_host(pred))
        self.targets.append(_host(target))

    def compute(self) -> dict[str, float]:
        if not self.predictions:
            return {}
        p = np.concatenate(self.predictions, axis=0)
        t = np.concatenate(self.targets, axis=0)
        m: dict[str, float] = {}
        m["mae"] = float(np.abs(p - t).mean())
        m["mse"] = float(((p - t) ** 2).mean())
        m["rmse"] = float(np.sqrt(((p - t) ** 2).mean()))

        per_bs = np.abs(p - t).mean(axis=0)
        m["max_bs_mae"] = float(per_bs.max())
        m["min_bs_mae"] = float(per_bs.min())
        m["std_bs_mae"] = (float(per_bs.std(ddof=1)) if len(per_bs) > 1
                           else 0.0)

        corrs = []
        for i in range(p.shape[1]):
            if p[:, i].std() > 1e-6 and t[:, i].std() > 1e-6:
                c = np.corrcoef(p[:, i], t[:, i])[0, 1]
                if not np.isnan(c):
                    corrs.append(float(c))
        m["mean_correlation"] = float(np.mean(corrs)) if corrs else 0.0
        m["min_correlation"] = float(np.min(corrs)) if corrs else 0.0

        if p.shape[0] > 1:
            dp, dt = np.diff(p, axis=0), np.diff(t, axis=0)
            m["temporal_consistency"] = float(np.abs(dp - dt).mean())
            m["pred_smoothness"] = float(np.abs(dp).mean())
            m["target_smoothness"] = float(np.abs(dt).mean())

        thr = 0.1
        pa, ta = (p > thr).astype(float), (t > thr).astype(float)
        m["pred_activity"] = float(pa.mean())
        m["target_activity"] = float(ta.mean())
        tp = (pa * ta).sum()
        fp = (pa * (1 - ta)).sum()
        fn = ((1 - pa) * ta).sum()
        precision = tp / (tp + fp + 1e-8)
        recall = tp / (tp + fn + 1e-8)
        m["precision"] = float(precision)
        m["recall"] = float(recall)
        m["f1_score"] = float(2 * precision * recall
                              / (precision + recall + 1e-8))
        return m


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compute_lip_sync_metrics(pred, target, audio_features=None
                             ) -> dict[str, float]:
    """Mouth-region MAE, mouth-activity correlation and, with
    ``audio_features``, the audio-visual sync correlation. Host-side."""
    p = _host(pred)
    t = _host(target)
    mouth = list(range(12, 32))
    pm, tm = p[:, mouth], t[:, mouth]
    m: dict[str, float] = {"mouth_mae": float(np.abs(pm - tm).mean())}

    pa, ta = pm.sum(axis=1), tm.sum(axis=1)
    if pa.std() > 1e-6 and ta.std() > 1e-6:
        c = np.corrcoef(pa, ta)[0, 1]
        m["mouth_correlation"] = float(c) if not np.isnan(c) else 0.0
    else:
        m["mouth_correlation"] = 0.0

    if audio_features is not None:
        af = _host(audio_features)
        if af.ndim == 3:
            energy = np.linalg.norm(af, axis=-1).mean(axis=-1)
        else:
            energy = np.linalg.norm(af, axis=-1)
        if energy.std() > 1e-6:
            c = np.corrcoef(pa, energy)[0, 1]
            m["audiovisual_sync"] = float(c) if not np.isnan(c) else 0.0
        else:
            m["audiovisual_sync"] = 0.0
    return m


class KoeMorphLoss:
    """The reference's callable loss over :func:`koemorph_loss`: returns
    ``(total, metrics)``, as the reference's ``(loss, loss_dict)``; the
    keyword weights are :class:`KoeMorphLossConfig`'s fields."""

    def __init__(self, reduction: str = "mean", **weights):
        if reduction != "mean":
            raise ValueError("only reduction='mean' is supported "
                             "(the reference default)")
        self.config = KoeMorphLossConfig(**weights)

    def __call__(self, pred_blendshapes, target_blendshapes,
                 prev_pred=None, prev_target=None, audio_features=None):
        return koemorph_loss(
            pred_blendshapes, target_blendshapes, prev_pred=prev_pred,
            prev_target=prev_target, audio_features=audio_features,
            config=self.config)


class PerceptualBlendshapeLoss:
    """The reference's callable group-weighted perceptual term
    (:func:`perceptual_loss`)."""

    def __call__(self, pred, target, audio_features=None):
        return perceptual_loss(pred, target, audio_features=audio_features)


class LandmarkConsistencyLoss:
    """The reference's callable approximate-landmark L2
    (:func:`landmark_loss`, its fixed projection)."""

    def __call__(self, pred, target):
        return landmark_loss(pred, target)
