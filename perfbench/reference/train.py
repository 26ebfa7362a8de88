"""Training, plainly: the sequence trainer's batches, step and update.

- Batches: the files of a data directory (16-bit PCM WAV beside JSONL
  blendshapes) in sorted order, shuffled per epoch by
  ``numpy.random.default_rng(epoch)``; each file's windows of ``span``
  frames at ``stride`` frames in order; batches of ``batch`` consecutive
  windows, the last partial batch of an epoch dropped.
- Step: the sequential model in training mode, its dropout masks drawn
  from a CUDA generator seeded from ``(seed, step)``; targets aligned with
  the output frames; the sequence loss; the gradients of every parameter.
- Update: the global norm clipped to ``clip``, then AdamW (optax's
  arithmetic) at the cosine schedule's rate.
"""

from __future__ import annotations

import json
import math
import wave
from pathlib import Path

import numpy as np
import torch

from perfbench.reference.losses import (KoeMorphLossConfig,
                                        sequence_koemorph_loss)


def read_pair(wav_path: Path) -> tuple[np.ndarray, np.ndarray]:
    """(float32 audio in [-1, 1], (frames, 52) float32 blendshapes)."""
    with wave.open(str(wav_path), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    audio = (pcm.astype(np.float64) / 32768.0).astype(np.float32)
    rows = [json.loads(line)["blendshapes"]
            for line in wav_path.with_suffix(".jsonl").read_text().split("\n")
            if line.strip()]
    return audio, np.asarray(rows, np.float32)


def epoch_batches(data_dir: Path, epoch: int, span: int, stride: int,
                  hop: int, batch: int, limit: int):
    """The first ``limit`` batches of ``epoch``: ``(audio (B, span*hop),
    blendshapes (B, span, 52))``."""
    files = sorted(Path(data_dir).glob("**/*.wav"))
    order = np.arange(len(files))
    np.random.default_rng(epoch).shuffle(order)
    out, rows = [], []
    for i in order:
        audio, bs = read_pair(files[i])
        frames = min(len(bs), len(audio) // hop)
        for s in range(0, frames - span + 1, stride):
            rows.append((audio[s * hop:(s + span) * hop], bs[s:s + span]))
            if len(rows) == batch:
                out.append((np.stack([a for a, _ in rows]),
                            np.stack([b for _, b in rows])))
                rows = []
                if len(out) == limit:
                    return out
    return out


def dropout_seed(seed: int, step: int) -> int:
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def cosine_lr(step: int, lr: float, decay_steps: int, eta_min: float
              ) -> float:
    count = min(step, decay_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    alpha = eta_min / lr
    return lr * ((1.0 - alpha) * cosine + alpha)


def loss_config(train_cfg: dict) -> KoeMorphLossConfig:
    """The configured weights; no temporal or velocity weight means the
    sequence trainer's velocity weight of 0.1."""
    fields = {f for f in KoeMorphLossConfig.__dataclass_fields__}
    cfg = KoeMorphLossConfig(**{k: float(v) for k, v in
                                train_cfg.get("loss", {}).items()
                                if k in fields})
    if cfg.temporal_weight == 0 and cfg.velocity_weight == 0:
        cfg = KoeMorphLossConfig(**{**cfg.__dict__, "velocity_weight": 0.1})
    return cfg


class Trainer:
    """The reference's model, parameters and AdamW state."""

    def __init__(self, model: torch.nn.Module, train_cfg: dict,
                 steps_per_epoch: int, seed: int):
        self.model = model
        self.params = dict(model.named_parameters())
        opt, sched = train_cfg["optimizer"], train_cfg["lr_scheduler"]
        self.lr, self.wd = float(opt["lr"]), float(opt["weight_decay"])
        self.b1, self.b2 = (float(b) for b in opt["betas"])
        self.eps = 1e-8
        self.clip = float(train_cfg["gradient_clip_val"])
        self.decay = max(1, int(sched["t_max"]) * steps_per_epoch
                         - int(sched.get("warmup_steps", 0)))
        self.eta_min = float(sched["eta_min"])
        self.loss_cfg = loss_config(train_cfg)
        self.seed = seed
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def loss_and_grads(self, audio: torch.Tensor, target: torch.Tensor):
        m = self.model
        m.train()
        gen = torch.Generator(device=audio.device)
        gen.manual_seed(dropout_seed(self.seed, self.count))
        pred = m(audio, generator=gen)["blendshapes"]        # (B, T, 52)
        idx = m.window_frames - 1 + torch.arange(
            pred.shape[1], device=audio.device) * m.stride_frames
        idx = idx.clamp(max=target.shape[1] - 1)
        loss, _ = sequence_koemorph_loss(pred.contiguous(),
                                         target[:, idx].contiguous(),
                                         config=self.loss_cfg)
        grads = torch.autograd.grad(loss, list(self.params.values()),
                                    allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(self.params.items(), grads)}

    @torch.no_grad()
    def update(self, grads: dict) -> dict:
        """Clip, then one AdamW update; returns the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if float(norm) >= self.clip:
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        lr = cosine_lr(self.count, self.lr, self.decay, self.eta_min)
        bc1 = 1.0 - self.b1 ** (self.count + 1)
        bc2 = 1.0 - self.b2 ** (self.count + 1)
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g * (1.0 - self.b1))
            self.nu[k].mul_(self.b2).add_((g * g) * (1.0 - self.b2))
            step = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                         + self.eps) + self.wd * p
            p.add_(step * -lr)
        self.count += 1
        return grads

    def step(self, audio: torch.Tensor, target: torch.Tensor):
        """(loss, clipped gradients) of one train step, parameters
        updated."""
        loss, grads = self.loss_and_grads(audio, target)
        return loss, self.update(grads)
