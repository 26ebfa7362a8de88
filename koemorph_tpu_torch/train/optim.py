"""Learning-rate schedules and the optimizer, from the ``training`` config
group: the counterpart of ``koemorph_tpu.train.optim``, which builds them
from optax.

The step follows optax's arithmetic, not ``torch.optim``'s:

- global-norm clipping leaves the gradients alone when their norm is below
  the limit and otherwise divides them by the norm and multiplies by the
  limit (``optax.clip_by_global_norm``);
- AdamW decays every parameter (biases, norms, queries, stream weights and
  ``smoothing_alpha`` too), with ``eps`` outside the square root;
- the schedule is read at the update count before the update;
- with ``accumulate_grad_batches`` k > 1 (``optax.MultiSteps``) the
  gradients of k calls are averaged, and only the k-th call updates the
  parameters and advances the schedule.

Every state tensor is written in place and the per-update scalars (the
learning rate, the bias corrections) are read from device tensors, so a
CUDA graph of a train step replays the update (:meth:`Optimizer.update`)
while the host keeps the counts (:meth:`Optimizer.advance`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["create_lr_schedule", "create_optimizer", "Optimizer",
           "global_norm"]

Schedule = Callable[[int], float]


def _constant(value: float) -> Schedule:
    return lambda step: value


def _cosine_decay(init_value: float, decay_steps: int,
                  alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""
    def schedule(step: int) -> float:
        count = min(step, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def _linear(init_value: float, end_value: float,
            transition_steps: int) -> Schedule:
    """``optax.linear_schedule``."""
    def schedule(step: int) -> float:
        count = min(max(step, 0), transition_steps)
        frac = 1.0 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _join(schedules: list, boundaries: list) -> Schedule:
    """``optax.join_schedules``: the later schedule sees ``step -
    boundary``."""
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, later in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = later(step - boundary)
        return out
    return schedule


def create_lr_schedule(cfg: dict, steps_per_epoch: int) -> Schedule:
    """The learning rate as a function of the update count, from the
    ``lr_scheduler`` config group: constant, cosine, or cosine with warm
    restarts over 8 cycles, each optionally after a linear warmup."""
    opt_cfg = cfg.get("optimizer", {})
    sched_cfg = cfg.get("lr_scheduler", {})
    base_lr = float(opt_cfg.get("lr", 1e-4))
    name = sched_cfg.get("name", "cosine")
    warmup = int(sched_cfg.get("warmup_steps", 0) or 0)

    if name == "constant":
        sched = _constant(base_lr)
    elif name == "cosine":
        t_max_epochs = int(sched_cfg.get("t_max", 100))
        eta_min = float(sched_cfg.get("eta_min", 0.0))
        decay_steps = max(1, t_max_epochs * steps_per_epoch - warmup)
        sched = _cosine_decay(base_lr, decay_steps, eta_min / base_lr)
    elif name == "cosine_restarts":
        t0 = max(1, int(sched_cfg.get("restart_period", 10))
                 * steps_per_epoch)
        mult = int(sched_cfg.get("restart_mult", 2))
        eta_min = float(sched_cfg.get("eta_min", 0.0))
        schedules, boundaries, period, total = [], [], t0, 0
        for _ in range(8):     # 8 restart cycles covers any practical run
            schedules.append(_cosine_decay(base_lr, period,
                                           eta_min / base_lr))
            total += period
            boundaries.append(total)
            period *= max(1, mult)
        sched = _join(schedules, boundaries[:-1])
    else:
        raise ValueError(f"Unknown lr scheduler: {name}")

    if warmup > 0:
        sched = _join([_linear(0.0, base_lr, warmup), sched], [warmup])
    return sched


def global_norm(tensors) -> torch.Tensor:
    """``sqrt`` of the sum of squares of every element (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """AdamW, Adam or SGD with momentum over named parameters, with
    optional global-norm clipping and gradient accumulation, stepping as
    the optax chain of ``koemorph_tpu.train.optim.create_optimizer`` does.

    ``step(grads)`` updates the parameters in place. The state
    (``state_dict()``) holds the update ``count`` (the Adam count and the
    schedule count, which move together), the moments ``mu`` and ``nu``
    (Adam) or the momentum ``trace`` (SGD), and with accumulation the
    ``mini_step``, ``gradient_step`` and the running mean ``acc``.
    """

    def __init__(self, params: dict[str, torch.Tensor], *, name: str,
                 schedule: Schedule, betas=(0.9, 0.999),
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 eps: float = 1e-8, clip: Optional[float] = None,
                 accumulate: int = 1):
        if name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"Unknown optimizer: {name}")
        self.params = dict(params)
        self.name = name
        self.schedule = schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.weight_decay = float(weight_decay) if name == "adamw" else 0.0
        self.momentum = float(momentum)
        self.eps = float(eps)
        self.clip = float(clip) if clip else None
        self.accumulate = int(accumulate or 1)
        self.count = 0
        self.mini_step = 0
        self.gradient_step = 0

        def zeros():
            return {k: torch.zeros_like(p) for k, p in self.params.items()}

        if name == "sgd":
            self.trace = zeros()
        else:
            self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if self.accumulate > 1 else None
        first = next(iter(self.params.values()), None)
        self._device = (first.device if first is not None
                        else torch.device("cpu"))
        self._reciprocal = self._device.type == "cuda"
        #: (first update count, rows) of the device scalars' table
        self._table: tuple = (0, None)

    @property
    def lr(self) -> float:
        """The learning rate the next update applies."""
        return self.schedule(self.count)

    def applies_next(self) -> bool:
        """Whether the next call's gradients update the parameters (always,
        unless it is an accumulating call)."""
        return self.acc is None or self.mini_step == self.accumulate - 1

    def scalars(self, count: int, n: int = 1) -> torch.Tensor:
        """The device scalars of updates ``count .. count + n - 1``, one
        float32 row each: the negated learning rate ``schedule(count)``
        and the two bias corrections ``1 - b ** (count + 1)``, computed in
        float64 on the host as the update always has. On CUDA a row holds
        the corrections' reciprocals, since a CUDA kernel divides by a host
        scalar as a product with its reciprocal (taken in float64, then
        rounded); on the CPU it holds the corrections, which the CPU
        divides by. Each value is rounded to float32 once, as a kernel
        rounds a host scalar, so the update is bit for bit the one with
        host scalars. Rows are built in
        chunks of at least 256, one host-to-device copy per chunk."""
        base, table = self._table
        if table is None or count < base or count + n > base + len(table):
            rows = []
            for c in range(count, count + max(n, 256)):
                bc1 = 1.0 - self.b1 ** (c + 1)
                bc2 = 1.0 - self.b2 ** (c + 1)
                if self._reciprocal:
                    bc1, bc2 = 1.0 / bc1, 1.0 / bc2
                rows.append((-self.schedule(c), bc1, bc2))
            table = torch.from_numpy(np.asarray(rows, np.float32)).to(
                self._device)
            base = count
            self._table = (base, table)
        return table[count - base:count - base + n]

    def _div(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """``x`` divided by the bias correction whose :meth:`scalars`
        entry is ``s``."""
        return x * s if self._reciprocal else x / s

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> bool:
        """Apply one call's gradients (by parameter name); returns whether
        the parameters changed (always, unless accumulating)."""
        applies = self.applies_next()
        self.update(grads, self.mini_step,
                    self.scalars(self.count)[0] if applies else None)
        self.advance()
        return applies

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], mini_step: int,
               scalars: Optional[torch.Tensor]) -> None:
        """The device half of :meth:`step`: every tensor of the state is
        written in place (a CUDA graph of a train step replays this; each
        product and sum rounds as in the update that reassigned them), and
        nothing on the host changes. ``mini_step`` is the call's place in
        an accumulation, ``scalars`` the update's row of :meth:`scalars`
        (read only when the call updates); :meth:`advance` then moves the
        host counts."""
        if self.acc is not None:
            n = mini_step
            for k, g in grads.items():
                self.acc[k].add_((g - self.acc[k]) / (n + 1))
            if n != self.accumulate - 1:
                return
            grads = self.acc
        if self.clip is not None:
            norm = global_norm(grads.values())
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm * self.clip)
                     for k, g in grads.items()}
        neg_lr = scalars[0]
        if self.name == "sgd":
            for k, p in self.params.items():
                self.trace[k].mul_(self.momentum).add_(grads[k])
                p.add_(self.trace[k] * neg_lr)
        else:
            for k, p in self.params.items():
                g = grads[k]
                # the products and sums of optax's update, each rounded
                # once as before, written into the moments
                self.mu[k].mul_(self.b1).add_(g * (1.0 - self.b1))
                self.nu[k].mul_(self.b2).add_((g * g) * (1.0 - self.b2))
                update = self._div(self.mu[k], scalars[1]) / (
                    torch.sqrt(self._div(self.nu[k], scalars[2])) + self.eps)
                if self.weight_decay:
                    update = update + self.weight_decay * p
                p.add_(update * neg_lr)
        if self.acc is not None:
            for a in self.acc.values():
                a.zero_()

    def advance(self) -> None:
        """The host half of :meth:`step`: the accumulation's mini step,
        and on an update the update count (and the gradient step)."""
        applies = self.applies_next()
        if self.acc is not None:
            self.mini_step = (self.mini_step + 1) % self.accumulate
            if applies:
                self.gradient_step += 1
        if applies:
            self.count += 1

    def fast_forward(self, step: int) -> None:
        """Set the update count to ``step`` (moments stay as they are): the
        schedule resumes mid-curve after a checkpoint without optimizer
        state, as ``koemorph_tpu.train.trainer._fast_forward_counts``
        does."""
        self.count = int(step)

    def state_dict(self) -> dict:
        def host(d):
            return {k: v.detach().cpu().clone() for k, v in d.items()}

        out = {"name": self.name, "count": self.count,
               "mini_step": self.mini_step,
               "gradient_step": self.gradient_step}
        if self.name == "sgd":
            out["trace"] = host(self.trace)
        else:
            out["mu"], out["nu"] = host(self.mu), host(self.nu)
        if self.acc is not None:
            out["acc"] = host(self.acc)
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` (or one converted from optax);
        raises ``ValueError`` naming the entry on another kind of state, a
        missing or extra parameter, or a wrong shape."""
        if _moments(state.get("name")) != _moments(self.name):
            raise ValueError(f"optimizer state is {state.get('name')!r}, "
                             f"this optimizer is {self.name!r}")
        keys = (("trace",) if self.name == "sgd" else ("mu", "nu")) + (
            ("acc",) if self.acc is not None else ())
        loaded = {}
        for key in keys:
            if key not in state:
                raise ValueError(f"optimizer state has no {key!r}")
            loaded[key] = _check_like(state[key], self.params, key)
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        self.gradient_step = int(state.get("gradient_step", 0))
        # in place: a captured train step reads these tensors' memory
        for key, value in loaded.items():
            held = getattr(self, key)
            for k, t in value.items():
                held[k].copy_(t)


def _moments(name) -> str:
    """The state an optimizer keeps: Adam's and AdamW's are alike (optax's
    weight decay keeps none)."""
    return "trace" if name == "sgd" else "adam"


def _check_like(tensors: dict, params: dict, what: str) -> dict:
    """``tensors`` on ``params``' devices, after checking names and
    shapes."""
    missing = sorted(set(params) - set(tensors))
    extra = sorted(set(tensors) - set(params))
    if missing or extra:
        raise ValueError(f"optimizer state {what!r}: missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for k, p in params.items():
        t = tensors[k]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"optimizer state {what}[{k!r}] has shape "
                             f"{tuple(t.shape)}, the parameter "
                             f"{tuple(p.shape)}")
        out[k] = t.to(device=p.device, dtype=p.dtype).clone()
    return out


def create_optimizer(cfg: dict, params: dict[str, torch.Tensor],
                     steps_per_epoch: int = 1000,
                     schedule: Optional[Schedule] = None) -> Optimizer:
    """AdamW (or Adam or SGD) with global-norm clipping
    (``gradient_clip_val``) and accumulation (``accumulate_grad_batches``)
    from the ``training`` config group, over ``params`` (name -> tensor)."""
    opt_cfg = cfg.get("optimizer", {})
    name = str(opt_cfg.get("name", "adamw")).lower()
    betas = opt_cfg.get("betas", [0.9, 0.999])
    sched = schedule if schedule is not None \
        else create_lr_schedule(cfg, steps_per_epoch)
    return Optimizer(
        params, name=name, schedule=sched, betas=betas,
        weight_decay=float(opt_cfg.get("weight_decay", 1e-5)),
        momentum=float(opt_cfg.get("momentum", 0.9)),
        clip=cfg.get("gradient_clip_val", None),
        accumulate=int(cfg.get("accumulate_grad_batches", 1) or 1))
