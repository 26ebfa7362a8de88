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
"""

from __future__ import annotations

import math
from typing import Callable, Optional

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

    @property
    def lr(self) -> float:
        """The learning rate the next update applies."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor]) -> bool:
        """Apply one call's gradients (by parameter name); returns whether
        the parameters changed (always, unless accumulating)."""
        if self.acc is not None:
            n = self.mini_step
            for k, g in grads.items():
                self.acc[k] = self.acc[k] + (g - self.acc[k]) / (n + 1)
            self.mini_step = (n + 1) % self.accumulate
            if n != self.accumulate - 1:
                return False
            self.gradient_step += 1
            grads = self.acc
            self.acc = {k: torch.zeros_like(p)
                        for k, p in self.params.items()}
        if self.clip is not None:
            norm = global_norm(grads.values())
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm * self.clip)
                     for k, g in grads.items()}
        lr = self.schedule(self.count)
        self.count += 1
        if self.name == "sgd":
            for k, p in self.params.items():
                self.trace[k] = grads[k] + self.momentum * self.trace[k]
                p.add_(self.trace[k] * -lr)
            return True
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1.0 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[k]
            update = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                          + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(update * -lr)
        return True

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
        for key, value in loaded.items():
            setattr(self, key, value)


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
