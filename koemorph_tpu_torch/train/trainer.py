"""Trainers: the legacy frame trainer, the dual-stream window trainer and
the sequential trainer, the counterpart of ``koemorph_tpu.train.trainer``
on one device.

A train step runs eagerly in full fp32: the model's forward (in training
mode, dropout masks drawn from a generator seeded from ``(seed, step)``),
the loss, ``torch.autograd.grad`` over every parameter, and the
optimizer's update (:mod:`koemorph_tpu_torch.train.optim`). The epoch loop,
validation, checkpoint cadence, early stopping, resume and TensorBoard
scalars follow the JAX trainer's ``fit``. ``metrics["grad_norm"]`` is the
global norm of the step's gradients before clipping. With a TensorBoard
writer, every ``log_images_every_n_steps`` steps the attention weights of
the batch's first utterance go to ``attention/mel`` and
``attention/emotion`` as images (:meth:`Trainer._log_attention_images`).

Not ported (each raises ``NotImplementedError`` naming its ``ROADMAP.md``
item): the device-resident scan epochs (``train_epoch_scan``) and tensor
parallelism.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from koemorph_tpu_torch.blendshapes import EXPRESSION_INDICES, MOUTH_INDICES
from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.models.losses import (KoeMorphLossConfig,
                                              dual_stream_loss,
                                              koemorph_loss,
                                              sequence_koemorph_loss)
from koemorph_tpu_torch.train.checkpoint import CheckpointManager
from koemorph_tpu_torch.train.optim import (create_lr_schedule,
                                            create_optimizer, global_norm)
from koemorph_tpu_torch.utils.config import to_dict
from koemorph_tpu_torch.utils.params import load_model_state

logger = logging.getLogger(__name__)

__all__ = ["Trainer", "KoeMorphTrainer", "DualStreamTrainer",
           "SequentialTrainer",
           "loss_config_from", "sequence_targets", "dropout_generator"]

#: where the features that are not ported are queued
SCAN_ITEM = "ROADMAP.md section 1, item 10 (the compiled train step)"
TP_ITEM = "ROADMAP.md section 1, item 8 (several GPUs)"


def loss_config_from(cfg: dict) -> KoeMorphLossConfig:
    loss_cfg = cfg.get("loss", {}) if cfg else {}
    fields = {f.name for f in dataclasses.fields(KoeMorphLossConfig)}
    return KoeMorphLossConfig(
        **{k: float(v) for k, v in loss_cfg.items() if k in fields})


def sequence_targets(blendshapes: torch.Tensor, window_frames: int,
                     stride_frames: int, n_out: int) -> torch.Tensor:
    """Target frames aligned with the sequential model's output frames:
    output ``i`` is input frame ``window_frames - 1 + i * stride``."""
    idx = window_frames - 1 + np.arange(n_out) * stride_frames
    idx = np.clip(idx, 0, blendshapes.shape[1] - 1)
    return blendshapes[:, torch.from_numpy(idx).to(blendshapes.device), :]


def dropout_generator(seed: int, step: int,
                      device: torch.device) -> torch.Generator:
    """The dropout masks' generator of train step ``step``: seeded from
    ``(seed, step)`` alone, so a resumed run draws the masks an
    uninterrupted one draws."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    return g


def _mask_padded(pred: torch.Tensor, target: torch.Tensor,
                 batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Neutralize padding rows (``sample_mask`` 0): a padded row's
    prediction becomes its detached target, so its error terms and
    gradients are zero; the returned scale keeps the real rows' weight."""
    mask = batch.get("sample_mask")
    if mask is None:
        return pred, torch.ones((), device=pred.device)
    m = mask.reshape((pred.shape[0],) + (1,) * (pred.dim() - 1))
    pred = m * pred + (1 - m) * target.detach()
    scale = pred.shape[0] / torch.clamp_min(torch.sum(mask), 1.0)
    return pred, scale


def _stream_weight_metrics(mel_w, emo_w) -> dict:
    """Stream-specialization scalars: the mel stream's weight mass on the
    mouth, the emotion stream's on the expressions."""
    if not isinstance(mel_w, torch.nn.Parameter) or \
            not isinstance(emo_w, torch.nn.Parameter):
        return {}
    sm_mel = torch.softmax(mel_w.detach(), -1)
    sm_emo = torch.softmax(emo_w.detach(), -1)
    return {
        "stream/mel_on_mouth": torch.sum(sm_mel[list(MOUTH_INDICES)]),
        "stream/emotion_on_expression": torch.sum(
            sm_emo[list(EXPRESSION_INDICES)]),
    }


def _check_full_fp32(device: torch.device) -> None:
    """The port trains with every matmul and convolution in full fp32
    (TF32 keeps ~3 decimal digits)."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise ValueError(
            "TF32 matmuls are enabled; the port trains in full fp32 "
            "(torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.set_float32_matmul_precision('highest'))")
    if device.type == "cuda" and torch.backends.cudnn.allow_tf32:
        raise ValueError(
            "cuDNN TF32 convolutions are enabled (PyTorch's default); the "
            "port trains in full fp32 (torch.backends.cudnn.allow_tf32 = "
            "False)")


def _make_trainable(model: torch.nn.Module) -> None:
    """Replace any inference tensor among the model's parameters and
    buffers (a model built or moved under ``torch.inference_mode``) with a
    normal copy: autograd cannot save an inference tensor for backward."""
    with torch.inference_mode(False):
        for module in model.modules():
            for name, buf in list(module._buffers.items()):
                if buf is not None and buf.is_inference():
                    module._buffers[name] = buf.clone()
            for name, p in list(module._parameters.items()):
                if p is not None and p.is_inference():
                    module._parameters[name] = torch.nn.Parameter(
                        p.detach().clone(), requires_grad=p.requires_grad)


class Trainer:
    """Shared epoch, validation, checkpoint and early-stopping machinery.

    The model's weights are drawn from the training seed
    (``model.init_random``) and the model moves to ``device`` (``cuda``
    unless the caller asks for another; raises when CUDA is absent).
    Subclasses define :meth:`loss_fn` ``(batch, generator) -> (loss,
    metrics)``; a ``None`` generator is the deterministic (eval) forward.
    """

    def __init__(self, model, config: dict, *,
                 work_dir: str | Path = "outputs/run", mesh=None,
                 steps_per_epoch: int = 100, seed: int = 42,
                 tensor_parallel: bool = False,
                 device: DeviceLike = None):
        if tensor_parallel or mesh is not None:
            raise NotImplementedError(
                f"meshes and tensor parallelism are not ported: {TP_ITEM}")
        self.config = config or {}
        self.train_cfg = self.config.get("training", self.config)
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.steps_per_epoch = steps_per_epoch
        self.device = resolve_device(device)
        _check_full_fp32(self.device)

        self.seed = int(self.train_cfg.get("seed", seed))
        _make_trainable(model)
        model.init_random(torch.Generator().manual_seed(self.seed))
        self.model = model.to(self.device)
        self.params = dict(self.model.named_parameters())
        self._schedule = create_lr_schedule(self.train_cfg, steps_per_epoch)
        self.optimizer = create_optimizer(self.train_cfg, self.params,
                                          steps_per_epoch,
                                          schedule=self._schedule)
        self.dropout_seed = self.seed
        self.checkpoints = CheckpointManager(
            self.work_dir / "checkpoints",
            keep_epoch_every=int(self.train_cfg.get("checkpoint", {}).get(
                "keep_epoch_every", 10)),
            config=to_dict(self.config))
        self.writer = self._make_writer()
        #: False once the model showed it has no ``return_attention``
        self._attention_images = True
        self.epoch = 0
        self.global_step = 0

    # -- subclass surface --------------------------------------------------

    def loss_fn(self, batch: dict, generator: Optional[torch.Generator]):
        raise NotImplementedError

    # -- steps -------------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One update on a prepared batch; returns the step's metrics as
        device scalars (``loss``, ``grad_norm`` and the loss terms)."""
        self.model.train()
        gen = dropout_generator(self.dropout_seed, self.global_step,
                                self.device)
        # the backward picks its convolution algorithms (the emotion2vec
        # encoder's) here, outside the encoder's own scoped flags:
        # deterministic ones, no autotuning, no TF32, so a resumed run is
        # bit for bit the uninterrupted one
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=False,
                deterministic=True, allow_tf32=False):
            loss, metrics = self.loss_fn(batch, gen)
            grads = torch.autograd.grad(loss, list(self.params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(self.params.items(), grads)}
        norm = global_norm(grads.values())
        self.optimizer.step(grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = norm
        self.global_step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        self.model.eval()
        loss, metrics = self.loss_fn(batch, None)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    # -- loops -------------------------------------------------------------

    def _prepare(self, batch: dict) -> dict:
        """Arrays of a host batch on the device (lists dropped), with an
        all-ones ``sample_mask``: one device pads nothing."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, list):
                continue
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            out[k] = t.to(self.device)
        b = next(v.shape[0] for v in out.values() if v.dim() > 0)
        out["sample_mask"] = torch.ones((b,), device=self.device)
        return out

    def train_epoch(self, loader: Iterable[dict]) -> dict[str, float]:
        logging_cfg = self.train_cfg.get("logging", {})
        log_every = int(logging_cfg.get("log_every_n_steps", 50))
        image_every = int(logging_cfg.get("log_images_every_n_steps", 100))
        collected: list[dict] = []   # device scalars; no host sync per step
        t0 = time.time()
        for batch in loader:
            prepared = self._prepare(batch)
            metrics = self.train_step(prepared)
            collected.append(metrics)
            self._on_step_metrics(batch, metrics)
            if self.global_step % log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["lr"] = float(self._schedule(self.global_step))
                self._log_scalars("train", host, self.global_step)
            if image_every and self.global_step % image_every == 0:
                self._log_attention_images(prepared)
        self._on_epoch_end()
        if not collected:
            return {}
        logger.info("epoch %d: %d steps in %.1fs", self.epoch,
                    len(collected), time.time() - t0)
        return {k: float(torch.stack([m[k] for m in collected]).mean())
                for k in collected[0]}

    def train_epoch_scan(self, loader: Iterable[dict]) -> dict[str, float]:
        raise NotImplementedError(
            f"device-resident scan epochs are not ported: {SCAN_ITEM}")

    def validate(self, loader: Iterable[dict]) -> dict[str, float]:
        sums: dict[str, float] = {}
        count = 0
        for batch in loader:
            metrics = self.eval_step(self._prepare(batch))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        out = {k: v / max(1, count) for k, v in sums.items()}
        self._log_scalars("val", out, self.global_step)
        return out

    def opt_state(self) -> dict:
        """What ``opt_state.pth`` holds: the optimizer state (its update
        count sets the schedule) and the dropout seed."""
        return {"optimizer": self.optimizer.state_dict(),
                "dropout_seed": self.dropout_seed}

    def resume(self) -> bool:
        """Restore the parameters, the optimizer state and the bookkeeping
        from the run's last checkpoint. A checkpoint without optimizer
        state fast-forwards the update count to ``global_step``, so the
        learning rate applied is ``schedule(global_step)`` (the moments
        restart from zero)."""
        restored = self.checkpoints.latest(with_opt=True)
        if restored is None:
            return False
        state, opt_state, meta = restored
        load_model_state(self.model, state)
        self.epoch = int(meta.get("epoch", -1)) + 1
        self.global_step = int(meta.get("global_step", 0))
        if opt_state is None:
            self.optimizer.fast_forward(self.global_step)
        else:
            self.optimizer.load_state_dict(opt_state["optimizer"])
            self.dropout_seed = int(opt_state.get("dropout_seed",
                                                  self.dropout_seed))
        logger.info("resumed from epoch %d (step %d)", self.epoch,
                    self.global_step)
        return True

    def _save(self, val_loss: Optional[float]) -> None:
        self.checkpoints.save(self.model.state_dict(), epoch=self.epoch,
                              global_step=self.global_step,
                              val_loss=val_loss, opt_state=self.opt_state())

    def fit(self, train_loader_fn: Callable[..., Iterable[dict]],
            val_loader_fn: Optional[Callable[[], Iterable[dict]]] = None,
            max_epochs: Optional[int] = None,
            use_scan: bool = False) -> dict:
        """Epoch loop: train, validate every ``check_val_every_n_epoch``,
        checkpoint every ``checkpoint.every_n_epochs``, on the last epoch
        and on every improvement, and stop early after ``patience``
        epochs without one. A loader factory that takes an argument gets
        the epoch."""
        if use_scan:
            raise NotImplementedError(
                f"device-resident scan epochs are not ported: {SCAN_ITEM}")
        max_epochs = max_epochs or int(self.train_cfg.get("max_epochs", 1))
        check_every = int(self.train_cfg.get("check_val_every_n_epoch", 1))
        ckpt_every = int(self.train_cfg.get("checkpoint", {})
                         .get("every_n_epochs", 1))
        es_cfg = self.train_cfg.get("early_stopping", {})
        patience = int(es_cfg.get("patience", 0) or 0)
        best, since_best = float("inf"), 0
        history = {"train": [], "val": []}
        takes_epoch = len(inspect.signature(
            train_loader_fn).parameters) >= 1

        for self.epoch in range(self.epoch, max_epochs):
            loader = (train_loader_fn(self.epoch) if takes_epoch
                      else train_loader_fn())
            history["train"].append(self.train_epoch(loader))
            val_loss = None
            if val_loader_fn is not None and \
                    (self.epoch + 1) % check_every == 0:
                val_metrics = self.validate(val_loader_fn())
                history["val"].append(val_metrics)
                val_loss = val_metrics.get("loss")
            improved = val_loss is not None and val_loss < best
            # an improvement always saves, so a later, worse epoch cannot
            # claim the 'best' slot
            saved = ((self.epoch + 1) % max(1, ckpt_every) == 0
                     or self.epoch + 1 == max_epochs or improved)
            if saved:
                self._save(val_loss)
            if val_loss is not None:
                if improved:
                    best, since_best = val_loss, 0
                else:
                    since_best += 1
                    if patience and since_best >= patience:
                        logger.info("Early stopping at epoch %d", self.epoch)
                        if not saved:   # keep `last` current on early exit
                            self._save(val_loss)
                        break
        return history

    # -- logging -----------------------------------------------------------

    def _make_writer(self):
        if not self.train_cfg.get("logging", {}).get("tensorboard", True):
            return None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(str(self.work_dir / "tb"))

    def _log_scalars(self, prefix: str, scalars: dict, step: int) -> None:
        if self.writer is None:
            return
        for k, v in scalars.items():
            if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
                self.writer.add_scalar(f"{prefix}/{k}", float(v), step)

    def _on_step_metrics(self, batch: dict, metrics: dict) -> None:
        """Per-step hook for subclass bookkeeping (sequence stats)."""

    def _on_epoch_end(self) -> None:
        """End-of-epoch hook (sequence-stat flush)."""

    def _log_attention_images(self, batch: dict) -> None:
        """Attention-weight images to TensorBoard: a forward of the batch's
        first utterance with ``return_attention=True`` in eval mode (no
        dropout, no generator: the training steps' masks are untouched),
        each map (for a sequential model its last window's) divided by its
        peak, as ``attention/mel`` and ``attention/emotion``. A model
        without ``return_attention`` turns the images off once; a failed
        call logs and is tried again at the next interval."""
        if self.writer is None or not self._attention_images:
            return
        if "return_attention" not in inspect.signature(
                self.model.forward).parameters:
            logger.info("attention images disabled: %s has no "
                        "return_attention", type(self.model).__name__)
            self._attention_images = False
            return
        self.model.eval()
        try:
            with torch.no_grad():
                out = self.model(batch["audio"][:1], return_attention=True)
        except Exception as e:
            logger.warning("attention image logging failed, will retry "
                           "next interval: %s", e)
            return
        if isinstance(out, tuple):
            out = out[0]
        for name, key in (("mel", "mel_attention_weights"),
                          ("emotion", "emotion_attention_weights")):
            w = out.get(key)
            if w is None:
                continue
            img = w[0].detach().to(torch.float32).cpu().numpy()
            while img.ndim > 2:      # sequential models: (n, Q, K)
                img = img[-1]
            peak = float(img.max())
            if peak > 0:
                img = img / peak
            self.writer.add_image(f"attention/{name}", img,
                                  self.global_step, dataformats="HW")


class KoeMorphTrainer(Trainer):
    """Legacy frame trainer over ``SimplifiedKoeMorphModel``: each sample is
    a whole (padded) file, and the target is its first frame,
    ``arkit[:, 0, :]``, under ``koemorph_loss``."""

    def __init__(self, model, config: dict, **kw):
        self.loss_config = loss_config_from(
            (config or {}).get("training", config or {}))
        super().__init__(model, config, **kw)

    def loss_fn(self, batch, generator):
        pred = self.model(batch["audio"], generator=generator)
        target = batch["arkit"][:, 0, :]
        pred, scale = _mask_padded(pred, target, batch)
        loss, metrics = koemorph_loss(pred, target, config=self.loss_config)
        return loss * scale, metrics


class DualStreamTrainer(Trainer):
    """Single-window dual-stream trainer (``SimplifiedDualStreamModel``)
    with the stream-separation regularizer; the target is each window's
    last frame."""

    def __init__(self, model, config: dict, **kw):
        cfg = config or {}
        tcfg = cfg.get("training", cfg).get("loss", {})
        self.l1_weight = float(tcfg.get("l1_weight", 1.0))
        self.l2_weight = float(tcfg.get("l2_weight",
                                        tcfg.get("mse_weight", 0.5)))
        self.separation_weight = float(
            tcfg.get("stream_separation_weight", 0.01))
        super().__init__(model, config, **kw)

    def loss_fn(self, batch, generator):
        pred = self.model(batch["audio"], generator=generator)["blendshapes"]
        target = batch["blendshapes"]
        if target.dim() == 3:   # (B, W, 52) window -> its last frame
            target = target[:, -1, :]
        pred, scale = _mask_padded(pred, target, batch)
        att = self.model.dual_stream_attention
        mel_w, emo_w = _learned(att, "mel_weights"), _learned(
            att, "emotion_weights")
        loss, metrics = dual_stream_loss(
            pred, target, mel_weights=mel_w, emotion_weights=emo_w,
            l1_weight=self.l1_weight, l2_weight=self.l2_weight,
            separation_weight=self.separation_weight)
        metrics.update(_stream_weight_metrics(mel_w, emo_w))
        return loss * scale, metrics


def _learned(module, name):
    """The stream weights when they are trained parameters, else None (a
    fixed-fusion model's masks)."""
    value = getattr(module, name)
    return value if isinstance(value, torch.nn.Parameter) else None


class SequentialTrainer(Trainer):
    """Sequence trainer over ``SequentialDualStreamModel``: each sample is a
    span longer than the model window; the model emits ``T_out`` frames in
    one forward and the loss compares them against output-aligned targets
    with the temporal and velocity terms."""

    def __init__(self, model, config: dict, *,
                 span_frames: Optional[int] = None, **kw):
        cfg = config or {}
        self.loss_config = loss_config_from(cfg.get("training", cfg))
        if self.loss_config.temporal_weight == 0 and \
                self.loss_config.velocity_weight == 0:
            self.loss_config = dataclasses.replace(
                self.loss_config, velocity_weight=0.1)
        data_cfg = cfg.get("data", {})
        self.span_frames = span_frames or int(
            data_cfg.get("window_frames", model.window_frames + 32))
        if self.span_frames <= model.window_frames:
            self.span_frames = model.window_frames + 32
        self.hop = int(model.sample_rate / model.target_fps)
        self._seq_losses: list = []
        self._seq_smoothness: list = []
        self._seq_file: int = -1
        super().__init__(model, config, **kw)

    def loss_fn(self, batch, generator):
        out = self.model(batch["audio"], generator=generator)
        pred_seq = out["blendshapes"]                  # (B, T_out, 52)
        target_seq = sequence_targets(
            batch["blendshapes"], self.model.window_frames,
            self.model.stride_frames, pred_seq.shape[1])
        pred_seq, scale = _mask_padded(pred_seq, target_seq, batch)
        loss, metrics = sequence_koemorph_loss(pred_seq, target_seq,
                                               config=self.loss_config)
        att = self.model.dual_stream_attention
        metrics.update(_stream_weight_metrics(
            _learned(att, "mel_weights"), _learned(att, "emotion_weights")))
        if pred_seq.shape[1] > 1:
            # temporal smoothness of the prediction itself
            metrics["smoothness"] = torch.mean(torch.abs(
                pred_seq[:, 1:] - pred_seq[:, :-1]))
        return loss * scale, metrics

    def _on_step_metrics(self, batch: dict, metrics: dict) -> None:
        """Per-sequence loss statistics at file boundaries
        (``sequence/mean_loss``, ``std_loss``, ``loss_trend``)."""
        fi = batch.get("file_indices", batch.get("file_idx"))
        if fi is None:
            return
        current = int(np.asarray(fi).reshape(-1)[0])
        if current != self._seq_file and self._seq_losses:
            self._flush_sequence_stats()
        self._seq_file = current
        # device scalars; converted only at the flush boundary
        self._seq_losses.append(metrics["loss"])
        if "smoothness" in metrics:
            self._seq_smoothness.append(metrics["smoothness"])

    def _on_epoch_end(self) -> None:
        if self._seq_losses:
            self._flush_sequence_stats()
        self._seq_file = -1

    def _flush_sequence_stats(self) -> None:
        losses = np.asarray([float(v) for v in self._seq_losses])
        self._seq_losses = []
        smooth = np.asarray([float(v) for v in self._seq_smoothness])
        self._seq_smoothness = []
        stats = {
            "mean_loss": float(losses.mean()),
            "std_loss": float(losses.std()),
            "loss_trend": float(np.polyfit(
                np.arange(len(losses)), losses, 1)[0])
            if len(losses) > 1 else 0.0,
        }
        if smooth.size:
            stats["smoothness"] = float(smooth.mean())
        self._log_scalars("sequence", stats, self.global_step)
