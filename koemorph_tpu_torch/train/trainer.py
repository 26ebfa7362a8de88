"""Trainers: the legacy frame trainer, the dual-stream window trainer and
the sequential trainer, the counterpart of ``koemorph_tpu.train.trainer``,
on one device, or data- and tensor-parallel over a ``torch.distributed``
group.

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

The compiled step (:meth:`Trainer.compiled_step`), the counterpart of
the jitted ``Trainer._train_step``, is one CUDA graph of the same step
(``runtime/graphs.py``), captured per batch shape: it reads the batch from
static buffers, writes the parameters and the optimizer state in place
(the port's ``donate_argnums``), reads the update's learning rate and
bias corrections from a device row (``Optimizer.scalars``) and draws its
dropout masks from one generator reseeded from ``(seed, step)`` before
each replay, so it is bit for bit the eager step. On the CPU, or with
``graphs=False``, it is the eager step. The scan epochs
(:meth:`Trainer.train_epoch_scan`, :meth:`Trainer.train_epochs_scan`,
``fit(use_scan=True)``) stack an epoch's batches on the device once and
run the compiled step over them with no host-to-device copy and no host
synchronization per step; the per-step hooks do not run.

Data parallelism (``Trainer(mesh=...)`` with a process group's mesh, or
``mesh=None`` inside a group of world > 1): one process per card, launched
by ``python -m torch.distributed.run``. Every rank builds the same global
batch from the same loader, pads it to a multiple of the world (repeating
the last row, ``sample_mask`` 0 on the padding) and keeps its block of
rows. The loss is the global batch's, not a mean of per-rank losses (the
batch mask's scale, the weighted loss's ``w / mean(w)`` and the perceptual
term's cosine all normalize over the batch): each rank runs the model on
its block, gathers the predictions, targets and mask of the whole batch
(``distributed.gather_rows``, a differentiable sum of zero-filled
buffers; adding zeros is exact) and computes the one global loss. Every
rank backpropagates that same loss, so the backward of the gather sums
``world`` copies of each row's gradient: the parameters' gradients are
summed over the ranks in one flat all-reduce and divided by the world size
(exact for a power of two; at world 1 the step is the single-process step
bit for bit). The gradient norm, the clip and the update then run on the
same reduced gradients on every rank, so the replicas stay identical (rank
0's parameters are broadcast at the start). Dropout masks are the global
batch's, drawn from the ``(seed, step)`` generator, each rank keeping its
rows (``models.dropout.BatchBlock``). Under NCCL the compiled step captures
the collectives in its CUDA graph; gloo's cannot be captured, so under
gloo on the card the compiled step and the scan epochs raise (pass
``graphs=False``). Only rank 0 writes checkpoints and TensorBoard
scalars; every rank reads a checkpoint on ``resume``.

Tensor parallelism (``tensor_parallel=True`` with a ``(data, model)``
grid of a process group, :func:`~koemorph_tpu_torch.parallel.tp.
make_mesh_2d`): the parameters the rule table splits, and their optimizer
moments, are held 1/M per rank of a model group by sharded layers that
take and return the whole activations
(:func:`~koemorph_tpu_torch.parallel.tp.parallelize`), so every rank of a
model group computes the same loss of the same data block. The batch
splits on the data axis only, padded to a multiple of every rank (D x M,
as JAX pads to ``mesh.devices.size``); the gradients are summed over the
data group and divided by D; the clip's global norm sums the split
leaves' squares over the model group and counts the replicated leaves
once; AdamW updates each rank's shards. Checkpoints hold the whole
tensors, gathered over the model group (a single-process trainer,
``infer`` and ``serve`` load them); on ``resume`` every rank reads them
and keeps its shards. A grid without a ``model`` axis raises
``ValueError``; at M = 1 nothing is split and the trainer is the
data-parallel one. A mesh of several entries in one process raises
``ValueError``: training over several cards runs one process each.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import logging
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from koemorph_tpu_torch.blendshapes import EXPRESSION_INDICES, MOUTH_INDICES
from koemorph_tpu_torch.device import DeviceLike, resolve_device, scalar_like
from koemorph_tpu_torch.models.losses import (KoeMorphLossConfig,
                                              dual_stream_loss,
                                              koemorph_loss,
                                              sequence_koemorph_loss)
from koemorph_tpu_torch.models.dropout import BatchBlock
from koemorph_tpu_torch.ops.device_cache import device_cache, index_constant
from koemorph_tpu_torch.parallel import distributed
from koemorph_tpu_torch.parallel.mesh import (Mesh, batch_leading_size,
                                              block_rows, make_mesh,
                                              pad_batch_to_multiple,
                                              pad_batch_to_size, replicate,
                                              shard_batch)
from koemorph_tpu_torch.parallel.tp import (MODEL_AXIS, gather_shards,
                                            local_shards, parallelize)
from koemorph_tpu_torch.runtime.graphs import StepGraphs
from koemorph_tpu_torch.train.checkpoint import CheckpointManager
from koemorph_tpu_torch.train.optim import (create_lr_schedule,
                                            create_optimizer, global_norm)
from koemorph_tpu_torch.utils.config import to_dict
from koemorph_tpu_torch.utils.params import load_model_state

logger = logging.getLogger(__name__)

__all__ = ["Trainer", "KoeMorphTrainer", "DualStreamTrainer",
           "SequentialTrainer",
           "loss_config_from", "sequence_targets", "dropout_generator",
           "dropout_seed", "scan_orders"]


#: the optimizer's per-parameter state: Adam's moments, SGD's momentum,
#: the accumulator
_OPT_TENSORS = ("mu", "nu", "trace", "acc")


def loss_config_from(cfg: dict) -> KoeMorphLossConfig:
    loss_cfg = cfg.get("loss", {}) if cfg else {}
    fields = {f.name for f in dataclasses.fields(KoeMorphLossConfig)}
    return KoeMorphLossConfig(
        **{k: float(v) for k, v in loss_cfg.items() if k in fields})


def sequence_targets(blendshapes: torch.Tensor, window_frames: int,
                     stride_frames: int, n_out: int) -> torch.Tensor:
    """Target frames aligned with the sequential model's output frames:
    output ``i`` is input frame ``window_frames - 1 + i * stride``."""
    return blendshapes[:, _target_index(window_frames, stride_frames, n_out,
                                        blendshapes.shape[1],
                                        blendshapes.device), :]


@device_cache(16)
def _target_index(window_frames: int, stride_frames: int, n_out: int,
                  frames: int, device: torch.device) -> torch.Tensor:
    idx = window_frames - 1 + np.arange(n_out) * stride_frames
    return torch.from_numpy(np.clip(idx, 0, frames - 1)).to(device)


def dropout_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s dropout masks, from ``(seed,
    step)`` alone, so a resumed run draws the masks an uninterrupted one
    draws."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def dropout_generator(seed: int, step: int,
                      device: torch.device) -> torch.Generator:
    """The dropout masks' generator of train step ``step``, seeded with
    :func:`dropout_seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(dropout_seed(seed, step))
    return g


def scan_orders(n_steps: int, n_epochs: int,
                shuffle_seed: int) -> list[list[int]]:
    """The step order of each epoch of :meth:`Trainer.train_epochs_scan`:
    a permutation of ``range(n_steps)`` per epoch, the order that sorts
    ``n_steps`` uniform draws of a CPU ``torch.Generator`` seeded with
    ``shuffle_seed`` (not the JAX package's threefry permutation, so the
    orders differ from its). ``torch.randperm`` is not used: at a few
    steps it left a CPU generator's state as it was, so every epoch got
    the same order."""
    g = torch.Generator().manual_seed(int(shuffle_seed))
    return [torch.argsort(torch.rand(n_steps, generator=g,
                                     dtype=torch.float64),
                          stable=True).tolist()
            for _ in range(n_epochs)]


def _mask_padded(pred: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Neutralize padding rows (``mask`` 0): a padded row's prediction
    becomes its detached target, so its error terms and gradients are
    zero; the returned scale keeps the real rows' weight."""
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
    mouth = index_constant(tuple(MOUTH_INDICES), mel_w.device)
    expr = index_constant(tuple(EXPRESSION_INDICES), emo_w.device)
    return {
        "stream/mel_on_mouth": torch.sum(sm_mel[mouth]),
        "stream/emotion_on_expression": torch.sum(sm_emo[expr]),
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


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _placement(mesh: Optional[Mesh], device: DeviceLike,
               tensor_parallel: bool = False
               ) -> tuple[torch.device, Optional[Mesh]]:
    """The trainer's device, and its mesh when it trains over ranks: a
    process group's mesh (``mesh=None`` inside a group of world > 1
    means every rank, on ``device`` when given), a row of ranks or a
    ``(data, model)`` grid of them. A one-entry mesh in one process is
    that entry's device. ``tensor_parallel`` needs a mesh with a
    ``model`` axis (``ValueError``)."""
    if mesh is None and distributed.world_size() > 1:
        mesh = make_mesh(devices=None if device is None
                         else [device] * distributed.world_size())
    if tensor_parallel and (mesh is None or MODEL_AXIS not in mesh.shape):
        raise ValueError(
            f"tensor_parallel=True needs a mesh with a '{MODEL_AXIS}' axis "
            "(parallel.make_mesh_2d)")
    if mesh is None:
        return resolve_device(device), None
    if not mesh.distributed and mesh.size > 1:
        raise ValueError(
            f"a mesh of {mesh.size} entries in one process: training over "
            "several devices runs one process per device (python -m "
            "torch.distributed.run --nproc-per-node N ...)")
    dev = resolve_device(mesh.local_device)
    if device is not None and not _same_device(resolve_device(device), dev):
        raise ValueError(f"device {device} is not the mesh entry {dev} of "
                         "this process")
    return dev, mesh if mesh.distributed else None


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
    Subclasses define :meth:`predict` ``(batch, generator) -> (pred,
    target)``, the per-row part (a ``None`` generator is the deterministic
    eval forward), and :meth:`loss_from` ``(pred, target, mask) -> (loss,
    metrics)``, the batch's loss; :meth:`loss_fn` is the two in turn.
    ``graphs`` selects the compiled step's CUDA graphs: ``None`` means
    graphs on a CUDA device and none elsewhere, ``False`` the eager step
    on the card too. ``mesh`` (a process group's, from
    :func:`~koemorph_tpu_torch.parallel.make_mesh`) trains data-parallel
    (the module's docstring); so does ``mesh=None`` inside a process group
    of world > 1. ``tensor_parallel`` with a grid from
    :func:`~koemorph_tpu_torch.parallel.make_mesh_2d` splits the rule
    table's parameters over its model axis as well.
    """

    #: batch shapes whose graphs are kept, the least recently used dropped
    max_graphs = 4

    def __init__(self, model, config: dict, *,
                 work_dir: str | Path = "outputs/run", mesh=None,
                 steps_per_epoch: int = 100, seed: int = 42,
                 tensor_parallel: bool = False,
                 device: DeviceLike = None, graphs: Optional[bool] = None):
        self.device, self.mesh = _placement(mesh, device, tensor_parallel)
        #: the batch's blocks (the data axis) and this process's block (1
        #: and 0 on one device)
        self.world = self.mesh.data_size if self.mesh is not None else 1
        self.rank = self.mesh.data_rank if self.mesh is not None else 0
        self.config = config or {}
        self.train_cfg = self.config.get("training", self.config)
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.steps_per_epoch = steps_per_epoch
        _check_full_fp32(self.device)

        self.seed = int(self.train_cfg.get("seed", seed))
        _make_trainable(model)
        model.init_random(torch.Generator().manual_seed(self.seed))
        self.model = model.to(self.device)
        if self.mesh is not None:           # every replica is rank 0's
            replicate(self.model, self.mesh)
        #: the parameters split over the model axis: name -> spec
        self.tp_specs = (parallelize(self.model, self.mesh)
                         if tensor_parallel and self.mesh is not None
                         else {})
        self.params = dict(self.model.named_parameters())
        self._schedule = create_lr_schedule(self.train_cfg, steps_per_epoch)
        self.optimizer = create_optimizer(self.train_cfg, self.params,
                                          steps_per_epoch,
                                          schedule=self._schedule)
        self.optimizer.global_norm = self._global_norm
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
        self.step_graphs = StepGraphs(self.device, graphs)
        #: static batch buffers by batch-shape key, the most recent last
        self._static: collections.OrderedDict = collections.OrderedDict()
        self._static_scalars = torch.zeros(3, device=self.device)
        self._graph_gen: Optional[torch.Generator] = None
        self._metric_keys: dict = {}

    # -- subclass surface --------------------------------------------------

    def predict(self, batch: dict, generator) -> tuple:
        """``(pred, target)`` of the batch's rows: the model's output (its
        dropout masks from ``generator``, None for the eval forward) and
        the rows' targets."""
        raise NotImplementedError

    def loss_from(self, pred: torch.Tensor, target: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> tuple:
        """``(loss, metrics)`` of a batch's predictions and targets, the
        rows of ``mask`` 0 left out."""
        raise NotImplementedError

    def loss_fn(self, batch: dict, generator: Optional[torch.Generator]):
        pred, target = self.predict(batch, generator)
        # contiguous, as the data-parallel gather gives them: the loss's
        # reductions then sum in one order on both paths
        return self.loss_from(pred.contiguous(), target.contiguous(),
                              batch.get("sample_mask"))

    def _loss(self, batch: dict, generator: Optional[torch.Generator]):
        """:meth:`loss_fn`; data-parallel, the global batch's loss from
        this rank's block: the model on the block (the global batch's
        dropout masks, the block's rows kept), then the predictions,
        targets and mask of every rank gathered and one loss over them."""
        if self.mesh is None:
            return self.loss_fn(batch, generator)
        rows = batch["sample_mask"].shape[0]
        start, total = self.rank * rows, self.world * rows
        if generator is not None:
            generator = BatchBlock(generator, start, start + rows, total)
        pred, target = self.predict(batch, generator)
        group = self.mesh.data_group
        return self.loss_from(
            distributed.gather_rows(pred, start, total, group),
            distributed.gather_rows(target.detach(), start, total, group),
            distributed.gather_rows(batch["sample_mask"], start, total,
                                    group))

    def _reduce_grads(self, grads: dict) -> dict:
        """The data group's gradients summed in one flat all-reduce and
        divided by its size: every rank backpropagated the same global
        loss, so the sum holds ``world`` copies of each row's gradient
        (a model group's ranks each reduce their own shards)."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        distributed.all_reduce_(flat, self.mesh.data_group)
        flat = flat / scalar_like(float(self.world), flat)
        parts = torch.split(flat, [g.numel() for g in grads.values()])
        return {k: p.view_as(g) for (k, g), p in zip(grads.items(), parts)}

    def _global_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the whole gradients: tensor-parallel, the
        split leaves' squares summed over the model group, the replicated
        leaves' counted once."""
        if not self.tp_specs:
            return global_norm(grads.values())
        split = sum(torch.sum(g * g) for k, g in grads.items()
                    if k in self.tp_specs).reshape(1)
        distributed.all_reduce_(split, self.mesh.model_group)
        return torch.sqrt(split[0] + sum(
            torch.sum(g * g) for k, g in grads.items()
            if k not in self.tp_specs))

    # -- steps -------------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One update on a prepared batch, eagerly; returns the step's
        metrics as device scalars (``loss``, ``grad_norm`` and the loss
        terms)."""
        opt = self.optimizer
        metrics = self._step_body(
            batch, dropout_generator(self.dropout_seed, self.global_step,
                                     self.device),
            opt.mini_step,
            opt.scalars(opt.count)[0] if opt.applies_next() else None)
        opt.advance()
        self.global_step += 1
        return metrics

    def _step_body(self, batch: dict, gen: torch.Generator, mini_step: int,
                   scalars: Optional[torch.Tensor]) -> dict:
        """The device work of a train step: the forward in training mode,
        the gradients, their global norm and the optimizer's in-place
        update (``Optimizer.update``). It changes nothing on the host, so
        a CUDA graph of it replays the whole step."""
        self.model.train()
        # the backward picks its convolution algorithms (the emotion2vec
        # encoder's) here, outside the encoder's own scoped flags:
        # deterministic ones, no autotuning, no TF32, so a resumed run is
        # bit for bit the uninterrupted one
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=False,
                deterministic=True, allow_tf32=False):
            loss, metrics = self._loss(batch, gen)
            grads = torch.autograd.grad(loss, list(self.params.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(self.params.items(), grads)}
        if self.mesh is not None:
            grads = self._reduce_grads(grads)
        norm = self._global_norm(grads)
        self.optimizer.update(grads, mini_step, scalars)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = norm
        return metrics

    def compiled_step(self, batch: dict) -> dict:
        """The train step as one CUDA graph replay (the counterpart of the
        jitted ``_train_step``): bit for bit :meth:`train_step`, which it
        is on the CPU or with ``graphs=False``. A batch shape seen for the
        first time is captured first (a warm-up step that leaves the
        parameters and the optimizer state as it found them, then the
        capture); a capture or replay failure raises. Data-parallel under
        gloo on the card it raises: gloo's collectives cannot be captured
        (pass ``graphs=False``)."""
        if not self.step_graphs.enabled:
            return self.train_step(batch)
        if self.mesh is not None and distributed.backend() != "nccl":
            raise RuntimeError(
                f"the {distributed.backend()} backend's collectives cannot "
                "be captured in a CUDA graph: train with graphs=False (the "
                "eager step) or under NCCL")
        # one graph per batch shape and accumulation phase; the batch is
        # copied into the graph's static buffers
        opt = self.optimizer
        shape_key = tuple(sorted((k, tuple(v.shape), v.dtype)
                                 for k, v in batch.items()))
        key = (shape_key, opt.mini_step if opt.acc is not None else 0)
        static = self._static.pop(shape_key, None)
        if static is None:
            if len(self._static) >= self.max_graphs:
                old = next(iter(self._static))
                del self._static[old]
                for k in [k for k in self.step_graphs.keys() if k[0] == old]:
                    self.step_graphs.drop(k)
                    del self._metric_keys[k]
            static = {k: v.clone() for k, v in batch.items()}
        else:
            for k, v in batch.items():
                static[k].copy_(v)
        self._static[shape_key] = static
        if opt.applies_next():
            self._static_scalars.copy_(opt.scalars(opt.count)[0])
        if key not in self.step_graphs:
            self._capture(key, static)
        self._graph_gen.manual_seed(dropout_seed(self.dropout_seed,
                                                 self.global_step))
        row = self.step_graphs.run(key, None)
        opt.advance()
        self.global_step += 1
        return dict(zip(self._metric_keys[key], row.unbind(0)))

    def _capture(self, key: tuple, static: dict) -> None:
        """Capture the step graph of ``key`` over ``static``. Its warm-up
        runs the step eagerly, between a snapshot of the parameters and
        the optimizer's tensors and their restore, so the first replay
        starts from the state the caller left."""
        if self._graph_gen is None:
            self._graph_gen = torch.Generator(device=self.device)
        gen, mini_step = self._graph_gen, key[1]
        scalars = self._static_scalars
        keys: list = []

        def body():
            metrics = self._step_body(static, gen, mini_step, scalars)
            keys[:] = list(metrics)
            return torch.stack(list(metrics.values()))

        def warm():
            state = self._state_tensors()
            saved = [t.clone() for t in state]
            body()
            with torch.no_grad():
                for t, v in zip(state, saved):
                    t.copy_(v)

        logger.info("capturing the train step's CUDA graph for %s",
                    [(k, s) for k, s, _ in key[0]])
        self.step_graphs.capture(key, body, warm, generators=(gen,))
        self._metric_keys[key] = list(keys)

    def _state_tensors(self) -> list:
        """The tensors a train step writes: the parameters and the
        optimizer's moments (or momentum) and accumulator."""
        opt = self.optimizer
        out = list(self.params.values())
        for name in _OPT_TENSORS:
            held = getattr(opt, name, None)
            if held is not None:
                out += list(held.values())
        return out

    def drop_graphs(self) -> None:
        """Free the compiled step's graphs and static buffers."""
        for k in self.step_graphs.keys():
            self.step_graphs.drop(k)
        self._static.clear()
        self._metric_keys.clear()

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        self.model.eval()
        loss, metrics = self._loss(batch, None)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    # -- loops -------------------------------------------------------------

    def _prepare(self, batch: dict) -> dict:
        """Arrays of a host batch on the device (lists dropped), with an
        all-ones ``sample_mask``: one device pads nothing. Over ranks: the
        batch padded to a multiple of every rank (the mesh's size),
        masked, and this rank's block of it on the data axis."""
        if self.mesh is not None:
            host = {k: np.asarray(v) for k, v in batch.items()
                    if not isinstance(v, list)}
            padded, real = pad_batch_to_multiple(host, self.mesh.size)
            mask = np.zeros((batch_leading_size(padded),), np.float32)
            mask[:real] = 1.0
            return shard_batch({**padded, "sample_mask": mask}, self.mesh)
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
        logger.info("epoch %d: %d steps in %.3fs", self.epoch,
                    len(collected), time.time() - t0)
        return {k: float(torch.stack([m[k] for m in collected]).mean())
                for k in collected[0]}

    def _stack_epoch(self, loader: Iterable[dict]) -> tuple[dict, int]:
        """Stack an epoch's batches into ``(S, B, ...)`` tensors on the
        device, one host-to-device copy per array. Every batch is padded
        to the epoch's largest size (over ranks: rounded up to a multiple
        of every rank) by repeating its last row
        (:func:`~koemorph_tpu_torch.parallel.mesh.pad_batch_to_size`),
        with ``sample_mask`` 0 on the padding, so the loss leaves the
        padding out; data-parallel, the rank keeps its block of axis 1.
        Raises ``ValueError`` naming the size when the stack would not fit
        in the card's free memory."""
        raw = [{k: np.asarray(v) for k, v in b.items()
                if not isinstance(v, list)} for b in loader]
        if not raw:
            return {}, 0
        n = self.mesh.size if self.mesh is not None else 1
        target = -(-max(batch_leading_size(b) for b in raw) // n) * n
        shapes = {(k, np.shape(v)[1:], np.asarray(v).dtype)
                  for b in raw for k, v in b.items()}
        if len(shapes) != len(raw[0]):
            raise ValueError(
                "the scan epochs stack an epoch's batches, which must "
                "differ in their leading size at most: "
                f"{sorted(map(str, shapes))}")
        prepared = []
        for b in raw:
            padded, real = pad_batch_to_size(b, target)
            mask = np.zeros((target,), np.float32)
            mask[:real] = 1.0
            prepared.append({**padded, "sample_mask": mask})
        stacked = {k: np.stack([p[k] for p in prepared]) for k in prepared[0]}
        if self.mesh is not None:
            rows = block_rows(target, self.world, self.rank)
            stacked = {k: np.ascontiguousarray(v[:, rows])
                       for k, v in stacked.items()}
        nbytes = sum(v.nbytes for v in stacked.values())
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if nbytes > 0.9 * free:
                raise ValueError(
                    f"the epoch's {len(prepared)} batches take "
                    f"{nbytes / 1e9:.2f} GB on the device, more than 90% of "
                    f"the {free / 1e9:.2f} GB free; train on fewer batches "
                    "per call or with train_epoch")
        return ({k: torch.from_numpy(v).to(self.device)
                 for k, v in stacked.items()}, len(prepared))

    def _scan(self, stacked: dict, order: list[int]) -> dict[str, np.ndarray]:
        """The compiled step over batches ``order`` of the stack: each
        batch is a view of the stack, copied on the device into the
        graph's static buffers; the metric rows stay on the device and
        are fetched once, as ``{name: (len(order),) array}``."""
        opt = self.optimizer
        opt.scalars(opt.count, len(order))       # one table for the run
        rows = []
        for i in order:
            metrics = self.compiled_step({k: v[i] for k, v in stacked.items()})
            rows.append(torch.stack(list(metrics.values())))
        host = torch.stack(rows).cpu().numpy()
        return {k: host[:, j] for j, k in enumerate(metrics)}

    def train_epoch_scan(self, loader: Iterable[dict]) -> dict[str, float]:
        """One epoch device-resident: the epoch's batches are stacked on
        the device once and the compiled step runs over them with no
        host-to-device copy and no host synchronization per step; the
        per-step metrics are fetched once and replayed into TensorBoard
        with the step loop's tags and step numbers. The math is
        :meth:`train_epoch`'s; the per-step hooks (sequence statistics,
        attention images) do not run: use :meth:`train_epoch` when they
        matter."""
        stacked, n_steps = self._stack_epoch(loader)
        if not n_steps:
            return {}
        t0 = time.time()
        start = self.global_step
        host = self._scan(stacked, list(range(n_steps)))
        self._replay_scan_metrics(host, n_steps, start)
        logger.info("epoch %d (scan): %d steps in %.3fs", self.epoch,
                    n_steps, time.time() - t0)
        return {k: float(v.mean()) for k, v in host.items()}

    def train_epochs_scan(self, loader: Iterable[dict], n_epochs: int,
                          shuffle_seed: int = 0) -> list[dict[str, float]]:
        """``n_epochs`` epochs over one upload of the loader's batches:
        each epoch runs the compiled step over the stack in a new order
        (:func:`scan_orders` of ``shuffle_seed``; a permutation from a
        ``torch.Generator``, not the JAX package's threefry one). The
        order of the steps changes per epoch, the batches' membership is
        fixed at the upload. The caller checkpoints. Returns each epoch's
        mean metrics; TensorBoard scalars are replayed at the configured
        cadence."""
        stacked, n_steps = self._stack_epoch(loader)
        if not n_steps or n_epochs <= 0:
            return []
        t0 = time.time()
        start = self.global_step
        orders = scan_orders(n_steps, n_epochs, shuffle_seed)
        host = self._scan(stacked, [i for o in orders for i in o])
        self._replay_scan_metrics(host, n_epochs * n_steps, start)
        self.epoch += n_epochs
        logger.info("%d epochs x %d steps (device-resident) in %.1fs",
                    n_epochs, n_steps, time.time() - t0)
        return [{k: float(v[e * n_steps:(e + 1) * n_steps].mean())
                 for k, v in host.items()} for e in range(n_epochs)]

    def _replay_scan_metrics(self, host: dict, n_steps: int,
                             start: int) -> None:
        """Per-step metrics of a scan that began after step ``start`` into
        TensorBoard, with the step loop's tags and step numbers."""
        log_every = int(self.train_cfg.get("logging", {})
                        .get("log_every_n_steps", 50))
        if not log_every:
            return
        for i in range(n_steps):
            step = start + i + 1
            if step % log_every == 0:
                scalars = {k: float(v[i]) for k, v in host.items()}
                scalars["lr"] = float(self._schedule(step))
                self._log_scalars("train", scalars, step)

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

    def model_state(self) -> dict:
        """The model's state dict with whole tensors (tensor-parallel:
        gathered over the model group, which every rank of it calls)."""
        state = self.model.state_dict()
        if self.tp_specs:
            state = gather_shards(state, self.tp_specs, self.mesh)
        return state

    def opt_state(self) -> dict:
        """What ``opt_state.pth`` holds: the optimizer state (its update
        count sets the schedule) and the dropout seed; tensor-parallel,
        the moments whole, gathered as :meth:`model_state`."""
        state = self.optimizer.state_dict()
        if self.tp_specs:
            for key in _OPT_TENSORS:
                held = getattr(self.optimizer, key, None)
                if held is not None:
                    state[key] = {k: v.cpu() for k, v in gather_shards(
                        held, self.tp_specs, self.mesh).items()}
        return {"optimizer": state, "dropout_seed": self.dropout_seed}

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
        if self.tp_specs:                  # whole tensors: keep the shards
            state = local_shards(state, self.tp_specs, self.mesh)
        load_model_state(self.model, state)
        self.epoch = int(meta.get("epoch", -1)) + 1
        self.global_step = int(meta.get("global_step", 0))
        if opt_state is None:
            self.optimizer.fast_forward(self.global_step)
        else:
            held = dict(opt_state["optimizer"])
            if self.tp_specs:
                for key in _OPT_TENSORS:
                    if key in held:
                        held[key] = local_shards(held[key], self.tp_specs,
                                                 self.mesh)
            self.optimizer.load_state_dict(held)
            self.dropout_seed = int(opt_state.get("dropout_seed",
                                                  self.dropout_seed))
        logger.info("resumed from epoch %d (step %d)", self.epoch,
                    self.global_step)
        return True

    def _save(self, val_loss: Optional[float]) -> None:
        self.checkpoints.save(self.model_state(), epoch=self.epoch,
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
        the epoch. ``use_scan`` runs each epoch through
        :meth:`train_epoch_scan`."""
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
            history["train"].append(self.train_epoch_scan(loader) if use_scan
                                    else self.train_epoch(loader))
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
        """Rank 0's TensorBoard writer; None on the other ranks, or
        without ``logging.tensorboard`` or tensorboardX. ``_tensorboard``
        says on every rank whether rank 0 has one."""
        self._tensorboard = False
        if not self.train_cfg.get("logging", {}).get("tensorboard", True):
            return None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        self._tensorboard = True
        if self.mesh is not None and self.mesh.rank != 0:
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
        call logs and is tried again at the next interval.
        Tensor-parallel, the ranks of rank 0's model group run the forward
        with it (its sharded layers' collectives)."""
        joins = bool(self.tp_specs) and self.rank == 0 and self._tensorboard
        if not self._attention_images or (self.writer is None and not joins):
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
        if self.writer is None:
            return
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

    def predict(self, batch, generator):
        return (self.model(batch["audio"], generator=generator),
                batch["arkit"][:, 0, :])

    def loss_from(self, pred, target, mask):
        pred, scale = _mask_padded(pred, target, mask)
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

    def predict(self, batch, generator):
        pred = self.model(batch["audio"], generator=generator)["blendshapes"]
        target = batch["blendshapes"]
        if target.dim() == 3:   # (B, W, 52) window -> its last frame
            target = target[:, -1, :]
        return pred, target

    def loss_from(self, pred, target, mask):
        pred, scale = _mask_padded(pred, target, mask)
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

    def predict(self, batch, generator):
        out = self.model(batch["audio"], generator=generator)
        pred_seq = out["blendshapes"]                  # (B, T_out, 52)
        return pred_seq, sequence_targets(
            batch["blendshapes"], self.model.window_frames,
            self.model.stride_frames, pred_seq.shape[1])

    def loss_from(self, pred_seq, target_seq, mask):
        pred_seq, scale = _mask_padded(pred_seq, target_seq, mask)
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
