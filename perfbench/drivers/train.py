"""Training: ``SequentialTrainer`` by the route ``train --scan-epochs``
takes (``train_epoch_scan`` once per epoch, over the program's sequential
loader).

Set-up writes ``files`` pairs of a 16-bit PCM WAV (``file_seconds`` of
seeded speech-like audio) and JSONL blendshapes (smooth seeded curves in
[0, 1], 4 decimals) into a new directory under ``TMPDIR`` (removed at
the end), builds the loader
over them (span and stride as the configuration's ``data`` and ``train``
set them) and the trainer with weights from the seed, and drives it
through its first ``check_steps`` steps of epoch 0 by
``train_epoch_scan``: step 1 alone (it captures the step's graph, and
its first gradient is read from Adam's first moment), the rest as one
call over their stack, as the window's calls run. Set-up then runs
:data:`WARM_EPOCHS` whole epochs as the window does. The window runs
the whole epochs after them until ``--seconds`` have passed: each
collects its batches from the loader (the benchmark's clock times that
as the load) and hands them to ``train_epoch_scan``.

The reference follows the first steps from the same files: each step's
loss, the first gradient (Adam's first moment after step 1, over 1 -
beta1), and each parameter's change after the last checked step, the
last two by the worst leaf: the gap between the program's norm of a leaf
and the reference's, over the larger of the reference's norm of that leaf
and its median leaf's; and the first gradient's worst leaf among the mel
stream's (:data:`MEL_LEAVES`), which the eGeMAPS features do not reach.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a key bias under softmax) move by round-off alone and are left
out of the change.

With ``--trace 1`` the window's second epoch runs its first
``slice_steps`` batches as one ``train_epoch_scan`` call under the
profiler, then the rest.
"""

from __future__ import annotations

import contextlib
import shutil
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import audio, compare, model_cfg, roofline, weights
from perfbench.harness.flops import count_flops
from perfbench.harness.kernels import LaunchRecorder, bounds
from perfbench.harness.trace import Slice, warm_profiler


def write_data(data_dir: Path, cfg: dict, tr: dict, seed: int,
               device) -> None:
    """The training files, from the seed."""
    fps, sr = model_cfg.fps(cfg), cfg["sample_rate"]
    pcm = audio.to_int16(audio.utterance_pool(tr["files"],
                                              tr["file_seconds"], seed,
                                              device))
    rng = np.random.default_rng([seed, 2])
    frames = int(tr["file_seconds"] * fps)
    data_dir.mkdir(parents=True, exist_ok=True)
    for i in range(tr["files"]):
        knots = rng.standard_normal((frames // 10 + 2, 52))
        t = np.arange(frames) / 10.0
        curves = np.stack([np.interp(t, np.arange(len(knots)), knots[:, j])
                           for j in range(52)], 1)
        bs = 1.0 / (1.0 + np.exp(-2.0 * curves))
        stem = data_dir / f"utt{i:03d}"
        with wave.open(str(stem.with_suffix(".wav")), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm[i].tobytes())
        with open(stem.with_suffix(".jsonl"), "w") as fh:
            for f in range(frames):
                vals = ",".join(f"{v:.4f}" for v in bs[f])
                fh.write(f'{{"timestamp": {f / fps:.6f}, '
                         f'"blendshapes": [{vals}]}}\n')


def _trainer_config(cfg: dict) -> dict:
    return {"training": cfg["training"], "data": cfg["data"]}


def reference_readings(cfg: dict, tr: dict, data_dir: Path, state: dict,
                       steps_per_epoch: int, seed: int, device,
                       fault: str = "") -> dict:
    """The reference's first ``check_steps`` steps: losses, the first
    clipped gradient, the parameters before and after. ``fault`` plants
    one: ``"half"`` leaves half of each batch out (the loss the mean over
    the rest), ``"state"`` leaves the parameters and moments unchanged
    (the first gradient then reads 0, as the program's unwritten first
    moment would)."""
    from perfbench.reference import train as ref
    from perfbench.reference.model import SequentialDualStreamModel
    model = SequentialDualStreamModel(**model_cfg.sequential_kwargs(cfg))
    model = model.to(device)
    model.load_state_dict(state)
    trainer = ref.Trainer(model, cfg["training"], steps_per_epoch, seed)
    batches = ref.epoch_batches(
        data_dir, 0, tr["span_frames"], cfg["data"]["stride_frames"],
        model_cfg.hop(cfg), tr["batch"], tr["check_steps"])
    before = {k: p.detach().clone() for k, p in trainer.params.items()}
    losses, first = [], None
    for a, b in batches:
        rows = len(a) // 2 if fault == "half" else len(a)
        a, b = (torch.from_numpy(x[:rows]).to(device) for x in (a, b))
        if fault == "state":
            loss, grads = trainer.loss_and_grads(a, b)
            grads = {k: torch.zeros_like(g) for k, g in grads.items()}
        else:
            loss, grads = trainer.step(a, b)
        losses.append(float(loss))
        if first is None:
            first = grads
    return {"losses": losses, "grad": first, "before": before,
            "after": {k: p.detach().clone()
                      for k, p in trainer.params.items()}}


#: whole epochs that set-up runs before the window
WARM_EPOCHS = 2

#: the leaves only the mouth blendshapes reach (the mel stream): their
#: gradients do not see the eGeMAPS features, whose formant rows K2 and its
#: plain form may round apart
MEL_LEAVES = ("mel_channel_encoder", "mel_norm", "mel_attention",
              "mouth_queries", "mel_output_proj")


def train_gaps(prog: dict, want: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, the first
    gradient's and the change's worst leaf, and the first gradient's worst
    leaf of the mel stream."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   want["losses"]))
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in
             want["grad"].items()}
    med = float(np.median(list(norms.values())))
    moved = [k for k, n in norms.items() if n >= 1e-3 * med]

    def change(side):
        return {k: side["after"][k] - side["before"][k] for k in moved}

    grad = compare.leaf_gaps(prog["grad"], want["grad"])
    delta = compare.leaf_gaps(change(prog), change(want))

    mel = [v for k, v in grad.items()
           if any(f".{name}" in k for name in MEL_LEAVES)]
    return {"train_loss_gap": loss, "train_grad_gap": max(grad.values()),
            "train_change_gap": max(delta.values()),
            "train_mel_grad_gap": max(mel)}


def control(cell, device, steps: int, fault: str = "") -> dict:
    """The control: the reference in TF32 put in the program's place, its
    numbers against the float32 reference's over the first ``steps``
    steps; with ``fault`` (``"half"``, ``"state"``:
    :func:`reference_readings`) instead the float32 reference with that
    fault planted."""
    from perfbench.reference.model import SequentialDualStreamModel
    cfg, tr = cell.config, dict(cell.traffic, check_steps=steps)
    work = Path(tempfile.mkdtemp(prefix=f"perfbench-{cell.name}-"))
    try:
        write_data(work, cfg, tr, cell.seed, device)
        template = SequentialDualStreamModel(
            **model_cfg.sequential_kwargs(cfg))
        state = weights.seeded_state(template, cell.seed, device)
        spe = _steps_per_epoch(cfg, tr, work)
        seed = int(cfg["training"]["seed"])
        want = reference_readings(cfg, tr, work, state, spe, seed, device)
        with (contextlib.nullcontext() if fault else compare.tf32()):
            got = reference_readings(cfg, tr, work, state, spe, seed,
                                     device, fault=fault)
        return train_gaps(got, want)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _steps_per_epoch(cfg: dict, tr: dict, data_dir: Path) -> int:
    """Steps of an epoch as ``train`` counts them: every file's windows
    over the batch."""
    from perfbench.reference.train import read_pair
    hop, span = model_cfg.hop(cfg), tr["span_frames"]
    stride = cfg["data"]["stride_frames"]
    windows = 0
    for f in sorted(Path(data_dir).glob("**/*.wav")):
        audio, bs = read_pair(f)
        frames = min(len(bs), len(audio) // hop)
        windows += max(0, (frames - span) // stride + 1)
    return max(1, windows // tr["batch"])


def _step_flops(cfg: dict, state: dict, batch: dict, steps_per_epoch: int,
                device) -> float:
    """Floating-point operations of one train step's forward and backward
    outside the kernels, counted on the reference."""
    from perfbench.reference import train as ref
    from perfbench.reference.model import SequentialDualStreamModel
    model = SequentialDualStreamModel(**model_cfg.sequential_kwargs(cfg))
    model = model.to(device)
    model.load_state_dict(state)
    trainer = ref.Trainer(model, cfg["training"], steps_per_epoch, 0)
    a = torch.from_numpy(np.asarray(batch["audio"])).to(device)
    b = torch.from_numpy(np.asarray(batch["blendshapes"])).to(device)
    return count_flops(lambda: trainer.loss_and_grads(a, b))


@contextlib.contextmanager
def scan_losses(trainer):
    """Each step's loss as ``train_epoch_scan`` fetches it from the card
    (its per-step host metrics, before it averages them), in step order,
    for the calls made inside the block."""
    losses: list = []
    scan = trainer._scan

    def fetch(stacked, order):
        host = scan(stacked, order)
        losses.extend(float(x) for x in np.asarray(host["loss"]).reshape(-1))
        return host

    trainer._scan = fetch
    try:
        yield losses
    finally:
        del trainer._scan


def run(cell, t_start: float, device: str) -> dict:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel)
    from koemorph_tpu_torch.train.trainer import SequentialTrainer
    work = Path(tempfile.mkdtemp(prefix=f"perfbench-{cell.name}-"))
    try:
        write_data(work / "data", cfg, tr, cell.seed, dev)
        loader_fn, dataset = create_sequential_dataloader(
            work / "data", batch_size=tr["batch"],
            window_frames=tr["span_frames"],
            stride_frames=cfg["data"]["stride_frames"],
            sample_rate=cfg["sample_rate"],
            target_fps=float(model_cfg.fps(cfg)))
        spe = _steps_per_epoch(cfg, tr, work / "data")
        from perfbench.reference.model import (
            SequentialDualStreamModel as ReferenceModel)
        # the weights drawn with the reference's model as the template
        # (its constructor's constants included), loaded into the program's
        state = weights.seeded_state(
            ReferenceModel(**model_cfg.sequential_kwargs(cfg)), cell.seed,
            dev)
        model = SequentialDualStreamModel(**model_cfg.sequential_kwargs(cfg))
        trainer = SequentialTrainer(
            model, _trainer_config(cfg), span_frames=tr["span_frames"],
            work_dir=work / "run", steps_per_epoch=spe, device=dev)
        trainer.model.load_state_dict(state)
        recorder = LaunchRecorder() if (cell.trace and on_card) else None
        prog = {"before": {k: p.detach().clone() for k, p in
                           trainer.params.items()}}
        dataset.set_epoch(0)
        first = loader_fn()
        checked = [next(first) for _ in range(tr["check_steps"])]
        first.close()
        with (recorder.installed() if recorder
              else contextlib.nullcontext()), scan_losses(trainer) as losses:
            if recorder:
                recorder.watch(trainer.step_graphs)
            # step 1 alone, for the first gradient in Adam's first moment;
            # the rest as one call over their stack, as the window runs
            trainer.train_epoch_scan(checked[:1])
            b1 = trainer.optimizer.b1
            prog["grad"] = {k: v / (1.0 - b1) for k, v in
                            trainer.optimizer.mu.items()}
            trainer.train_epoch_scan(checked[1:])
        prog["losses"] = losses
        del checked
        prog["after"] = {k: p.detach().clone()
                         for k, p in trainer.params.items()}
        # whole epochs as the window runs them, the last epoch's batches
        # held while the next ones load: every file is decoded into the
        # loader's cache, and the host memory for two epochs' batches has
        # been touched once (an epoch that loads into fresh memory takes
        # ~2x as long), so every epoch of the window does the same work
        for epoch in range(1, WARM_EPOCHS + 1):
            dataset.set_epoch(epoch)
            batches = list(loader_fn())
            trainer.train_epoch_scan(batches)
        if recorder:
            warm_profiler()
        if on_card:
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start

        steps, load_s, epochs, traced, slice_batch = 0, 0.0, 0, None, None
        first_epoch = WARM_EPOCHS + 1
        each = []                 # each epoch's (load, load and scan) s
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cell.seconds:
            epochs += 1
            dataset.set_epoch(first_epoch + epochs - 1)
            a = time.perf_counter()
            with record_function("perfbench.load"):
                batches = list(loader_fn())
            load_s += time.perf_counter() - a
            each.append([time.perf_counter() - a])
            steps += len(batches)
            if recorder and epochs == 2:
                n = tr["slice_steps"]
                prof = Slice(cell.root / "build" / "perfbench" /
                             f"{cell.name}.trace.json")
                prof.__enter__()
                recorder.recording = True
                with record_function("perfbench.scan"):
                    trainer.train_epoch_scan(batches[:n])
                recorder.recording = False
                prof.__exit__(None, None, None)
                traced, slice_batch = prof, batches[0]
                batches = batches[n:]
            with record_function("perfbench.scan"):
                trainer.train_epoch_scan(batches)
            each[-1].append(time.perf_counter() - a)
        window_s = time.perf_counter() - t0
        if recorder and traced is None:
            raise RuntimeError("the window ended before the profiled "
                               "slice; give the run more seconds")
        memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        finite = all(np.isfinite(x) for x in prog["losses"])
        del trainer, model
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        want = reference_readings(cfg, tr, work / "data", state, spe,
                                  int(cfg["training"]["seed"]), dev)
        gaps = train_gaps(prog, want)
        print(f"perfbench: set-up {setup_s:.1f} s, {epochs} epochs of "
              f"{spe} steps (load / epoch s: "
              + " ".join(f"{a:.3f}/{b:.3f}" for a, b in each)
              + f"), reference {time.perf_counter() - t_ref:.1f} s",
              file=sys.stderr)
        span_s = tr["span_frames"] * model_cfg.hop(cfg) / cfg["sample_rate"]
        rec = {"setup_s": setup_s, "window_s": window_s,
               "attempted": int(steps), "failed": int(not finite),
               "audio_s": steps * tr["batch"] * span_s,
               "load_s": load_s, "memory_peak_bytes": memory_peak,
               "compared": {k: (v, tr["limits"][k])
                            for k, v in gaps.items()}}
        if recorder:
            mel = cfg["mel"]
            live, nnz = roofline.logmel_live(
                mel["n_fft"], cfg["sample_rate"], mel["n_mels"],
                float(mel["f_min"]), float(mel["f_max"]))
            kb = bounds(recorder.snapshots, live, nnz)
            per_step = _step_flops(cfg, state, slice_batch, spe, dev)
            rec.update(trace=traced.result, kernel_bounds=kb,
                       slice_flops=tr["slice_steps"] * per_step
                       + sum(e["ops"] for e in kb.values()))
        return rec
    finally:
        shutil.rmtree(work, ignore_errors=True)
