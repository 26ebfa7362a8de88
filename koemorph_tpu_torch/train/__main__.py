"""Training CLI: ``python -m koemorph_tpu_torch.train --config <root.yaml>
[k=v...]``, the counterpart of ``python -m koemorph_tpu.train``.

One dispatcher keyed on ``model.name`` (``simplified``, the legacy frame
model of ``configs/config.yaml``, trained by ``KoeMorphTrainer`` on
``KoeMorphDataModule``; ``simplified_dual_stream`` or
``sequential_dual_stream``) over the same config tree and dot-notation
overrides. ``--synthetic N``
writes N synthetic WAV+JSONL pairs (the same files the JAX CLI writes) and
trains on them. Trains on the GPU and fails when there is none; ``--cpu``
trains on the CPU. The last line of standard output is one JSON object
with the work directory and the final epoch's mean train metrics.

Data-parallel over several cards: ``python -m torch.distributed.run
--nproc-per-node N -m koemorph_tpu_torch.train ...`` runs one process per
card (NCCL; ``--dist-backend gloo`` for gloo, the CPU's backend with
``--cpu``), each rank training on its block of every global batch
(``Trainer(mesh=...)``); rank 0 writes the synthetic data, the
checkpoints and the final JSON line.

Resume a run with ``--resume`` (the work directory's ``checkpoints/last``);
serve what it wrote with ``--model <work>/checkpoints/last`` on
``koemorph_tpu_torch.infer``, ``.rt`` or ``.serve`` (the dual-stream
models) or ``.rt_simplified`` and ``.test_model`` (the simplified one).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("koemorph_tpu_torch.train")


def write_synthetic_dataset(out_dir: Path, n_files: int, *,
                            sample_rate: int = 16000, fps: float = 30.0,
                            duration_s: float = 12.0, seed: int = 0,
                            speech_correlated: bool = True) -> Path:
    """Speech-like WAVs with blendshape JSONL.

    ``speech_correlated=True`` (default) ties the targets to the audio —
    mouth/jaw coefficients track the per-frame energy envelope and lip
    shapes follow F0, while expressions drift on slow 'emotion'
    oscillations — so training has real audio->face structure to learn
    (the learnability dress-rehearsal the random targets of round 1
    couldn't provide). ``False`` keeps the old random targets.
    """
    from koemorph_tpu_torch.blendshapes import ARKIT_BLENDSHAPES
    from koemorph_tpu_torch.data.wav import write_wav

    name_idx = {n: i for i, n in enumerate(ARKIT_BLENDSHAPES)}
    rng = np.random.default_rng(seed)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = int(duration_s * sample_rate)
    t = np.arange(n) / sample_rate
    hop = int(sample_rate / fps)
    frames = int(duration_s * fps)
    for i in range(n_files):
        f0_base = 110 + 70 * rng.random()
        f0 = f0_base * (1 + 0.15 * np.sin(2 * np.pi * 0.4 * t
                                          + rng.uniform(0, 6)))
        syllable = 0.5 * (1 + np.sin(2 * np.pi * (2 + 1.5 * rng.random())
                                     * t + rng.uniform(0, 6))) ** 2
        phase = 2 * np.pi * np.cumsum(f0) / sample_rate
        voiced = (np.sin(phase) + 0.4 * np.sin(2 * phase)
                  + 0.15 * np.sin(3 * phase))
        x = (0.4 * syllable * voiced
             + 0.02 * rng.standard_normal(n)).astype(np.float32)
        write_wav(out_dir / f"synth_{i:03d}.wav", x, sample_rate)

        coeffs = np.zeros((frames, 52), np.float32)
        if speech_correlated:
            # per-frame energy envelope drives the jaw/mouth
            energy = np.sqrt(np.add.reduceat(
                x[: frames * hop].astype(np.float64) ** 2,
                np.arange(0, frames * hop, hop)) / hop)
            mouth_drive = np.clip(energy / (energy.max() + 1e-9), 0, 1)
            # F0 (normalized) shapes pucker/funnel vs stretch
            f0_frame = f0[np.clip(np.arange(frames) * hop, 0, n - 1)]
            f0_norm = (f0_frame - f0_frame.min()) / (
                np.ptp(f0_frame) + 1e-9)
            # Sparse ARKit-like amplitudes (real mocap: most channels
            # ~0, a handful of actives reaching 0.3-0.8) — sized to stay
            # *reachable* through the reference's across-52 fusion
            # softmax, which bounds the per-frame SUM of all 52 outputs
            # by ~max(sigmoid) <= 1 (see models/dual_stream.py:19-24):
            # peak sum here ~0.95, so calibrated amplitudes, threshold
            # F1 and range_ratio are all attainable by a trained model.
            coeffs[:, name_idx["jawOpen"]] = 0.6 * mouth_drive
            coeffs[:, name_idx["mouthFunnel"]] = (
                0.12 * mouth_drive * f0_norm)
            coeffs[:, name_idx["mouthStretchLeft"]] = (
                0.1 * mouth_drive * (1 - f0_norm))
            # slow 'emotion' drift on one brow channel (crosses the 0.1
            # activation threshold, unlike the round-2 0.05-scale drift)
            k = np.arange(frames)
            coeffs[:, name_idx["browInnerUp"]] = 0.13 + 0.12 * np.sin(
                2 * np.pi * 0.15 * k / fps + rng.uniform(0, 6))
            # faint noise floor on remaining channels, ARKit-style
            floor = rng.uniform(0, 0.008, (frames, 52)).astype(np.float32)
            coeffs = np.clip(coeffs + floor, 0, 1)
        else:
            base = rng.uniform(0, 0.6, 52)
            k = np.arange(frames)[:, None]
            coeffs = np.clip(
                base + 0.2 * np.sin(2 * np.pi * 2 * k / fps
                                    + np.arange(52)), 0, 1
            ).astype(np.float32)

        with open(out_dir / f"synth_{i:03d}.jsonl", "w") as f:
            for k in range(frames):
                f.write(json.dumps({
                    "timestamp": k / fps,
                    "blendshapes": coeffs[k].round(4).tolist()}) + "\n")
    return out_dir


def build_model(cfg):
    """``(model, kind)`` from the ``model`` config group; ``kind`` is
    ``"frame"``, ``"window"`` or ``"sequence"``."""
    name = cfg.model.get("name", "simplified")
    common = dict(
        d_model=int(cfg.model.d_model),
        num_heads=int(cfg.model.num_heads),
        num_blendshapes=int(cfg.model.get("num_blendshapes", 52)),
        sample_rate=int(cfg.model.get("sample_rate", 16000)),
        target_fps=int(cfg.model.get("target_fps", 30)))
    if name == "simplified":
        from koemorph_tpu_torch.models.simplified import (
            SimplifiedKoeMorphModel)
        return SimplifiedKoeMorphModel(**common), "frame"
    if name not in ("simplified_dual_stream", "sequential_dual_stream"):
        raise ValueError(f"Unknown model.name: {name}")
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel, SimplifiedDualStreamModel)

    emotion = cfg.model.get("emotion_config", {})
    ds = dict(
        common,
        mel_sequence_length=int(cfg.model.get("mel_sequence_length", 256)),
        emotion_backend=emotion.get("backend", "egemaps"),
        use_concatenation=bool(emotion.get("use_concatenation", True)),
        dropout=float(cfg.model.get("dual_stream_attention", {})
                      .get("dropout", 0.1)),
    )
    if name == "simplified_dual_stream":
        return SimplifiedDualStreamModel(**ds), "window"
    return SequentialDualStreamModel(
        **ds, stride_frames=int(cfg.model.get("stride_frames", 1)),
        decode_mode=cfg.model.get("decode_mode", "parallel")), "sequence"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/dual_stream_config.yaml")
    p.add_argument("--work-dir", default=None,
                   help="override run_dir/experiment-name output location")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N generated synthetic WAV+JSONL pairs")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the work dir's last checkpoint")
    p.add_argument("--scan-epochs", action="store_true",
                   help="run each epoch device-resident "
                        "(Trainer.train_epoch_scan): the epoch's batches "
                        "stacked on the device once, the compiled step (a "
                        "CUDA graph on the card) over them; same math as "
                        "the step loop, no host work per step; the "
                        "per-step hooks (attention images, sequence stats) "
                        "don't run")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the GPU)")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="under torch.distributed.run: the process group's "
                        "backend (default nccl on the GPU, gloo with --cpu)")
    p.add_argument("overrides", nargs="*", metavar="key=value",
                   help="dot-notation config overrides")
    args = p.parse_args(argv)
    from koemorph_tpu_torch.parallel import distributed

    launched = distributed.launched()
    logging.basicConfig(
        level=logging.INFO if not launched or os.environ.get("RANK") == "0"
        else logging.WARNING,
        format="%(asctime)s %(name)s %(message)s")
    if not launched:
        return _train(args)
    distributed.init_process_group(args.dist_backend,
                                   "cpu" if args.cpu else None)
    try:
        return _train(args)
    finally:
        distributed.destroy_process_group()


def _train(args) -> int:
    """Train as ``args`` says: on one device, or as this rank of the
    process group when there is one."""

    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.device import resolve_device
    from koemorph_tpu_torch.parallel import distributed, make_mesh
    from koemorph_tpu_torch.train.trainer import (DualStreamTrainer,
                                                  KoeMorphTrainer,
                                                  SequentialTrainer)
    from koemorph_tpu_torch.utils.config import load_config, to_dict

    device = resolve_device("cpu" if args.cpu else "cuda")
    mesh = None
    if distributed.is_initialized():
        mesh = make_mesh(devices=["cpu"] * distributed.world_size()
                         if args.cpu else None)
        device = mesh.local_device
    # the port trains in full fp32: cuDNN's convolutions (the emotion2vec
    # encoder's) too, which PyTorch runs in TF32 by default
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args.config, overrides=args.overrides)
    work_dir = Path(args.work_dir or
                    Path(cfg.get("run_dir", "outputs"))
                    / cfg.get("experiment", {}).get("name", "run"))
    work_dir.mkdir(parents=True, exist_ok=True)

    if args.synthetic:
        synth = work_dir / "synth_data"
        if distributed.rank() == 0:
            write_synthetic_dataset(synth, args.synthetic,
                                    sample_rate=int(cfg.data.sample_rate),
                                    fps=float(cfg.data.target_fps))
        distributed.barrier()
        cfg.data.train_data_dir = str(synth)
        cfg.data.val_data_dir = str(synth)

    model, kind = build_model(cfg)
    tcfg = to_dict(cfg)
    max_epochs = args.max_epochs or int(cfg.training.get("max_epochs", 1))

    if kind == "frame":
        from koemorph_tpu_torch.data.dataset import KoeMorphDataModule
        dm = KoeMorphDataModule(
            train_data_dir=cfg.data.train_data_dir,
            val_data_dir=cfg.data.get("val_data_dir"),
            batch_size=int(cfg.data.batch_size),
            sample_rate=int(cfg.data.sample_rate),
            target_fps=float(cfg.data.target_fps))
        dm.setup()
        steps = args.steps_per_epoch or max(1, len(dm.train_dataloader()))
        trainer = KoeMorphTrainer(
            model, tcfg, work_dir=work_dir, steps_per_epoch=steps,
            device=device, mesh=mesh)
        if args.resume:
            trainer.resume()

        def train_loader(epoch: int):
            loader = dm.train_dataloader()
            loader.set_epoch(epoch)      # per-epoch reshuffle
            return iter(loader)

        history = trainer.fit(
            train_loader,
            (lambda: iter(dm.val_dataloader())) if dm.val_dataset else None,
            max_epochs=max_epochs, use_scan=args.scan_epochs)
    else:
        # window samples per training example: the model window for the
        # single-frame trainer, model window + extra output span for the
        # sequence trainer
        window = (model.window_frames + 32 if kind == "sequence"
                  else model.mel_sequence_length)
        loader_fn, dataset = create_sequential_dataloader(
            cfg.data.train_data_dir,
            batch_size=int(cfg.data.batch_size),
            window_frames=window,
            stride_frames=int(cfg.data.get("stride_frames", 8)),
            sample_rate=int(cfg.data.sample_rate),
            target_fps=float(cfg.data.target_fps))
        steps = args.steps_per_epoch or max(1, dataset.get_num_windows()
                                            // int(cfg.data.batch_size))
        cls = SequentialTrainer if kind == "sequence" else DualStreamTrainer
        kwargs = {"span_frames": window} if kind == "sequence" else {}
        trainer = cls(model, tcfg, work_dir=work_dir, steps_per_epoch=steps,
                      device=device, mesh=mesh, **kwargs)
        if args.resume:
            trainer.resume()

        def train_loader(epoch: int):
            dataset.set_epoch(epoch)     # stride schedule + file reshuffle
            return loader_fn()

        history = trainer.fit(train_loader, None, max_epochs=max_epochs,
                              use_scan=args.scan_epochs)

    final = history["train"][-1] if history["train"] else {}
    logger.info("training done: %s",
                {k: round(float(v), 5) for k, v in final.items()})
    if distributed.rank() == 0:
        print(json.dumps({"work_dir": str(work_dir),
                          "final_train_metrics":
                              {k: float(v) for k, v in final.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
