"""Training dress rehearsal: train the production sequential dual-stream
model on speech-correlated synthetic data, check that it learned the
audio -> face structure, and drive the trained checkpoint through the
``infer``, ``rt`` and ``export_model`` entry points. The counterpart of
the JAX package's ``scripts/training_rehearsal.py``.

No mocap corpus is in the repository. The targets here are derived from
the audio (jaw and mouth follow the energy envelope, lip shapes follow
F0, one brow channel drifts slowly across the 0.1 activation threshold,
the rest sits on a <= 0.008 noise floor), so a model that tracks them
must be using the audio. The success gate: correlation > 0.3, F1 > 0.2,
the range ratio at least half its first epoch's and at least
``--min-range-ratio``, and every entry point run on the checkpoint
exiting 0. A run that fails the gate writes ``training_report_failed.md``;
one shorter than the report already there writes
``training_report_smoke.md`` (``--force-report`` overrides); otherwise
``training_report.md``. Each goes under ``--report-dir`` with the
per-epoch curves as JSON lines (and PNGs where matplotlib imports). The
entry points (``infer``, ``rt``, ``export_model``) run at once, each in
its own process.

Training runs device-resident, as the JAX script's: at most 10 chunks of
epochs, each one ``Trainer.train_epochs_scan`` over the loader's batches
of that chunk (``set_epoch(c)``, ``shuffle_seed=100 + c``), so the batch
membership is re-formed once per chunk and the step order permuted per
epoch; the step order is a ``torch.Generator``'s permutation, not JAX's.
One checkpoint is written after the last chunk. The export step writes a
``torch.export`` program of the trained frame function (the JAX script
writes a TensorFlow SavedModel).

``--smoke`` (a port flag) is the quickest rehearsal known to pass the
gate, the check of the training path on the card: the values of
:data:`SMOKE` (the JAX package's committed report's 8 files, 880 epochs
and active weight 4, without the recall diagnosis) replace the
corresponding flags, and the checkpoint goes through ``infer`` and
``rt`` only (``export_model`` takes longer than the training). Shorter runs fail the gate's range ratio (4 files x
880 epochs: 0.35; 8 x 500: 0.44; ``port_runs/rehearsal_gate_probe.py``),
and on the card the scan epochs train the 8,800 steps in about a minute.

Runs on the GPU (raises without CUDA) unless ``--cpu`` is given. Prints
one JSON summary line; exits 0 when the gate passes.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPORT = "training_report.md"
REPORT_SMOKE = "training_report_smoke.md"
REPORT_FAILED = "training_report_failed.md"
THRESH_SWEEP = (0.05, 0.075, 0.1, 0.15, 0.2)
#: the JAX package's committed report (docs/training_report.md, a TPU run of
#: 880 epochs x 10 steps at active_weight 4): a quality reference only
JAX_REFERENCE = {"correlation": 0.928, "range_ratio": 0.860, "mae": 0.00441}


def _existing_total_steps(path: Path) -> int:
    """Total optimizer steps recorded in a report's header ("... N epochs x
    M steps ..."): the overwrite guard's yardstick."""
    if not path.exists():
        return 0
    m = re.search(r"(\d+) epochs x (\d+) steps", path.read_text())
    return int(m.group(1)) * int(m.group(2)) if m else 0


@torch.no_grad()
def recall_diagnosis(model, data_dir: Path) -> tuple[list, dict]:
    """The trained model's operating point over every utterance of
    ``data_dir``, each cut to their common length and decoded whole with
    its output-aligned targets: a threshold sweep (precision, recall and
    F1 at each cut), where the missed actives lie in target amplitude, the
    active channels' tracking, and the per-frame output sum on active
    frames (the across-52 fusion softmax bounds it near 1)."""
    from koemorph_tpu_torch.blendshapes import ARKIT_BLENDSHAPES
    from koemorph_tpu_torch.data.io import load_blendshapes_with_fps
    from koemorph_tpu_torch.data.wav import read_wav
    from koemorph_tpu_torch.train.trainer import sequence_targets

    device = next(model.parameters()).device
    model.eval()
    hop = int(model.sample_rate / model.target_fps)
    files = []
    for wav in sorted(Path(data_dir).glob("*.wav")):
        audio, _sr = read_wav(wav, mono=True)
        bs, _fps = load_blendshapes_with_fps(wav.with_suffix(".jsonl"))
        n_frames = min(len(audio) // hop, bs.shape[0])
        if n_frames > model.window_frames:
            files.append((audio, bs, n_frames))
    if not files:       # every utterance shorter than the model window
        return [], {}
    n_common = min(n for _, _, n in files)
    preds, tgts = [], []
    for audio, bs, _n in files:
        out = model(torch.from_numpy(audio[None, : n_common * hop]).to(
            device))["blendshapes"]
        t = sequence_targets(torch.from_numpy(bs[None, :n_common]),
                             model.window_frames, model.stride_frames,
                             out.shape[1])
        preds.append(out[0].cpu().numpy())
        tgts.append(t[0].numpy())
    pred = np.concatenate(preds)                          # (N, 52)
    tgt = np.concatenate(tgts)

    sweep = []
    for th in THRESH_SWEEP:
        pa, ta = pred > th, tgt > th
        tp = float((pa & ta).sum())
        prec = tp / max(pa.sum(), 1)
        rec = tp / max(ta.sum(), 1)
        sweep.append({"threshold": th, "precision": prec, "recall": rec,
                      "f1": 2 * prec * rec / max(prec + rec, 1e-9)})

    active = tgt > 0.1
    missed = active & (pred <= 0.1)
    stats = {
        "n_frames": int(pred.shape[0]),
        "active_frac": float(active.mean()),
        "missed_frac_of_active": float(missed.sum() / max(active.sum(), 1)),
        "missed_target_below_0p15": float(
            (tgt[missed] < 0.15).mean()) if missed.any() else 0.0,
        "missed_target_median": float(
            np.median(tgt[missed])) if missed.any() else 0.0,
        "pred_sum_mean_active_frames": float(
            pred[active.any(1)].sum(1).mean()),
        "tgt_sum_mean_active_frames": float(
            tgt[active.any(1)].sum(1).mean()),
    }
    stats["channels"] = [{
        "name": ARKIT_BLENDSHAPES[c],
        "active_frac": float(active[:, c].mean()),
        "tgt_mean": float(tgt[active[:, c], c].mean()),
        "pred_mean": float(pred[active[:, c], c].mean()),
        "recall": float((pred[active[:, c], c] > 0.1).mean()),
    } for c in np.nonzero(active.any(0))[0]]
    return sweep, stats


def run_entry_points(cmds: dict, work: Path, timeout: float = 900) -> dict:
    """Run each command of ``cmds`` (name -> argv) in its own process, all
    at once (each reads the checkpoint and writes its own output), their
    output to ``<work>/<name>.log``; returns name -> ``{"rc", "tail"}``
    (the last 400 characters of its output)."""
    procs = {}
    for name, cmd in cmds.items():
        log = open(work / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log)
    out = {}
    for name, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log.close()
        out[name] = {"rc": rc, "tail": (work / f"{name}.log").read_text()
                     [-400:]}
    return out


def passes_gate(summary: dict, min_range_ratio: float) -> bool:
    """The model tracks the audio (correlation), its threshold F1 is not
    degenerate, its amplitude range neither collapsed against the first
    epoch nor sits under ``min_range_ratio``, and every entry point run
    on the checkpoint exited 0."""
    return (summary["correlation_last"] > 0.3
            and summary["f1_last"] > 0.2
            and summary["range_ratio_last"] > 0.5 * max(
                summary["range_ratio_first"], 1e-9)
            and summary["range_ratio_last"] >= min_range_ratio
            and all(rc == 0 for rc in summary["cli"].values()))


def route_report(report_dir: Path, ok: bool, total_steps: int,
                 force: bool) -> Path:
    """Where the report goes: a failed gate to ``REPORT_FAILED``, a run
    shorter than the report already there to ``REPORT_SMOKE`` (unless
    ``force``), else ``REPORT``."""
    if not ok:
        return report_dir / REPORT_FAILED
    if total_steps < _existing_total_steps(report_dir / REPORT) \
            and not force:
        return report_dir / REPORT_SMOKE
    return report_dir / REPORT


def _plot_curves(epochs: list, report_dir: Path, suffix: str) -> list:
    """The loss and MAE curves and the stream weights as PNGs, where
    matplotlib imports; returns the files written."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []
    xs = np.arange(1, len(epochs) + 1)
    fig, ax = plt.subplots(1, 2, figsize=(10, 3.6))
    ax[0].plot(xs, [e["loss"] for e in epochs])
    ax[0].set(title="training loss", xlabel="epoch", ylabel="loss")
    ax[1].plot(xs, [e["mae"] for e in epochs], color="teal")
    ax[1].set(title="MAE", xlabel="epoch", ylabel="MAE")
    fig.tight_layout()
    out = [report_dir / f"rehearsal_loss{suffix}.png"]
    fig.savefig(out[0], dpi=110)
    plt.close(fig)
    keys = [k for k in epochs[0] if "stream" in k or "weight" in k]
    if keys:
        fig, ax = plt.subplots(figsize=(6.5, 3.6))
        for k in keys:
            ax.plot(xs, [e[k] for e in epochs], label=k)
        ax.legend(fontsize=7)
        ax.set(title="stream-weight specialization", xlabel="epoch")
        fig.tight_layout()
        out.append(report_dir / f"rehearsal_streams{suffix}.png")
        fig.savefig(out[1], dpi=110)
        plt.close(fig)
    return out


#: the flags ``--smoke`` sets
SMOKE = {"files": 8, "epochs": 880, "active_weight": 4.0,
         "no_diagnose_recall": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--work-dir", default="outputs/rehearsal")
    ap.add_argument("--report-dir", default="port_runs",
                    help="where the report and its curves go")
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--lr", type=float, default=5e-4,
                    help="the upper edge of the reference's schedule "
                         "(1e-4..5e-4); hotter runs collapse the sigmoid "
                         "outputs to zero under the L1-to-zero pressure "
                         "on the ~48 inactive channels")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--fps", type=int, default=30, choices=(30, 60),
                    help="60 doubles the mel window to 512 frames")
    ap.add_argument("--active-weight", type=float, default=1.0,
                    help="KoeMorphLossConfig.active_weight: extra MSE/L1 "
                         "emphasis on active-target elements (the "
                         "recall-vs-precision knob)")
    ap.add_argument("--no-diagnose-recall", action="store_true",
                    help="skip the threshold sweep and per-channel "
                         "operating point after training")
    ap.add_argument("--min-range-ratio", type=float, default=0.7,
                    help="absolute range_ratio floor of the success gate")
    ap.add_argument("--force-report", action="store_true",
                    help="write training_report.md even when this run "
                         "has fewer optimizer steps than the report "
                         "already there")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the GPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="the quickest rehearsal known to pass the gate: "
                         + ", ".join(f"{k}={v}" for k, v in SMOKE.items())
                         + ", no export step")
    args = ap.parse_args(argv)
    if args.smoke:
        for k, v in SMOKE.items():
            setattr(args, k, v)
    # the port trains in full fp32: cuDNN's convolutions too, which
    # PyTorch runs in TF32 by default (the trainer refuses them)
    torch.backends.cudnn.allow_tf32 = False

    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.device import device_label, resolve_device
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel)
    from koemorph_tpu_torch.train.__main__ import write_synthetic_dataset
    from koemorph_tpu_torch.train.trainer import SequentialTrainer

    device = resolve_device("cpu" if args.cpu else None)
    work = Path(args.work_dir)
    work.mkdir(parents=True, exist_ok=True)
    report_dir = Path(args.report_dir)
    data_dir = write_synthetic_dataset(
        work / "data", args.files, duration_s=args.duration, seed=7,
        fps=float(args.fps), speech_correlated=True)

    window = 256 if args.fps == 30 else 512
    model = SequentialDualStreamModel(
        d_model=args.d_model, num_heads=8, mel_sequence_length=window,
        emotion_backend="egemaps", use_concatenation=True,
        target_fps=args.fps, dropout=0.1, stride_frames=4)
    span = model.window_frames + 32
    loader_fn, dataset = create_sequential_dataloader(
        str(data_dir), batch_size=args.batch_size, window_frames=span,
        stride_frames=64, sample_rate=16000, target_fps=float(args.fps))
    if dataset.get_num_windows() == 0:
        print(f"no training windows: each file must be longer than the "
              f"model's window span ({span} frames = {span / args.fps:.1f} "
              f"s at {args.fps} fps; got --duration {args.duration}). "
              "Increase --duration.", file=sys.stderr)
        return 2
    steps = max(1, dataset.get_num_windows() // args.batch_size)
    tcfg = {
        "training": {
            "optimizer": {"name": "adamw", "lr": args.lr,
                          "weight_decay": 1e-5},
            "lr_scheduler": {"name": "cosine", "t_max": args.epochs,
                             "eta_min": 1e-6},
            "loss": {"mse_weight": 1.0, "l1_weight": 0.3,
                     "velocity_weight": 0.1,
                     "active_weight": args.active_weight},
            "gradient_clip_val": 1.0,
            "max_epochs": args.epochs,
            # one checkpoint, after the last epoch
            "checkpoint": {"every_n_epochs": args.epochs},
            "logging": {"log_every_n_steps": 10,
                        "log_images_every_n_steps": 0},
        },
        "data": {"window_frames": span},
    }
    trainer = SequentialTrainer(model, tcfg, work_dir=work,
                                steps_per_epoch=steps, span_frames=span,
                                device=device)

    t0 = time.time()
    n_chunks = min(10, max(args.epochs, 0))
    per_chunk = args.epochs // n_chunks if n_chunks else 0
    epochs = []
    for c in range(n_chunks):
        dataset.set_epoch(c)
        n_ep = per_chunk if c < n_chunks - 1 else (
            args.epochs - per_chunk * (n_chunks - 1))
        epochs += trainer.train_epochs_scan(loader_fn(), n_epochs=n_ep,
                                            shuffle_seed=100 + c)
    trainer.checkpoints.save(
        trainer.model.state_dict(), epoch=args.epochs - 1,
        global_step=trainer.global_step, val_loss=None,
        opt_state=trainer.opt_state())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0

    # ---- the checkpoint through the entry points ----
    ckpt = work / "checkpoints" / "last"
    wav = next(Path(data_dir).glob("*.wav"))
    dev_args = ["--device", "cpu"] if args.cpu else []

    cli_log = run_entry_points({
        "infer": [sys.executable, "-m", "koemorph_tpu_torch.infer",
                  "--model", str(ckpt), "--input", str(wav),
                  "--output", str(work / "infer_out.jsonl"),
                  "--fps", str(args.fps), "--d-model", str(args.d_model),
                  *dev_args],
        "rt": [sys.executable, "-m", "koemorph_tpu_torch.rt",
               "--model", str(ckpt), "--input", str(wav),
               "--output", "file",
               "--output-file", str(work / "rt_out.jsonl"),
               "--no-realtime", "--d-model", str(args.d_model),
               "--fps", str(args.fps), "--max-frames", "120", *dev_args],
        **({} if args.smoke else {"export": [
            sys.executable, "-m", "koemorph_tpu_torch.export_model",
            "--model", str(ckpt), "--output", str(work / "export"),
            "--d-model", str(args.d_model), "--fps", str(args.fps),
            *dev_args]})}, work)

    empty = {"loss": float("nan"), "mae": float("nan")}
    first, last = (epochs[0], epochs[-1]) if epochs else (empty, empty)
    sweep, rstats = ([], {})
    if not args.no_diagnose_recall:
        sweep, rstats = recall_diagnosis(trainer.model, data_dir)

    summary = {
        "epochs": len(epochs),
        "steps_per_epoch": steps,
        "fps": args.fps,
        "active_weight": args.active_weight,
        "loss_first": float(first["loss"]),
        "loss_last": float(last["loss"]),
        "mae_last": float(last.get("mae", float("nan"))),
        "correlation_first": float(first.get("correlation", 0.0)),
        "correlation_last": float(last.get("correlation", 0.0)),
        "f1_last": float(last.get("f1_score", 0.0)),
        "precision_last": float(last.get("precision", 0.0)),
        "recall_last": float(last.get("recall", 0.0)),
        "range_ratio_first": float(first.get("range_ratio", 0.0)),
        "range_ratio_last": float(last.get("range_ratio", 0.0)),
        "sweep": [{k: round(float(v), 4) for k, v in row.items()}
                  for row in sweep],
        "train_seconds": round(train_s, 1),
        "device": device_label(device),
        "cli": {k: v["rc"] for k, v in cli_log.items()},
    }
    ok = passes_gate(summary, args.min_range_ratio)
    report_path = route_report(report_dir, ok, args.epochs * steps,
                               args.force_report)
    if report_path.name != REPORT:
        print(f"writing {report_path.name}: "
              + ("the run failed its success gate" if not ok else
                 f"the run ({args.epochs * steps} steps) is shorter than "
                 f"{REPORT}'s; pass --force-report to overwrite"),
              file=sys.stderr)

    report_dir.mkdir(parents=True, exist_ok=True)
    suffix = report_path.stem[len("training_report"):] + (
        "" if args.fps == 30 else f"_{args.fps}fps")
    curves = report_dir / f"rehearsal_curves{suffix}.jsonl"
    curves.write_text("".join(json.dumps(e) + "\n" for e in epochs))
    pngs = _plot_curves(epochs, report_dir, suffix) if epochs else []

    report = [
        "# Training dress rehearsal (production sequential model, port)",
        "",
        f"Generated by `python -m koemorph_tpu_torch.training_rehearsal` "
        f"on {summary['device']}: {args.files} files x "
        f"{args.duration:.0f} s speech-correlated synthetic data, "
        f"SequentialDualStreamModel d={args.d_model}, window {window}, "
        f"stride 4, {args.fps} fps, {args.epochs} epochs x {steps} steps, "
        f"batch {args.batch_size}, lr {args.lr:g}, active_weight "
        f"{args.active_weight:g}, device-resident scan epochs "
        f"(`train_epochs_scan` in {n_chunks} chunks, batch membership "
        f"re-formed per chunk), {train_s:.1f} s of training wall.",
        "",
        "The JAX package's committed report (`docs/training_report.md`, "
        "a TPU run of 880 epochs x 10 steps at active_weight 4 through "
        "device-resident scan epochs) reached correlation "
        f"{JAX_REFERENCE['correlation']}, range_ratio "
        f"{JAX_REFERENCE['range_ratio']} and MAE {JAX_REFERENCE['mae']}: "
        "a quality reference, not a speed one.",
        "",
        "MAE floor: with a uniform [0, 0.008] noise floor on the ~48 "
        "inactive channels a perfect model scores MAE ~0.004.",
        "",
        "| metric | first epoch | last epoch | JAX report (TPU) |",
        "|---|---|---|---|",
    ]
    for key in sorted(set(first) & set(last)):
        ref = JAX_REFERENCE.get(key, "")
        report.append(f"| {key} | {float(first[key]):.5f} "
                      f"| {float(last[key]):.5f} | {ref} |")
    report += ["", f"Per-epoch curves: `{curves.name}`"
               + "".join(f", `{p.name}`" for p in pngs) + ".", ""]
    if sweep:
        report += [
            "## Recall diagnosis (threshold operating point)",
            "",
            "An element counts as active above 0.1 (the reference's "
            "metrics threshold).",
            "",
            "| threshold | precision | recall | F1 |",
            "|---|---|---|---|",
            *(f"| {r['threshold']:g} | {r['precision']:.3f} "
              f"| {r['recall']:.3f} | {r['f1']:.3f} |" for r in sweep),
            "",
            f"{rstats['missed_frac_of_active']:.1%} of active-target "
            f"elements are missed at the 0.1 cut; "
            f"{rstats['missed_target_below_0p15']:.1%} of those have a "
            f"target under 0.15 (median missed target "
            f"{rstats['missed_target_median']:.3f}). Active-frame output "
            f"sums average {rstats['pred_sum_mean_active_frames']:.3f} "
            f"against the targets' "
            f"{rstats['tgt_sum_mean_active_frames']:.3f} (ceiling ~1).",
            "",
            "| channel | active frac | target mean | pred mean "
            "| recall@0.1 |",
            "|---|---|---|---|---|",
            *(f"| {c['name']} | {c['active_frac']:.3f} "
              f"| {c['tgt_mean']:.3f} | {c['pred_mean']:.3f} "
              f"| {c['recall']:.3f} |" for c in rstats["channels"]),
            "",
        ]
    report += ["## Checkpoint driven through the entry points", ""]
    for name, res in cli_log.items():
        status = "ok" if res["rc"] == 0 else f"FAILED rc={res['rc']}"
        report.append(f"- `{name}`: {status}")
    report.append("")
    report_path.write_text("\n".join(report))

    summary["report"] = str(report_path)
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
