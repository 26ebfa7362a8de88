#!/usr/bin/env python3
"""Drive the PyTorch port of KoeMorph on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line:

1. device: the card's name and power limit (no GPU is a failure);
2. build: the CUDA kernels compiled from ``koemorph_tpu_torch/ops/cuda``;
3. cycle_dsum: the kernel against its plain PyTorch form on the card, at
   both shapes the streaming refresh uses and at 13,600 rows;
4. dk_roots: the kernel against its plain form on LPC polynomials of
   vowel-like frames, at 30 and 4,096 rows;
5. stream: the flagship streaming model (d_model 256, 8 heads, 256-frame
   window, 80 mels, 264-D eGeMAPS, 20 s ring, refresh every 9 frames) over
   3.5 s of synthetic voiced audio through ``StreamingInference``, with the
   kernels' launch counts, then the same stream with the plain forms;
6. times: per-frame device times (refresh and other frames), a profile of
   the kernels one frame runs, and per-launch kernel times (back-to-back
   launches timed with CUDA events, ``ms``, and the kernel's own device
   duration from the profiler, ``device_ms``) beside the plain forms,
   ``torch.linalg.eigvals`` and the bound the card's memory and fp32 rates
   set.

Every check that fails raises, so the script exits non-zero; no phase
catches its own failure. The last lines are the kernels table, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
K1_RTOL = K1_ATOL = 1e-5
DK_MEDIAN_MAX, DK_MAX = 1e-5, 1e-3
STREAM_PLAIN_MAX = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn):
    """Run ``fn()`` under ``torch.profiler`` and return the device kernels
    it ran as (name, microseconds) pairs (empty when the profiler sees no
    device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if str(e.device_type).endswith("CUDA")]


def kernel_device_ms(fn, pattern: str, iters: int = 50):
    """Mean device duration (ms) of the kernels named like ``pattern`` over
    ``iters`` calls of ``fn``, from the profiler; None if it saw none."""
    def run():
        for _ in range(iters):
            fn()
    times = [us for name, us in device_kernels(run) if pattern in name]
    return float(np.mean(times)) / 1e3 if times else None


def voiced_audio(seconds: float, seed: int, sr: int = 16000):
    """Harmonic pulse train with formants: stretches at 85 Hz (below the
    512-sample frame's cycle-pair limit), 200 Hz, and a 120-250 Hz glide,
    with short pauses and a little noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = np.where(t < 1.0, 85.0, np.where(t < 2.0, 200.0,
                                          120.0 + 130.0 * (t - 2.0) / 1.5))
    phase = np.cumsum(2 * np.pi * f0 / sr)
    x = np.zeros(n)
    for h in range(1, 60):
        fh = f0 * h
        gain = sum(np.exp(-((fh - c) / w) ** 2)
                   for c, w in ((700, 250), (1200, 300), (2600, 400))) + 0.05
        x += np.where(fh < 7600, gain, 0.0) * np.cos(h * phase)
    gate = ((t % 1.0) < 0.9).astype(np.float64)
    x = 0.3 * x / np.abs(x).max() * gate
    return (x + 0.003 * rng.standard_normal(n)).astype(np.float32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops.stft import autocorr_matmul
    from koemorph_tpu_torch.runtime.engine import build_streaming_model
    from koemorph_tpu_torch.runtime.streaming import StreamingInference

    # full-f32 products everywhere (TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_script = time.perf_counter()

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    card = f"{name}, {smi.split(',')[-1].strip()}"
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build (one nvcc per source, all at once) ----
    t0 = time.perf_counter()
    libs = ck.build()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libs": {k: str(v) for k, v in libs.items()},
          "ptxas": {k: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, log in ck.BUILD_LOGS.items()}})

    # ---- 3. cycle_dsum: kernel vs plain ----
    rng = np.random.default_rng(0)
    tau_max = 291                      # ceil(16000 / 55)

    def k1_inputs(rows, n, half_lag):
        frames = rng.standard_normal((rows, n)).astype(np.float32) * 0.3
        pick = rng.integers(32, tau_max, size=rows)
        start = np.clip(pick - half_lag, 0, tau_max + half_lag)
        tau = (pick + rng.uniform(-0.5, 0.5, rows)).astype(np.float32)
        off = (rng.uniform(0, 0.5, rows) * tau).astype(np.float32)
        # extreme periods and grid phases: lowest pitch at the clip edge,
        # highest pitch (many cycles), zero phase
        start[:3] = [0, tau_max + half_lag, 24]
        tau[:3] = [8.0, tau_max, 32.4]
        off[:3] = [0.0, 0.0, 3.7]
        return (torch.from_numpy(frames).to(dev),
                torch.from_numpy(start.astype(np.int32)).to(dev),
                torch.from_numpy(tau).to(dev), torch.from_numpy(off).to(dev))

    k1_shapes = {"K8/L17/n512": (30, 512, 8, 8),
                 "K5/L33/n1024": (30, 1024, 5, 16),
                 "K8/L17/n512 x13600": (13600, 512, 8, 8)}
    k1 = {}
    for label, (rows, n, K, H) in k1_shapes.items():
        args = k1_inputs(rows, n, H)
        kw = dict(n_cycles=K, half_lag=H)
        got = ck.cycle_dsum(*args, **kw)
        want = f0_ops.cycle_dsum_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= K1_ATOL + K1_RTOL * want.abs()).all())
        k1[label] = dict(args=args, kw=kw, rows=rows, n=n, K=K, L=2 * H + 1,
                         max_abs_err=float(err.max()))
        emit({"phase": "cycle_dsum", "shape": label, "rows": rows,
              "max_abs_err": float(err.max()),
              "max_ref": float(want.abs().max()), "rtol": K1_RTOL,
              "atol": K1_ATOL, "ok": ok})
        check(ok, f"cycle_dsum kernel disagrees with plain at {label}")

    # ---- 4. dk_roots: kernel vs plain on LPC polynomials ----
    def lpc_polys(rows):
        # vowel-like frames: three formant tones plus noise (polynomials
        # with clustered roots are where 20 Durand-Kerner iterations stop
        # short in any implementation)
        t = np.arange(400) / 16000
        x = rng.standard_normal((rows, 400)).astype(np.float32) * 0.05
        x += (0.5 * np.sin(2 * np.pi * 700 * t)
              + 0.3 * np.sin(2 * np.pi * 1220 * t)
              + 0.2 * np.sin(2 * np.pi * 2600 * t))[None, :].astype(
                  np.float32)
        x *= np.hanning(400)[None, :].astype(np.float32)
        r = autocorr_matmul(torch.from_numpy(x).to(dev), 11)
        r = torch.cat([r[:, :1] * 1.0001, r[:, 1:]], -1)
        return eg._levinson(r, 10).contiguous()

    def hausdorff(za, zb):
        d = (za[:, :, None] - zb[:, None, :]).abs()
        return torch.maximum(d.amin(2).amax(1), d.amin(1).amax(1))

    def companion(a):
        rows = a.shape[0]
        comp = torch.zeros((rows, 10, 10), device=dev, dtype=a.dtype)
        comp[:, 0, :] = -a[:, 1:] / a[:, :1]
        comp[:, 1:, :-1] = torch.eye(9, device=dev, dtype=a.dtype)
        return comp

    k2 = {}
    for rows in (30, 4096):
        a = lpc_polys(rows)
        got = ck.dk_roots(a)
        want = eg.poly_roots_plain(a)
        h = hausdorff(got, want)
        # rows where 20 iterations have not converged (the plain form is
        # more than the max bound from the exact roots, float64 eigvals)
        # diverge chaotically in any two implementations: counted, and
        # held to no bound; at most 0.5% of the rows may be such
        exact = torch.linalg.eigvals(companion(a.double()))
        conv = hausdorff(want.to(torch.complex128), exact) < DK_MAX
        n_bad = int((~conv).sum())
        ok = bool(h[conv].median() < DK_MEDIAN_MAX
                  and h[conv].max() < DK_MAX and n_bad <= 0.005 * rows)
        k2[rows] = dict(a=a, max_abs_err=float(h[conv].max()))
        emit({"phase": "dk_roots", "rows": rows,
              "hausdorff_median_converged": float(h[conv].median()),
              "hausdorff_max_converged": float(h[conv].max()),
              "hausdorff_max_all": float(h.max()),
              "unconverged_rows": n_bad, "median_bound": DK_MEDIAN_MAX,
              "max_bound": DK_MAX, "ok": ok})
        check(ok, f"dk_roots kernel disagrees with plain at {rows} rows")

    # ---- 5. the flagship stream through the user entry points ----
    model, cfg = build_streaming_model(seed=0)
    engine = StreamingInference(model, cfg)
    audio = voiced_audio(3.5, seed=1)
    engine.warmup()
    ck.reset_launch_counts()
    frames = engine.process_audio(audio)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    path_launches = dict(ck.SHAPE_LAUNCHES)
    shape_launches = {f"{k[0]}{list(k[1])}": v
                      for k, v in path_launches.items()}
    bs = np.stack(frames)
    n_frames = len(frames)
    n_refresh = -(-n_frames // cfg.emotion_update_frames)
    emit({"phase": "stream", "frames": n_frames, "refreshes": n_refresh,
          "shape": list(bs.shape), "finite": bool(np.isfinite(bs).all()),
          "min": float(bs.min()), "max": float(bs.max()),
          "launches": launches, "launches_by_shape": shape_launches,
          "performance_stats": engine.performance_stats()})
    check(n_frames >= 90 and bs.shape[1:] == (52,), "stream shape")
    check(bool(np.isfinite(bs).all()), "stream has non-finite values")
    check(bs.min() >= 0.0 and bs.max() <= 1.0, "blendshapes outside [0, 1]")
    check(launches["cycle_dsum"] == 2 * n_refresh
          and launches["dk_roots"] == n_refresh,
          f"kernel launches {launches} for {n_refresh} refreshes")

    # the same stream with the plain forms on the card
    saved = (f0_ops.cycle_dsum, eg.poly_roots)
    f0_ops.cycle_dsum, eg.poly_roots = f0_ops.cycle_dsum_plain, \
        eg.poly_roots_plain
    try:
        engine.reset()
        plain = np.stack(engine.process_audio(audio))
    finally:
        f0_ops.cycle_dsum, eg.poly_roots = saved
    d_plain = float(np.abs(plain - bs).max())
    emit({"phase": "stream_plain", "max_abs_diff_blendshapes": d_plain,
          "bound": STREAM_PLAIN_MAX})
    check(d_plain <= STREAM_PLAIN_MAX, "kernel stream != plain stream")

    # ---- 6. times ----
    hop = cfg.hop_length
    engine.reset()
    evs = []
    with torch.inference_mode():
        for i in range(n_frames):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = engine.step(audio[i * hop:(i + 1) * hop])
            e1.record()
            out.cpu()
            evs.append((e0, e1))
    torch.cuda.synchronize()
    ft = np.asarray([a.elapsed_time(b) for a, b in evs])
    is_ref = np.arange(n_frames) % cfg.emotion_update_frames == 0

    def q(x):
        return {"median_ms": float(np.median(x)),
                "p99_ms": float(np.percentile(x, 99)), "n": int(len(x))}

    emit({"phase": "frame_times", "card": card, "refresh": q(ft[is_ref]),
          "other": q(ft[~is_ref])})

    # where a frame's time goes: device kernels per frame, their summed
    # device time, and the host wall time of the same frames
    engine.reset()
    for label, idx in (("refresh", [0]), ("other", list(range(1, 9)))):
        def frames_run():
            with torch.inference_mode():
                for i in idx:
                    engine.step(audio[i * hop:(i + 1) * hop]).cpu()
        t0 = time.perf_counter()
        ks = device_kernels(frames_run)
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(idx)
        busy_ms = sum(us for _, us in ks) / 1e3 / len(idx)
        top = {}
        for kname, us in ks:
            top[kname[:60]] = top.get(kname[:60], 0.0) + us / len(idx)
        emit({"phase": "frame_profile", "frames": label, "card": card,
              "kernels_per_frame": len(ks) / len(idx),
              "device_busy_ms_per_frame": busy_ms,
              "profiled_wall_ms_per_frame": wall_ms,
              "top_kernels_us_per_frame": dict(sorted(
                  top.items(), key=lambda kv: -kv[1])[:8])})

    kernels = []
    for label in ("K8/L17/n512", "K5/L33/n1024", "K8/L17/n512 x13600"):
        c = k1[label]
        args, kw = c["args"], c["kw"]
        ms = time_ms(lambda: ck.cycle_dsum(*args, **kw))
        device_ms = kernel_device_ms(lambda: ck.cycle_dsum(*args, **kw),
                                     "cycle_dsum_kernel")
        plain_ms = time_ms(lambda: f0_ops.cycle_dsum_plain(*args, **kw),
                           iters=20)
        frames_t, start, tau, off = args
        rows, n, K, L = c["rows"], c["n"], c["K"], c["L"]
        # the samples the cycle masks select, from these inputs
        span = n - L + 1
        j = torch.arange(span, device=dev, dtype=torch.float32)
        kk = torch.arange(K, device=dev, dtype=torch.float32)[:, None]
        lim = (n - 1.0) - 2.0 * (L // 2) - start.float()
        m = ((j >= off[:, None, None] + kk * tau[:, None, None])
             & (j < off[:, None, None] + (kk + 1.0) * tau[:, None, None])
             & (j <= lim[:, None, None]))
        ops = 3.0 * L * float(m.sum())
        nbytes = rows * (n * 4 + 12) + rows * K * L * 4
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S) * 1e3
        entry = {"name": f"cycle_dsum[{label}]", "route": "cuda",
                 "source": "koemorph_tpu_torch/ops/cuda/cycle_dsum.cu",
                 "replaces": "koemorph_tpu/ops/pallas/cycle_dsum_kernel.py:79",
                 "launches": path_launches.get(("cycle_dsum", (K, L, n)), 0)
                 if rows == 30 else 0,
                 "max_abs_err": c["max_abs_err"], "ms": ms,
                 "device_ms": device_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                              >= ops / PEAK_FP32_PER_S else "operations"),
                 "library_ms": None, "card": card}
        if rows == 30:
            kernels.append(entry)
        else:
            emit({"phase": "kernel_time_offpath", **entry})

    for rows in (30, 4096):
        a = k2[rows]["a"]
        ms = time_ms(lambda: ck.dk_roots(a))
        device_ms = kernel_device_ms(lambda: ck.dk_roots(a),
                                     "dk_roots_kernel")
        plain_ms = time_ms(lambda: eg.poly_roots_plain(a), iters=20)
        comp = companion(a)
        library_ms = time_ms(lambda: torch.linalg.eigvals(comp), iters=20)
        ops = 20.0 * 10 * (10 * 11 + 10 * 10 + 14) * rows
        nbytes = rows * 11 * 4 + rows * 10 * 8 + 10 * 8
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S) * 1e3
        entry = {"name": f"dk_roots[{rows} rows]", "route": "cuda",
                 "source": "koemorph_tpu_torch/ops/cuda/dk_roots.cu",
                 "replaces": "koemorph_tpu/ops/pallas/dk_roots_kernel.py:95",
                 "launches": path_launches.get(("dk_roots", (rows,)), 0)
                 if rows == 30 else 0,
                 "max_abs_err": k2[rows]["max_abs_err"], "ms": ms,
                 "device_ms": device_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                              >= ops / PEAK_FP32_PER_S else "operations"),
                 "library_ms": library_ms, "card": card}
        if rows == 30:
            kernels.append(entry)
        else:
            emit({"phase": "kernel_time_offpath", **entry})
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the path was not launched by the stream")

    emit({"phase": "done",
          "seconds": round(time.perf_counter() - t_script, 1)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
