#!/usr/bin/env python3
"""Drive the PyTorch port of KoeMorph on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root

Phases, each printing one JSON line:

1. device: the card's name and power limit (no GPU is a failure);
2. build: the CUDA kernels compiled from ``koemorph_tpu_torch/ops/cuda``;
3. cycle_dsum: the kernel against its plain PyTorch form on the card, at
   both shapes the streaming refresh uses (30 rows) and both shapes the
   flagship decode uses (13,624 rows), on contiguous frames and on the
   same kind of strided views the paths pass (read in place), on cycle
   boundaries that fall on integer samples, tau 8 and tau_max, zero phase
   and non-finite periods and phases; two launches bitwise equal at 30 and
   13,624 rows;
4. dk_roots: the kernel against its plain form on LPC polynomials of
   vowel-like frames, at 30 and 13,624 rows, and on diverging rows (one
   huge or non-finite coefficient) whose roots both forms turn NaN;
5. logmel: the fused STFT -> mel -> dB kernel against its plain form at
   T = 1 (the stream), 1,040 (the decode's window-edge frames) and 4,104
   (the decode's global STFT), on the 64 rows of a multi-session audio
   ring that the server reads in place (odd row stride, unaligned), on
   silent and on near-full-scale frames; two launches bitwise equal at
   T = 1, 64, 1,040 and 4,104; on a
   high-dynamic-range set (a near-full-scale tone, noise 90 dB below)
   both the kernel's and the plain form's errors against a float64 form
   on the card, mel bins within 80 dB of each frame's maximum;
Every path runs as the card runs it by default, one CUDA graph replay
per step (``runtime/graphs.py``), and each is held bit for bit against
the same path run eagerly (``graphs=False``), which also records the
arguments each kernel was called with. Each main path is driven with the
launch counts set to 0 just before its engine is built: the wrappers
count the warm-up runs' launches and those each capture records, and the
replays, which run without the wrappers, are counted from the profiler's
kernel names over the whole run and held equal to what the replayed
graphs recorded. The plain-form comparisons run eager engines built
inside ``plain_forms()``.

6. stream: the flagship streaming model (d_model 256, 8 heads, 256-frame
   window, 80 mels, 264-D eGeMAPS, 20 s ring, refresh every 9 frames) over
   3.5 s of synthetic voiced audio through ``StreamingInference`` (four
   graphs), with the kernels' launch counts, against the eager stream
   bitwise, then the same stream with the plain forms;
7. decode: ``BatchedSequentialDecoder`` at the flagship width over 8
   utterances of 17.06 s (stride 4, reflect window edges), one graph,
   with launch counts, against the eager decode bitwise, then with the
   plain forms; ``decode_scheduled`` (eager) with strides 4 and 8; a
   60 fps decode; ``exact_window_stft`` against the reflect splice on
   9 s; the first and second calls of an unseen length, graphed and
   eager (``decode_new_length``); eager decodes of 40 other lengths,
   which evict the cached constants the graphs read from their caches,
   then the decode's and the stream's graphs again, bitwise as before
   (``graphs_hold_constants``); the arguments the stream and the decode
   passed ``cycle_dsum`` (recorded in phases 6 and 7: frame views, not
   copies) against the plain form;
8. serving: ``MultiStreamInference`` at the flagship width, 64 sessions
   of the voiced pattern shifted 0.25 s per lane, 105 steps, with one
   refresh clock and with 8 refresh cohorts (``multistream``: 2(G+1)
   graphs, launch counts, ``logmel`` once per step at T = 64,
   ``cycle_dsum`` twice and ``dk_roots`` once per refreshing cohort-step
   at 1,920 or 240 rows, bitwise equal to the eager server);
   lanes of cohorts 0, 1, 5 and 7 against dedicated ``StreamingInference``
   engines whose clocks start at the cohort's phase
   (``multistream_lanes``); both clock settings with the plain forms
   (``multistream_plain``); a lane reset against a fresh phase-shifted
   engine, the other lanes untouched, graphed bitwise equal to eager
   (``multistream_reset``); int16 input bitwise equal to float, graphed
   and eager (``multistream_int16``); step times, kernels and device busy
   per step, graph count, capture time and peak memory, graphed and
   eager, ``sustained_stats`` at 64 and 256 sessions with 8 cohorts and
   with one clock, and one clock's refreshing step at 256 sessions
   (``multistream_times``); ``python -m koemorph_tpu_torch.serve`` in
   replay mode (``serve_cli``) and in listen mode fed over loopback by
   ``python -m koemorph_tpu_torch.feed_serve`` (``serve_listen``);
9. infer_cli: ``python -m koemorph_tpu_torch.infer`` on a 10 s WAV;
10. times: per-frame stream times and profiles (graphed and eager; the
   eager refresh frame also with the eGeMAPS index copies put back, and
   in a profiling window without a lead-in), the
   decode's time per call, frames per second and profile (graphed and
   eager) and stage split, and per-launch kernel times
   (back-to-back launches timed with CUDA events, ``ms``, and the kernels'
   own device duration per call from the profiler, ``device_ms``) beside
   the plain forms, a library call where one exists, and the bound the
   card's memory and fp32 rates set (for ``logmel`` also the 3xTF32
   tensor-core bound, ``bound_tc_ms``), counting the work this run's
   inputs need (for ``logmel`` the live bins and the nonzero filter
   weights; for ``cycle_dsum`` the distinct samples its frame views cover
   and the masked samples, with ``bound_materialized_ms`` counting every
   frame's samples as the copy the paths no longer make); ``cycle_dsum``
   also on the arguments the stream and the decode passed it.

Every check that fails raises, so the script exits non-zero; no phase
catches its own failure. Among the checks: the graphed single-session
refresh frame and the graphed 64-session refreshing step with one clock
have a p99 under the 33.3 ms frame budget, the kernels each main path's
replays ran (the profiler's kernel names) are those their captures
recorded, and a graphed non-refreshing server step is no busier on the
device than the eager one (within 5%). The last lines are the kernels
table, the ``nvidia-smi`` name and power limit, and ``{"ok": true,
"device": ...}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12                # dense tensor-core TF32
K1_RTOL = K1_ATOL = 1e-5
DK_MEDIAN_MAX, DK_MAX = 1e-5, 1e-3
K3_RTOL, K3_ATOL = 1e-4, 1e-3          # dB; the JAX kernel test's bound
K3_HDR_FLOOR = 1e-3                    # dB; the 2x rule's floor
STREAM_PLAIN_MAX = 1e-4
DECODE_PLAIN_MAX = 1e-4
EXACT_EDGE_MAX = 1e-3                  # docs/flagship_parity.json e2e gate
SERVE_PLAIN_MAX = 1e-4                 # kernels vs plain forms, served
SERVE_LANE_MAX = 1e-4                  # a lane vs its dedicated engine
SERVE_UNTOUCHED_MAX = 1e-6             # lanes beside a reset lane
BUDGET_MS = 1e3 / 30                   # a 30 fps frame
SR, HOP = 16000, 533
DECODE_B, DECODE_LEN, DECODE_STRIDE = 8, 512 * HOP, 4
SERVE_S, SERVE_BIG, SERVE_STEPS, SERVE_SHIFT = 64, 256, 105, 4000


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


MEASURED = "chip_smoke.measured"


def profiled(fn):
    """Run ``fn()`` under ``torch.profiler`` (input shapes recorded) in a
    ``MEASURED`` range, after a lead-in: a profiling window loses its
    first few device activities, so it starts with 64 tiny kernels, a
    synchronization and 20 ms of sleep, which ``measured_events`` leaves
    out. ``prof.wall_s`` is the host time of ``fn()`` to a
    synchronization."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        lead = torch.zeros(1, device="cuda")
        for _ in range(64):
            lead.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.02)
        t0 = time.perf_counter()
        with record_function(MEASURED):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.wall_s = wall
    return prof


def measured_events(prof):
    """The profile's events that start inside its ``MEASURED`` range (1 ms
    of slack for clock alignment; the lead-in ended 20 ms before)."""
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == MEASURED)
    return [e for e in events
            if e.name != MEASURED and e.time_range.start >= start - 1000]


def device_kernels(fn, prof=None):
    """The device activities (kernels, copies, fills) ``fn()`` ran as
    (name, microseconds) pairs, from ``torch.profiler`` (empty when the
    profiler sees no device activity); ``prof`` reuses a profile of
    ``fn`` already taken."""
    prof = prof or profiled(fn)
    return [(e.name, e.time_range.elapsed_us()) for e in
            measured_events(prof) if str(e.device_type).endswith("CUDA")]


#: the profiler's kernel names of each hand-written kernel's source
KERNEL_PATTERNS = {"cycle_dsum": "cycle_dsum_kernel",
                   "dk_roots": "dk_roots_kernel", "logmel": "logmel_"}
#: the kernels one launch of each wrapper runs (the logmel wrapper: its
#: power or product pass and its mel or reduction pass)
KERNELS_PER_LAUNCH = {"cycle_dsum": 1, "dk_roots": 1, "logmel": 2}


def own_kernels(ks, per: float = 1.0) -> dict:
    """Device kernels of each hand-written source among profiled (name,
    µs) pairs, per ``per`` (the logmel wrapper launches two: its power or
    product pass and its mel or reduction pass)."""
    return {src: sum(pat in name for name, _ in ks) / per
            for src, pat in KERNEL_PATTERNS.items()}


def copies(ks, per: float = 1.0) -> dict:
    """Copies and fills among profiled (name, µs) pairs, by kind, per
    ``per``: the device activities that are not kernels."""
    out: dict = {}
    for name, _ in ks:
        if name.startswith(("Memcpy", "Memset")):
            out[name] = out.get(name, 0.0) + 1.0 / per
    return out


def recorded(graphs, key) -> dict:
    """The launches the capture of ``key`` recorded, by kernel."""
    by = dict.fromkeys(KERNEL_PATTERNS, 0)
    for (name, _), n in graphs.launches(key).items():
        by[name] += n
    return by


def graph_info(graphs) -> dict:
    """Graph count, capture seconds (warm-up runs included), the launches
    each graph's capture recorded, by kernel, and its replays."""
    return {"count": len(graphs), "capture_s": graphs.capture_s,
            "recorded_launches": {str(k): recorded(graphs, k)
                                  for k in graphs.keys()},
            "replays": {str(k): n for k, n in graphs.replays.items()}}


def refresh_record(t: int, rows: int, refresh: bool) -> dict:
    """The launches, by ``(name, shape)``, a stream or server step records:
    ``logmel`` on its ``t`` newest frames; on a refresh ``cycle_dsum`` at
    both frame lengths and ``dk_roots`` on ``rows`` LLD rows."""
    rec = {("logmel", (t,)): 1}
    if refresh:
        rec.update({("cycle_dsum", (rows, 8, 17, 512)): 1,
                    ("cycle_dsum", (rows, 5, 33, 1024)): 1,
                    ("dk_roots", (rows,)): 1})
    return rec


def replayed_launches(graphs, fn) -> tuple[dict, dict]:
    """Run ``fn()`` profiled. Returns the launches of each hand-written
    kernel the profiler saw, from the kernel names, and those the graphs
    ``fn()`` replayed recorded at capture (each graph's record times its
    replays in the run)."""
    before = collections.Counter(graphs.replays)
    ks = device_kernels(None, profiled(fn))
    seen = {src: n / KERNELS_PER_LAUNCH[src]
            for src, n in own_kernels(ks).items()}
    want = dict.fromkeys(KERNEL_PATTERNS, 0)
    for key, n in graphs.replays.items():
        for name, c in recorded(graphs, key).items():
            want[name] += (n - before[key]) * c
    return seen, want


def top_ops(prof, per: float, n: int = 8) -> dict:
    """Device microseconds per call by the host operator (with its input
    shapes) that launched each kernel, the ``n`` largest."""
    acc: dict = {}
    for e in measured_events(prof):
        for k in getattr(e, "kernels", []) or []:
            shapes = [list(s) for s in (e.input_shapes or []) if s]
            key = f"{e.name}{shapes}"[:90]
            acc[key] = acc.get(key, 0.0) + k.duration / per
    return dict(sorted(acc.items(), key=lambda kv: -kv[1])[:n])


def q(x) -> dict:
    """Median, p99 and count of a set of times in ms."""
    return {"median_ms": float(np.median(x)),
            "p99_ms": float(np.percentile(x, 99)), "n": int(len(x))}


def profile_summary(ks, per: float, top_n: int = 8) -> dict:
    """Device µs per ``per`` of the ``top_n`` largest kernels by name."""
    top: dict = {}
    for kname, us in ks:
        top[kname[:60]] = top.get(kname[:60], 0.0) + us / per
    return dict(sorted(top.items(), key=lambda kv: -kv[1])[:top_n])


def kernel_device_ms(fn, pattern: str, iters: int = 50, by_kernel=None):
    """Device time (ms) per call of ``fn`` spent in the kernels named like
    ``pattern``, over ``iters`` calls, from the profiler; None if it saw
    none. ``by_kernel``, a dict, receives the µs per call of each such
    kernel by name."""
    def run():
        for _ in range(iters):
            fn()
    times = [(name, us) for name, us in device_kernels(run)
             if pattern in name]
    if by_kernel is not None:
        for name, us in times:
            key = re.split(r"[(<]", name.replace(
                "(anonymous namespace)::", "").replace("void ", ""))[0]
            by_kernel[key] = by_kernel.get(key, 0.0) + us / iters
    return (float(np.sum([us for _, us in times])) / 1e3 / iters
            if times else None)


def bound(nbytes: float, ops: float, rate: float = PEAK_FP32_PER_S
          ) -> tuple[float, str]:
    """(least time in ms, what binds it) at the card's memory rate and
    ``rate`` operations per second."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def voiced_audio(seconds: float, seed: int, sr: int = SR):
    """Harmonic pulse train with formants: stretches at 85 Hz (below the
    512-sample frame's cycle-pair limit), 200 Hz, and a 120-250 Hz glide,
    with short pauses and a little noise; the 3.5 s pattern repeats,
    shifted by 0.5 s per seed."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    tt = (t + 0.5 * (seed - 1)) % 3.5
    f0 = np.where(tt < 1.0, 85.0, np.where(tt < 2.0, 200.0,
                                           120.0 + 130.0 * (tt - 2.0) / 1.5))
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


def lane_audio(lanes: int, steps: int, shift: int = SERVE_SHIFT
               ) -> np.ndarray:
    """(lanes, steps*HOP) float32: one voiced pattern, lane ``l`` starting
    ``l * shift`` samples (0.25 s) into it."""
    n = steps * HOP
    base = voiced_audio(((lanes - 1) * shift + n) / SR, seed=1)
    return np.stack([base[i * shift: i * shift + n] for i in range(lanes)])


@contextlib.contextmanager
def recording_kernels(store: dict, tag: str):
    """Every kernel wrapper, recording the last arguments each launch
    shape was called with under ``(name, tag, shape)``; launches and
    counts as usual."""
    from koemorph_tpu_torch.ops import cuda as ck
    real = {name: getattr(ck, name)
            for name in ("cycle_dsum", "dk_roots", "logmel")}

    def wrap(name, key_fn):
        def record(*args, **kw):
            store[(name, tag, key_fn(*args, **kw))] = (args, kw)
            return real[name](*args, **kw)
        return record

    ck.cycle_dsum = wrap("cycle_dsum", lambda frames, start, *a, **kw: (
        start.numel(), frames.shape[-1]))
    ck.dk_roots = wrap("dk_roots", lambda a, **kw: a.numel() // a.shape[-1])
    ck.logmel = wrap("logmel", lambda frames, **kw: frames.numel()
                     // frames.shape[-1])
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ck, name, fn)


@contextlib.contextmanager
def plain_forms():
    """Every kernel's caller switched to the kernel's plain PyTorch form."""
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import frontend
    saved = (f0_ops.cycle_dsum, eg.poly_roots, frontend.frames_to_logmel)
    f0_ops.cycle_dsum = f0_ops.cycle_dsum_plain
    eg.poly_roots = eg.poly_roots_plain
    frontend.frames_to_logmel = frontend.frames_to_logmel_plain
    try:
        yield
    finally:
        f0_ops.cycle_dsum, eg.poly_roots, frontend.frames_to_logmel = saved


def k1_cases(case: str, rows: int, half_lag: int, rng, tau_max: int = 291):
    """(start, tau, off) numpy rows for the boundary sets: cycle bounds on
    integer samples, many cycles (tau 8), tau_max, zero phase, and
    non-finite or negative periods and phases (nothing selected)."""
    pick = rng.integers(32, tau_max, size=rows)
    start = np.clip(pick - half_lag, 0, tau_max + half_lag).astype(np.int32)
    start[:3] = [0, tau_max + half_lag, 1]
    tau = (pick + rng.uniform(-0.5, 0.5, rows)).astype(np.float32)
    off = (rng.uniform(0, 0.5, rows) * tau).astype(np.float32)
    if case == "integer_bounds":
        tau[::2] = rng.integers(8, tau_max + 1, size=tau[::2].shape)
        off[::2] = rng.integers(0, 40, size=off[::2].shape)
        tau[1::2] = rng.integers(16, 2 * tau_max, size=tau[1::2].shape) + 0.5
        off[1::2] = 0.5
    elif case == "tau8":
        tau[:] = 8.0
        tau[1::2] += rng.uniform(0, 0.5, tau[1::2].shape).astype(np.float32)
        off = rng.uniform(0, 8, rows).astype(np.float32)
    elif case == "tau_max":
        tau[:] = tau_max
        tau[1::2] += 0.5
        start[:] = tau_max - half_lag
    elif case == "off0":
        off[:] = 0.0
    elif case == "nonfinite":
        tau[0::5], off[1::5] = np.nan, np.nan
        tau[2::5], off[3::5] = np.inf, -np.inf
        tau[4::10] = -tau[4::10]
    return start, tau, off


def k1_bytes(frames, rows: int, n_out: int) -> float:
    """Bytes ``cycle_dsum`` must move: the distinct samples its frame view
    covers, read once, the per-row start, tau and off, the output."""
    from koemorph_tpu_torch.ops import cuda as ck
    lay = ck.frame_layout(frames)
    n = frames.shape[-1]
    per_batch = ((lay.frames - 1) * lay.frame_stride + n
                 if lay.frame_stride <= n else lay.frames * n)
    return 4.0 * lay.batches * per_batch + rows * (4.0 * n_out + 12)


def hdr_frames(t: int, seed: int = 11) -> np.ndarray:
    """(t, 1024) frames of a near-full-scale tone (0.95, a different
    frequency and phase per frame) plus white noise 90 dB below the
    tone's power."""
    rng = np.random.default_rng(seed)
    n = np.arange(1024)
    f0 = 200.0 + (7791.0 - 200.0) * rng.random(t)
    ph = 2 * np.pi * rng.random(t)
    tone = 0.95 * np.sin(2 * np.pi * f0[:, None] * n / SR + ph[:, None])
    sigma = 0.95 / np.sqrt(2.0) * 10.0 ** (-90.0 / 20.0)
    return (tone + sigma * rng.standard_normal((t, 1024))).astype(np.float32)


def main() -> int:  # noqa: C901
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from koemorph_tpu_torch.data.wav import write_wav
    from koemorph_tpu_torch.models import dual_stream_model as dm
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import frontend
    from koemorph_tpu_torch.ops.mel import mel_filterbank
    from koemorph_tpu_torch.ops.stft import autocorr_matmul, dft_matrices
    from koemorph_tpu_torch.ops.window import frame_signal, hann_window
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    from koemorph_tpu_torch.runtime import MultiStreamInference
    from koemorph_tpu_torch.runtime.engine import build_streaming_model
    from koemorph_tpu_torch.runtime.streaming import (StreamingConfig,
                                                      StreamingInference)

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
    spills = [ln for ln in ck.BUILD_LOGS.get("cycle_dsum", "").splitlines()
              if "spill" in ln]
    check(bool(spills) and all("0 bytes spill stores, 0 bytes spill loads"
                               in ln for ln in spills),
          f"cycle_dsum spills registers: {spills}")

    # the decode's audio, used by several phases
    audio_b = np.stack([voiced_audio(DECODE_LEN / SR, seed=s)
                        for s in range(1, DECODE_B + 1)])
    check(audio_b.shape == (DECODE_B, DECODE_LEN), "decode audio shape")
    audio_dev = torch.from_numpy(audio_b).to(dev)
    span = DECODE_LEN // HOP - 256
    n_out = span // DECODE_STRIDE + 1                           # 65
    t_global = DECODE_B * (DECODE_LEN // HOP + 1)               # 4,104
    t_edges = DECODE_B * n_out * 2                              # 1,040
    lld_rows = DECODE_B * (1 + (DECODE_LEN - 512) // 160)       # 13,624
    # the served sessions' audio (phase 8), and their audio rings as the
    # server holds them after it (phase 5): the newest frame of each lane
    # is a row of a (64, 329,927) tensor, read in place
    lanes_np = lane_audio(SERVE_S, SERVE_STEPS)
    ring_len = StreamingConfig().emotion_ring_len
    rings = torch.zeros((SERVE_S, ring_len), device=dev)
    rings[:, -lanes_np.shape[1]:] = torch.from_numpy(lanes_np).to(dev)
    ring_off = ring_len - 1024 - (-512) % HOP

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
                 f"K8/L17/n512 x{lld_rows}": (lld_rows, 512, 8, 8),
                 f"K5/L33/n1024 x{lld_rows}": (lld_rows, 1024, 5, 16)}
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
        again = ck.cycle_dsum(*args, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, again))
        emit({"phase": "cycle_dsum", "shape": label, "rows": rows,
              "max_abs_err": float(err.max()),
              "max_ref": float(want.abs().max()), "rtol": K1_RTOL,
              "atol": K1_ATOL, "ok": ok, "two_launches_equal": same})
        check(ok, f"cycle_dsum kernel disagrees with plain at {label}")
        check(same, f"two cycle_dsum launches differ at {label}")

    def k1_check(label, frames, start, tau, off, kw):
        got = ck.cycle_dsum(frames, start, tau, off, **kw)
        want = f0_ops.cycle_dsum_plain(frames, start, tau, off, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= K1_ATOL + K1_RTOL * want.abs()).all()
                  and torch.equal(got.isnan(), want.isnan()))
        emit({"phase": "cycle_dsum", "shape": label,
              "frames": list(frames.shape), "strides": list(frames.stride()),
              "max_abs_err": float(err.max()),
              "max_ref": float(want.abs().max()),
              "rows_all_zero": int((want.flatten(-2).abs().amax(-1) == 0)
                                   .sum()),
              "rtol": K1_RTOL, "atol": K1_ATOL, "ok": ok})
        check(ok, f"cycle_dsum kernel disagrees with plain at {label}")

    # the same kind of frames as the paths hold them: the decode's unfold
    # of each utterance (8, 1703, n), and the stream's 30 frames of a ring
    # slice that starts off a 16-byte boundary; read in place
    lld_audio = torch.cat([torch.zeros((DECODE_B, 512), device=dev),
                           audio_dev], -1)
    for n, K, H in ((512, 8, 8), (1024, 5, 16)):
        kw = dict(n_cycles=K, half_lag=H)
        views = {
            f"decode view n{n}": frame_signal(
                audio_dev if n == 512 else lld_audio, n, 160, center=False),
            f"stream view n{n}": frame_signal(
                audio_dev[1, 7:7 + 29 * 160 + n], n, 160, center=False)}
        for label, frames_v in views.items():
            check(not frames_v.is_contiguous(), f"{label} is a view")
            lead = tuple(frames_v.shape[:-1])
            st, tau, off = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                            for v in k1_cases("random", int(np.prod(lead)),
                                              H, rng))
            k1_check(label, frames_v, st.reshape(lead), tau.reshape(lead),
                     off.reshape(lead), kw)
        # cycle bounds on integer samples, many cycles, tau_max, zero
        # phase, non-finite and negative periods and phases
        for case in ("integer_bounds", "tau8", "tau_max", "off0",
                     "nonfinite"):
            frames_c = torch.from_numpy(
                rng.standard_normal((200, n)).astype(np.float32) * 0.3).to(dev)
            st, tau, off = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                            for v in k1_cases(case, 200, H, rng))
            k1_check(f"{case} n{n}", frames_c, st, tau, off, kw)

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
    for rows in (30, lld_rows):
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

    # diverging rows (one huge or non-finite coefficient), 3 per warp
    # between LPC rows: a root thrown far out makes the next products
    # inf - inf; both forms step on a NaN product, so every root of such a
    # row turns NaN, and the LPC rows beside them are untouched
    wild = [(10, 1e38), (1, 1e30), (5, 1e20), (10, 1e12), (10, -3e37),
            (3, float("inf")), (4, float("nan"))]
    a = lpc_polys(3 * len(wild))
    for r, (k, v) in enumerate(wild):
        a[3 * r + 1] = 0.0
        a[3 * r + 1, 0], a[3 * r + 1, k] = 1.0, v
    got = ck.dk_roots(a)
    want = eg.poly_roots_plain(a)
    wild_rows = torch.arange(len(wild), device=dev) * 3 + 1
    tame = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
    tame[wild_rows] = False
    exact = torch.linalg.eigvals(companion(a[tame].double()))
    conv = hausdorff(want[tame].to(torch.complex128), exact) < DK_MAX
    h = hausdorff(got[tame], want[tame])[conv]
    ok = bool(torch.equal(got.isnan(), want.isnan())
              and want[wild_rows].isnan().all()
              and torch.isfinite(got[tame]).all() and h.max() < DK_MAX)
    emit({"phase": "dk_roots_diverging", "rows": int(a.shape[0]),
          "diverging_rows": len(wild),
          "nan_roots_kernel": int(got.isnan().sum()),
          "nan_roots_plain": int(want.isnan().sum()),
          "hausdorff_max_other_rows": float(h.max()), "ok": ok})
    check(ok, "dk_roots kernel and plain differ on diverging rows")

    # ---- 5. logmel: kernel vs plain ----
    # the frames the decode gives the kernel: its global STFT frames, and
    # the mirrored edge frames of its windows (one per end at 30 fps)
    global_frames = frame_signal(audio_dev, 1024, HOP).reshape(-1, 1024)
    starts = np.arange(n_out) * DECODE_STRIDE * HOP
    offs = torch.from_numpy(dm._edge_offsets_np(1024, HOP, 256 * HOP)).to(
        dev)
    edge_frames = audio_dev[:, torch.from_numpy(starts).to(dev)[:, None, None]
                            + offs].reshape(-1, 1024)
    loud = np.sign(np.sin(2 * np.pi * 440 * np.arange(1024) / SR)) * 0.999
    k3_inputs = {
        "T=1": audio_dev[0, 40000:41024][None].contiguous(),
        # frames that start off a 16-byte boundary (as the stream's do)
        "T=1 offset 1": audio_dev[0, 40001:41025][None],
        "T=16 offset 3": audio_dev[0, 3:3 + 16 * 1024].reshape(16, 1024),
        f"T={SERVE_S} ring rows": rings[:, ring_off:ring_off + 1024],
        f"T={edge_frames.shape[0]}": edge_frames.contiguous(),
        f"T={global_frames.shape[0]}": global_frames.contiguous(),
        "silence T=1": torch.zeros((1, 1024), device=dev),
        "silence T=16": torch.zeros((16, 1024), device=dev),
        "loud T=3": torch.from_numpy(np.tile(loud, (3, 1)).astype(
            np.float32)).to(dev),
        "loud T=40": torch.from_numpy(
            np.tile(loud, (40, 1)).astype(np.float32)
            * np.linspace(0.01, 1.0, 40, dtype=np.float32)[:, None]).to(dev),
    }
    check(global_frames.shape[0] == t_global
          and edge_frames.shape[0] == t_edges, "decode's logmel shapes")
    k3 = {}
    for label, x in k3_inputs.items():
        got = ck.logmel(x)
        want = frontend.frames_to_logmel_plain(x)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= K3_ATOL + K3_RTOL * want.abs()).all())
        if label.startswith("silence"):
            ok = ok and bool((got == -100.0).all())
        k3[label] = dict(x=x, max_abs_err=float(err.max()))
        emit({"phase": "logmel", "shape": label, "T": x.shape[0],
              "max_abs_err_db": float(err.max()),
              "min_db": float(want.min()), "max_db": float(want.max()),
              "rtol": K3_RTOL, "atol_db": K3_ATOL, "ok": ok})
        check(ok, f"logmel kernel disagrees with plain at {label}")
        if label in ("T=1", f"T={SERVE_S} ring rows", f"T={t_edges}",
                     f"T={t_global}"):
            again = ck.logmel(x)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, again))
            emit({"phase": "logmel_bitwise", "shape": label, "equal": same})
            check(same, f"two logmel launches differ at {label}")

    # high dynamic range: errors against float64 on the card, mel bins
    # within 80 dB of each frame's maximum; the kernel's at most 2x the
    # plain form's, or K3_HDR_FLOOR dB
    wc64, ws64, fb64 = (c.double() for c in frontend.logmel_constants(
        1024, SR, 80, 80.0, 8000.0, dev))
    for t_hdr in (1, 256):
        x = torch.from_numpy(hdr_frames(t_hdr)).to(dev)
        x64 = x.double()
        ref = 10.0 * torch.log10(torch.clamp_min(
            ((x64 @ wc64.T) ** 2 + (x64 @ ws64.T) ** 2) @ fb64, 1e-10))
        keep = ref >= ref.amax(1, keepdim=True) - 80.0
        got = ck.logmel(x).double()
        plain = frontend.frames_to_logmel_plain(x).double()
        e_k = float((got - ref).abs()[keep].max())
        e_p = float((plain - ref).abs()[keep].max())
        ok = e_k <= max(2.0 * e_p, K3_HDR_FLOOR)
        emit({"phase": "logmel_hdr", "T": t_hdr,
              "bins_within_80db": int(keep.sum()),
              "kernel_max_err_db": e_k, "plain_max_err_db": e_p,
              "kernel_median_err_db": float((got - ref).abs()[keep].median()),
              "plain_median_err_db": float((plain - ref).abs()[keep].median()),
              "rule": "kernel <= max(2 x plain, 1e-3 dB)", "ok": ok})
        check(ok, f"logmel high-dynamic-range error at T={t_hdr}")

    # ---- 6. the flagship stream through the user entry points ----
    # graphed, the card's default: warmup() captures the step's graphs
    # (the wrappers count the warm-up runs and the captures); the replays
    # are counted from the profiler's kernel names
    model, cfg = build_streaming_model(seed=0)
    audio = voiced_audio(3.5, seed=1)
    profiled(lambda: None)       # the profiler's first use starts its tracer
    ck.reset_launch_counts()
    engine = StreamingInference(model, cfg)
    engine.warmup()
    check(engine.step_graphs.enabled and len(engine.step_graphs) == 4,
          "the stream did not capture its four graphs")
    box = []
    seen, want = replayed_launches(
        engine.step_graphs, lambda: box.append(engine.process_audio(audio)))
    launches = dict(ck.LAUNCHES)
    stream_shapes = dict(ck.SHAPE_LAUNCHES)
    bs = np.stack(box[0])
    n_frames = len(bs)
    n_refresh = -(-n_frames // cfg.emotion_update_frames)
    emit({"phase": "stream", "frames": n_frames, "refreshes": n_refresh,
          "shape": list(bs.shape), "finite": bool(np.isfinite(bs).all()),
          "min": float(bs.min()), "max": float(bs.max()),
          "launches": launches,
          "launches_by_shape": {f"{k[0]}{list(k[1])}": v
                                for k, v in stream_shapes.items()},
          "replayed_launches_profiled": seen,
          "replayed_launches_recorded": want,
          "graphs": graph_info(engine.step_graphs),
          "performance_stats": engine.performance_stats()})
    check(n_frames >= 90 and bs.shape[1:] == (52,), "stream shape")
    check(bool(np.isfinite(bs).all()), "stream has non-finite values")
    check(bs.min() >= 0.0 and bs.max() <= 1.0, "blendshapes outside [0, 1]")
    for key in engine.step_graphs.keys():          # (refresh, parity)
        rec = dict(engine.step_graphs.launches(key))
        check(rec == refresh_record(1, 30, key[0]),
              f"the stream's graph {key} recorded {rec}")
    check(seen == want == {"cycle_dsum": 2 * n_refresh,
                           "dk_roots": n_refresh, "logmel": n_frames},
          f"the stream's replays ran {seen}, their captures recorded "
          f"{want}, for {n_frames} frames and {n_refresh} refreshes")

    # the same stream eager, the reference the graphs are held to bit for
    # bit; it records the arguments each kernel was called with
    path_rec: dict = {}
    eager_engine = StreamingInference(model, cfg, graphs=False)
    eager_engine.warmup()
    with recording_kernels(path_rec, "stream"):
        eager_bs = np.stack(eager_engine.process_audio(audio))
    emit({"phase": "stream_graphed_vs_eager", "frames": n_frames,
          "bitwise_equal": bool(np.array_equal(bs, eager_bs)),
          "max_abs_diff": float(np.abs(bs - eager_bs).max())})
    check(np.array_equal(bs, eager_bs), "graphed stream != eager stream")

    # the same stream with the plain forms on the card
    with plain_forms():
        plain_engine = StreamingInference(model, cfg, graphs=False)
        before = dict(ck.LAUNCHES)
        plain = np.stack(plain_engine.process_audio(audio))
        check(dict(ck.LAUNCHES) == before, "the plain stream launched a "
              "kernel")
    d_plain = float(np.abs(plain - bs).max())
    emit({"phase": "stream_plain", "max_abs_diff_blendshapes": d_plain,
          "bound": STREAM_PLAIN_MAX})
    check(d_plain <= STREAM_PLAIN_MAX, "kernel stream != plain stream")

    # ---- 7. the flagship batched decode ----
    def seq_model(seed=0, **kw):
        m = dm.SequentialDualStreamModel(d_model=256, num_heads=8, **kw)
        m.init_random(torch.Generator().manual_seed(seed))
        return m

    dec_model = seq_model(mel_sequence_length=256, target_fps=30,
                          stride_frames=DECODE_STRIDE, window_edge="reflect")
    ck.reset_launch_counts()
    decoder = BatchedSequentialDecoder(dec_model)
    decoder(audio_dev)                  # the first call captures its graph
    box = []
    seen, want = replayed_launches(
        decoder.step_graphs, lambda: box.append(decoder(audio_dev)))
    dec_launches = dict(ck.LAUNCHES)
    dec_shapes = dict(ck.SHAPE_LAUNCHES)
    out_np = box[0].cpu().numpy()
    emit({"phase": "decode", "card": card, "shape": list(out_np.shape),
          "finite": bool(np.isfinite(out_np).all()),
          "min": float(out_np.min()), "max": float(out_np.max()),
          "launches": dec_launches,
          "launches_by_shape": {f"{k[0]}{list(k[1])}": v
                                for k, v in dec_shapes.items()},
          "replayed_launches_profiled": seen,
          "replayed_launches_recorded": want,
          "graphs": graph_info(decoder.step_graphs)})
    check(len(decoder.step_graphs) == 1, "the decode was not one graph")
    check(seen == want == {"cycle_dsum": 2, "dk_roots": 1, "logmel": 2},
          f"the decode's replay ran {seen}, its capture recorded {want}")
    eager_decoder = BatchedSequentialDecoder(decoder.model, graphs=False)
    with recording_kernels(path_rec, "decode"):
        eager_np = eager_decoder(audio_dev).cpu().numpy()
    emit({"phase": "decode_graphed_vs_eager",
          "bitwise_equal": bool(np.array_equal(out_np, eager_np)),
          "max_abs_diff": float(np.abs(out_np - eager_np).max())})
    check(np.array_equal(out_np, eager_np), "graphed decode != eager")
    check(out_np.shape == (DECODE_B, n_out, 52), "decode shape")
    check(bool(np.isfinite(out_np).all()), "decode has non-finite values")
    check(out_np.min() >= 0.0 and out_np.max() <= 1.0,
          "decode outside [0, 1]")
    for key in (("logmel", (t_global,)), ("logmel", (t_edges,)),
                ("cycle_dsum", (lld_rows, 8, 17, 512)),
                ("cycle_dsum", (lld_rows, 5, 33, 1024)),
                ("dk_roots", (lld_rows,))):
        check(dec_shapes.get(key, 0) > 0, f"decode did not launch {key}")

    with plain_forms(), torch.inference_mode():
        before = dict(ck.LAUNCHES)
        plain_out = eager_decoder(audio_dev).cpu().numpy()
        emo_plain = decoder.model.emotion_raw(audio_dev)
        check(dict(ck.LAUNCHES) == before, "the plain decode launched a "
              "kernel")
    with torch.inference_mode():
        emo = decoder.model.emotion_raw(audio_dev)
    rel = ((emo - emo_plain).abs() / (emo_plain.abs() + 1e-4)).cpu().numpy()
    worst = np.unravel_index(np.argmax(rel), rel.shape)
    d_dec = float(np.abs(plain_out - out_np).max())
    emit({"phase": "decode_plain", "max_abs_diff_blendshapes": d_dec,
          "bound": DECODE_PLAIN_MAX,
          "emotion_max_rel_diff": float(rel.max()),
          "emotion_worst": {"utterance": int(worst[0]),
                            "offset_window": int(worst[1] // 88),
                            "functional": int(worst[1] % 88)}})
    check(d_dec <= DECODE_PLAIN_MAX, "kernel decode != plain decode")

    strides = [4, 8] * (DECODE_B // 2)
    sched, mask = decoder.decode_scheduled(audio_dev, strides)
    sched = sched.cpu().numpy()
    d_sched = float(np.abs(sched[0::2] - out_np[0::2]).max())
    emit({"phase": "decode_scheduled", "strides": strides,
          "windows": mask.sum(1).tolist(), "shape": list(sched.shape),
          "max_abs_diff_stride4_rows_vs_decode": d_sched})
    check(mask.sum(1).tolist() == [n_out, span // 8 + 1] * (DECODE_B // 2),
          "decode_scheduled mask")
    check(sched.shape == (DECODE_B, n_out, 52)
          and bool(np.isfinite(sched).all()), "decode_scheduled output")
    check(d_sched <= 1e-5, "scheduled stride-4 rows != the decode's")

    dec60 = BatchedSequentialDecoder(seq_model(
        mel_sequence_length=512, target_fps=60, stride_frames=4))
    out60 = dec60(audio_dev[:1]).cpu().numpy()
    n60 = (DECODE_LEN // 266 - 512) // 4 + 1
    (key60,) = dec60.step_graphs.keys()
    rec60 = dict(dec60.step_graphs.launches(key60))
    emit({"phase": "decode_60fps", "shape": list(out60.shape),
          "finite": bool(np.isfinite(out60).all()),
          "recorded_launches_by_shape": {f"{k[0]}{list(k[1])}": v
                                         for k, v in rec60.items()}})
    check(out60.shape == (1, n60, 52) and bool(np.isfinite(out60).all())
          and out60.min() >= 0.0 and out60.max() <= 1.0, "60 fps decode")
    check(rec60.get(("logmel", (n60 * 2 * 2,)), 0) == 1,
          "60 fps decode: two edge frames per window end")

    reflect_model = seq_model(mel_sequence_length=256, target_fps=30)
    exact_model = seq_model(mel_sequence_length=256, target_fps=30,
                            exact_window_stft=True)
    exact_model.load_state_dict(reflect_model.state_dict())
    a9 = torch.from_numpy(voiced_audio(9.0, seed=9)[None]).to(dev)
    r9 = BatchedSequentialDecoder(reflect_model)(a9).cpu().numpy()
    e9 = BatchedSequentialDecoder(exact_model)(a9).cpu().numpy()
    d_exact = float(np.abs(r9 - e9).max())
    emit({"phase": "decode_exact", "shape": list(r9.shape),
          "max_abs_diff_exact_vs_reflect": d_exact,
          "bound": EXACT_EDGE_MAX})
    check(r9.shape == e9.shape == (1, 15, 52), "exact decode shape")
    check(d_exact <= EXACT_EDGE_MAX, "exact_window_stft != reflect splice")

    # the first call of a length the decoder has not seen (graphed: a
    # warm-up run, a capture and a replay) against eager's first call of
    # another unseen length, and the second calls: host wall ms to a
    # synchronization
    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    new_len = {"graphed": (decoder, DECODE_LEN - 1100),
               "eager": (eager_decoder, DECODE_LEN - 3300)}
    first_calls = {}
    for tag, (dec, n_len) in new_len.items():
        x = audio_dev[:, :n_len].contiguous()
        capture_s = dec.step_graphs.capture_s
        first_calls[tag] = {
            "samples": n_len, "first_ms": wall_ms(lambda: dec(x)),
            "second_ms": wall_ms(lambda: dec(x)),
            "capture_s": dec.step_graphs.capture_s - capture_s}
    emit({"phase": "decode_new_length", "card": card, "batch": DECODE_B,
          **first_calls, "graphs_kept": len(decoder.step_graphs),
          "max_graphs": decoder.max_graphs})
    check(len(decoder.step_graphs) == 2, "the new length's graph")

    # a graph holds the cached constants it reads: eager decodes of 40
    # other lengths push every shape-keyed entry the decode's and the
    # stream's graphs read (masks, index grids) out of its cache; both
    # graphs then replay bitwise as before
    caches = {"offset_masks": eg.offset_masks,
              "index_grid": dm._index_grid}
    misses = {k: f.cache_info().misses for k, f in caches.items()}
    with torch.inference_mode():
        for k in range(1, 41):
            eager_decoder(audio_dev[:1, :DECODE_LEN - k * 2200])
    misses = {k: f.cache_info().misses - misses[k]
              for k, f in caches.items()}
    dec_again = decoder(audio_dev).cpu().numpy()
    engine.reset()
    stream_again = np.stack(engine.process_audio(audio))
    emit({"phase": "graphs_hold_constants", "other_lengths": 40,
          "cache_misses": misses,
          "cache_sizes": {k: f.cache_info().maxsize
                          for k, f in caches.items()},
          "decode_bitwise_equal": bool(np.array_equal(dec_again, out_np)),
          "stream_bitwise_equal": bool(np.array_equal(stream_again, bs))})
    check(all(misses[k] > f.cache_info().maxsize
              for k, f in caches.items()),
          f"the other lengths did not cycle the caches: {misses}")
    check(np.array_equal(dec_again, out_np),
          "the decode's graph changed after its constants left the cache")
    check(np.array_equal(stream_again, bs),
          "the stream's graph changed after its constants left the cache")

    # what the stream and the decode passed cycle_dsum: frame views (the
    # frames are not copied), against the plain form
    # the last cycle_dsum call of each frame length, as (tag, n)
    k1_args = {(tag, key[1]): (*args, kw)
               for (name, tag, key), (args, kw) in path_rec.items()
               if name == "cycle_dsum"}
    check(sorted(k1_args) == [("decode", 512), ("decode", 1024),
                              ("stream", 512), ("stream", 1024)],
          f"cycle_dsum calls recorded: {sorted(k1_args)}")
    with torch.inference_mode():
        for (tag, n), (frames_a, st, tau, off, kw) in sorted(k1_args.items()):
            check(not frames_a.is_contiguous(),
                  f"the {tag} passed cycle_dsum copied frames")
            k1_check(f"{tag} args n{n}", frames_a, st, tau, off, kw)

    # ---- 8. multi-session serving ----
    k_ref = cfg.emotion_update_frames
    hop = cfg.hop_length
    block_rows = cfg.lld_block_rows                             # 30
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def serve_steps(srv, audio, first=0, steps=SERVE_STEPS):
        """(steps, S, 52) on the card: one ``step`` per hop of ``audio``
        from hop ``first``."""
        return torch.stack([srv.step(audio[:, (first + i) * hop:
                                           (first + i + 1) * hop])
                            for i in range(steps)])

    def engine_frames(lane, clock, first=0):
        eng = StreamingInference(model, cfg)
        eng.state.frame_count = clock
        return np.stack(eng.process_audio(lanes_np[lane, first * hop:]))

    serve_rec: dict = {}
    serve_out, serve_shapes, phases = {}, {}, {}
    for g in (1, 8):
        ck.reset_launch_counts()
        srv = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=g)
        srv.warmup()
        box = []
        seen, want = replayed_launches(
            srv.step_graphs, lambda: box.append(serve_steps(srv, lanes_np)))
        launches, shapes = dict(ck.LAUNCHES), dict(ck.SHAPE_LAUNCHES)
        out_g = box[0]
        serve_out[g], serve_shapes[g] = out_g.cpu().numpy(), shapes
        phases[g] = srv.phases
        # the eager twin, the reference the graphs are held to bit for
        # bit; it records the arguments each kernel was called with
        ref_srv = MultiStreamInference(model, cfg, SERVE_S,
                                       refresh_cohorts=g, graphs=False)
        with recording_kernels(serve_rec, f"G={g}"):
            eager_g = serve_steps(ref_srv, lanes_np).cpu().numpy()
        rows = SERVE_S // g * block_rows
        refreshing = sum(len(range(-p % k_ref, SERVE_STEPS, k_ref))
                         for p in srv.phases)
        o = serve_out[g]
        emit({"phase": "multistream", "sessions": SERVE_S,
              "refresh_cohorts": g, "phases": list(srv.phases),
              "steps": SERVE_STEPS, "refreshing_cohort_steps": refreshing,
              "refresh_rows": rows, "shape": list(o.shape),
              "finite": bool(np.isfinite(o).all()), "min": float(o.min()),
              "max": float(o.max()), "launches": launches,
              "launches_by_shape": {f"{kk[0]}{list(kk[1])}": v
                                    for kk, v in shapes.items()},
              "replayed_launches_profiled": seen,
              "replayed_launches_recorded": want,
              "graphs": graph_info(srv.step_graphs),
              "graphed_bitwise_equal_eager": bool(np.array_equal(o, eager_g)),
              "max_abs_diff_vs_eager": float(np.abs(o - eager_g).max()),
              "performance_stats": srv.performance_stats()})
        check(len(srv.step_graphs) == 2 * (g + 1),
              f"G={g}: {len(srv.step_graphs)} graphs, not 2(G+1)")
        check(o.shape == (SERVE_STEPS, SERVE_S, 52)
              and bool(np.isfinite(o).all()), f"G={g}: served output")
        check(o.min() >= 0.0 and o.max() <= 1.0,
              f"G={g}: blendshapes outside [0, 1]")
        for key in srv.step_graphs.keys():     # (due, parity, dtype)
            rec = dict(srv.step_graphs.launches(key))
            check(rec == refresh_record(SERVE_S, rows, bool(key[0])),
                  f"G={g}: the graph {key} recorded {rec}")
        check(seen == want == {"cycle_dsum": 2 * refreshing,
                               "dk_roots": refreshing,
                               "logmel": SERVE_STEPS},
              f"G={g}: the replays ran {seen}, their captures recorded "
              f"{want}, for {SERVE_STEPS} steps and {refreshing} "
              f"refreshing cohort-steps of {rows} rows")
        check(all(launches[k] > 0 for k in KERNEL_PATTERNS),
              f"G={g}: a kernel was not launched: {launches}")
        check(np.array_equal(o, eager_g), f"G={g}: graphed server != eager")
        del srv, ref_srv, out_g

    # lanes of four cohorts against dedicated engines on the card
    lane_ids = (0, 1, 5, 7)
    d_lanes = {}
    for lane in lane_ids:
        want = engine_frames(lane, phases[8][lane % 8])
        d_lanes[lane] = float(np.abs(serve_out[8][:, lane] - want).max())
    emit({"phase": "multistream_lanes", "refresh_cohorts": 8,
          "lanes": list(lane_ids),
          "cohort_phase": [phases[8][i % 8] for i in lane_ids],
          "max_abs_diff_vs_engine": d_lanes, "bound": SERVE_LANE_MAX})
    check(max(d_lanes.values()) <= SERVE_LANE_MAX,
          f"served lanes differ from dedicated engines: {d_lanes}")

    # both clock settings with the plain forms
    d_plain = {}
    with plain_forms():
        before = dict(ck.LAUNCHES)
        for g in (1, 8):
            srv = MultiStreamInference(model, cfg, SERVE_S,
                                       refresh_cohorts=g, graphs=False)
            plain_g = serve_steps(srv, lanes_np).cpu().numpy()
            d_plain[g] = float(np.abs(plain_g - serve_out[g]).max())
        check(dict(ck.LAUNCHES) == before, "the plain server launched a "
              "kernel")
        del srv
    emit({"phase": "multistream_plain", "max_abs_diff_blendshapes":
          {f"G={g}": d for g, d in d_plain.items()},
          "bound": SERVE_PLAIN_MAX})
    check(max(d_plain.values()) <= SERVE_PLAIN_MAX,
          f"kernel server != plain server: {d_plain}")

    # a lane reset mid-run: a fresh session whose clock is its cohort's;
    # graphed (captured at the first step) and eager
    half, reset_lane = SERVE_STEPS * 3 // 7, 5              # step 45
    out_rs = {}
    for graphed in (True, False):
        srv = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=8,
                                   graphs=graphed)
        first = serve_steps(srv, lanes_np, steps=half)
        srv.reset_sessions([reset_lane])
        second = serve_steps(srv, lanes_np, first=half,
                             steps=SERVE_STEPS - half)
        out_rs[graphed] = torch.cat([first, second]).cpu().numpy()
        clocks_after = srv.clocks
        del srv, first, second
    out_r = out_rs[True]
    fresh = engine_frames(reset_lane, phases[8][reset_lane % 8] + half,
                          first=half)
    others = [i for i in range(SERVE_S) if i != reset_lane]
    d_fresh = float(np.abs(out_r[half:, reset_lane] - fresh).max())
    d_others = float(np.abs(out_r[:, others] - serve_out[8][:, others]).max())
    d_moved = float(np.abs(out_r[half:, reset_lane]
                           - serve_out[8][half:, reset_lane]).max())
    emit({"phase": "multistream_reset", "lane": reset_lane, "at_step": half,
          "clocks_after": clocks_after,
          "max_abs_diff_vs_fresh_engine": d_fresh,
          "max_abs_diff_other_lanes": d_others,
          "reset_lane_moved_by": d_moved, "bound_fresh": SERVE_LANE_MAX,
          "bound_others": SERVE_UNTOUCHED_MAX,
          "graphed_bitwise_equal_eager": bool(np.array_equal(
              out_rs[True], out_rs[False]))})
    check(d_fresh <= SERVE_LANE_MAX, "reset lane != fresh engine")
    check(d_others <= SERVE_UNTOUCHED_MAX, "a reset moved other lanes")
    check(d_moved > 1e-3, "the reset lane did not change")
    check(np.array_equal(out_rs[True], out_rs[False]),
          "graphed server with a reset != eager")

    # int16 PCM on the card: the same bits as its float twin, graphed
    # (int16 graphs captured by warmup) and eager
    n16 = 2 * k_ref + 2
    pcm = np.clip(np.round(lanes_np[:, :n16 * hop] * 32767.0), -32768,
                  32767).astype(np.int16)
    as_float = pcm.astype(np.float32) / 32768.0
    srv_f = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=8)
    srv_i = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=8)
    srv_e = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=8,
                                 graphs=False)
    srv_i.warmup(dtype=torch.int16)
    same16, same_eager = [], []
    for i in range(n16):
        sl = slice(i * hop, (i + 1) * hop)
        got_i = srv_i.step(pcm[:, sl])
        same16.append(bool(torch.equal(srv_f.step(as_float[:, sl]), got_i)))
        same_eager.append(bool(torch.equal(got_i, srv_e.step(pcm[:, sl]))))
    emit({"phase": "multistream_int16", "steps": n16,
          "bitwise_equal_steps": sum(same16),
          "graphed_equal_eager_steps": sum(same_eager),
          "int16_graphs": sum(k[2] == torch.int16
                              for k in srv_i.step_graphs.keys())})
    check(all(same16), "int16 input differs from its float twin")
    check(all(same_eager), "graphed int16 server != eager")
    del srv_f, srv_i, srv_e

    # step times between CUDA events, split by whether a cohort
    # refreshes; kernels and device busy per step from the profiler (for
    # a graph, the kernels its replay ran); graphed and eager; graph
    # count, capture time and peak memory; sustained throughput at 64 and
    # 256 sessions; G = 1's refreshing step at 256 sessions
    serve_times = {}
    profiled(lambda: None)       # the profiler's first use starts its tracer
    for g in (1, 8):
        for graphed in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            srv = MultiStreamInference(model, cfg, SERVE_S,
                                       refresh_cohorts=g, graphs=graphed)
            srv.warmup()
            evs, due = [], []
            for i in range(SERVE_STEPS):
                due.append(bool(srv.due_cohorts()))
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                step_out = srv.step(lanes_np[:, i * hop:(i + 1) * hop])
                e1.record()
                step_out.cpu()
                evs.append((e0, e1))
            torch.cuda.synchronize()
            st = np.asarray([a.elapsed_time(b) for a, b in evs])
            due = np.asarray(due)
            prof_rows = {}
            windows = ((("refresh", True, 1), ("other", False, 8)) if g == 1
                       else (("9 steps", None, 9),))
            for label, want_due, n_steps in windows:
                i0 = SERVE_STEPS
                while want_due is not None and bool(srv.due_cohorts()) \
                        != want_due:
                    srv.step(lanes_np[:, (i0 % SERVE_STEPS) * hop:
                                      (i0 % SERVE_STEPS + 1) * hop])
                    i0 += 1

                def steps_run():
                    for j in range(n_steps):
                        t = (i0 + j) % SERVE_STEPS
                        srv.step(lanes_np[:, t * hop:(t + 1) * hop]).cpu()
                prof = profiled(steps_run)
                wall_ms = prof.wall_s * 1e3 / n_steps
                ks = device_kernels(None, prof)
                prof_rows[label] = {
                    "kernels_per_step": len(ks) / n_steps,
                    "device_busy_ms_per_step":
                        sum(us for _, us in ks) / 1e3 / n_steps,
                    "own_kernels_per_step": own_kernels(ks, n_steps),
                    "copies_per_step": copies(ks, n_steps),
                    "profiled_wall_ms_per_step": wall_ms,
                    "top_kernels_us_per_step": profile_summary(ks, n_steps)}
            serve_times[(g, graphed)] = {
                "refresh_steps": q(st[due]) if due.any() else None,
                "other_steps": q(st[~due]) if (~due).any() else None,
                "profile": prof_rows,
                "graphs": len(srv.step_graphs),
                "capture_s": srv.step_graphs.capture_s,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            del srv
    sustained = {}
    for g in (8, 1):
        for n_s in (SERVE_S, SERVE_BIG):
            for graphed in (True, False):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                srv = MultiStreamInference(model, cfg, n_s,
                                           refresh_cohorts=g, graphs=graphed)
                srv.warmup()
                stats_s = srv.sustained_stats(n_frames=5 * k_ref)
                stats_s["peak_memory_gb"] = (
                    torch.cuda.max_memory_allocated() / 1e9)
                sustained[f"S={n_s} G={g} "
                          f"{'graphed' if graphed else 'eager'}"] = stats_s
                del srv
    big_lanes = lane_audio(SERVE_BIG, 5 * k_ref)
    big_steps = {}
    for graphed in (True, False):
        srv = MultiStreamInference(model, cfg, SERVE_BIG, graphs=graphed)
        srv.warmup()
        evs, due = [], []
        for i in range(5 * k_ref):
            due.append(bool(srv.due_cohorts()))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            step_out = srv.step(big_lanes[:, i * hop:(i + 1) * hop])
            e1.record()
            step_out.cpu()
            evs.append((e0, e1))
        torch.cuda.synchronize()
        st = np.asarray([a.elapsed_time(b) for a, b in evs])
        due = np.asarray(due)
        big_steps["graphed" if graphed else "eager"] = {
            "refresh_steps": q(st[due]), "other_steps": q(st[~due])}
        del srv
    emit({"phase": "multistream_times", "card": card, "sessions": SERVE_S,
          "step_times": {f"G={g} {'graphed' if gr else 'eager'}": v
                         for (g, gr), v in serve_times.items()},
          "sustained_stats": sustained,
          f"G=1 steps at {SERVE_BIG} sessions": big_steps})
    g1 = serve_times[(1, True)]
    check(g1["refresh_steps"]["p99_ms"] < BUDGET_MS,
          f"graphed G=1 refreshing step p99 {g1['refresh_steps']} over "
          f"the {BUDGET_MS} ms budget")
    check(all(v > 0 for v in
              g1["profile"]["refresh"]["own_kernels_per_step"].values()),
          "a kernel is missing from the graphed refreshing step's replay: "
          f"{g1['profile']['refresh']['own_kernels_per_step']}")
    busy_g = g1["profile"]["other"]["device_busy_ms_per_step"]
    busy_e = serve_times[(1, False)]["profile"]["other"][
        "device_busy_ms_per_step"]
    check(busy_g <= 1.05 * busy_e,
          f"a graphed non-refreshing step is busier ({busy_g} ms) than "
          f"the eager one ({busy_e} ms)")

    # the serve entry point, replay mode
    serve_wav = work / "serve.wav"
    write_wav(serve_wav, voiced_audio(2.0, seed=3), SR)
    serve_jsonl = work / "serve.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.serve", "--replay",
         str(serve_wav), "--sessions", "16", "--refresh-cohorts", "8",
         "--output", "file", "--output-file", str(serve_jsonl),
         "--no-realtime", "--max-frames", "30"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"serve CLI failed:\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in serve_jsonl.read_text().splitlines()]
    stats = [json.loads(ln)["performance_stats"]
             for ln in proc.stdout.splitlines() if "performance_stats" in ln]
    emit({"phase": "serve_cli", "rows": len(rows),
          "sessions": sorted({r["session"] for r in rows}),
          "seconds": round(time.perf_counter() - t0, 2),
          "performance_stats": stats[-1] if stats else None})
    check(len(rows) == 30 * 16
          and sorted({r["session"] for r in rows}) == list(range(16))
          and all(len(r["blendshapes"]) == 52 for r in rows),
          "serve CLI rows")
    check(bool(stats) and stats[-1]["ticks"] == 30
          and stats[-1]["frames_sent"] == 480, "serve CLI stats line")

    # the serve entry point, listen mode: session 1 fed over loopback by
    # the feeder, session 0 underruns and is served silence
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        listen_port = probe.getsockname()[1]
    listen_log, listen_jsonl = work / "listen.log", work / "listen.jsonl"
    listen_ticks = 60
    with open(listen_log, "w") as log_fh:
        server_p = subprocess.Popen(
            [sys.executable, "-m", "koemorph_tpu_torch.serve", "--listen",
             "--listen-port", str(listen_port), "--sessions", "2",
             "--output", "file", "--output-file", str(listen_jsonl),
             "--max-frames", str(listen_ticks)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=log_fh, text=True)
        try:
            deadline = time.time() + 300
            while ("loop is live" not in listen_log.read_text()
                   and server_p.poll() is None and time.time() < deadline):
                time.sleep(0.1)
            check(server_p.poll() is None, "listen server exited early:\n"
                  + listen_log.read_text()[-3000:])
            feed = subprocess.run(
                [sys.executable, "-m", "koemorph_tpu_torch.feed_serve",
                 "--port", str(listen_port), "--sessions", "1",
                 "--first-session", "1", "--ticks", str(2 * listen_ticks),
                 str(serve_wav)], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=120)
            listen_out, _ = server_p.communicate(timeout=120)
        finally:
            if server_p.poll() is None:
                server_p.kill()
                server_p.communicate()
    check(feed.returncode == 0, f"feeder failed:\n{feed.stderr[-2000:]}")
    check(server_p.returncode == 0, "listen server failed:\n"
          + listen_log.read_text()[-3000:])
    rows = [json.loads(line)
            for line in listen_jsonl.read_text().splitlines()]
    bs = {sid: np.asarray([r["blendshapes"] for r in rows
                           if r["session"] == sid]) for sid in (0, 1)}
    stats = [json.loads(ln)["performance_stats"]
             for ln in listen_out.splitlines() if "performance_stats" in ln]
    # session 0 is a fresh stream of silence from clock 0 (the server's
    # weights are seed 0's, as this script's model)
    eng = StreamingInference(model, cfg)
    silent = np.stack(eng.process_audio(np.zeros(listen_ticks * hop,
                                                 np.float32)))
    d_silent = (float(np.abs(bs[0] - silent).max())
                if bs[0].shape == silent.shape else float("inf"))
    d_fed = float(np.abs(bs[1] - bs[0]).max()) if len(bs[1]) else 0.0
    emit({"phase": "serve_listen", "rows": len(rows),
          "feeder": feed.stdout.strip(),
          "session0_max_abs_diff_vs_silent_engine": d_silent,
          "session1_max_abs_diff_vs_session0": d_fed,
          "performance_stats": stats[-1] if stats else None})
    check(len(rows) == 2 * listen_ticks and len(bs[0]) == len(bs[1]),
          "listen rows")
    check(d_silent <= SERVE_LANE_MAX,
          "the underrun session was not served silence")
    check(d_fed > 1e-3, "the fed session's audio did not arrive")
    check(bool(stats) and stats[-1]["dropped_datagrams"] == 0,
          "listen stats line")

    # ---- 9. the offline CLI ----
    wav, jsonl = work / "speech.wav", work / "frames.jsonl"
    write_wav(wav, voiced_audio(10.0, seed=10), SR)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.infer", "--input",
         str(wav), "--output", str(jsonl)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"infer CLI failed:\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    n_cli = (160000 // HOP - 256) + 1
    stamps_ok = all(r["timestamp"] == round((255 + i) / 30, 6)
                    for i, r in enumerate(rows))
    emit({"phase": "infer_cli", "rows": len(rows), "expected": n_cli,
          "timestamps_ok": stamps_ok, "seconds": round(cli_s, 2),
          "log": [ln for ln in proc.stderr.splitlines() if "RTF" in ln]})
    check(len(rows) == n_cli and stamps_ok, "infer CLI output")

    # ---- 10. times ----
    # per-frame times of the graphed stream (the main path's engine) and
    # of the eager one, between CUDA events
    def frame_times(eng) -> dict:
        """ms per frame of ``eng`` over the stream's audio from a fresh
        state, between CUDA events, refresh frames and others apart."""
        eng.reset()
        evs = []
        with torch.inference_mode():
            for i in range(n_frames):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                step_out = eng.step(audio[i * hop:(i + 1) * hop])
                e1.record()
                step_out.cpu()
                evs.append((e0, e1))
        torch.cuda.synchronize()
        ft = np.asarray([a.elapsed_time(b) for a, b in evs])
        is_ref = np.arange(n_frames) % cfg.emotion_update_frames == 0
        return {"refresh": q(ft[is_ref]), "other": q(ft[~is_ref])}

    stream_prof = {}
    frame_q = {"graphed": frame_times(engine),
               "eager": frame_times(eager_engine)}
    emit({"phase": "frame_times", "card": card, **frame_q["graphed"],
          "eager": frame_q["eager"]})

    # what the eGeMAPS functionals' index copies, which no step makes any
    # more, cost the eager stream alone: each index built from a host list
    # at every call again (a pageable copy the host waits for), runs
    # interleaved as is, copies, copies, as is; and the activities of one
    # eager refresh frame, with and without the copies, and in a
    # profiling window that opens on the frame itself (no lead-in)
    cached_index = eg._index

    def host_index(ids, device):
        return torch.tensor(ids, dtype=torch.int64, device=device)

    def refresh_frame():
        eager_engine.reset()
        eager_engine.step(audio[:hop]).cpu()

    def bare_window_count(fn) -> int:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(str(e.device_type).endswith("CUDA") for e in prof.events())

    copy_runs, copy_acts = [], {}
    for copies_back in (False, True, True, False):
        eg._index = host_index if copies_back else cached_index
        try:
            copy_runs.append({"index_copies": copies_back,
                              **frame_times(eager_engine)})
            ks = device_kernels(refresh_frame)
            copy_acts[str(copies_back)] = {"activities": len(ks),
                                           **copies(ks)}
        finally:
            eg._index = cached_index
    emit({"phase": "eager_index_copies", "card": card, "runs": copy_runs,
          "refresh_frame": copy_acts,
          "refresh_frame_activities_without_lead_in": [
              bare_window_count(refresh_frame) for _ in range(3)]})

    # where a frame's time goes: device kernels per frame (a replay's
    # kernels for the graphed engine), their summed device time, and the
    # host wall time of the same frames
    for tag, eng in (("graphed", engine), ("eager", eager_engine)):
        eng.reset()
        for label, idx in (("refresh", [0]), ("other", list(range(1, 9)))):
            def frames_run():
                with torch.inference_mode():
                    for i in idx:
                        eng.step(audio[i * hop:(i + 1) * hop]).cpu()
            prof = profiled(frames_run)
            wall_ms = prof.wall_s * 1e3 / len(idx)
            ks = device_kernels(frames_run, prof)
            row = {"kernels_per_frame": len(ks) / len(idx),
                   "device_busy_ms_per_frame":
                       sum(us for _, us in ks) / 1e3 / len(idx),
                   "own_kernels_per_frame": own_kernels(ks, len(idx)),
                   "copies_per_frame": copies(ks, len(idx)),
                   "profiled_wall_ms_per_frame": wall_ms}
            stream_prof[(tag, label)] = row
            emit({"phase": "frame_profile", "engine": tag, "frames": label,
                  "card": card, **row,
                  "top_kernels_us_per_frame": profile_summary(ks, len(idx)),
                  "top_ops_us_per_frame": top_ops(prof, len(idx))})
    check(frame_q["graphed"]["refresh"]["p99_ms"] < BUDGET_MS,
          f"graphed refresh frame p99 {frame_q['graphed']['refresh']} over "
          f"the {BUDGET_MS} ms budget")
    own = stream_prof[("graphed", "refresh")]["own_kernels_per_frame"]
    check(all(v > 0 for v in own.values()),
          f"a kernel is missing from the graphed refresh frame: {own}")

    # the decode: device time per call (CUDA events), host wall time per
    # call (waited for), frames per second, kernels and device busy per
    # call; graphed (the main path's decoder) and eager
    dec_rows = {}
    for tag, dec in (("graphed", decoder), ("eager", eager_decoder)):
        dec_ms, wall = [], []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            dec(audio_dev)
            e1.record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            dec_ms.append(e0.elapsed_time(e1))
        dec_med = float(np.median(dec_ms))
        prof = profiled(lambda: dec(audio_dev))
        ks = device_kernels(None, prof)
        busy = sum(us for _, us in ks) / 1e3
        dec_rows[tag] = {
            "device_ms_per_call_median": dec_med,
            "device_ms_per_call": dec_ms,
            "wall_ms_per_call_median": float(np.median(wall)),
            "frames_per_s": DECODE_B * n_out / (dec_med / 1e3),
            "kernels_per_call": len(ks), "device_busy_ms_per_call": busy,
            "device_busy_share": busy / dec_med,
            "own_kernels_per_call": own_kernels(ks),
            "copies_per_call": copies(ks),
            "top_kernels_us_per_call": profile_summary(ks, 1, top_n=10)}
    dec_med = dec_rows["eager"]["device_ms_per_call_median"]
    own = dec_rows["graphed"]["own_kernels_per_call"]
    check(all(v > 0 for v in own.values()),
          f"a kernel is missing from the graphed decode: {own}")

    # stage split of one decode: each stage alone, CUDA events, median of 3
    model = decoder.model
    mel_kw = model.mel_frontend.logmel_kwargs()
    with torch.inference_mode():
        emo_raw = model.emotion_raw(audio_dev)
        emotion = model.emotion_projection(emo_raw)
        mel_w = torch.rand((DECODE_B * n_out, 256, 80), device=dev)
        det_w = torch.rand((DECODE_B * n_out, 3, 80), device=dev)
        raw_seq = torch.rand((n_out, DECODE_B, 52), device=dev)
        stages = {
            "emotion (eGeMAPS LLDs + functionals)":
                lambda: model.emotion_raw(audio_dev),
            f"mel: global STFT (logmel T={t_global})":
                lambda: frontend.fused_log_mel_frontend(
                    audio_dev, n_fft=1024, hop_length=HOP, **mel_kw),
            f"mel: window edges (logmel T={t_edges})":
                lambda: dm._reflect_edge_rows(audio_dev, starts, 256 * HOP,
                                              1024, HOP, **mel_kw),
            f"attention ({DECODE_B * n_out} windows)":
                lambda: model.dual_stream_attention(mel_w, det_w, emotion),
            "EMA": lambda: dm._ema_smooth(raw_seq, model.alpha()),
        }
        stage_ms = {k: time_ms(fn, iters=3, warmup=1)
                    for k, fn in stages.items()}
    emit({"phase": "decode_times", "card": card, "batch": DECODE_B,
          "windows_per_utterance": n_out, **dec_rows["graphed"],
          "eager": dec_rows["eager"], "graphs": graph_info(
              decoder.step_graphs),
          "stage_ms": stage_ms,
          "stage_share_of_eager_call": {k: v / dec_med
                                        for k, v in stage_ms.items()}})

    kernels = []

    def entry(kname, source, replaces, launches, max_abs_err, fn, pattern,
              plain_fn, nbytes, ops, library_ms, library=None,
              tensor_cores=False):
        bound_ms, bound_by = bound(nbytes, ops)
        by_kernel = {}
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max_abs_err, "ms": time_ms(fn),
                "device_ms": kernel_device_ms(fn, pattern,
                                              by_kernel=by_kernel),
                "device_us_by_kernel": by_kernel,
                "plain_ms": time_ms(plain_fn, iters=20),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_tc_ms": (bound(nbytes, 3.0 * ops,
                                      PEAK_TF32_PER_S)[0]
                                if tensor_cores else None),
                "library_ms": library_ms, "library": library, "card": card}

    def k1_entry(label, frames_k, start, tau, off, kw, launches_k,
                 max_abs_err):
        n, K, L = frames_k.shape[-1], kw["n_cycles"], 2 * kw["half_lag"] + 1
        rows = start.numel()
        # the samples the cycle masks select, from these inputs
        masked = float(f0_ops.cycle_masks(
            n, start.reshape(-1), tau.reshape(-1), off.reshape(-1),
            **kw).sum())
        e = entry(f"cycle_dsum[{label}]",
                  "koemorph_tpu_torch/ops/cuda/cycle_dsum.cu",
                  "koemorph_tpu/ops/pallas/cycle_dsum_kernel.py:79",
                  launches_k, max_abs_err,
                  lambda: ck.cycle_dsum(frames_k, start, tau, off, **kw),
                  "cycle_dsum_kernel",
                  lambda: f0_ops.cycle_dsum_plain(frames_k, start, tau, off,
                                                  **kw),
                  k1_bytes(frames_k, rows, K * L), 3.0 * L * masked, None)
        e["bound_materialized_ms"] = bound(
            rows * (n * 4.0 + 12) + rows * K * L * 4.0, 3.0 * L * masked)[0]
        e["masked_samples_per_row"] = masked / rows
        return e

    for label, c in k1.items():
        frames_t, start, tau, off = c["args"]
        shape_key = ("cycle_dsum", (c["rows"], c["K"], c["L"], c["n"]))
        kernels.append(k1_entry(
            label, frames_t, start, tau, off, c["kw"],
            (stream_shapes if c["rows"] == 30 else dec_shapes).get(
                shape_key, 0), c["max_abs_err"]))
    with torch.inference_mode():
        for (tag, n), (frames_a, st, tau, off, kw) in sorted(k1_args.items()):
            L = 2 * kw["half_lag"] + 1
            key = ("cycle_dsum", (st.numel(), kw["n_cycles"], L, n))
            got = ck.cycle_dsum(frames_a, st, tau, off, **kw)
            want = f0_ops.cycle_dsum_plain(frames_a, st, tau, off, **kw)
            kernels.append(k1_entry(
                f"{tag} args n{n}", frames_a, st, tau, off, kw,
                (stream_shapes if tag == "stream" else dec_shapes).get(key, 0),
                float((got - want).abs().max())))

    for rows, c in k2.items():
        a = c["a"]
        comp = companion(a)
        library_ms = (time_ms(lambda: torch.linalg.eigvals(comp), iters=20)
                      if rows == 30 else
                      time_ms(lambda: torch.linalg.eigvals(comp), iters=2,
                              warmup=1))
        kernels.append(entry(
            f"dk_roots[{rows} rows]",
            "koemorph_tpu_torch/ops/cuda/dk_roots.cu",
            "koemorph_tpu/ops/pallas/dk_roots_kernel.py:95",
            (stream_shapes if rows == 30 else dec_shapes).get(
                ("dk_roots", (rows,)), 0),
            c["max_abs_err"], lambda: ck.dk_roots(a), "dk_roots_kernel",
            lambda: eg.poly_roots_plain(a),
            rows * 11 * 4 + rows * 10 * 8 + 10 * 8,
            20.0 * 10 * (10 * 11 + 10 * 10 + 14) * rows, library_ms,
            "torch.linalg.eigvals of the companion matrices"))

    # logmel: the chain the JAX model path runs (window, two DFT products,
    # power, mel product, dB) as three cuBLAS fp32 products is the
    # library yardstick; no single PyTorch call computes this function.
    # The bound counts the work the function needs: the live bins' bases
    # and DFT products, the nonzero filter weights and their products
    # (every other bin adds exactly +0)
    lc = frontend.logmel_kernel_constants(1024, SR, 80, 80.0, 8000.0, dev)
    live, nnz = lc.hi - lc.lo, lc.fb_nz.numel()
    win = hann_window(1024, device=dev)
    cos_m, sin_m = dft_matrices(1024, dev)
    fb = mel_filterbank(SR, 1024, 80, 80.0, 8000.0, device=dev)

    def cublas_chain(x):
        xw = x * win
        re, im = xw @ cos_m, xw @ sin_m
        return 10.0 * torch.log10(torch.clamp_min((re * re + im * im) @ fb,
                                                  1e-10))

    for label, shapes in (("T=1", stream_shapes),
                          (f"T={t_edges}", dec_shapes),
                          (f"T={t_global}", dec_shapes)):
        x = k3[label]["x"]
        t = x.shape[0]
        kernels.append(entry(
            f"logmel[{label}]", "koemorph_tpu_torch/ops/cuda/logmel.cu",
            "koemorph_tpu/ops/pallas/frontend_kernel.py:93",
            shapes.get(("logmel", (t,)), 0), k3[label]["max_abs_err"],
            lambda: ck.logmel(x), "logmel_",
            lambda: frontend.frames_to_logmel_plain(x),
            4.0 * (t * 1024 + 2 * 1024 * live + nnz + t * 80),
            t * (2.0 * 1024 * live * 2 + 2.0 * nnz),
            time_ms(lambda: cublas_chain(x), iters=50),
            "chain: window, 2 DFT matmuls, power, mel matmul, dB "
            "(3 cuBLAS fp32 products)", tensor_cores=True))

    # the serving shapes, on the arguments the server passed them (phase
    # 8): K3 on the lanes' newest frames, K1 and K2 on a refreshing
    # cohort's LLD block (all lanes at G = 1, 8 lanes at G = 8)
    (x_s,), kw_s = serve_rec[("logmel", "G=8", SERVE_S)]
    with torch.inference_mode():
        err_s = float((ck.logmel(x_s, **kw_s)
                       - frontend.frames_to_logmel_plain(x_s, **kw_s))
                      .abs().max())
    kernels.append(entry(
        f"logmel[T={SERVE_S}]", "koemorph_tpu_torch/ops/cuda/logmel.cu",
        "koemorph_tpu/ops/pallas/frontend_kernel.py:93",
        serve_shapes[8].get(("logmel", (SERVE_S,)), 0), err_s,
        lambda: ck.logmel(x_s, **kw_s), "logmel_",
        lambda: frontend.frames_to_logmel_plain(x_s, **kw_s),
        4.0 * (SERVE_S * 1024 + 2 * 1024 * live + nnz + SERVE_S * 80),
        SERVE_S * (2.0 * 1024 * live * 2 + 2.0 * nnz),
        time_ms(lambda: cublas_chain(x_s), iters=50),
        "chain: window, 2 DFT matmuls, power, mel matmul, dB "
        "(3 cuBLAS fp32 products)", tensor_cores=True))
    with torch.inference_mode():
        for g in (1, 8):
            rows = SERVE_S // g * block_rows
            for n, n_cyc, L in ((512, 8, 17), (1024, 5, 33)):
                (frames_a, st, tau, off), kw = serve_rec[
                    ("cycle_dsum", f"G={g}", (rows, n))]
                got = ck.cycle_dsum(frames_a, st, tau, off, **kw)
                want = f0_ops.cycle_dsum_plain(frames_a, st, tau, off, **kw)
                kernels.append(k1_entry(
                    f"serve G={g} args n{n} x{rows}", frames_a, st, tau, off,
                    kw, serve_shapes[g].get(
                        ("cycle_dsum", (rows, n_cyc, L, n)), 0),
                    float((got - want).abs().max())))
            (a_s,), _ = serve_rec[("dk_roots", f"G={g}", rows)]
            a_s = a_s.reshape(rows, a_s.shape[-1])      # (lanes, 30, 11)
            got, want = ck.dk_roots(a_s), eg.poly_roots_plain(a_s)
            exact = torch.linalg.eigvals(companion(a_s.double()))
            conv = hausdorff(want.to(torch.complex128), exact) < DK_MAX
            comp_s = companion(a_s)
            kernels.append(entry(
                f"dk_roots[serve G={g}, {rows} rows]",
                "koemorph_tpu_torch/ops/cuda/dk_roots.cu",
                "koemorph_tpu/ops/pallas/dk_roots_kernel.py:95",
                serve_shapes[g].get(("dk_roots", (rows,)), 0),
                float(hausdorff(got, want)[conv].max()),
                lambda: ck.dk_roots(a_s), "dk_roots_kernel",
                lambda: eg.poly_roots_plain(a_s),
                rows * 11 * 4 + rows * 10 * 8 + 10 * 8,
                20.0 * 10 * (10 * 11 + 10 * 10 + 14) * rows,
                time_ms(lambda: torch.linalg.eigvals(comp_s), iters=2,
                        warmup=1),
                "torch.linalg.eigvals of the companion matrices"))

    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the path was not launched by its run: "
          + str([k["name"] for k in kernels if k["launches"] == 0]))
    emit({"phase": "done",
          "seconds": round(time.perf_counter() - t_script, 1)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
