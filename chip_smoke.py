#!/usr/bin/env python3
"""Drive the PyTorch port of KoeMorph on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root

Phases, each printing one JSON line:

1. device: the card's name and power limit (no GPU is a failure);
2. build: the CUDA kernels compiled from ``koemorph_tpu_torch/ops/cuda``;
   then ``native_emit``: the native batch emitter at 256 sessions against
   the ``json.dumps`` wire contract (values within 5e-10, float32
   bit-exact above 2^-6), a NaN / Infinity row, a 1e30 timestamp refused,
   µs per session both ways;
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
   of the voiced pattern shifted 0.25 s per lane, 36 steps, with one
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
10. training, at the flagship width of ``configs/dual_stream_config.yaml``
   (batch 16, span 288 frames = 153,504 samples, 33 windows per sample,
   dropout 0.1, AdamW) on two 36 s files of the port's synthetic dataset:
   ``train_step``: ``SequentialTrainer.fit`` over
   ``create_sequential_dataloader`` for 12 steps with the launch counts
   set to 0 just before (K1 twice and K2 once per step on 15,312 LLD
   rows, K3 on the 4,624 global STFT frames and the 1,056 window-edge
   frames), ms per step between CUDA events, activities and device busy
   per step, peak memory, audio seconds per second, the step split into
   emotion features, forward, backward and optimizer; finite losses and
   every parameter with a gradient moved; ``train_plain``: one step's
   loss and gradients with the kernels against the plain forms (dropout
   0), and each kernel against its plain form on the arguments the train
   step passed it; ``train_resume``: 2 steps, a checkpoint, a fresh
   trainer's ``resume()`` and 2 more, bitwise equal to 4 steps at once
   (dropout on); ``train_cli``: ``python -m koemorph_tpu_torch.train
   --scan-epochs`` (its epochs device-resident) in a subprocess, then
   ``infer``, ``rt`` and ``serve`` with ``--model`` on what it wrote,
   each equal to the same engine run in-process on the loaded state
   dict;
11. times: per-frame stream times and profiles (graphed and eager; the
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

12. the configurations without the LLD ring and the emotion2vec
   backend (``slice8_phases``; its streams, and phase 13's, over 36
   frames), each through its entry points, graphed
   and held bitwise against eager and within 1e-4 against the plain
   forms, launch counts against the capture records: the stream with
   ``basic`` and full-ring ``egemaps`` (K1 and K2 on the arguments the
   full-ring refresh passed), the stream with the compact encoder
   (cuDNN's global TF32 flag on; the vector against float64 on the card
   within 1e-5 of its largest element) and with the 24-layer config
   loaded through ``load_hf_checkpoint``, the ``basic`` server (64
   sessions, G = 1 and 8) and the emotion2vec server (16 sessions, G =
   8) with lanes against engines and a lane reset, the emotion2vec
   decode, 6 emotion2vec train steps at batch 16 (split, plain forms,
   the cost of deterministic cuDNN, a 2 + 2 resume bitwise), and the
   ``rt`` / ``serve`` CLIs with ``--emotion-backend basic``.
13. the remaining eGeMAPS, F0, frontend and decoder options
   (``slice9_phases``): the stream and the server (64 sessions, G = 1
   and 8, four lanes reset at step 17, graphed bitwise against eager)
   with frame-level voice quality (``egemaps_per_period=False``: no
   ``cycle_dsum``), the frame-level decode beside the per-period one,
   the Viterbi smoother on the decode's 13,624 LLD rows and in 30-row
   blocks over the stream's audio (eager; picks with kernels equal to
   the plain forms', K1 and K2 on its arguments), the decode with
   ``return_attention`` (weights' rows sum to 1, blendshapes bitwise
   unchanged), graphs of ``decode_scheduled`` (strides 1, 2, 4, 8) and
   ``decode_sequence_parallel`` against eager and ``__call__``, and the
   torchaudio-style and rfft frontends against float64 on the card.
   The eager stream and server runs' wrapper counts are held equal to
   the expected launches too.
14. the legacy model family (``slice10_phases``) at flagship width:
   ``rt_simplified`` (``run_stream`` over 36 frames of the rolling 1 s
   window, one graph; ``logmel`` at T = 31 once per frame by the profiler,
   the capture's record and the eager wrappers; graphed bitwise equal to
   eager; the plain forms within 1e-4, the mel within K3's rule; frame
   times graphed and eager), the CLI chain (``python -m
   koemorph_tpu_torch.train --config configs/config.yaml --synthetic 32``,
   then ``rt_simplified --model`` on one file, bitwise equal to the
   in-process frames, ``test_model --model-name simplified``, and
   ``test_model --model-name sequential_dual_stream`` on random weights
   from a ``.pth``, its metrics within 1e-5 of the same batch in process,
   which launches K1, K2 and K3; one simplified evaluation batch counted
   in process), ``KoeMorphTrainer.fit`` for 12 steps at batch 16 on 12 s
   files (``logmel`` once per step at 5,776 frames; ms per step, audio
   seconds per second, the fit's peak memory above what the process held
   before it, the device-busy share of two profiled steps' wall time; one
   step's loss and gradients against the plain forms; a resume
   after step 6 bitwise), and ``KoeMorphModel`` carried over 30 steps per
   smoothing method at batch 4 on K3's 256-frame mel (outputs finite in
   [0, 1]).
15. from files to a checked, trained model (``slice11_phases``):
   ``fit_wall_split`` (phase 14's legacy fit as the train CLI runs it,
   validation and checkpoints included, its wall split into the wait for
   batches, the steps, validation and checkpoint writes, in turns
   through the Python readers and the native WAV / JSONL parsers, losses
   bitwise equal; a load-only pass over the 32 files both ways),
   ``reference_import`` (a synthetic reference ``.pth`` at flagship width,
   learnable and fixed fusion, through ``import_torch_checkpoint``, then
   ``infer``, ``rt`` and ``test_model`` on the card, within 1e-5 of the
   same model in process), ``rehearsal`` (``demo_lipsync_learning`` at its
   defaults, the loss falling; ``reproduce_results --smoke``, its report
   written; K1-K3 against their plain forms on the batch-4 train step's
   arguments) and ``extractor`` (``EmotionExtractor``'s fallback matrix
   and ``integration_check`` with ``"ok": true``).
16. the reference-named feature extractors, reconstruction, prosody and
   export (``slice12_phases``): ``MelSlidingWindowExtractor`` at its
   defaults fed 8.5 s hop by hop (``logmel`` once per extraction at T =
   257; the dB rows by K3's rule and the normalized mel within 1e-4 of the
   plain forms), ``EgemapsStreamingExtractor`` on a 20 s context with the
   3-window concatenation (``cycle_dsum`` twice and ``dk_roots`` once per
   window on 1,997 LLD rows; the functionals against the plain forms at
   the CPU tests' bounds), ``MelSpectrogramExtractor``,
   ``InverseMelSpectrogram`` and ``extract_prosody`` (no kernel; against
   the same calls on the CPU, the Griffin-Lim pitch round trip), then
   ``python -m koemorph_tpu_torch.export_model --benchmark`` on phase
   15's imported checkpoint, the ``.pt2`` reloaded in another process and
   run for 30 frames with the EMA carry threaded: within 1e-5 of the live
   module and 1e-4 of the plain forms, the three ``torch.library``
   operators in its graph, its launches counted there and its kernels
   seen by the profiler, exported and live frame ms between CUDA events
   (and, from ``--benchmark``, in one process in alternating rounds);
   the live frame through the operators bitwise equal to the direct
   route, the two routes timed in alternating rounds, per frame and per
   kernel call on the host.
17. the compiled train step, the scan epochs, the profiling entry points
   and the microphone flags (``slice13_phases``): 12 flagship steps
   (``configs/dual_stream_config.yaml``, batch 16, span 288, dropout 0.1)
   through ``SequentialTrainer.compiled_step`` (one CUDA graph per batch
   shape) and 12 eager steps from one start, the parameters, moments,
   count and every step's metrics bitwise, the replays' kernels seen by
   the profiler against the capture's record (K1 x2, K2, K3 x2 per
   replay), step times graphed and eager, device busy share, peak memory
   and capture seconds; the same for ``KoeMorphTrainer``
   (``configs/config.yaml``, batch 16, K3 once per replay at T = 5,776)
   and the emotion2vec trainer, 4 steps each; a graphed resume bitwise
   equal to the uninterrupted graphed run; ``train_epochs_scan`` over 2
   epochs bitwise equal to per-epoch ``train_epoch_scan`` in the same
   orders, with no host-to-device copy per step (the profiler's ``Memcpy
   HtoD`` count is the stack's arrays and the scalar table; phase 10's
   ``train_cli`` runs ``--scan-epochs``); ``training_rehearsal --smoke``
   (trained by scan) passing its gate; ``profile_training --batches 4 8
   16`` and ``profile_multistream --sessions 64 256``; ``rt
   --list-devices`` and ``rt --mic`` without ``pyaudio``; each kernel
   against its plain form on the arguments the eager twins passed.
18. several devices, on the one card (``slice14_phases``): the 64-session
   server (8 cohorts) as a mesh of two ``cuda:0`` entries for 36 steps,
   graphed and counted (K3 at T = 32, K1 and K2 at 120 rows per entry),
   within 1e-5 of the one-engine server and bitwise its eager twin, the
   replays' kernels against the captures' records, step times beside the
   one engine's; ``serve --mesh-devices 1`` and ``--device cuda:0
   --mesh-devices 2`` against the one-device CLI's rows; phase 7's decode
   and one utterance's ``decode_sequence_parallel`` over two entries
   against the one-device decode, call times beside it; a world-1 NCCL
   process group in this process, the data-parallel
   ``SequentialTrainer.compiled_step`` at the ranks' batch block (8) bit
   for bit the single-process compiled step (its all-reduces issued at
   the capture, none at the replays), step times beside it; the train
   CLI under ``torch.distributed.run``: one NCCL rank with
   ``--scan-epochs`` bitwise the single-process CLI, two gloo ranks on
   the card within the sharded-step bounds of the single-process CLI
   (loss rtol 1e-5, parameters rtol 2e-4 / atol 2e-6), a two-rank resume
   bitwise the uninterrupted two-rank run; each kernel against its plain
   form on the arguments the eager twins passed.
19. tensor-parallel training, on the one card (``slice15_phases``): the
   flagship ``SequentialTrainer`` (batch 16, span 288) with
   ``tensor_parallel=True`` as gloo ranks sharing ``cuda:0`` on grids
   (1, 2) and (2, 2), relaunching this script as the rank program
   (``--tp-rank``) under ``torch.distributed.run``: 4 eager steps against
   the single-process eager steps (losses rtol 1e-5; the first whole
   gradients against the single process's float64 gradient after the
   features by the CPU tests' rule, and in float64 within 1e-9 of it; the
   parameters within the sharded-step bounds after the first step and
   JAX's tensor-parallel run bounds after the fourth), the split leaves'
   and their moments' bytes per rank, the collectives per step by name,
   step times beside the single process's and two data-parallel gloo
   ranks'; the grid
   (1, 1) of a world-1 NCCL group through ``compiled_step`` bit for bit
   the single-process compiled step; K1-K3's launches counted on the
   ranks and held against their plain forms on a rank's arguments.

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

import argparse
import collections
import contextlib
import io
import json
import os
import re
import shutil
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
DEVICE = "cuda"
DECODE_B, DECODE_LEN, DECODE_STRIDE = 8, 512 * HOP, 4
#: the served sessions, their number for throughput, the steps of every
#: server and of the streams of phases 12-13 (4 refreshes of each clock;
#: cut from 105 to keep the script inside its time), the lanes' shift
#: in samples
SERVE_S, SERVE_BIG, SERVE_STEPS, SERVE_SHIFT = 64, 256, 36, 4000


#: the script's start on the host clock
T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``at_s``, the seconds since
    the script started (a phase's own seconds are the difference from the
    line before it)."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 1)}
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
    first few device activities, so it starts with
    ``utils.trace_latency.lead_in`` (tiny kernels, a synchronization and
    20 ms of sleep), which ``measured_events`` leaves out; and it ends
    with ``utils.trace_latency.lead_out`` (20 ms of sleep), since the
    profiler drops a device activity that, mapped to the host's clock,
    ends after the window stopped (a window without it once lost a
    replay's kernels). ``prof.wall_s`` is the host time of ``fn()`` to a
    synchronization."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from koemorph_tpu_torch.utils.trace_latency import lead_in, lead_out
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        lead_in("cuda")
        t0 = time.perf_counter()
        with record_function(MEASURED):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lead_out("cuda")
    prof.wall_s = wall
    return prof


def measured_events(prof):
    """The profile's events of its ``MEASURED`` range. Host events: those
    that start inside it (10 ms of slack). Device activities: those after
    the lead-in's idle gap on the device's own clock
    (``utils.trace_latency.lead_in_end``), since the device's timestamps
    are aligned with the host's only to milliseconds (with 1 ms of slack a
    run left out the first replay of a window); where the gap does not
    show (the lead-in's activities lost), those too from 10 ms before the
    range's start."""
    from koemorph_tpu_torch.utils.trace_latency import lead_in_end
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == MEASURED)
    on_device = sorted((e for e in events
                        if str(e.device_type).endswith("CUDA")),
                       key=lambda e: e.time_range.start)
    first = lead_in_end([(e.time_range.start, e.time_range.end, e.name)
                         for e in on_device])
    out = []
    for e in events:
        if e.name == MEASURED:
            continue
        if first is not None and str(e.device_type).endswith("CUDA"):
            if e.time_range.start >= first:
                out.append(e)
        elif e.time_range.start >= start - 10000:
            out.append(e)
    return out


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
                   "dk_roots": "dk_roots_kernel", "logmel": "logmel_",
                   "linear_3xtf32": "linear_3xtf32_kernel"}
#: the kernels one launch of each wrapper runs (the logmel wrapper: its
#: power or product pass and its mel or reduction pass)
KERNELS_PER_LAUNCH = {"cycle_dsum": 1, "dk_roots": 1, "logmel": 2,
                      "linear_3xtf32": 1}
#: K1-K3, which every flagship (eGeMAPS) path launches; K4
#: (``linear_3xtf32``) runs only in the wav2vec2 encoder
FLAGSHIP_KERNELS = ("cycle_dsum", "dk_roots", "logmel")


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


#: steps or frames per profiling window of a main path's run: a window of
#: 105 server steps (~25,000 device activities) lost 1-2 replays'
#: kernels from the profile in two of three runs, and a window of 21
#: frames of the 24-layer emotion2vec stream lost 8 frames' in one run
WINDOW = 7


def in_windows(n: int, fn) -> list:
    """``fn(lo, hi)`` over ``[0, n)`` in runs of ``WINDOW``, as a list of
    calls for :func:`replayed_launches`."""
    return [lambda lo=lo: fn(lo, min(lo + WINDOW, n))
            for lo in range(0, n, WINDOW)]


def replayed_launches(graphs, fns) -> tuple[dict, dict]:
    """Run each of ``fns`` in its own profiling window. Returns the
    launches of each hand-written kernel the profiler saw, from the kernel
    names, and those the graphs the calls replayed recorded at capture
    (each graph's record times its replays in the run). ``graphs``: one
    engine's ``StepGraphs``, or a list (a mesh's entries)."""
    many = graphs if isinstance(graphs, list) else [graphs]
    before = [collections.Counter(g.replays) for g in many]
    seen = dict.fromkeys(KERNEL_PATTERNS, 0.0)
    for fn in fns:
        ks = device_kernels(None, profiled(fn))
        for src, n in own_kernels(ks).items():
            seen[src] += n / KERNELS_PER_LAUNCH[src]
    want = dict.fromkeys(KERNEL_PATTERNS, 0)
    for g, b in zip(many, before):
        for key, n in g.replays.items():
            for name, c in recorded(g, key).items():
                want[name] += (n - b[key]) * c
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


def exact_roots(a):
    """The float64 roots of the polynomials ``a (rows, 11)`` the K2
    checks hold against: the eigenvalues of their companion matrices by
    LAPACK on the host (about 1 s for 15,312 rows; the card's
    ``eigvals`` takes 10-13 s there), returned on ``a``'s device."""
    import torch
    return torch.linalg.eigvals(companion(a.double()).cpu()).to(a.device)


def eigvals_ms(comp) -> float:
    """The library yardstick of K2, ``torch.linalg.eigvals`` of the
    companion matrices, timed over one call (it takes 0.03-13 s a call at
    the shapes here)."""
    import torch
    return time_ms(lambda: torch.linalg.eigvals(comp), iters=1, warmup=0)


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
    from koemorph_tpu_torch.ops import linear as lin
    saved = (f0_ops.cycle_dsum, eg.poly_roots, frontend.frames_to_logmel,
             lin.linear)
    f0_ops.cycle_dsum = f0_ops.cycle_dsum_plain
    eg.poly_roots = eg.poly_roots_plain
    frontend.frames_to_logmel = frontend.frames_to_logmel_plain
    lin.linear = lin.linear_plain
    try:
        yield
    finally:
        (f0_ops.cycle_dsum, eg.poly_roots, frontend.frames_to_logmel,
         lin.linear) = saved


@contextlib.contextmanager
def through_operators():
    """Every kernel's dispatcher switched to its ``torch.library``
    operator, the route an exported program takes, on the live paths
    too."""
    import torch
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import frontend
    ops = torch.ops.koemorph_torch

    def cycle_dsum(frames, start, tau, off, *, n_cycles, half_lag):
        return ops.cycle_dsum(frames, start.to(torch.int32), tau, off,
                              n_cycles, half_lag)

    def frames_to_logmel(frames, *, sample_rate=16000, n_mels=80,
                         f_min=80.0, f_max=8000.0):
        return ops.logmel(frames, int(sample_rate), int(n_mels),
                          float(f_min), float(f_max))

    saved = (f0_ops.cycle_dsum, eg.poly_roots, frontend.frames_to_logmel)
    f0_ops.cycle_dsum, eg.poly_roots = cycle_dsum, ops.dk_roots
    frontend.frames_to_logmel = frames_to_logmel
    try:
        yield
    finally:
        f0_ops.cycle_dsum, eg.poly_roots, frontend.frames_to_logmel = saved


def round_stats(rounds: dict) -> dict:
    """Medians and spreads of two sides' rounds (``{name: [ms]}``, as
    ``benchmark_rounds`` gives them) and, per round, the second side's
    time over the first's."""
    first, second = rounds.values()
    ratio = [b / a for a, b in zip(first, second)]
    return {"rounds_ms": rounds,
            "median_ms": {k: float(np.median(v)) for k, v in rounds.items()},
            "spread_ms": {k: [min(v), max(v)] for k, v in rounds.items()},
            "ratio_per_round": ratio, "ratio_median": float(np.median(ratio)),
            "rounds_second_slower": int(sum(x > 1.0 for x in ratio))}


def dispatch_host_ms(rec: dict, tag: str, rounds: int, calls: int
                     ) -> dict:
    """Host ms per call of each kernel on ``tag``'s recorded arguments,
    through its dispatcher (the live route) and through its operator: a
    loop of ``calls`` calls timed without waiting for the device (their
    launches fit in the launch queue), the device drained between loops,
    in ``rounds`` rounds that alternate which route goes first."""
    import torch
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import frontend
    ops = torch.ops.koemorph_torch
    routes = {
        "cycle_dsum": (lambda a, kw: f0_ops.cycle_dsum(*a, **kw),
                       lambda a, kw: ops.cycle_dsum(
                           *a, kw["n_cycles"], kw["half_lag"])),
        "dk_roots": (lambda a, kw: eg.poly_roots(*a),
                     lambda a, kw: ops.dk_roots(*a)),
        "logmel": (lambda a, kw: frontend.frames_to_logmel(*a, **kw),
                   lambda a, kw: ops.logmel(
                       *a, kw["sample_rate"], kw["n_mels"], kw["f_min"],
                       kw["f_max"]))}
    out = {}
    for (name, t, shape), (args, kw) in sorted(rec.items(), key=str):
        if t != tag:
            continue
        direct, routed = routes[name]
        sides = {"direct": lambda: direct(args, kw),
                 "operators": lambda: routed(args, kw)}
        got: dict = {side: [] for side in sides}
        for r in range(rounds):
            for side in (("direct", "operators") if r % 2 == 0
                         else ("operators", "direct")):
                sides[side]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    sides[side]()
                got[side].append((time.perf_counter() - t0) / calls * 1e3)
                torch.cuda.synchronize()
        out[f"{name}{[int(x) for x in np.atleast_1d(shape)]}"] = \
            round_stats(got)
    return out


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


def hausdorff(za, zb):
    """Per-row Hausdorff distance between two (rows, 10) root sets."""
    import torch
    d = (za[:, :, None] - zb[:, None, :]).abs()
    return torch.maximum(d.amin(2).amax(1), d.amin(1).amax(1))


def companion(a):
    """(rows, 10, 10) companion matrices of (rows, 11) polynomials."""
    import torch
    rows = a.shape[0]
    comp = torch.zeros((rows, 10, 10), device=a.device, dtype=a.dtype)
    comp[:, 0, :] = -a[:, 1:] / a[:, :1]
    comp[:, 1:, :-1] = torch.eye(9, device=a.device, dtype=a.dtype)
    return comp


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


#: the flagship training run: the data config's batch, the sequence
#: trainer's span (window + 32 frames) over two 36 s synthetic files at
#: stride 8 (100 windows each: 12 full batches)
TRAIN_FILES, TRAIN_FILE_S = 2, 36.0
TRAIN_PLAIN_LOSS_RTOL = 1e-4
TRAIN_E2V_STEPS = 6
EMIT_MAX = 5e-10                       # the native emitter's value bound
#: every leaf's gradient, kernels against plain forms, relative to the
#: leaf's largest element (the H100 readings were at most 3.5e-5)
TRAIN_PLAIN_GRAD = 5e-4


#: the training rows include noise-like frames whose LPC roots cluster:
#: after the reference's 20 Durand-Kerner iterations 0.3-0.5% of them are
#: not within DK_MAX of the float64 roots in the plain form (30
#: iterations leave 0-2 of 15,312, 40 none); held to at most 1%
DK_TRAIN_UNCONVERGED = 0.01
#: draws of the plain form on inputs rounded the other way, to measure how
#: many of its converged rows rounding alone turns (0-6 of 15,312 per
#: draw over 12 training batches on an H100; the kernel missed 0-4)
DK_TRAIN_DRAWS = 8


def dk_train_agreement(a, exact=None) -> dict:
    """K2 against its plain form on the training rows ``a (..., 11)``.

    The rows held are chosen by the plain form and float64 alone: those
    where the plain form lies within DK_MAX of the float64 roots. There
    the kernel must lie within 2 DK_MAX of the plain form, and a row where
    it does not is a miss. On a few such rows whether 20 iterations land
    is decided by rounding, so the misses are held to the rate at which
    the plain form misses its own result when each coefficient is rounded
    one step up or down (DK_TRAIN_DRAWS draws, mean m): at most
    m + 4 sqrt(m) + 2. ``exact``: the float64 roots of ``a``'s rows, when
    the caller has them already."""
    import torch
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import egemaps as eg
    a = a.reshape(-1, a.shape[-1])
    got, want = ck.dk_roots(a), eg.poly_roots_plain(a)
    if exact is None:
        exact = exact_roots(a)
    conv = hausdorff(want.to(torch.complex128), exact) < DK_MAX
    h = hausdorff(got, want)[conv]
    gen = torch.Generator(device=a.device).manual_seed(0)
    plain_misses = []
    for _ in range(DK_TRAIN_DRAWS):
        step = torch.randint(-1, 2, a.shape, generator=gen, device=a.device)
        step[:, 0] = 0                  # the leading coefficient stays 1
        nudged = a * (1 + step.to(a.dtype) * 2.0 ** -23)
        hp = hausdorff(eg.poly_roots_plain(nudged), want)[conv]
        plain_misses.append(int((hp >= 2 * DK_MAX).sum()))
    m = sum(plain_misses) / len(plain_misses)
    held = h[h < 2 * DK_MAX]
    return {"rows": a.shape[0], "rows_not_converged": int((~conv).sum()),
            "misses": int((h >= 2 * DK_MAX).sum()),
            "miss_bound": m + 4 * m ** 0.5 + 2,
            "plain_misses_rounded": plain_misses,
            "hausdorff_median": float(h.median()),
            "hausdorff_max_held": float(held.max())}


def dk_train_ok(r: dict) -> bool:
    """The rules of :func:`dk_train_agreement` on its result."""
    return (r["hausdorff_median"] < DK_MEDIAN_MAX
            and r["misses"] <= r["miss_bound"]
            and r["rows_not_converged"] <= DK_TRAIN_UNCONVERGED * r["rows"])


def native_emit_phase(card: str) -> None:
    """The native batch emitter against the ``json.dumps`` wire contract
    at 256 sessions: fields, values within 5e-10 (float32 bit-exact for
    |v| >= 2^-6), timestamps within 1e-6, every session; a NaN / Infinity
    row that ``json.loads`` reads; a 1e30 timestamp refused without an
    overrun; µs per session both ways."""
    from koemorph_tpu_torch.data import native
    rng = np.random.default_rng(8)
    frames = rng.uniform(0, 1, (SERVE_BIG, 52)).astype(np.float32)
    ts = time.time()

    def python_rows(fr, t):
        return "".join(json.dumps({
            "timestamp": t, "session": i,
            "blendshapes": np.asarray(row, np.float32).tolist()}) + "\n"
            for i, row in enumerate(fr))

    got = [json.loads(x) for x in native.format_frames_jsonl_native(
        frames, ts).decode().splitlines()]
    want = [json.loads(x) for x in python_rows(frames, ts).splitlines()]
    gv = np.asarray([r["blendshapes"] for r in got])
    wv = np.asarray([r["blendshapes"] for r in want])
    big = np.abs(wv) >= 2.0 ** -6
    contract = {
        "sessions_equal": [r["session"] for r in got]
        == [r["session"] for r in want] == list(range(SERVE_BIG)),
        "fields_equal": all(set(a) == set(b) for a, b in zip(got, want)),
        "max_abs_value_err": float(np.abs(gv - wv).max()),
        "float32_bit_exact_above_2^-6": bool(
            (gv[big].astype(np.float32) == wv[big].astype(np.float32)).all()),
        "max_timestamp_err": max(abs(a["timestamp"] - b["timestamp"])
                                 for a, b in zip(got, want))}
    odd = frames[:2].copy()
    odd[0, :3] = [np.nan, np.inf, -np.inf]
    row = json.loads(native.format_frames_jsonl_native(odd, ts)
                     .decode().splitlines()[0])
    nan_ok = (np.isnan(row["blendshapes"][0])
              and row["blendshapes"][1:3] == [float("inf"), -float("inf")])
    try:
        native.format_frames_jsonl_native(frames, 1e30)
        refused = False
    except ValueError:
        refused = True
    intact = len(native.format_frames_jsonl_native(
        frames, ts).splitlines()) == SERVE_BIG

    def per_session_us(fn, reps=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps / SERVE_BIG * 1e6

    us = {"native": per_session_us(
              lambda: native.format_frames_jsonl_native(frames, ts)),
          "python": per_session_us(lambda: python_rows(frames, ts))}
    emit({"phase": "native_emit", "card": card, "sessions": SERVE_BIG,
          **contract, "nan_row_parses": bool(nan_ok),
          "huge_timestamp_refused": refused, "intact_after": intact,
          "us_per_session": us})
    check(contract["sessions_equal"] and contract["fields_equal"]
          and contract["max_abs_value_err"] <= 5e-10
          and contract["float32_bit_exact_above_2^-6"]
          and contract["max_timestamp_err"] <= 1e-6,
          f"native emitter breaks the wire contract: {contract}")
    check(nan_ok and refused and intact,
          "native emitter: non-finite row or huge timestamp")


def _step_times(step_fn, n, is_refresh):
    """ms of each of ``n`` calls of ``step_fn(i)`` between CUDA events
    (each output copied to the host, as a server does), refresh calls
    and others apart."""
    import torch
    evs = []
    for i in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step_fn(i)
        e1.record()
        out.cpu()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    t = np.asarray([a.elapsed_time(b) for a, b in evs])
    ref = np.asarray([is_refresh(i) for i in range(n)])
    return {"refresh": q(t[ref]) if ref.any() else None,
            "other": q(t[~ref]) if (~ref).any() else None}


def refresh_launches(cfg) -> tuple[int, int]:
    """``cycle_dsum`` and ``dk_roots`` launches per refresh of a stream or
    server with ``cfg``: the eGeMAPS refresh (with the LLD ring or not)
    launches ``dk_roots`` once and, with per-period voice quality,
    ``cycle_dsum`` twice; the other backends neither."""
    if cfg.emotion_backend != "egemaps":
        return 0, 0
    return (2 if cfg.egemaps_per_period else 0), 1


def linear_launches(cfg) -> int:
    """``linear_3xtf32`` launches per refresh of a stream or server with
    ``cfg``: the ``emotion2vec`` encoder's feature projection, and per
    layer its grouped q, k, v, its out projection and its feed-forward's
    two; the other backends none."""
    if cfg.emotion_backend != "emotion2vec":
        return 0
    return 1 + 4 * cfg.emotion2vec_config.num_hidden_layers


def drive_stream(out: dict, card: str, tag: str, model, cfg,
                 plain: bool = True):
    """The stream of ``model`` over ``SERVE_STEPS`` frames of voiced audio:
    graphed and counted (the launch counts set to 0 just before the engine
    is built), eager (recording the kernels' arguments in ``out["rec"]``),
    plain; each check that fails raises. Returns the graphed engine and
    frames."""
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.runtime.streaming import StreamingInference
    audio = voiced_audio(SERVE_STEPS * HOP / SR, seed=1)
    n_frames = len(audio) // HOP
    k = cfg.emotion_update_frames
    n_ref = -(-n_frames // k)
    profiled(lambda: None)
    ck.reset_launch_counts()
    eng = StreamingInference(model, cfg)
    eng.warmup()
    box = []
    seen, want = replayed_launches(eng.step_graphs, in_windows(
        n_frames, lambda lo, hi: box.extend(eng.process_audio(
            audio[lo * HOP:hi * HOP if hi < n_frames else None]))))
    launches, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
    bs = np.stack(box)
    eager = StreamingInference(model, cfg, graphs=False)
    eager.warmup()
    before = ck.launches()
    with recording_kernels(out["rec"], tag):
        eager_bs = np.stack(eager.process_audio(audio))
    eager_launches = {name: ck.launches().get(name, 0) - before.get(name, 0)
                      for name in KERNEL_PATTERNS}
    d_plain = None
    if plain:
        with plain_forms():
            before = ck.launches()
            p_bs = np.stack(StreamingInference(
                model, cfg, graphs=False).process_audio(audio))
            check(ck.launches() == before,
                  f"{tag}: the plain stream launched a kernel")
        d_plain = float(np.abs(p_bs - bs).max())
    eng.reset()
    times = _step_times(lambda i: eng.step(audio[i * HOP:(i + 1) * HOP]),
                        n_frames, lambda i: i % k == 0)
    k1, k2 = refresh_launches(cfg)
    expect = {"cycle_dsum": k1 * n_ref, "dk_roots": k2 * n_ref,
              "logmel": n_frames,
              "linear_3xtf32": linear_launches(cfg) * n_ref}
    emit({"phase": tag, "card": card, "frames": n_frames,
          "refreshes": n_ref, "emotion_backend": cfg.emotion_backend,
          "incremental_lld": cfg.incremental_lld,
          "emotion_raw_dim": cfg.emotion_raw_dim,
          "finite": bool(np.isfinite(bs).all()),
          "min": float(bs.min()), "max": float(bs.max()),
          "launches": launches,
          "launches_by_shape": {f"{a}{list(b)}": v
                                for (a, b), v in shapes.items()},
          "replayed_launches_profiled": seen,
          "replayed_launches_recorded": want,
          "eager_launches_counted": eager_launches,
          "graphs": graph_info(eng.step_graphs),
          "graphed_bitwise_equal_eager": bool(
              np.array_equal(bs, eager_bs)),
          "max_abs_diff_plain": d_plain, "bound_plain": STREAM_PLAIN_MAX,
          "frame_times": times})
    check(bs.shape == (n_frames, 52) and bool(np.isfinite(bs).all())
          and bs.min() >= 0.0 and bs.max() <= 1.0, f"{tag} output")
    check(np.array_equal(bs, eager_bs), f"{tag}: graphed != eager")
    check(len(eng.step_graphs) == 4, f"{tag}: not four graphs")
    check(seen == want == expect == eager_launches,
          f"{tag}: replays ran {seen}, captures recorded {want}, the "
          f"eager run counted {eager_launches}, expected {expect}")
    check(d_plain is None or d_plain <= STREAM_PLAIN_MAX,
          f"{tag}: kernel stream != plain stream ({d_plain})")
    out["shapes"][tag] = shapes
    return eng, bs


def drive_server(out: dict, card: str, tag: str, model, cfg, sessions: int,
                 cohorts_list, reset_lanes=(1,), reset_at=None) -> dict:
    """The server of ``model`` over ``sessions`` lanes of the voiced
    pattern for ``SERVE_STEPS`` steps at each refresh-cohort count of
    ``cohorts_list``: graphed and counted (the launch counts set to 0 just
    before the server is built), eager (recording the kernels' arguments),
    plain, lanes against dedicated engines, ``reset_lanes`` reset at step
    ``reset_at`` (default ``SERVE_STEPS * 3 // 7``) against fresh engines
    and the graphed reset run bitwise against an eager one, step times.
    Returns the launches by shape per cohort count."""
    import torch
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.runtime import MultiStreamInference
    from koemorph_tpu_torch.runtime.streaming import StreamingInference
    k = cfg.emotion_update_frames
    lanes = lane_audio(sessions, SERVE_STEPS)

    def steps(srv, first=0, n=SERVE_STEPS):
        return torch.stack([srv.step(lanes[:, (first + i) * HOP:
                                           (first + i + 1) * HOP])
                            for i in range(n)])

    res = {}
    for g in cohorts_list:
        profiled(lambda: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        srv = MultiStreamInference(model, cfg, sessions,
                                   refresh_cohorts=g)
        srv.warmup()
        box = []
        seen, want = replayed_launches(srv.step_graphs, in_windows(
            SERVE_STEPS,
            lambda lo, hi: box.append(steps(srv, lo, hi - lo))))
        launches, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
        o = torch.cat(box).cpu().numpy()
        ref = MultiStreamInference(model, cfg, sessions,
                                   refresh_cohorts=g, graphs=False)
        before = ck.launches()
        with recording_kernels(out["rec"], f"{tag} G={g}"):
            eager_o = steps(ref).cpu().numpy()
        eager_launches = {name: ck.launches().get(name, 0)
                          - before.get(name, 0) for name in KERNEL_PATTERNS}
        with plain_forms():
            before = ck.launches()
            plain_o = steps(MultiStreamInference(
                model, cfg, sessions, refresh_cohorts=g,
                graphs=False)).cpu().numpy()
            check(ck.launches() == before,
                  f"{tag}: the plain server launched a kernel")
        d_lanes = {}
        for lane in sorted({0, 1, g - 1, sessions - 1}):
            eng = StreamingInference(model, cfg)
            eng.state.frame_count = srv.phases[lane % g]
            d_lanes[lane] = float(np.abs(
                o[:, lane] - np.stack(eng.process_audio(lanes[lane])))
                .max())
        # lane resets mid-run against fresh engines at their clocks
        half = SERVE_STEPS * 3 // 7 if reset_at is None else reset_at

        def reset_run(graphs=None):
            rs = MultiStreamInference(model, cfg, sessions,
                                      refresh_cohorts=g, graphs=graphs)
            first = steps(rs, n=half)
            rs.reset_sessions(list(reset_lanes))
            second = steps(rs, first=half, n=SERVE_STEPS - half)
            return torch.cat([first, second]).cpu().numpy()

        o_r = reset_run()
        d_fresh = 0.0
        for lane_r in reset_lanes:
            fresh = StreamingInference(model, cfg)
            fresh.state.frame_count = srv.phases[lane_r % g] + half
            d_fresh = max(d_fresh, float(np.abs(
                o_r[half:, lane_r] - np.stack(fresh.process_audio(
                    lanes[lane_r, half * HOP:]))).max()))
        others = [i for i in range(sessions) if i not in reset_lanes]
        d_others = float(np.abs(o_r[:, others] - o[:, others]).max())
        reset_bitwise = bool(np.array_equal(o_r, reset_run(graphs=False)))
        srv_t = MultiStreamInference(model, cfg, sessions,
                                     refresh_cohorts=g)
        srv_t.warmup()
        due = []

        def timed(i):
            due.append(bool(srv_t.due_cohorts()))
            return srv_t.step(lanes[:, i * HOP:(i + 1) * HOP])

        times = _step_times(timed, SERVE_STEPS, lambda i: due[i])
        peak = torch.cuda.max_memory_allocated() / 1e9
        refreshing = sum(len(range(-p % k, SERVE_STEPS, k))
                         for p in srv.phases)
        k1, k2 = refresh_launches(cfg)
        expect = {"cycle_dsum": k1 * refreshing, "dk_roots": k2 * refreshing,
                  "logmel": SERVE_STEPS,
                  "linear_3xtf32": linear_launches(cfg) * refreshing}
        emit({"phase": tag, "card": card, "sessions": sessions,
              "refresh_cohorts": g, "phases": list(srv.phases),
              "steps": SERVE_STEPS,
              "refreshing_cohort_steps": refreshing,
              "finite": bool(np.isfinite(o).all()),
              "launches": launches,
              "launches_by_shape": {f"{a}{list(b)}": v
                                    for (a, b), v in shapes.items()},
              "replayed_launches_profiled": seen,
              "replayed_launches_recorded": want,
              "eager_launches_counted": eager_launches,
              "graphs": graph_info(srv.step_graphs),
              "graphed_bitwise_equal_eager": bool(
                  np.array_equal(o, eager_o)),
              "max_abs_diff_plain": float(np.abs(plain_o - o).max()),
              "max_abs_diff_lane_vs_engine": d_lanes,
              "reset_lanes": list(reset_lanes), "reset_at": half,
              "reset_lane_vs_fresh_engine": d_fresh,
              "reset_other_lanes_moved": d_others,
              "reset_graphed_bitwise_equal_eager": reset_bitwise,
              "step_times": times, "peak_memory_gb": peak})
        check(o.shape == (SERVE_STEPS, sessions, 52)
              and bool(np.isfinite(o).all()) and o.min() >= 0
              and o.max() <= 1, f"{tag} G={g}: output")
        check(np.array_equal(o, eager_o), f"{tag} G={g}: graphed != eager")
        check(len(srv.step_graphs) == 2 * (g + 1),
              f"{tag} G={g}: {len(srv.step_graphs)} graphs")
        check(seen == want == expect == eager_launches,
              f"{tag} G={g}: replays ran {seen}, captures recorded "
              f"{want}, the eager run counted {eager_launches}, expected "
              f"{expect}")
        check(float(np.abs(plain_o - o).max()) <= SERVE_PLAIN_MAX,
              f"{tag} G={g}: kernel server != plain server")
        check(max(d_lanes.values()) <= SERVE_LANE_MAX,
              f"{tag} G={g}: lanes vs engines {d_lanes}")
        check(d_fresh <= SERVE_LANE_MAX and d_others <= SERVE_UNTOUCHED_MAX,
              f"{tag} G={g}: reset {d_fresh}, others {d_others}")
        check(reset_bitwise,
              f"{tag} G={g}: the graphed reset run != the eager one")
        res[g] = shapes
        del srv, ref, srv_t
    out["shapes"][tag] = res
    return res


def slice8_phases(card: str, work: Path, env: dict, synth: Path) -> dict:
    """The configurations without the LLD ring and the emotion2vec
    backend on every path, each driven through its entry points with the
    launch counts set to 0 just before, graphed and held bit for bit
    against the same path run eagerly (whose kernels' arguments are
    recorded), then with the plain forms: ``stream_basic``,
    ``stream_full_ring``, ``stream_e2v`` (and the encoder against float64
    on the card), ``stream_e2v_large``, ``multistream_basic``,
    ``multistream_e2v``, ``decode_e2v``, ``train_e2v``, and the ``rt`` /
    ``serve`` CLIs with ``--emotion-backend basic``. Returns the recorded
    kernel arguments and launch counts for the kernels table."""
    import copy
    import dataclasses
    import itertools
    import torch
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.data.wav import write_wav
    from koemorph_tpu_torch.features import wav2vec2 as w2v
    from koemorph_tpu_torch.models import dual_stream_model as dm
    from koemorph_tpu_torch.models.losses import sequence_koemorph_loss
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import frontend
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    from koemorph_tpu_torch.runtime.engine import build_streaming_model
    from koemorph_tpu_torch.runtime.streaming import StreamingInference
    from koemorph_tpu_torch.train.__main__ import build_model
    from koemorph_tpu_torch.train.trainer import (SequentialTrainer,
                                                  dropout_generator,
                                                  sequence_targets)
    from koemorph_tpu_torch.utils.config import load_config, to_dict

    out: dict = {"rec": {}, "shapes": {}}

    # ---- stream_basic, stream_full_ring ----
    model_b, cfg_b = build_streaming_model(emotion_backend="basic", seed=0)
    drive_stream(out, card, "stream_basic", model_b, cfg_b)
    model_f, cfg_f = build_streaming_model(seed=0)
    cfg_f = dataclasses.replace(cfg_f, incremental_lld=False)
    drive_stream(out, card, "stream_full_ring", model_f, cfg_f)
    rows_f = 1 + (cfg_f.emotion_context_samples - 512) // 160
    for n in (512, 1024):
        (frames_a, st, tau, off), kw = out["rec"][
            ("cycle_dsum", "stream_full_ring", (rows_f, n))]
        got = ck.cycle_dsum(frames_a, st, tau, off, **kw)
        want = f0_ops.cycle_dsum_plain(frames_a, st, tau, off, **kw)
        err = (got - want).abs()
        ok = bool((err <= K1_ATOL + K1_RTOL * want.abs()).all()
                  and torch.equal(got.isnan(), want.isnan()))
        emit({"phase": "cycle_dsum", "card": card,
              "shape": f"full-ring args n{n} x{rows_f}",
              "frames": list(frames_a.shape),
              "strides": list(frames_a.stride()),
              "max_abs_err": float(err.max()), "ok": ok})
        check(ok, f"cycle_dsum disagrees with plain on the full-ring "
              f"refresh's n{n} arguments")
    # K2 on the full-ring refresh's rows, held where the plain form
    # converges (as on the training rows); the rows where it does not are
    # counted: the context's zero prefill (17 of its 20.6 s after 3.5 s of
    # audio) gives polynomials with every root at 0, and the audio's
    # noise-only pauses clustered roots, where 20 iterations converge in
    # no form
    (a_f,), _ = out["rec"][("dk_roots", "stream_full_ring", rows_f)]
    (frames_f, *_), _ = out["rec"][
        ("cycle_dsum", "stream_full_ring", (rows_f, 512))]
    r_f = dk_train_agreement(a_f)
    emit({"phase": "dk_roots", "card": card, "args": "full-ring refresh",
          "silent_rows": int((frames_f == 0).all(-1).sum()), **r_f})
    check(r_f["hausdorff_median"] < DK_MEDIAN_MAX
          and r_f["misses"] <= r_f["miss_bound"],
          f"dk_roots on the full-ring refresh: {r_f}")
    out["rows_full_ring"] = rows_f
    out["dk_full_ring"] = r_f
    del model_f

    # ---- stream_e2v: cuDNN's TF32 flag at PyTorch's default (on); the
    # encoder's scoped flags keep its convolutions in fp32 ----
    torch.backends.cudnn.allow_tf32 = True
    model_e, cfg_e = build_streaming_model(emotion_backend="emotion2vec",
                                           seed=0)
    eng_e, _ = drive_stream(out, card, "stream_e2v", model_e, cfg_e)
    ctx = eng_e.state.audio_ring[-cfg_e.emotion_context_samples:][None]
    enc64 = copy.deepcopy(model_e.emotion2vec).double()
    with torch.inference_mode():
        k4_before = ck.launches()["linear_3xtf32"]
        v32 = model_e.encode_emotion(ctx).double()
        k4 = ck.launches()["linear_3xtf32"] - k4_before
        with plain_forms():
            v32_plain = model_e.encode_emotion(ctx).double()
        v64 = enc64(ctx.double()).mean(-2)
    rel = float((v32 - v64).abs().max() / v64.abs().max())
    rel_plain = float((v32_plain - v64).abs().max() / v64.abs().max())
    emit({"phase": "stream_e2v_float64", "card": card,
          "context_samples": int(ctx.shape[-1]),
          "encoder_frames": cfg_e.emotion2vec_config.frames(ctx.shape[-1]),
          "global_cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "linear_3xtf32_launches": k4,
          "max_abs_diff_over_max": rel,
          "max_abs_diff_over_max_plain": rel_plain, "bound": 1e-5})
    check(rel <= 1e-5, f"encoder vs float64: {rel} of the largest element")
    check(k4 == linear_launches(cfg_e),
          f"the encoder launched linear_3xtf32 {k4} times")
    del enc64, eng_e

    # ---- stream_e2v_large: the 24-layer config through the HF loader ----
    big = w2v.Wav2Vec2Config()
    gen = torch.Generator().manual_seed(5)
    hf = {}
    with torch.device("meta"):
        meta_sd = w2v.Wav2Vec2Encoder(big).state_dict()
    for k, v in meta_sd.items():
        if k == "layer_fusion_weights":
            continue
        if k.endswith("bias"):
            t = torch.zeros(v.shape)
        elif v.dim() == 1:
            t = torch.ones(v.shape)
        else:
            t = torch.randn(v.shape, generator=gen) / np.sqrt(v[0].numel())
        hf[f"wav2vec2.{k}"] = t
    pos = "wav2vec2.encoder.pos_conv_embed.conv"
    hf[f"{pos}.weight_v"] = hf.pop(f"{pos}.weight")
    hf[f"{pos}.weight_g"] = torch.rand((1, 1, big.num_conv_pos_embeddings),
                                       generator=gen) + 0.5
    ckpt = work / "w2v_large"
    ckpt.mkdir(parents=True, exist_ok=True)
    (ckpt / "config.json").write_text(json.dumps(dict(
        dataclasses.asdict(big), conv_dim=list(big.conv_dim),
        conv_stride=list(big.conv_stride), conv_kernel=list(big.conv_kernel))))
    t0 = time.perf_counter()
    torch.save(hf, ckpt / "pytorch_model.bin")
    del hf
    big_cfg, big_sd = w2v.load_hf_checkpoint(ckpt)
    load_s = time.perf_counter() - t0
    model_l, cfg_l = build_streaming_model(
        emotion_backend="emotion2vec", emotion2vec_config=big_cfg, seed=0,
        device="cpu")
    model_l.emotion2vec.load_state_dict(big_sd)
    del big_sd
    eng_l, _ = drive_stream(out, card, "stream_e2v_large", model_l, cfg_l,
                            plain=False)
    # the 24-layer encoder's vector, K4 and the plain form, against float64
    ctx = eng_l.state.audio_ring[-cfg_l.emotion_context_samples:][None]
    enc64 = copy.deepcopy(model_l.emotion2vec).double()
    with torch.inference_mode():
        v32 = model_l.encode_emotion(ctx).double()
        with plain_forms():
            v32_plain = model_l.encode_emotion(ctx).double()
        v64 = enc64(ctx.double()).mean(-2)
    rel_l = float((v32 - v64).abs().max() / v64.abs().max())
    rel_l_plain = float((v32_plain - v64).abs().max() / v64.abs().max())
    del enc64
    emit({"phase": "stream_e2v_large_load", "card": card,
          "layers": big_cfg.num_hidden_layers,
          "encoder_params": sum(p.numel()
                                for p in model_l.emotion2vec.parameters()),
          "write_and_load_s": load_s,
          "float64_max_abs_diff_over_max": rel_l,
          "float64_max_abs_diff_over_max_plain": rel_l_plain})
    # K4 within twice the plain form's own distance from float64 (the
    # logmel rule): 24 random layers put the plain form itself at ~8e-6
    check(rel_l <= max(1e-5, 2.0 * rel_l_plain),
          f"the 24-layer encoder vs float64: {rel_l} (plain {rel_l_plain})")
    del eng_l, model_l
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    # ---- multistream_basic (64 sessions, G = 1, 8), multistream_e2v (16
    # sessions, G = 8) ----
    drive_server(out, card, "multistream_basic", model_b, cfg_b, SERVE_S,
                 (1, 8))
    drive_server(out, card, "multistream_e2v", model_e, cfg_e, 16, (8,))
    torch.cuda.empty_cache()

    # ---- decode_e2v: 8 x 17.06 s through the in-model encoder ----
    audio_b = torch.from_numpy(np.stack([
        voiced_audio(DECODE_LEN / SR, seed=s)
        for s in range(1, DECODE_B + 1)])).cuda()
    dec_model = dm.SequentialDualStreamModel(
        d_model=256, num_heads=8, emotion_backend="emotion2vec",
        use_concatenation=False, stride_frames=DECODE_STRIDE)
    dec_model.init_random(torch.Generator().manual_seed(0))
    ck.reset_launch_counts()
    dec = BatchedSequentialDecoder(dec_model)
    dec(audio_b)
    box = []
    seen, want = replayed_launches(dec.step_graphs,
                                   [lambda: box.append(dec(audio_b))])
    dec_launches = ck.launches()
    out["shapes"]["decode_e2v"] = dict(ck.SHAPE_LAUNCHES)
    o = box[0].cpu().numpy()
    eager_dec = BatchedSequentialDecoder(dec.model, graphs=False)
    with recording_kernels(out["rec"], "decode_e2v"):
        eager_o = eager_dec(audio_b).cpu().numpy()
    with plain_forms(), torch.inference_mode():
        plain_o = eager_dec(audio_b).cpu().numpy()
    ms = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        dec(audio_b)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    with torch.inference_mode():
        enc_ms = time_ms(lambda: dec.model.emotion_raw(audio_b), iters=3,
                         warmup=1)
    n_out = o.shape[1]
    emit({"phase": "decode_e2v", "card": card, "shape": list(o.shape),
          "finite": bool(np.isfinite(o).all()), "launches": dec_launches,
          "replayed_launches_profiled": seen,
          "replayed_launches_recorded": want,
          "graphed_bitwise_equal_eager": bool(np.array_equal(o, eager_o)),
          "max_abs_diff_plain": float(np.abs(plain_o - o).max()),
          "device_ms_per_call": ms, "ms_per_call_median": float(np.median(ms)),
          "frames_per_s": DECODE_B * n_out / (np.median(ms) / 1e3),
          "encoder_ms": enc_ms})
    check(o.shape == (DECODE_B, n_out, 52) and bool(np.isfinite(o).all()),
          "decode_e2v output")
    check(np.array_equal(o, eager_o), "decode_e2v: graphed != eager")
    k4 = 1 + 4 * dec_model.emotion2vec.cfg.num_hidden_layers
    check(seen == want == {"cycle_dsum": 0, "dk_roots": 0, "logmel": 2,
                           "linear_3xtf32": k4},
          f"decode_e2v: replays {seen}, recorded {want}")
    check(float(np.abs(plain_o - o).max()) <= DECODE_PLAIN_MAX,
          "decode_e2v: kernels != plain")
    del dec, eager_dec, dec_model, audio_b, model_e
    torch.cuda.empty_cache()

    # ---- train_e2v: 6 flagship sequential steps at batch 16 ----
    config_path = ROOT / "configs" / "dual_stream_config.yaml"
    over = ["model.emotion_config.backend=emotion2vec"]
    cfg = load_config(config_path, overrides=over)
    cfg.data.train_data_dir = str(synth)
    batch_size = int(cfg.data.batch_size)
    tcfg = to_dict(cfg)

    def new_trainer(tag, model_cfg=cfg):
        model, _ = build_model(model_cfg)
        loader_fn, dataset = create_sequential_dataloader(
            synth, batch_size=batch_size,
            window_frames=model.window_frames + 32,
            stride_frames=int(cfg.data.stride_frames),
            sample_rate=int(cfg.data.sample_rate),
            target_fps=float(cfg.data.target_fps))
        return SequentialTrainer(
            model, tcfg, work_dir=work / f"train_e2v_{tag}",
            steps_per_epoch=TRAIN_E2V_STEPS,
            span_frames=model.window_frames + 32), loader_fn

    trainer, loader_fn = new_trainer("main")
    model = trainer.model
    check(hasattr(model, "emotion2vec"), "train_e2v: no encoder")
    events, losses = [], []
    real_step = trainer.train_step

    def timed_step(batch):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        metrics = real_step(batch)
        e1.record()
        events.append((e0, e1))
        losses.append(metrics["loss"])
        return metrics

    trainer.train_step = timed_step
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_kernels(out["rec"], "train_e2v"):
        trainer.fit(lambda epoch: itertools.islice(loader_fn(),
                                                   TRAIN_E2V_STEPS),
                    None, max_epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
    out["shapes"]["train_e2v"] = shapes
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.train_step = real_step
    step_ms = np.asarray([a.elapsed_time(b) for a, b in events])
    losses = [float(v) for v in losses]
    moved = [k for k, v in trainer.params.items()
             if bool((v.detach() != before[k]).any())]
    batches = [trainer._prepare(b) for b in itertools.islice(loader_fn(), 3)]
    prof = profiled(lambda: [trainer.train_step(b) for b in batches[:2]])
    ks = device_kernels(None, prof)
    busy_ms = sum(us for _, us in ks) / 1e3 / 2
    names = list(trainer.params)
    split = collections.defaultdict(list)
    for b in batches[:2]:
        model.train()
        gen = dropout_generator(trainer.dropout_seed, trainer.global_step,
                                torch.device("cuda"))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        emo = model.emotion_raw(b["audio"])
        ev[1].record()
        pred = model(b["audio"], emotion_features_raw=emo,
                     generator=gen)["blendshapes"]
        loss, _ = sequence_koemorph_loss(
            pred, sequence_targets(b["blendshapes"], model.window_frames,
                                   model.stride_frames, pred.shape[1]),
            config=trainer.loss_config)
        ev[2].record()
        grads = torch.autograd.grad(loss, list(trainer.params.values()))
        ev[3].record()
        trainer.optimizer.step(dict(zip(names, grads)))
        ev[4].record()
        torch.cuda.synchronize()
        for i, part in enumerate(("emotion2vec encoder forward",
                                  "mel + attention + loss forward",
                                  "backward (encoder included)",
                                  "optimizer")):
            split[part].append(ev[i].elapsed_time(ev[i + 1]))
    split_ms = {k: float(np.median(v)) for k, v in split.items()}
    # the encoder's share of the backward: its parameters' gradients alone
    with torch.enable_grad():
        emo = model.emotion_raw(batches[0]["audio"])
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.autograd.grad(emo.sum(), list(model.emotion2vec.parameters()))
        e1.record()
        torch.cuda.synchronize()
    split_ms["encoder backward alone"] = e0.elapsed_time(e1)
    # what cuDNN's deterministic algorithms cost: 3 steps with cuDNN free
    # to choose (the scoped flags' deterministic=True overridden here),
    # between CUDA events (the resume below needs them)
    real_flags = torch.backends.cudnn.flags

    def steps_ms(deterministic):
        torch.backends.cudnn.flags = lambda **kw: real_flags(
            **dict(kw, deterministic=deterministic))
        try:
            ev = []
            for b in batches[:3]:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                trainer.train_step(b)
                e1.record()
                ev.append((e0, e1))
            torch.cuda.synchronize()
            return [a.elapsed_time(c) for a, c in ev]
        finally:
            torch.backends.cudnn.flags = real_flags

    det_cost = {"free": steps_ms(False), "deterministic": steps_ms(True)}
    span_samples = (model.window_frames + 32) * model.hop_length
    med = float(np.median(step_ms[1:]))
    emit({"phase": "train_e2v", "card": card, "batch": batch_size,
          "span_samples": span_samples, "steps": len(step_ms),
          "first_step_ms": float(step_ms[0]), "step_ms": q(step_ms[1:]),
          "fit_wall_s": wall, "device_busy_ms_per_step": busy_ms,
          "device_busy_share": busy_ms / med, "peak_gb": peak_gb,
          "split_ms": split_ms,
          "encoder_share_of_step": (split_ms["emotion2vec encoder forward"]
                                    + split_ms["encoder backward alone"])
          / med,
          "audio_s_per_step_s": batch_size * span_samples / SR / (med / 1e3),
          "launches": launches,
          "launches_by_shape": {f"{a}{list(b)}": v
                                for (a, b), v in shapes.items()},
          "losses": losses, "params_moved": len(moved),
          "params": len(names),
          "step_ms_cudnn_free_vs_deterministic": det_cost})
    check(len(step_ms) == TRAIN_E2V_STEPS and all(np.isfinite(losses)),
          f"train_e2v: {len(step_ms)} steps, losses {losses}")
    check(launches == {"cycle_dsum": 0, "dk_roots": 0,
                       "logmel": 2 * TRAIN_E2V_STEPS, "linear_3xtf32": 0},
          f"train_e2v launches {launches}")
    check(all(k in moved for k in names if k.startswith("emotion2vec.")
              and not k.endswith("k_proj.bias")),
          "train_e2v: an encoder parameter did not move")

    # loss and every gradient leaf, kernels against plain forms (dropout 0)
    cfg0 = load_config(config_path, overrides=over + [
        "model.dual_stream_attention.dropout=0.0"])
    cfg0.data.train_data_dir = str(synth)
    plain_trainer, _ = new_trainer("plain", cfg0)
    plain_trainer.model.load_state_dict(model.state_dict())
    b = batches[2]

    def loss_grads():
        plain_trainer.model.train()
        loss, _ = plain_trainer.loss_fn(b, dropout_generator(
            0, 0, torch.device("cuda")))
        grads = torch.autograd.grad(
            loss, list(plain_trainer.params.values()), allow_unused=True)
        return float(loss.detach()), {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(plain_trainer.params.items(), grads)}

    loss_k, grads_k = loss_grads()
    with plain_forms():
        before_l = ck.launches()
        loss_p, grads_p = loss_grads()
        check(ck.launches() == before_l, "train_e2v plain launched")
    rel = {}
    for k, gp in grads_p.items():
        scale = float(gp.abs().max())
        d = float((grads_k[k] - gp).abs().max())
        rel[k] = d / scale if scale else d
    # a key bias's gradient is 0 (the softmax cancels it): both forms hold
    # rounding residues there, compared against the largest gradient
    top = max(float(g.abs().max()) for g in grads_p.values())
    zero = {k: rel[k] for k in rel if k.endswith("k_proj.bias")}
    bad = {k: r for k, r in rel.items()
           if (k not in zero and r > TRAIN_PLAIN_GRAD)
           or (k in zero and float((grads_k[k] - grads_p[k]).abs().max())
               > 1e-7 * top)}
    with torch.inference_mode():
        k3_err = {}
        for (name, tag, key), (args, kw) in out["rec"].items():
            if tag == "train_e2v" and name == "logmel":
                got = ck.logmel(*args, **kw)
                want = frontend.frames_to_logmel_plain(*args, **kw)
                err = (got - want).abs()
                k3_err[key] = float(err.max())
                check(bool((err <= K3_ATOL + K3_RTOL * want.abs()).all()),
                      f"train_e2v: logmel T={key} disagrees with plain")
    emit({"phase": "train_e2v_plain", "card": card, "loss_kernels": loss_k,
          "loss_plain": loss_p, "grad_max_rel_diff_by_leaf_top": dict(
              sorted(rel.items(), key=lambda kv: -kv[1])[:8]),
          "leaves": len(rel), "zero_gradient_leaves": len(zero),
          "logmel_max_abs_err_by_T": k3_err,
          "bounds": {"loss_rtol": TRAIN_PLAIN_LOSS_RTOL,
                     "grad": TRAIN_PLAIN_GRAD}})
    check(abs(loss_k - loss_p) <= TRAIN_PLAIN_LOSS_RTOL * abs(loss_p),
          f"train_e2v loss: kernels {loss_k}, plain {loss_p}")
    check(not bad, f"train_e2v gradients: kernels vs plain {bad}")
    check(len(k3_err) == 2, f"train_e2v logmel shapes {sorted(k3_err)}")

    # 2 + 2 resume, bitwise
    four = list(itertools.islice(loader_fn(), 4))

    def by_epoch(epoch):
        return iter(four[2 * epoch: 2 * epoch + 2])

    whole, _ = new_trainer("whole")
    whole.fit(by_epoch, None, max_epochs=2)
    first, _ = new_trainer("split")
    first.fit(by_epoch, None, max_epochs=1)
    resumed, _ = new_trainer("split")
    check(resumed.resume() and resumed.global_step == 2,
          "train_e2v: no checkpoint to resume")
    resumed.fit(by_epoch, None, max_epochs=2)
    diffs = {k: float((p.detach() - resumed.params[k].detach()).abs().max())
             for k, p in whole.params.items()}
    emit({"phase": "train_e2v_resume", "card": card, "steps": 4,
          "bitwise_equal": max(diffs.values()) == 0.0,
          "max_abs_diff": max(diffs.values())})
    check(max(diffs.values()) == 0.0,
          f"train_e2v resumed != uninterrupted: "
          f"{max(diffs, key=diffs.get)}")
    del whole, first, resumed, plain_trainer, trainer, model
    torch.cuda.empty_cache()

    # ---- rt and serve CLIs with --emotion-backend basic ----
    wav = work / "basic.wav"
    write_wav(wav, voiced_audio(3.0, seed=6), SR)
    rt_out, srv_out = work / "rt_basic.jsonl", work / "serve_basic.jsonl"
    procs = run_at_once({
        "rt": [sys.executable, "-m", "koemorph_tpu_torch.rt", "--input",
               str(wav), "--emotion-backend", "basic", "--output", "file",
               "--output-file", str(rt_out), "--no-realtime",
               "--max-frames", "40"],
        "serve": [sys.executable, "-m", "koemorph_tpu_torch.serve",
                  "--replay", str(wav), "--emotion-backend", "basic",
                  "--sessions", "16", "--refresh-cohorts", "8", "--output",
                  "file", "--output-file", str(srv_out), "--no-realtime",
                  "--max-frames", "30"]}, env)
    proc, proc_s = procs["rt"], procs["serve"]
    check(proc.returncode == 0, f"rt basic failed:\n{proc.stderr[-3000:]}")
    rt_rows = np.asarray([json.loads(r)["blendshapes"]
                          for r in rt_out.read_text().splitlines()])
    eng = StreamingInference(model_b, cfg_b)
    from koemorph_tpu_torch.data.wav import read_wav
    wav_audio, _ = read_wav(wav, mono=True)
    want = np.stack(eng.process_audio(wav_audio[:40 * HOP]))
    check(proc_s.returncode == 0,
          f"serve basic failed:\n{proc_s.stderr[-3000:]}")
    srv_rows = [json.loads(r) for r in srv_out.read_text().splitlines()]
    stats = [json.loads(ln)["performance_stats"] for ln in
             proc_s.stdout.splitlines() if "performance_stats" in ln]
    d_rt = (float(np.abs(rt_rows - want).max())
            if rt_rows.shape == want.shape else float("inf"))
    emit({"phase": "cli_basic", "card": card, "rt_rows": len(rt_rows),
          "rt_max_abs_diff_in_process": d_rt, "serve_rows": len(srv_rows),
          "serve_emit_path": stats[-1]["emit_path"] if stats else None,
          "serve_stats": stats[-1] if stats else None})
    check(d_rt == 0.0, f"rt basic differs from the in-process stream: {d_rt}")
    check(len(srv_rows) == 30 * 16 and bool(stats)
          and stats[-1]["emit_path"] == "native"
          and sorted({r["session"] for r in srv_rows}) == list(range(16)),
          "serve basic rows or emit path")
    return out


def run_at_once(cmds: dict, env: dict, timeout: float = 600) -> dict:
    """Run each command of ``cmds`` (name -> argv, from the repository
    root) in its own process, all started together; returns name ->
    ``subprocess.CompletedProcess``. Their output goes through files, so
    no pipe fills while another process is waited for; a process past
    ``timeout`` is killed."""
    import tempfile
    started = {}
    for name, argv in cmds.items():
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        started[name] = (subprocess.Popen(argv, cwd=ROOT, env=env,
                                          stdout=out, stderr=err, text=True),
                         out, err)
    done = {}
    for name, (proc, out, err) in started.items():
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out.seek(0)
        err.seek(0)
        done[name] = subprocess.CompletedProcess(proc.args, proc.returncode,
                                                 out.read(), err.read())
        out.close()
        err.close()
    return done


def run_beside(argv: list, env: dict, fn, timeout: float = 600):
    """Start ``argv`` (from the repository root) in its own process, call
    ``fn()`` in this one meanwhile, then wait for the process; returns
    ``(subprocess.CompletedProcess, fn's result, the process's wall
    seconds)``. The process's output goes through files; past ``timeout``
    it is killed."""
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                            stderr=err, text=True)
    try:
        result = fn()
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    done = subprocess.CompletedProcess(argv, proc.returncode, out.read(),
                                       err.read())
    out.close()
    err.close()
    return done, result, seconds


def _event_ms(fn, n: int) -> list:
    """ms of each of ``n`` calls of ``fn`` between CUDA events, each
    waited for."""
    import torch
    ms = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return ms


#: the LLD channels computed from the LPC roots (K2's output)
ROOT_KEYS = ("formant_freq", "formant_bw", "formant_rel", "h1_a3")


def dk_converged(a, exact=None):
    """Rows of the polynomials ``a (..., 11)`` on which the plain form's
    roots lie within DK_MAX of the float64 roots (``exact``, computed
    when not given), shaped ``a``'s rows."""
    import torch
    from koemorph_tpu_torch.ops import egemaps as eg
    flat = a.reshape(-1, a.shape[-1])
    if exact is None:
        exact = exact_roots(flat)
    plain = eg.poly_roots_plain(flat).to(torch.complex128)
    return (hausdorff(plain, exact) < DK_MAX).reshape(a.shape[:-1])


def _lld_agreement(got: dict, want: dict, converged=None) -> dict:
    """How far the LLDs ``got`` lie from ``want``: the booleans'
    mismatches, and each float channel's largest error beyond ``atol +
    rtol |want|``: rtol = atol = 1e-4, except the channels computed from
    the LPC roots (``ROOT_KEYS``), held as the CPU tests hold formants
    (rtol = atol = 1e-3) on the frames where both keep the same formant
    slots and, given ``converged``, where the plain form's roots converge
    (K2's rule; the others are counted)."""
    import torch
    held = (got["formant_valid"] == want["formant_valid"]).all(-1)
    res = {"formant_slot_flips": float((~held).float().mean())}
    if converged is not None:
        held = held & converged
    res["root_frames_not_held"] = int((~held).sum())
    worst = {}
    for key, w in want.items():
        g = got[key]
        if w.dtype == torch.bool:
            if key != "formant_valid":
                res[f"{key}_mismatches"] = int((g != w).sum())
            continue
        tol = 1e-4
        if key in ROOT_KEYS:
            g, w, tol = g[held], w[held], 1e-3
        excess = (g - w).abs() - (tol + tol * w.abs())
        worst[key] = float(excess.max()) if excess.numel() else 0.0
    res["worst_excess"] = worst
    res["ok"] = (all(v <= 0 for v in worst.values())
                 and all(v == 0 for k, v in res.items()
                         if k.endswith("_mismatches"))
                 and res["formant_slot_flips"] <= 0.01)
    return res


def slice9_phases(card: str) -> dict:
    """The remaining eGeMAPS, F0, frontend and decoder options at flagship
    width, each through its entry points with the launch counts set to 0
    just before: ``stream_frame_level`` and ``multistream_frame_level``
    (``egemaps_per_period=False``: no ``cycle_dsum``; four lanes reset at
    step 50, graphed bitwise against eager), ``decode_frame_level`` beside
    the per-period decode, ``viterbi`` (``compute_llds`` with the Viterbi
    smoother on the decode's 13,624 LLD rows and ``compute_lld_block`` in
    30-row blocks over the stream's 3.5 s, eager, with K1 and K2 on the
    arguments it passed), ``decode_attention``, ``decode_scheduled_graph``
    (graphs of ``decode_scheduled`` and ``decode_sequence_parallel``) and
    ``frontend_variants`` (the torchaudio style and the rfft librosa path
    against float64 on the card). Returns the recorded kernel arguments
    and launch counts for the kernels table."""
    import dataclasses
    import torch
    from koemorph_tpu_torch.models import dual_stream_model as dm
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import frontend
    from koemorph_tpu_torch.ops.mel import power_to_db
    from koemorph_tpu_torch.ops.window import frame_signal
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    from koemorph_tpu_torch.runtime.engine import build_streaming_model

    out: dict = {"rec": {}, "shapes": {}}
    dev = torch.device(DEVICE)

    # ---- stream_frame_level, multistream_frame_level ----
    model_s, cfg_s = build_streaming_model(seed=0)
    cfg_fl = dataclasses.replace(cfg_s, egemaps_per_period=False)
    check(cfg_fl.egemaps_config.per_period_voice_quality is False,
          "the frame-level stream's eGeMAPS config")
    drive_stream(out, card, "stream_frame_level", model_s, cfg_fl)
    (a_s,), _ = out["rec"][("dk_roots", "stream_frame_level", 30)]
    r_s = dk_train_agreement(a_s)
    emit({"phase": "dk_roots", "card": card,
          "args": "frame-level stream refresh", **r_s})
    check(r_s["hausdorff_median"] < DK_MEDIAN_MAX
          and r_s["misses"] <= r_s["miss_bound"],
          f"dk_roots on the frame-level refresh: {r_s}")
    check(not any(k[0] == "cycle_dsum" and k[1] == "stream_frame_level"
                  for k in out["rec"]),
          "the frame-level stream called cycle_dsum")
    drive_server(out, card, "multistream_frame_level", model_s, cfg_fl,
                 SERVE_S, (1, 8),
                 reset_lanes=(0, 1, SERVE_S // 4 + 1, SERVE_S - 1),
                 reset_at=SERVE_STEPS * 10 // 21)
    del model_s
    torch.cuda.empty_cache()

    # ---- decode_frame_level: beside the per-period decode ----
    audio_b = torch.from_numpy(np.stack([
        voiced_audio(DECODE_LEN / SR, seed=s)
        for s in range(1, DECODE_B + 1)])).to(dev)

    def seq_model(**kw):
        m = dm.SequentialDualStreamModel(d_model=256, num_heads=8,
                                         stride_frames=DECODE_STRIDE, **kw)
        m.init_random(torch.Generator().manual_seed(0))
        return m

    m_pp, m_fl = seq_model(), seq_model(egemaps_per_period=False)
    ck.reset_launch_counts()
    dec_fl = BatchedSequentialDecoder(m_fl)
    dec_fl(audio_b)
    box = []
    seen, want = replayed_launches(dec_fl.step_graphs,
                                   [lambda: box.append(dec_fl(audio_b))])
    out["shapes"]["decode_frame_level"] = dict(ck.SHAPE_LAUNCHES)
    fl_launches = ck.launches()
    o_fl = box[0].cpu().numpy()
    eager_fl = BatchedSequentialDecoder(dec_fl.model, graphs=False)
    with recording_kernels(out["rec"], "decode_frame_level"):
        eager_o = eager_fl(audio_b).cpu().numpy()
    with plain_forms(), torch.inference_mode():
        plain_o = eager_fl(audio_b).cpu().numpy()
    dec_pp = BatchedSequentialDecoder(m_pp)
    o_pp = dec_pp(audio_b).cpu().numpy()
    ms = {"per_period": [], "frame_level": []}
    for tag in ("per_period", "frame_level", "frame_level", "per_period"):
        dec = dec_pp if tag == "per_period" else dec_fl
        ms[tag] += _event_ms(lambda: dec(audio_b), 5)
    n_out = o_fl.shape[1]
    med = {k: float(np.median(v)) for k, v in ms.items()}
    emit({"phase": "decode_frame_level", "card": card,
          "shape": list(o_fl.shape), "launches": fl_launches,
          "replayed_launches_profiled": seen,
          "replayed_launches_recorded": want,
          "graphed_bitwise_equal_eager": bool(np.array_equal(o_fl, eager_o)),
          "max_abs_diff_plain": float(np.abs(plain_o - o_fl).max()),
          "max_abs_diff_vs_per_period": float(np.abs(o_fl - o_pp).max()),
          "ms_per_call": ms, "ms_per_call_median": med,
          "frames_per_s": {k: DECODE_B * n_out / (v / 1e3)
                           for k, v in med.items()},
          "frame_level_over_per_period": med["frame_level"]
          / med["per_period"]})
    check(o_fl.shape == (DECODE_B, n_out, 52)
          and bool(np.isfinite(o_fl).all()), "decode_frame_level output")
    check(np.array_equal(o_fl, eager_o), "decode_frame_level: graphed != eager")
    check(seen == want == {"cycle_dsum": 0, "dk_roots": 1, "logmel": 2,
                           "linear_3xtf32": 0},
          f"decode_frame_level: replays {seen}, recorded {want}")
    check(fl_launches.get("cycle_dsum", 0) == 0,
          "decode_frame_level: cycle_dsum was launched")
    check(float(np.abs(plain_o - o_fl).max()) <= DECODE_PLAIN_MAX,
          "decode_frame_level: kernels != plain")
    del eager_fl, dec_fl

    # ---- viterbi: compute_llds on the decode's rows, 30-row blocks over
    # the stream's audio (eager) ----
    cfg_v, cfg_n = eg.EgemapsConfig(f0_smoother="viterbi"), eg.EgemapsConfig()
    audio_s = torch.from_numpy(voiced_audio(3.5, seed=1)).to(dev)
    span = 29 * 160 + 512
    n_blocks = (audio_s.shape[0] - span) // (30 * 160) + 1

    def blocks(cfg):
        carry, rows = eg.silence_lld_carry(cfg, dev), []
        for i in range(n_blocks):
            lld, carry = eg.compute_lld_block(
                audio_s[i * 4800: i * 4800 + span], cfg, carry)
            rows.append(lld)
        return {k: torch.cat([r[k] for r in rows], 0) for k in rows[0]}

    with torch.inference_mode():
        ck.reset_launch_counts()
        with recording_kernels(out["rec"], "viterbi"):
            lld_v = eg.compute_llds(audio_b, cfg_v)
        v_launches, v_shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
        ck.reset_launch_counts()
        with recording_kernels(out["rec"], "viterbi_blocks"):
            blk_v = blocks(cfg_v)
        b_launches = ck.launches()
        with plain_forms():
            before = ck.launches()
            lld_p, blk_p = eg.compute_llds(audio_b, cfg_v), blocks(cfg_v)
            check(ck.launches() == before,
                  "viterbi: the plain forms launched a kernel")
        core_v = f0_ops.yin_core(audio_b, frame_length=512, hop_length=160,
                                 f0_min=55.0, f0_max=500.0, center=False,
                                 smoother="viterbi")
        core_n = f0_ops.yin_core(audio_b, frame_length=512, hop_length=160,
                                 f0_min=55.0, f0_max=500.0, center=False)
        lld_n = eg.compute_llds(audio_b, cfg_n)
        times = {
            "compute_llds_viterbi": _event_ms(
                lambda: eg.compute_llds(audio_b, cfg_v), 3),
            "compute_llds_none": _event_ms(
                lambda: eg.compute_llds(audio_b, cfg_n), 3),
            "yin_viterbi": _event_ms(lambda: f0_ops.yin_core(
                audio_b, frame_length=512, hop_length=160, f0_min=55.0,
                f0_max=500.0, center=False, smoother="viterbi"), 3),
            "yin_none": _event_ms(lambda: f0_ops.yin_core(
                audio_b, frame_length=512, hop_length=160, f0_min=55.0,
                f0_max=500.0, center=False), 3),
            "blocks_viterbi": _event_ms(lambda: blocks(cfg_v), 3),
            "blocks_none": _event_ms(lambda: blocks(cfg_n), 3)}
        acts = {k: len(device_kernels(fn)) for k, fn in (
            ("compute_llds_viterbi", lambda: eg.compute_llds(audio_b, cfg_v)),
            ("compute_llds_none", lambda: eg.compute_llds(audio_b, cfg_n)),
            ("blocks_viterbi", lambda: blocks(cfg_v)),
            ("blocks_none", lambda: blocks(cfg_n)))}
    rows_v = int(lld_v["voiced"].numel())
    (a_v,), _ = out["rec"][("dk_roots", "viterbi", rows_v)]
    with torch.inference_mode():
        exact_v = exact_roots(a_v.reshape(-1, a_v.shape[-1]))
        conv_v = dk_converged(a_v, exact_v).reshape(lld_v["voiced"].shape)
    agree = _lld_agreement(lld_v, lld_p, conv_v)
    agree_b = _lld_agreement(blk_v, blk_p)
    k1_held = {}
    for n in (512, 1024):
        (frames_a, st, tau, off), kw = out["rec"][
            ("cycle_dsum", "viterbi", (rows_v, n))]
        with torch.inference_mode():
            got = ck.cycle_dsum(frames_a, st, tau, off, **kw)
            want_k = f0_ops.cycle_dsum_plain(frames_a, st, tau, off, **kw)
        err = (got - want_k).abs()
        k1_held[n] = {"max_abs_err": float(err.max()), "ok": bool(
            (err <= K1_ATOL + K1_RTOL * want_k.abs()).all()
            and torch.equal(got.isnan(), want_k.isnan()))}
    r_v = dk_train_agreement(a_v, exact_v)
    med_t = {k: float(np.median(v)) for k, v in times.items()}
    picks_differ = float((core_v.pick != core_n.pick).float().mean())
    emit({"phase": "viterbi", "card": card, "lld_rows": rows_v,
          "block_rows": 30, "blocks": n_blocks,
          "launches": v_launches, "launches_blocks": b_launches,
          "launches_by_shape": {f"{a}{list(b)}": c
                                for (a, b), c in v_shapes.items()},
          "ms": times, "ms_median": med_t,
          "device_activities": acts,
          "share_of_frames_viterbi_moves": picks_differ,
          "voiced_share": {"viterbi": float(lld_v["voiced"].float().mean()),
                           "none": float(lld_n["voiced"].float().mean())},
          "kernels_vs_plain": agree, "blocks_kernels_vs_plain": agree_b,
          "cycle_dsum_on_its_args": k1_held, "dk_roots_on_its_args": r_v})
    check(v_launches.get("cycle_dsum") == 2
          and v_launches.get("dk_roots") == 1
          and not v_launches.get("logmel"),
          f"viterbi compute_llds launches {v_launches}")
    check(b_launches.get("cycle_dsum") == 2 * n_blocks
          and b_launches.get("dk_roots") == n_blocks,
          f"viterbi blocks launches {b_launches}")
    check(torch.equal(lld_v["f0_hz"], lld_p["f0_hz"])
          and torch.equal(lld_v["voiced"], lld_p["voiced"])
          and torch.equal(blk_v["f0_hz"], blk_p["f0_hz"]),
          "viterbi: the picks with kernels differ from the plain forms'")
    check(agree["ok"] and agree_b["ok"],
          f"viterbi LLDs with kernels vs plain: {agree} {agree_b}")
    check(all(v["ok"] for v in k1_held.values()),
          f"cycle_dsum on the viterbi arguments: {k1_held}")
    check(r_v["hausdorff_median"] < DK_MEDIAN_MAX
          and r_v["misses"] <= r_v["miss_bound"],
          f"dk_roots on the viterbi arguments: {r_v}")
    check(picks_differ > 0, "the viterbi path picked as plain YIN")
    out["rows_viterbi"] = rows_v
    out["shapes"]["viterbi"] = v_shapes
    del lld_v, lld_p, lld_n, core_v, core_n

    # ---- decode_attention ----
    eager_pp = BatchedSequentialDecoder(dec_pp.model, graphs=False)
    with torch.inference_mode():
        plain_bs = eager_pp(audio_b)
    att = dec_pp(audio_b, return_attention=True)
    att_ms = _event_ms(lambda: dec_pp(audio_b, return_attention=True), 3)
    mw, ew = att["mel_attention_weights"], att["emotion_attention_weights"]
    row_err = max(float((mw.sum(-1) - 1).abs().max()),
                  float((ew.sum(-1) - 1).abs().max()))
    emit({"phase": "decode_attention", "card": card,
          "mel_attention_weights": list(mw.shape),
          "emotion_attention_weights": list(ew.shape),
          "row_sum_max_err": row_err,
          "blendshapes_bitwise_equal": bool(torch.equal(att["blendshapes"],
                                                        plain_bs)),
          "graphed_equals_eager": bool(np.array_equal(o_pp,
                                                      plain_bs.cpu().numpy())),
          "ms_per_call": att_ms,
          "ms_per_call_median": float(np.median(att_ms)),
          "ms_per_call_without_graphed": med["per_period"]})
    check(list(mw.shape) == [DECODE_B, n_out, 28, 80]
          and list(ew.shape) == [DECODE_B, n_out, 24, 1],
          "decode_attention shapes")
    check(row_err <= 1e-5, f"attention rows sum to 1 within 1e-5: {row_err}")
    check(torch.equal(att["blendshapes"], plain_bs)
          and np.array_equal(o_pp, plain_bs.cpu().numpy()),
          "decode_attention: the blendshapes changed with return_attention")
    del att, mw, ew

    # ---- decode_scheduled_graph ----
    strides = [1, 2, 4, 8] * (DECODE_B // 4)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, r

    first_ms, (sched, mask) = wall_ms(
        lambda: dec_pp.decode_scheduled(audio_b, strides))
    box = []
    seen, want = replayed_launches(dec_pp.step_graphs, [
        lambda: box.append(dec_pp.decode_scheduled(audio_b, strides)[0])])
    sched_ms = _event_ms(lambda: dec_pp.decode_scheduled(audio_b, strides),
                         5)
    eager_sched, eager_mask = eager_pp.decode_scheduled(audio_b, strides)
    one = audio_b[:1]
    seq_first_ms, seq = wall_ms(
        lambda: dec_pp.decode_sequence_parallel(one[0].cpu().numpy()))
    seq_np = one[0].cpu().numpy()
    seq_ms = _event_ms(lambda: dec_pp.decode_sequence_parallel(seq_np), 5)
    eager_seq = eager_pp.decode_sequence_parallel(seq_np)
    call_one = dec_pp(one)[0]
    span_w = DECODE_LEN // HOP - 256
    n_max = span_w + 1
    emit({"phase": "decode_scheduled_graph", "card": card,
          "strides": strides, "windows": mask.sum(1).tolist(),
          "shape": list(sched.shape),
          "graphed_bitwise_equal_eager": bool(torch.equal(sched,
                                                          eager_sched)),
          "replayed_launches_profiled": seen,
          "replayed_launches_recorded": want,
          "first_call_ms": first_ms, "steady_ms": sched_ms,
          "steady_ms_median": float(np.median(sched_ms)),
          "sequence_parallel": {
              "shape": list(seq.shape),
              "graphed_bitwise_equal_eager": bool(torch.equal(seq,
                                                              eager_seq)),
              "bitwise_equal_call": bool(torch.equal(seq, call_one)),
              "max_abs_diff_call": float((seq - call_one).abs().max()),
              "first_call_ms": seq_first_ms, "steady_ms": seq_ms},
          "graphs": graph_info(dec_pp.step_graphs)})
    check(list(sched.shape) == [DECODE_B, n_max, 52]
          and mask.sum(1).tolist() == [span_w // s + 1 for s in strides]
          and np.array_equal(mask, eager_mask), "decode_scheduled shape")
    check(torch.equal(sched, eager_sched) and torch.equal(box[0], sched),
          "decode_scheduled: graphed != eager")
    check(seen == want == {"cycle_dsum": 2, "dk_roots": 1, "logmel": 2,
                           "linear_3xtf32": 0},
          f"decode_scheduled: replays {seen}, recorded {want}")
    check(torch.equal(seq, eager_seq),
          "decode_sequence_parallel: graphed != eager")
    check(torch.equal(seq, call_one),
          "decode_sequence_parallel != __call__ on one device")
    check(len(dec_pp.step_graphs) <= dec_pp.max_graphs, "graphs kept")
    del eager_pp, dec_pp, sched, eager_sched

    # ---- frontend_variants: against float64 on the card ----
    ta = frontend.LogMelFrontend(style="torchaudio", n_fft=512)
    rf = frontend.LogMelFrontend(stft_method="rfft")
    lib = frontend.LogMelFrontend()

    def ref64(cfg):
        x = audio_b.double()
        frames = frame_signal(x, cfg.n_fft, cfg.hop_length)
        n = torch.arange(cfg.n_fft, dtype=torch.float64, device=dev)
        win = 0.5 - 0.5 * torch.cos(2.0 * np.pi * n / cfg.n_fft)
        spec = torch.fft.rfft(frames * win, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        if cfg.style == "torchaudio":
            power = power / (win * win).sum()
        mel = power @ cfg.filterbank(dev).double()
        if cfg.style == "librosa":
            return power_to_db(mel, ref="max", top_db=80.0,
                               ref_axes=(-2, -1))
        log_mel = torch.log(mel + cfg.eps)
        return log_mel[..., : int(x.shape[-1] / SR * cfg.target_fps), :]

    with torch.inference_mode():
        got_ta, want_ta = ta(audio_b).double(), ref64(ta)
        got_rf, want_db = rf(audio_b).double(), ref64(rf)
        got_lib = lib(audio_b).double()
        t_ms = {name: time_ms(lambda c=c: c(audio_b), iters=20)
                for name, c in (("torchaudio", ta), ("rfft", rf),
                                ("librosa_kernel", lib))}
    peak = want_ta.amax(dim=(-2, -1), keepdim=True)
    near = want_ta >= peak - 80.0 * np.log(10.0) / 10.0
    err_ta = (got_ta - want_ta).abs()
    want_norm = (want_db + 80.0) / 80.0
    err_rf = float((got_rf - want_norm).abs().max()) * 80.0
    err_lib = float((got_lib - want_norm).abs().max()) * 80.0
    emit({"phase": "frontend_variants", "card": card,
          "torchaudio": {"shape": list(got_ta.shape), "n_fft": 512,
                         "max_err_ln_within_80db": float(err_ta[near].max()),
                         "bins_within_80db": float(near.double().mean()),
                         "max_err_ln_other_bins": float(err_ta[~near].max())
                         if (~near).any() else None},
          "rfft_librosa": {"shape": list(got_rf.shape),
                           "max_err_db": err_rf},
          "kernel_librosa_max_err_db": err_lib,
          "ms_per_call": t_ms})
    check(got_ta.shape == want_ta.shape
          and bool(torch.isfinite(got_ta).all()), "torchaudio shape")
    check(float(err_ta[near].max()) <= 1e-3,
          f"torchaudio style vs float64: {float(err_ta[near].max())}")
    check(err_rf <= 1e-3, f"rfft librosa path vs float64: {err_rf} dB")
    del audio_b
    torch.cuda.empty_cache()
    return out


def train_phases(card: str, work: Path, env: dict) -> dict:
    """Phase 10: the sequential trainer at flagship width on the card.

    ``train_step`` drives ``SequentialTrainer.fit`` over
    ``create_sequential_dataloader`` (the path ``python -m
    koemorph_tpu_torch.train`` takes) with the launch counts set to 0 just
    before; ``train_plain`` holds one step's loss and gradients against the
    plain forms; ``train_resume`` holds a resumed run against an
    uninterrupted one; ``train_cli`` trains through the CLI in a subprocess
    (``--scan-epochs``: its epochs device-resident on the compiled step)
    and serves what it wrote through ``infer``, ``rt`` and ``serve``.
    Returns the kernels' recorded arguments and launch counts of the
    ``train_step`` run, for the kernels table."""
    import torch
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.data.wav import read_wav, write_wav
    from koemorph_tpu_torch.models import dual_stream_model as dm
    from koemorph_tpu_torch.models.losses import sequence_koemorph_loss
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import egemaps as eg
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import frontend
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    from koemorph_tpu_torch.runtime import MultiStreamInference
    from koemorph_tpu_torch.runtime.engine import build_streaming_model
    from koemorph_tpu_torch.runtime.streaming import StreamingInference
    from koemorph_tpu_torch.serve import _load_replay_lanes
    from koemorph_tpu_torch.train.__main__ import (build_model,
                                                   write_synthetic_dataset)
    from koemorph_tpu_torch.train.checkpoint import load_opt_state
    from koemorph_tpu_torch.train.trainer import (SequentialTrainer,
                                                  dropout_generator,
                                                  sequence_targets)
    from koemorph_tpu_torch.utils.config import load_config, to_dict
    from koemorph_tpu_torch.utils.params import (load_model_state,
                                                 read_state_dict)

    dev = torch.device("cuda")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 matmuls are on; the trainer runs in full fp32")
    config_path = ROOT / "configs" / "dual_stream_config.yaml"
    cfg = load_config(config_path)
    synth = write_synthetic_dataset(
        work / "train_synth", TRAIN_FILES, duration_s=TRAIN_FILE_S,
        sample_rate=int(cfg.data.sample_rate), fps=float(cfg.data.target_fps))
    cfg.data.train_data_dir = str(synth)
    batch_size = int(cfg.data.batch_size)
    tcfg = to_dict(cfg)

    def new_trainer(tag, model_cfg=cfg):
        model, kind = build_model(model_cfg)
        check(kind == "sequence", f"the config's model is {kind}")
        loader_fn, dataset = create_sequential_dataloader(
            synth, batch_size=batch_size,
            window_frames=model.window_frames + 32,
            stride_frames=int(cfg.data.stride_frames),
            sample_rate=int(cfg.data.sample_rate),
            target_fps=float(cfg.data.target_fps))
        steps = dataset.get_num_windows() // batch_size
        trainer = SequentialTrainer(
            model, tcfg, work_dir=work / f"train_{tag}",
            steps_per_epoch=steps, span_frames=model.window_frames + 32)
        return trainer, loader_fn, steps

    trainer, loader_fn, n_steps = new_trainer("main")
    model = trainer.model
    att = model.dual_stream_attention
    span_samples = (model.window_frames + 32) * model.hop_length
    n_windows = 32 // model.stride_frames + 1                          # 33
    t_global = batch_size * (span_samples // model.hop_length + 1)
    t_edges = batch_size * n_windows * 2
    lld_rows = batch_size * (1 + (span_samples - 512) // 160)
    check(n_steps == 12 and att.mel_attention.attn_dropout.rate == 0.1,
          f"train config: {n_steps} steps, dropout "
          f"{att.mel_attention.attn_dropout.rate}")

    # ---- train_step: the main path, counted ----
    events, losses = [], []
    real_step = trainer.train_step

    def timed_step(batch):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        metrics = real_step(batch)
        e1.record()
        events.append((e0, e1))
        losses.append(metrics["loss"])
        return metrics

    trainer.train_step = timed_step
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    train_rec: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_kernels(train_rec, "train"):
        history = trainer.fit(lambda epoch: loader_fn(), None, max_epochs=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer.train_step = real_step
    step_ms = np.asarray([a.elapsed_time(b) for a, b in events])
    losses = [float(v) for v in losses]
    moved = {k: bool((v.detach() != before[k]).any())
             for k, v in trainer.params.items()}

    # the same path profiled over two more steps (a lead-in first), and
    # the step split into its parts between CUDA events
    batches = [trainer._prepare(b) for b in list(loader_fn())[:4]]
    prof = profiled(lambda: [trainer.train_step(b) for b in batches[:2]])
    ks = device_kernels(None, prof)
    busy_ms = sum(us for _, us in ks) / 1e3 / 2
    own = {k: v / KERNELS_PER_LAUNCH[k]
           for k, v in own_kernels(ks, 2).items()}
    names = list(trainer.params)
    split = collections.defaultdict(list)
    zero_grad = dict.fromkeys(names, True)
    for b in batches[:3]:
        model.train()
        gen = dropout_generator(trainer.dropout_seed, trainer.global_step,
                                dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        emo = model.emotion_raw(b["audio"])
        ev[1].record()
        pred = model(b["audio"], emotion_features_raw=emo,
                     generator=gen)["blendshapes"]
        loss, _ = sequence_koemorph_loss(
            pred, sequence_targets(b["blendshapes"], model.window_frames,
                                   model.stride_frames, pred.shape[1]),
            config=trainer.loss_config)
        ev[2].record()
        grads = torch.autograd.grad(loss, list(trainer.params.values()))
        ev[3].record()
        trainer.optimizer.step(dict(zip(names, grads)))
        ev[4].record()
        torch.cuda.synchronize()
        for k, g in zip(names, grads):
            zero_grad[k] &= bool((g == 0).all())
        for i, part in enumerate(("emotion features forward (eGeMAPS)",
                                  "mel + attention + loss forward",
                                  "backward", "optimizer")):
            split[part].append(ev[i].elapsed_time(ev[i + 1]))
    split_ms = {k: float(np.median(v)) for k, v in split.items()}
    audio_s = batch_size * span_samples / SR
    emit({"phase": "train_step", "card": card, "batch": batch_size,
          "span_samples": span_samples, "windows_per_sample": n_windows,
          "steps": len(step_ms), "first_step_ms": float(step_ms[0]),
          "step_ms": q(step_ms[1:]), "fit_wall_s": wall,
          "audio_s_per_wall_s": len(step_ms) * audio_s / wall,
          "audio_s_per_step_s": audio_s / (np.median(step_ms[1:]) / 1e3),
          "activities_per_step": len(ks) / 2,
          "device_busy_ms_per_step": busy_ms,
          "device_busy_share": busy_ms / float(np.median(step_ms[1:])),
          "profiled_wall_ms_per_step": prof.wall_s * 1e3 / 2,
          "peak_gb": peak_gb, "split_ms": split_ms,
          "launches": launches,
          "launches_per_step": {k: v / len(step_ms)
                                for k, v in launches.items()},
          "launches_by_shape": {f"{k[0]}{list(k[1])}": v
                                for k, v in shapes.items()},
          "profiled_kernels_per_step": own,
          "top_kernels_us_per_step": profile_summary(ks, 2, top_n=10),
          "losses": losses, "train_metrics": history["train"][0],
          "lld_rows": lld_rows, "logmel_T": [t_global, t_edges],
          "params_not_moved": [k for k, m in moved.items() if not m],
          "params_with_zero_gradient": [k for k, z in zero_grad.items()
                                        if z]})
    check(len(step_ms) == n_steps, f"fit ran {len(step_ms)} steps")
    check(all(np.isfinite(losses)), f"non-finite train losses: {losses}")
    # the expression queries get no gradient: their attention has one key
    # (the emotion token), so its softmax is 1 whatever the queries
    check(all(moved[k] for k in names if not zero_grad[k]),
          f"trained parameters did not move: {moved}")
    check(launches == {"cycle_dsum": 2 * n_steps, "dk_roots": n_steps,
                       "logmel": 2 * n_steps, "linear_3xtf32": 0},
          f"train launches {launches} for {n_steps} steps")
    for key in (("logmel", (t_global,)), ("logmel", (t_edges,)),
                ("cycle_dsum", (lld_rows, 8, 17, 512)),
                ("cycle_dsum", (lld_rows, 5, 33, 1024)),
                ("dk_roots", (lld_rows,))):
        check(shapes.get(key, 0) == n_steps,
              f"train: {key} launched {shapes.get(key, 0)} times")
    check(own == {"cycle_dsum": 2.0, "dk_roots": 1.0, "logmel": 2.0,
                  "linear_3xtf32": 0.0},
          f"profiled kernels per step: {own}")

    # ---- train_plain: one batch, the same parameters, dropout 0 ----
    cfg0 = load_config(config_path, overrides=[
        "model.dual_stream_attention.dropout=0.0"])
    plain_trainer, _, _ = new_trainer("plain", cfg0)
    plain_trainer.model.load_state_dict(model.state_dict())
    b = batches[3]

    def loss_grads():
        plain_trainer.model.train()
        loss, _ = plain_trainer.loss_fn(b, dropout_generator(0, 0, dev))
        grads = torch.autograd.grad(
            loss, list(plain_trainer.params.values()), allow_unused=True)
        return float(loss.detach()), {k: (torch.zeros_like(p) if g is None
                                          else g)
                             for (k, p), g in zip(
                                 plain_trainer.params.items(), grads)}

    before_launch = ck.launches()
    loss_k, grads_k = loss_grads()
    check(ck.launches() != before_launch, "the kernel step launched "
          "no kernel")
    with plain_forms():
        before_launch = ck.launches()
        loss_p, grads_p = loss_grads()
        check(ck.launches() == before_launch, "the plain step launched "
              "a kernel")
    rel = {}
    for k, gp in grads_p.items():
        scale = float(gp.abs().max())
        rel[k] = float((grads_k[k] - gp).abs().max()) / scale if scale \
            else float((grads_k[k] - gp).abs().max())
    bad = {k: r for k, r in rel.items() if r > TRAIN_PLAIN_GRAD}
    # each kernel against its plain form on the arguments the train step
    # passed it, by the rules of phases 3-5
    kernel_err, kernel_ok = {}, {}
    with torch.inference_mode():
        for (name, tag, key), (args, kw) in sorted(
                train_rec.items(), key=lambda kv: str(kv[0])):
            if name == "cycle_dsum":
                label = f"cycle_dsum n{key[1]} x{key[0]}"
                got = ck.cycle_dsum(*args, **kw)
                want = f0_ops.cycle_dsum_plain(*args, **kw)
                err = (got - want).abs()
                kernel_ok[label] = bool(
                    (err <= K1_ATOL + K1_RTOL * want.abs()).all()
                    and torch.equal(got.isnan(), want.isnan()))
                kernel_err[label] = float(err.max())
            elif name == "dk_roots":
                label = f"dk_roots x{key}"
                kernel_err[label] = dk_train_agreement(args[0])
                kernel_ok[label] = dk_train_ok(kernel_err[label])
            elif name == "logmel":
                label = f"logmel T={key}"
                got = ck.logmel(*args, **kw)
                want = frontend.frames_to_logmel_plain(*args, **kw)
                err = (got - want).abs()
                kernel_ok[label] = bool(
                    (err <= K3_ATOL + K3_RTOL * want.abs()).all())
                kernel_err[label] = float(err.max())
    emit({"phase": "train_plain", "loss_kernels": loss_k,
          "loss_plain": loss_p,
          "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
          "grad_max_rel_diff_by_leaf": rel,
          "bounds": {"loss_rtol": TRAIN_PLAIN_LOSS_RTOL,
                     "grad": TRAIN_PLAIN_GRAD},
          "kernel_max_abs_err_train_shapes": kernel_err,
          "kernel_ok_train_shapes": kernel_ok})
    check(abs(loss_k - loss_p) <= TRAIN_PLAIN_LOSS_RTOL * abs(loss_p),
          f"train loss: kernels {loss_k}, plain {loss_p}")
    check(not bad, f"train gradients: kernels vs plain {bad}")
    check(len(kernel_ok) == 5 and all(kernel_ok.values()),
          f"a kernel disagrees with its plain form at the training "
          f"shapes: {kernel_err}")

    # ---- train_resume: 2 steps, save, resume, 2 more vs 4 at once ----
    four = list(loader_fn())[:4]

    def by_epoch(epoch):
        return iter(four[2 * epoch: 2 * epoch + 2])

    whole, _, _ = new_trainer("whole")
    whole.fit(by_epoch, None, max_epochs=2)
    first, _, _ = new_trainer("split")
    first.fit(by_epoch, None, max_epochs=1)
    resumed, _, _ = new_trainer("split")
    check(resumed.resume() and resumed.global_step == 2,
          "the resumed trainer did not find its checkpoint")
    resumed.fit(by_epoch, None, max_epochs=2)
    diffs = {k: float((p.detach() - resumed.params[k].detach()).abs().max())
             for k, p in whole.params.items()}
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    moments_equal = all(torch.equal(sa[m][k], sb[m][k])
                        for m in ("mu", "nu") for k in sa[m])
    emit({"phase": "train_resume", "steps": 4, "dropout": 0.1,
          "bitwise_equal": max(diffs.values()) == 0.0 and moments_equal,
          "max_abs_diff": max(diffs.values()),
          "count": [sa["count"], sb["count"]]})
    check(max(diffs.values()) == 0.0 and moments_equal
          and sa["count"] == sb["count"] == 4,
          f"resumed run != uninterrupted run: {diffs}")
    del whole, first, resumed, plain_trainer

    # ---- train_cli: the CLI on the card, then serve what it wrote ----
    cli_work = work / "train_cli"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.train", "--config",
         str(config_path), "--synthetic", "4", "--max-epochs", "1",
         "--steps-per-epoch", "3", "--scan-epochs", "--work-dir",
         str(cli_work)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    train_cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"train CLI failed:\n{proc.stderr[-3000:]}")
    final = json.loads(proc.stdout.strip().splitlines()[-1])
    last = cli_work / "checkpoints" / "last"
    meta = json.loads((last / "meta.json").read_text())
    opt_count = load_opt_state(last)["optimizer"]["count"]
    check(np.isfinite(final["final_train_metrics"]["loss"])
          and meta["global_step"] == opt_count > 0,
          f"train CLI result: {final}, {meta}")
    sd = read_state_dict(last)

    wav = work / "train_cli.wav"
    write_wav(wav, voiced_audio(10.0, seed=12), SR)
    audio, _ = read_wav(wav, mono=True)
    results = {}
    rt_frames = 40
    sessions, ticks = 4, 24
    outs = {name: work / f"train_cli_{name}.jsonl"
            for name in ("infer", "rt", "serve")}
    # the three served at once, each in its own process
    procs = run_at_once({
        "infer": [sys.executable, "-m", "koemorph_tpu_torch.infer",
                  "--input", str(wav), "--output", str(outs["infer"]),
                  "--model", str(last)],
        "rt": [sys.executable, "-m", "koemorph_tpu_torch.rt", "--input",
               str(wav), "--model", str(last), "--output", "file",
               "--output-file", str(outs["rt"]), "--no-realtime",
               "--max-frames", str(rt_frames)],
        "serve": [sys.executable, "-m", "koemorph_tpu_torch.serve",
                  "--replay", str(wav), "--model", str(last),
                  "--sessions", str(sessions), "--output", "file",
                  "--output-file", str(outs["serve"]), "--no-realtime",
                  "--max-frames", str(ticks)]}, env)
    # infer: the decode of the loaded model, in-process
    out_jsonl = outs["infer"]
    proc = procs["infer"]
    check(proc.returncode == 0, f"infer --model failed:\n"
          f"{proc.stderr[-3000:]}")
    check("random weights" not in proc.stderr, "infer used random weights")
    got = np.asarray([json.loads(r)["blendshapes"]
                      for r in out_jsonl.read_text().splitlines()])
    dec_model = dm.SequentialDualStreamModel(dropout=0.0)
    load_model_state(dec_model, sd)
    usable = (len(audio) // HOP) * HOP
    want = BatchedSequentialDecoder(dec_model)(audio[None, :usable])[0]
    want = want.cpu().numpy().round(6).astype(np.float64)
    results["infer"] = (got.shape, float(np.abs(got - want).max())
                        if got.shape == want.shape else float("inf"))
    # rt: the stream of the loaded model, in-process
    out_jsonl = outs["rt"]
    proc = procs["rt"]
    check(proc.returncode == 0, f"rt --model failed:\n{proc.stderr[-3000:]}")
    got = np.asarray([json.loads(r)["blendshapes"]
                      for r in out_jsonl.read_text().splitlines()])
    s_model, s_cfg = build_streaming_model(checkpoint=str(last))
    eng = StreamingInference(s_model, s_cfg)
    want = np.stack(eng.process_audio(audio[:rt_frames * HOP])).astype(
        np.float64)
    results["rt"] = (got.shape, float(np.abs(got - want).max())
                     if got.shape == want.shape else float("inf"))
    # serve: the server of the loaded model over the same lanes, in-process
    out_jsonl = outs["serve"]
    proc = procs["serve"]
    check(proc.returncode == 0,
          f"serve --model failed:\n{proc.stderr[-3000:]}")
    rows = [json.loads(r) for r in out_jsonl.read_text().splitlines()]
    got = np.asarray([[r["blendshapes"] for r in rows if r["session"] == s]
                      for s in range(sessions)]).transpose(1, 0, 2)
    lanes = _load_replay_lanes([str(wav)], sessions, SR, HOP)
    srv = MultiStreamInference(s_model, s_cfg, sessions)
    want = np.stack([srv.step(lanes[:, t * HOP:(t + 1) * HOP]).cpu().numpy()
                     for t in range(ticks)]).astype(np.float64)
    results["serve"] = (got.shape, float(np.abs(got - want).max())
                        if got.shape == want.shape else float("inf"))
    emit({"phase": "train_cli", "card": card, "train_cli_s": train_cli_s,
          "final_train_metrics": final["final_train_metrics"],
          "global_step": meta["global_step"],
          "served": {k: {"shape": list(s), "max_abs_diff_in_process": d}
                     for k, (s, d) in results.items()}})
    # serve writes through the native emitter: within its bound
    for k, (shape, d) in results.items():
        check(d <= (EMIT_MAX if k == "serve" else 0.0),
              f"{k} --model differs from the in-process run: {shape}, {d}")
    return {"rec": train_rec, "shapes": shapes, "lld_rows": lld_rows,
            "dk_held": kernel_err[f"dk_roots x{lld_rows}"],
            "t_global": t_global, "t_edges": t_edges, "synth": synth}


#: the legacy family (phase 14): the frames of rt_simplified, the CLI
#: training run (32 synthetic 12 s files, batch 16: 2 steps an epoch), the
#: in-process KoeMorphTrainer steps and the KoeMorphModel's carried steps
RT_FRAMES, LEGACY_FILES, LEGACY_EPOCHS, KOEMORPH_STEPS = 36, 32, 6, 30
LEGACY_PLAIN_MAX = 1e-4                # blendshapes, kernels vs plain
#: test_model's metrics in its subprocess against the same batch in process
SEQ_EVAL_ATOL = 1e-5


def k3_rule(got, want) -> bool:
    """K3's agreement rule on dB rows: 1e-3 dB + 1e-4 relative."""
    return bool(((got - want).abs() <= K3_ATOL + K3_RTOL * want.abs()).all())


def hold_recorded(rec: dict, tags, known=None) -> dict:
    """Every launch shape :func:`recording_kernels` recorded under one of
    ``tags``: the kernel against its plain form on the recorded arguments,
    by the kernel's rule (K1 within K1_RTOL / K1_ATOL, K2 by
    :func:`dk_train_agreement` and :func:`dk_train_ok`, K3 by
    :func:`k3_rule`). Returns ``{(name, tag, shape): {"ok": bool,
    "max_abs_err": float, ...}}``; K2's error is the Hausdorff distance
    on the rows held. ``known``: ``(args, result)`` of a K2 hold made
    already, reused for recorded arguments equal to its own."""
    import torch
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import f0 as f0_ops
    from koemorph_tpu_torch.ops import frontend

    held = {}
    with torch.inference_mode():
        for key in sorted(k for k in rec if k[1] in tags):
            args, kw = rec[key]
            if key[0] == "dk_roots":
                same = (known is not None
                        and known[0][0].shape == args[0].shape
                        and torch.equal(known[0][0], args[0]))
                r = known[1] if same else dk_train_agreement(args[0])
                held[key] = {"ok": dk_train_ok(r),
                             "max_abs_err": r["hausdorff_max_held"], **r}
                continue
            if key[0] == "cycle_dsum":
                got = ck.cycle_dsum(*args, **kw)
                want = f0_ops.cycle_dsum_plain(*args, **kw)
                ok = bool(torch.allclose(got, want, rtol=K1_RTOL,
                                         atol=K1_ATOL))
            else:
                got = ck.logmel(*args, **kw)
                want = frontend.frames_to_logmel_plain(*args, **kw)
                ok = k3_rule(got, want)
            held[key] = {"ok": ok,
                         "max_abs_err": float((got - want).abs().max())}
    return held


def slice10_phases(card: str, work: Path, env: dict) -> dict:
    """Phase 14: the legacy model family at flagship width (d_model 256, 8
    heads, 80 mels, 30 fps), each through its entry points with the launch
    counts set to 0 just before: ``rt_simplified`` (``FrameStep`` and
    ``run_stream`` over 36 frames of the rolling 1 s window, graphed,
    then eager, then with the plain forms; K3 at T = 31 once per frame by
    the profiler and by the capture's record), ``legacy_cli`` (``python -m
    koemorph_tpu_torch.train --config configs/config.yaml``, then
    ``rt_simplified`` and ``test_model`` on what it wrote, and
    ``test_model --model-name sequential_dual_stream``, subprocesses),
    ``legacy_train`` (``KoeMorphTrainer.fit`` for 12 steps at batch 16 on
    the CLI's files: times, the kernels against the plain forms, a resume
    after step 6 bitwise) and ``koemorph_model`` (30 carried steps of
    ``KoeMorphModel`` per smoothing method on K3's mel at batch 4, T =
    256). Returns the recorded kernel arguments and launch counts for the
    kernels table."""
    import torch
    from koemorph_tpu_torch import rt_simplified as rts
    from koemorph_tpu_torch.data.dataset import KoeMorphDataModule
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.data.wav import read_wav, write_wav
    from koemorph_tpu_torch.models import KoeMorphModel, KoeMorphModelState
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import frontend
    from koemorph_tpu_torch.runtime.audio import AudioFileReader
    from koemorph_tpu_torch.models.losses import BlendshapeMetrics
    from koemorph_tpu_torch.test_model import build_model as tm_build_model
    from koemorph_tpu_torch.test_model import predict
    from koemorph_tpu_torch.train.__main__ import build_model
    from koemorph_tpu_torch.train.trainer import (KoeMorphTrainer,
                                                  dropout_generator)
    from koemorph_tpu_torch.utils.config import load_config, to_dict

    out: dict = {"rec": {}, "shapes": {}}
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()

    def windows(audio, n):
        """The rolling 1 s windows ``run_stream`` feeds the step."""
        buf = np.zeros(SR, np.float32)
        padded = np.pad(audio, (0, -len(audio) % HOP))
        rows = []
        for i in range(n):
            buf = np.concatenate([buf[HOP:], padded[i * HOP:(i + 1) * HOP]])
            rows.append(buf)
        return np.stack(rows)

    def event_ms(fn, items) -> list:
        times = []
        for x in items:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(x)                    # returns host numpy: synchronized
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return times

    # ---- rt_simplified: the main path, counted ----
    wav = work / "legacy_rt.wav"
    write_wav(wav, voiced_audio(RT_FRAMES * HOP / SR, seed=3), SR)
    audio, _ = read_wav(wav)              # as the file reader gives it
    wins = windows(audio, RT_FRAMES)
    t_rt = 1 + SR // HOP                                          # 31
    model = rts.build_model(seed=0)
    profiled(lambda: None)
    ck.reset_launch_counts()
    step = rts.FrameStep(model, SR)
    source = AudioFileReader(wav, SR, HOP, realtime=False)
    source.start()
    try:
        stats = rts.run_stream(step, source, max_frames=RT_FRAMES)
    finally:
        source.stop()
    launches, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
    bs = stats.pop("blendshapes")
    box = []
    seen, want = replayed_launches(step.step_graphs, in_windows(
        RT_FRAMES, lambda lo, hi: box.extend(step(w) for w in wins[lo:hi])))
    eager = rts.FrameStep(model, SR, graphs=False)
    eager.warmup()
    before = ck.launches()
    with recording_kernels(out["rec"], "rt_simplified"):
        eager_bs = np.stack([eager(w) for w in wins])
    eager_launches = {n: ck.launches()[n] - before[n] for n in KERNEL_PATTERNS}
    with plain_forms():
        before = ck.launches()
        plain = rts.FrameStep(model, SR, graphs=False)
        plain_bs = np.stack([plain(w) for w in wins])
        check(ck.launches() == before,
              "rt_simplified: the plain step launched a kernel")
    wins_dev = torch.from_numpy(wins).to(dev)
    lm_kw = model.frontend.logmel_kwargs()
    with torch.inference_mode():
        db_k = frontend.fused_log_mel_frontend(wins_dev, hop_length=HOP,
                                               **lm_kw)
        with plain_forms():
            db_p = frontend.fused_log_mel_frontend(wins_dev, hop_length=HOP,
                                                   **lm_kw)
    graphed_ms = event_ms(step, wins)
    eager_ms = event_ms(eager, wins)
    d_plain = float(np.abs(plain_bs - bs).max())
    expect = {"cycle_dsum": 0, "dk_roots": 0, "logmel": RT_FRAMES,
              "linear_3xtf32": 0}
    emit({"phase": "rt_simplified", "card": card, "frames": stats["frames"],
          "window_samples": SR, "logmel_T": t_rt,
          "run_stream": stats, "finite": bool(np.isfinite(bs).all()),
          "min": float(bs.min()), "max": float(bs.max()),
          "launches": launches,
          "launches_by_shape": {f"{a}{list(b)}": v
                                for (a, b), v in shapes.items()},
          "replayed_launches_profiled": seen,
          "replayed_launches_recorded": want,
          "eager_launches_counted": eager_launches,
          "graphs": graph_info(step.step_graphs),
          "run_stream_equals_steps": bool(np.array_equal(bs, np.stack(box))),
          "graphed_bitwise_equal_eager": bool(np.array_equal(bs, eager_bs)),
          "max_abs_diff_plain": d_plain, "bound_plain": LEGACY_PLAIN_MAX,
          "mel_db_max_abs_diff_plain": float((db_k - db_p).abs().max()),
          "mel_db_k3_rule": k3_rule(db_k, db_p),
          "frame_ms_graphed": q(graphed_ms), "frame_ms_eager": q(eager_ms)})
    check(bs.shape == (RT_FRAMES, 52) and bool(np.isfinite(bs).all())
          and bs.min() >= 0.0 and bs.max() <= 1.0, "rt_simplified output")
    check(np.array_equal(bs, np.stack(box)),
          "rt_simplified: run_stream != the same windows stepped")
    check(np.array_equal(bs, eager_bs), "rt_simplified: graphed != eager")
    check(launches["logmel"] > 0 and shapes.get(("logmel", (t_rt,)), 0) > 0,
          f"rt_simplified launched no logmel at T = {t_rt}: {launches}")
    check(seen == want == expect == eager_launches,
          f"rt_simplified: replays ran {seen}, the capture recorded "
          f"{want}, the eager run counted {eager_launches}, expected "
          f"{expect}")
    check(d_plain <= LEGACY_PLAIN_MAX and k3_rule(db_k, db_p),
          f"rt_simplified: kernels vs plain forms {d_plain}")
    out["shapes"]["rt_simplified"] = shapes
    out["t_rt"] = t_rt
    del step, eager, plain, wins_dev

    # ---- legacy_cli: train, then rt_simplified and test_model on it ----
    config_path = ROOT / "configs" / "config.yaml"
    cli_work = work / "legacy_cli"
    last = cli_work / "checkpoints" / "last"
    cli = {}

    def run_cli(name, *args, key=None):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", name, *args], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0,
              f"{name} failed:\n{proc.stderr[-3000:]}")
        check("random" not in proc.stderr, f"{name} used random weights")
        cli[key or name.rsplit(".", 1)[-1]] = {
            "seconds": time.perf_counter() - t0}
        return proc

    proc = run_cli("koemorph_tpu_torch.train", "--config", str(config_path),
                   "--synthetic", str(LEGACY_FILES), "--max-epochs", "1",
                   "--work-dir", str(cli_work))
    final = json.loads(proc.stdout.strip().splitlines()[-1])
    meta = json.loads((last / "meta.json").read_text())
    cli["train"].update(global_step=meta["global_step"],
                        final_train_metrics=final["final_train_metrics"])
    check(meta["global_step"] == LEGACY_FILES // 16
          and np.isfinite(final["final_train_metrics"]["loss"]),
          f"legacy train CLI: {final}, {meta}")
    synth = cli_work / "synth_data"
    rt_wav = synth / "synth_000.wav"
    rt_rows = work / "legacy_cli_rt.jsonl"
    # the sequential dual-stream model through the same test_model CLI (K1,
    # K2 and K3 in its eGeMAPS refresh and mel frontend), random weights
    # from a .pth; its first batch is counted in process below
    seq_args = argparse.Namespace(
        model_name="sequential_dual_stream", d_model=256, num_heads=8,
        fps=30, emotion_backend="egemaps")
    seq_model, seq_span = tm_build_model(seq_args)
    seq_model.init_random(torch.Generator().manual_seed(0))
    seq_pth = work / "legacy_cli_sequential.pth"
    torch.save(seq_model.state_dict(), seq_pth)
    # the three on what the CLI wrote, at once, each in its own process
    t0 = time.perf_counter()
    procs = run_at_once({
        "rt_simplified": [
            sys.executable, "-m", "koemorph_tpu_torch.rt_simplified",
            "--input", str(rt_wav), "--model", str(last), "--no-realtime",
            "--output", "file", "--output-file", str(rt_rows)],
        "test_model": [
            sys.executable, "-m", "koemorph_tpu_torch.test_model",
            "--data-dir", str(synth), "--model-name", "simplified",
            "--model", str(last)],
        "test_model_sequential": [
            sys.executable, "-m", "koemorph_tpu_torch.test_model",
            "--data-dir", str(synth), "--model-name",
            "sequential_dual_stream", "--model", str(seq_pth),
            "--max-batches", "1"]}, env)
    together_s = time.perf_counter() - t0
    for key, proc in procs.items():
        check(proc.returncode == 0,
              f"{key} failed:\n{proc.stderr[-3000:]}")
        check("random" not in proc.stderr, f"{key} used random weights")
        cli[key] = {"seconds_together": together_s}
    proc = procs["rt_simplified"]
    got = np.asarray([json.loads(r)["blendshapes"]
                      for r in rt_rows.read_text().splitlines()])
    cli_model = rts.build_model(checkpoint=str(last))
    rt_audio, _ = read_wav(rt_wav)
    in_proc = rts.FrameStep(cli_model, SR)
    want_rt = np.stack([in_proc(w) for w in
                        windows(rt_audio, -(-len(rt_audio) // HOP))])
    cli["rt_simplified"].update(
        frames=len(got), log=[ln for ln in proc.stderr.splitlines()
                              if "RTF" in ln],
        max_abs_diff_in_process=float(np.abs(got - want_rt).max())
        if got.shape == want_rt.shape else None)
    check(got.shape == want_rt.shape and np.array_equal(got, want_rt),
          "rt_simplified --model differs from the in-process frames")
    proc = procs["test_model"]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    cli["test_model"].update(metrics=result)
    check(result["batches"] >= 1
          and all(np.isfinite(v) for v in result.values()),
          f"test_model: {result}")
    proc = procs["test_model_sequential"]
    seq_result = json.loads(proc.stdout.strip().splitlines()[-1])
    seq_loader, _ = create_sequential_dataloader(
        synth, batch_size=4, window_frames=seq_span, stride_frames=seq_span,
        drop_last=True)
    seq_batch = next(iter(seq_loader()))
    seq_model = seq_model.eval().to(dev)
    ck.reset_launch_counts()
    seq_pred, seq_target = predict(seq_model, "sequential_dual_stream",
                                   256, seq_batch, dev)
    seq_launches = ck.launches()
    seq_metrics = BlendshapeMetrics()
    seq_metrics.update(seq_pred, np.asarray(seq_target))
    seq_in_proc = {k: float(v) for k, v in seq_metrics.compute().items()}
    seq_diff = max(abs(seq_result[k] - v) for k, v in seq_in_proc.items())
    cli["test_model_sequential"].update(
        metrics=seq_result, launches_in_process=seq_launches,
        max_abs_diff_in_process=seq_diff)
    check(seq_result["batches"] == 1.0
          and all(np.isfinite(v) for v in seq_result.values()),
          f"test_model sequential_dual_stream: {seq_result}")
    check(all(seq_launches[k] > 0 for k in ("cycle_dsum", "dk_roots",
                                             "logmel")),
          f"the sequential evaluation batch launched {seq_launches}")
    check(seq_diff <= SEQ_EVAL_ATOL,
          f"test_model sequential_dual_stream differs from the same batch "
          f"in process by {seq_diff}")
    del seq_model
    # one evaluation batch in process, counted: 4 windows of 256 frames
    loader_fn, _ = create_sequential_dataloader(
        synth, batch_size=4, window_frames=256, stride_frames=256)
    ev_batch = next(iter(loader_fn()))
    ck.reset_launch_counts()
    with recording_kernels(out["rec"], "eval"):
        pred, _ = predict(cli_model.eval(), "simplified", 256, ev_batch, dev)
    out["shapes"]["eval"] = dict(ck.SHAPE_LAUNCHES)
    t_eval = 4 * (1 + ev_batch["audio"].shape[1] // HOP)
    cli["eval_batch_launches"] = {f"{a}{list(b)}": v for (a, b), v in
                                  out["shapes"]["eval"].items()}
    emit({"phase": "legacy_cli", "card": card, **cli})
    check(out["shapes"]["eval"] == {("logmel", (t_eval,)): 1}
          and pred.shape == (4, 52),
          f"an evaluation batch launched {out['shapes']['eval']}")
    out["t_eval"] = t_eval
    del cli_model, in_proc

    # ---- legacy_train: KoeMorphTrainer on the CLI's files ----
    cfg = load_config(config_path)
    tcfg = to_dict(cfg)
    batch_size = int(cfg.data.batch_size)

    def new_trainer(tag, dropout=None):
        legacy, kind = build_model(cfg)
        check(kind == "frame", f"configs/config.yaml's model is {kind}")
        if dropout is not None:
            legacy.dropout.rate = legacy.attention.attn_dropout.rate = dropout
        dm_ = KoeMorphDataModule(train_data_dir=synth, batch_size=batch_size)
        dm_.setup()
        steps = len(dm_.train_dataloader())
        trainer = KoeMorphTrainer(legacy, tcfg,
                                  work_dir=work / f"legacy_{tag}",
                                  steps_per_epoch=steps)

        def loader(epoch):
            ld = dm_.train_dataloader()
            ld.set_epoch(epoch)
            return iter(ld)
        return trainer, loader, steps

    trainer, loader, per_epoch = new_trainer("main")
    n_steps = per_epoch * LEGACY_EPOCHS
    events, losses = [], []
    real_step = trainer.train_step

    def timed_step(batch):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        metrics = real_step(batch)
        e1.record()
        events.append((e0, e1))
        losses.append(metrics["loss"])
        return metrics

    trainer.train_step = timed_step
    before_p = {k: v.detach().clone() for k, v in trainer.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_kernels(out["rec"], "legacy_train"):
        history = trainer.fit(loader, None, max_epochs=LEGACY_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
    # the fit's own peak: above what the process held when it started
    peak_gb = (torch.cuda.max_memory_allocated() - held_before) / 1e9
    trainer.train_step = real_step
    step_ms = np.asarray([a.elapsed_time(b) for a, b in events])
    losses = [float(v) for v in losses]
    moved = [k for k, v in trainer.params.items()
             if not bool((v.detach() != before_p[k]).any())]
    batches = [trainer._prepare(b) for b in list(loader(0))[:2]]
    prof = profiled(lambda: [trainer.train_step(b) for b in batches])
    ks = device_kernels(None, prof)
    busy_ms = sum(us for _, us in ks) / 1e3 / 2
    profiled_step_ms = prof.wall_s * 1e3 / 2
    own = {k: v / KERNELS_PER_LAUNCH[k]
           for k, v in own_kernels(ks, 2).items()}
    t_train = batch_size * (1 + batches[0]["audio"].shape[1] // HOP)
    audio_s = batch_size * batches[0]["audio"].shape[1] / SR
    med = float(np.median(step_ms[1:]))

    # one step's loss and gradients, kernels against the plain forms
    plain_t, _, _ = new_trainer("plain", dropout=0.0)
    plain_t.model.load_state_dict(trainer.model.state_dict())
    b = batches[1]

    def loss_grads():
        plain_t.model.train()
        loss, _ = plain_t.loss_fn(b, dropout_generator(0, 0, dev))
        grads = torch.autograd.grad(loss, list(plain_t.params.values()))
        return float(loss.detach()), dict(zip(plain_t.params, grads))

    loss_k, grads_k = loss_grads()
    with plain_forms():
        before = ck.launches()
        loss_p, grads_p = loss_grads()
        check(ck.launches() == before,
              "the plain legacy step launched a kernel")
    rel = {k: float((grads_k[k] - g).abs().max() / g.abs().max())
           for k, g in grads_p.items()}
    (x_t,), kw_t = out["rec"][("logmel", "legacy_train", t_train)]
    with torch.inference_mode():
        k3_ok = k3_rule(ck.logmel(x_t, **kw_t),
                        frontend.frames_to_logmel_plain(x_t, **kw_t))

    # a resume after step 6 against the uninterrupted run (dropout on)
    whole, loader_w, _ = new_trainer("whole")
    whole.fit(loader_w, None, max_epochs=LEGACY_EPOCHS)
    first, loader_f, _ = new_trainer("split")
    first.fit(loader_f, None, max_epochs=LEGACY_EPOCHS // 2)
    resumed, loader_r, _ = new_trainer("split")
    check(resumed.resume() and resumed.global_step == n_steps // 2,
          "the resumed legacy trainer did not find its checkpoint")
    resumed.fit(loader_r, None, max_epochs=LEGACY_EPOCHS)
    diffs = {k: float((p.detach() - resumed.params[k].detach()).abs().max())
             for k, p in whole.params.items()}
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    moments_equal = all(torch.equal(sa[m][k], sb[m][k])
                        for m in ("mu", "nu") for k in sa[m])
    emit({"phase": "legacy_train", "card": card, "batch": batch_size,
          "audio_samples": int(batches[0]["audio"].shape[1]),
          "logmel_T": t_train, "steps": len(step_ms),
          "first_step_ms": float(step_ms[0]), "step_ms": q(step_ms[1:]),
          "fit_wall_s": wall,
          "audio_s_per_wall_s": len(step_ms) * audio_s / wall,
          "audio_s_per_step_s": audio_s / (med / 1e3),
          "activities_per_step": len(ks) / 2,
          "device_busy_ms_per_step": busy_ms,
          "profiled_step_ms": profiled_step_ms,
          "device_busy_share": busy_ms / profiled_step_ms,
          "fit_peak_gb_above_start": peak_gb, "launches": launches,
          "launches_by_shape": {f"{a}{list(s)}": v
                                for (a, s), v in shapes.items()},
          "profiled_kernels_per_step": own,
          "top_kernels_us_per_step": profile_summary(ks, 2, top_n=8),
          "losses": losses, "train_metrics": history["train"][-1],
          "params_not_moved": moved,
          "loss_kernels": loss_k, "loss_plain": loss_p,
          "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
          "grad_max_rel_diff": max(rel.values()),
          "logmel_train_shape_k3_rule": k3_ok,
          "resume_bitwise_equal": max(diffs.values()) == 0.0
          and moments_equal,
          "resume_max_abs_diff": max(diffs.values())})
    check(len(step_ms) == n_steps and all(np.isfinite(losses)),
          f"legacy fit: {len(step_ms)} steps, losses {losses}")
    check(not moved, f"legacy parameters did not move: {moved}")
    check(launches == {"cycle_dsum": 0, "dk_roots": 0, "logmel": n_steps,
                       "linear_3xtf32": 0}
          and shapes.get(("logmel", (t_train,)), 0) == n_steps,
          f"legacy train launches {shapes} for {n_steps} steps")
    check(own == {"cycle_dsum": 0.0, "dk_roots": 0.0, "logmel": 1.0,
                  "linear_3xtf32": 0.0},
          f"legacy train: profiled kernels per step {own}")
    check(abs(loss_k - loss_p) <= TRAIN_PLAIN_LOSS_RTOL * abs(loss_p),
          f"legacy loss: kernels {loss_k}, plain {loss_p}")
    check(max(rel.values()) <= TRAIN_PLAIN_GRAD,
          f"legacy gradients: kernels vs plain {rel}")
    check(k3_ok, "logmel disagrees with its plain form at the legacy "
          "training shape")
    check(max(diffs.values()) == 0.0 and moments_equal
          and sa["count"] == sb["count"] == n_steps,
          f"resumed legacy run != uninterrupted run: {diffs}")
    out["shapes"]["legacy_train"] = shapes
    out["t_train"] = t_train
    del trainer, plain_t, whole, first, resumed

    # ---- koemorph_model: 30 carried steps per smoothing method ----
    n_mel = 256
    km_audio = torch.from_numpy(np.stack([
        voiced_audio((n_mel - 1 + KOEMORPH_STEPS) * HOP / SR, seed=s)
        for s in range(4, 8)])).to(dev)
    emo = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (KOEMORPH_STEPS, 4, n_mel, 256)).astype(np.float32)).to(dev)
    mel_cfg = frontend.LogMelFrontend()
    km = {}
    ck.reset_launch_counts()
    for method in ("exponential", "gaussian", "median"):
        m = KoeMorphModel(smoothing_method=method, dropout=0.0,
                          attention_dropout=0.0, window_size=30,
                          causal=True)
        m.init_random(torch.Generator().manual_seed(0))
        m = m.eval().to(dev)
        state = KoeMorphModelState.create(4, device=dev)
        outs, ms = [], []
        with torch.inference_mode():
            for s in range(KOEMORPH_STEPS):
                x = km_audio[:, s * HOP:(s + n_mel - 1) * HOP]
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                mel = frontend.log_mel_spectrogram(x, mel_cfg)
                res, state = m(mel, emo[s], state)
                e1.record()
                outs.append(res["blendshapes"])
                e1.synchronize()
                ms.append(e0.elapsed_time(e1))
        o = torch.stack(outs).cpu().numpy()
        km[method] = {"step_ms": q(ms[1:]), "finite": bool(
            np.isfinite(o).all()), "min": float(o.min()),
            "max": float(o.max()), "mel_T": int(mel.shape[1]),
            "history_ptr": int(state.smoother.history_ptr)}
        check(mel.shape == (4, n_mel, 80), f"KoeMorphModel mel {mel.shape}")
        check(km[method]["finite"] and o.min() >= 0.0 and o.max() <= 1.0,
              f"KoeMorphModel ({method}) output {km[method]}")
    km_shapes = dict(ck.SHAPE_LAUNCHES)
    # the models' mel (dB before the normalization), kernels vs plain
    with torch.inference_mode():
        x = km_audio[:, :(n_mel - 1) * HOP]
        db_k = frontend.fused_log_mel_frontend(x)
        with plain_forms():
            db_p = frontend.fused_log_mel_frontend(x)
    mel_ok = k3_rule(db_k, db_p)
    emit({"phase": "koemorph_model", "card": card, "batch": 4,
          "mel_frames": n_mel, "steps": KOEMORPH_STEPS, "d_model": 256,
          "d_query": 128, "window_size": 30,
          "launches_by_shape": {f"{a}{list(s)}": v
                                for (a, s), v in km_shapes.items()},
          "mel_db_max_abs_diff_plain": float((db_k - db_p).abs().max()),
          "mel_db_k3_rule": mel_ok, "methods": km})
    check(km_shapes == {("logmel", (4 * n_mel,)): 3 * KOEMORPH_STEPS},
          f"KoeMorphModel launches {km_shapes}")
    check(mel_ok, "KoeMorphModel's mel: kernels vs plain forms")
    emit({"phase": "slice10", "seconds": time.perf_counter() - t_phase})
    out["synth"] = synth
    return out


#: an imported checkpoint's outputs through the entry points against the
#: same model in process
IMPORT_ATOL = 1e-5
#: the paths of phase 15 whose kernel arguments are recorded: tag -> the
#: path's name in the kernels line
SLICE11_PATHS = {"import_learnable": "import", "import_fixed": "import",
                 "demo": "lip-sync demo", "rehearsal": "rehearsal"}
#: the level-1 extractor's embedding, kernels against the plain forms
EXTRACTOR_PLAIN_MAX = 1e-4


def _stdout_json(fn, *, last_line: bool = True):
    """``fn()`` (an entry point's ``main``) with its standard output
    captured: its return code and the JSON it printed (its last line, or
    the whole output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    text = buf.getvalue().strip()
    return rc, json.loads(text.splitlines()[-1] if last_line else text)


def slice11_phases(card: str, work: Path, s10: dict) -> dict:
    """Phase 15: from files to a checked, trained model, each part through
    its entry points with the launch counts set to 0 just before.
    ``fit_wall_split``: phase 14's legacy ``KoeMorphTrainer.fit`` as the
    train CLI runs it (batch 16, 12 s files, validation on the same files
    every ``check_val_every_n_epoch``, the config's checkpoint cadence),
    its wall split into the main thread's wait for batches, the steps
    (host time and CUDA events), validation and checkpoint writes, in
    turns through the Python readers and the native parsers (Python,
    native, native, Python; losses bitwise equal), and a load-only pass
    over the files both ways.
    ``reference_import``: a synthetic reference state dict at flagship
    width, learnable and fixed fusion, through ``import_torch_checkpoint``,
    then ``infer``, ``rt`` and ``test_model`` on what it wrote, each within
    1e-5 of the same model in process. ``rehearsal``: the lip-sync demo
    at its defaults (the loss must fall) and ``reproduce_results --smoke``
    with a validation every epoch (the report written, the held-out loss
    falling). ``slice11_kernels_vs_plain``: every launch shape of the
    served import, the demo and the smoke (train steps and validation), on
    the arguments recorded there, against its plain form. ``extractor``:
    ``EmotionExtractor``'s fallback matrix (no source, eGeMAPS, basic, a
    ConvEmotionEncoder, precomputed hits and a miss, a runtime demotion)
    and ``integration_check`` with ``"ok": true``. Returns the recorded
    kernel arguments and launch counts for the kernels table."""
    import shutil
    import threading
    import unittest.mock as mock

    import torch
    from koemorph_tpu_torch import demo_lipsync_learning, infer
    from koemorph_tpu_torch import import_torch_checkpoint as importer
    from koemorph_tpu_torch import integration_check, reproduce_results, rt
    from koemorph_tpu_torch import test_model as tm
    from koemorph_tpu_torch.data import native
    from koemorph_tpu_torch.data.dataset import KoeMorphDataModule
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.data.wav import write_wav
    from koemorph_tpu_torch.features.emotion import (
        EmotionExtractor, PrecomputedEmotionFeatures)
    from koemorph_tpu_torch.features.emotion2vec import ConvEmotionEncoder
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel, SimplifiedDualStreamModel)
    from koemorph_tpu_torch.models.losses import BlendshapeMetrics
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    from koemorph_tpu_torch.train.__main__ import build_model
    from koemorph_tpu_torch.train.trainer import KoeMorphTrainer
    from koemorph_tpu_torch.utils.config import load_config, to_dict
    from koemorph_tpu_torch.utils.params import (read_model_state,
                                                 read_state_dict)

    out: dict = {"rec": {}, "shapes": {}}
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    synth = Path(s10["synth"])

    @contextlib.contextmanager
    def python_readers(on: bool):
        """The loaders' native parsers declining every file, so the
        strict Python readers run (``on``), or as they are."""
        if not on:
            yield
            return
        with mock.patch.object(native, "decode_wav_native",
                               return_value=None), \
                mock.patch.object(native, "parse_blendshape_jsonl_native",
                                  return_value=None):
            yield

    # ---- fit_wall_split: the legacy fit as the train CLI runs it ----
    config_path = ROOT / "configs" / "config.yaml"
    cfg = load_config(config_path)
    tcfg = to_dict(cfg)
    batch_size = int(cfg.data.batch_size)

    def fit_split(tag: str, python_path: bool) -> dict:
        legacy, kind = build_model(cfg)
        check(kind == "frame", f"configs/config.yaml's model is {kind}")
        dm_ = KoeMorphDataModule(train_data_dir=synth, val_data_dir=synth,
                                 batch_size=batch_size)
        dm_.setup()
        steps = len(dm_.train_dataloader())
        trainer = KoeMorphTrainer(legacy, tcfg,
                                  work_dir=work / f"fit_split_{tag}",
                                  steps_per_epoch=steps)
        split = collections.Counter()
        lock = threading.Lock()

        def timed(key, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    with lock:
                        split[key] += time.perf_counter() - t0
            return run

        events, losses = [], []
        real_step = trainer.train_step

        def step(batch):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            metrics = real_step(batch)
            e1.record()
            events.append((e0, e1))
            losses.append(metrics["loss"])
            return metrics

        trainer.train_step = timed("step_host_s", step)
        trainer._save = timed("checkpoint_s", trainer._save)
        trainer.validate = timed("validation_s", trainer.validate)
        for ds, key in ((dm_.train_dataset, "train_load_work_s"),
                        (dm_.val_dataset, "val_load_work_s")):
            ds.loader.load_sample = timed(key, ds.loader.load_sample)

        def train_loader(epoch):
            ld = dm_.train_dataloader()
            ld.set_epoch(epoch)
            it = iter(ld)
            while True:          # the main thread's wait for each batch
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    split["data_wait_s"] += time.perf_counter() - t0
                yield batch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with python_readers(python_path):
            history = trainer.fit(train_loader,
                                  lambda: iter(dm_.val_dataloader()),
                                  max_epochs=LEGACY_EPOCHS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        audio_s = steps * LEGACY_EPOCHS * batch_size * 12.0
        parts = ("data_wait_s", "step_host_s", "validation_s",
                 "checkpoint_s")
        row = {"wall_s": wall, **{k: split[k] for k in parts},
               "other_s": wall - sum(split[k] for k in parts),
               "train_load_work_s": split["train_load_work_s"],
               "val_load_work_s": split["val_load_work_s"],
               "steps": len(events),
               "step_device_ms": q([a.elapsed_time(b) for a, b in events]),
               "step_device_s_total": sum(a.elapsed_time(b)
                                          for a, b in events) / 1e3,
               "validations": len(history["val"]),
               "checkpoint_dirs": sorted(
                   p.name for p in (work / f"fit_split_{tag}" /
                                    "checkpoints").iterdir()),
               "audio_s_per_wall_s": audio_s / wall}
        row["dominant"] = max(parts, key=lambda k: row[k])
        return row, [float(v) for v in losses]

    # in turns (Python, native, native, Python): the first run of each
    # pair reads the files cold from the page cache of a fresh process
    runs = [fit_split(f"{tag}_{i}", tag == "python") for i, tag in
            enumerate(("python", "native", "native", "python"))]
    (split_py, losses_py), (split_nat, losses_nat) = runs[3], runs[2]

    def load_pass(python_path: bool):
        ds = KoeMorphDataModule(train_data_dir=synth)
        ds.setup()
        t0 = time.perf_counter()
        with python_readers(python_path):
            items = [ds.train_dataset[i] for i in range(len(ds.train_dataset))]
        return time.perf_counter() - t0, items

    load_py_s, items_py = load_pass(True)
    load_nat_s, items_nat = load_pass(False)
    same_items = all(np.array_equal(a[k], b[k]) for a, b in
                     zip(items_py, items_nat) for k in ("wav", "arkit"))
    files_audio_s = sum(len(x["wav"]) for x in items_nat) / SR
    emit({"phase": "fit_wall_split", "card": card, "batch": batch_size,
          "epochs": LEGACY_EPOCHS, "files": len(items_nat),
          "check_val_every_n_epoch": int(tcfg["training"].get(
              "check_val_every_n_epoch", 1)),
          "python_readers": split_py, "native_parsers": split_nat,
          "first_pair": {"python": runs[0][0], "native": runs[1][0]},
          "losses_bitwise_equal": all(r[1] == losses_nat for r in runs),
          "load_only": {"python_s": load_py_s, "native_s": load_nat_s,
                        "speedup": load_py_s / load_nat_s,
                        "audio_s_per_s_python": files_audio_s / load_py_s,
                        "audio_s_per_s_native": files_audio_s / load_nat_s,
                        "bitwise_equal": same_items}})
    check(all(r[1] == losses_nat for r in runs)
          and all(np.isfinite(losses_nat)),
          "the fit through the native parsers differs from the Python "
          f"readers': {losses_py} vs {losses_nat}")
    check(same_items and len(items_nat) == LEGACY_FILES,
          "native and Python readers disagree on the legacy files")

    # ---- reference_import: a reference .pth through the entry points ----
    imp = {}
    wav = work / "import_in.wav"
    write_wav(wav, voiced_audio(10.0, seed=13), SR)
    for learnable in (True, False):
        tag = "learnable" if learnable else "fixed"
        ref = SimplifiedDualStreamModel(dropout=0.0)
        ref.init_random(torch.Generator().manual_seed(5))
        sd = {k: v for k, v in ref.state_dict().items()
              if not k.startswith("emotion_projection.")}
        if not learnable:
            att = SimplifiedDualStreamModel(
                dropout=0.0, use_learnable_weights=False).dual_stream_attention
            sd["dual_stream_attention.mel_weights"] = att.mel_weights
            sd["dual_stream_attention.emotion_weights"] = att.emotion_weights
        pth = work / f"reference_{tag}.pth"
        torch.save({"model_state_dict": sd}, pth)
        out_dir = work / f"imported_{tag}"
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = importer.main([str(pth), "--output", str(out_dir)]
                               + ([] if learnable else ["--fixed-fusion"]))
        imported = read_state_dict(out_dir)
        check(rc == 0 and printed.getvalue().strip() == str(out_dir)
              and (("dual_stream_attention.mel_weights" in imported)
                   == learnable),
              f"import_torch_checkpoint ({tag}) wrote {sorted(imported)[:4]}")
        check(all(torch.equal(imported[k], v.cpu()) for k, v in sd.items()
                  if k in imported),
              f"the imported {tag} checkpoint differs from the reference's")
        # the served path: infer, rt (the stream) and test_model on the
        # card from the imported file, the kernels' arguments recorded
        rows_path = work / f"imported_{tag}_infer.jsonl"
        rt_rows = work / f"imported_{tag}_rt.jsonl"
        ck.reset_launch_counts()
        with recording_kernels(out["rec"], f"import_{tag}"):
            rc_inf = infer.main(["--input", str(wav), "--output",
                                 str(rows_path), "--model", str(out_dir)])
            rc_rt = rt.main(["--input", str(wav), "--model", str(out_dir),
                             "--output", "file", "--output-file",
                             str(rt_rows), "--no-realtime", "--max-frames",
                             "30"])
            rc, result = _stdout_json(lambda: tm.main(
                ["--data-dir", str(synth), "--model-name",
                 "sequential_dual_stream", "--model", str(out_dir),
                 "--max-batches", "1"]))
        launches = ck.launches()
        out["shapes"][f"import_{tag}"] = dict(ck.SHAPE_LAUNCHES)
        check(rc_inf == 0 and rc_rt == 0,
              f"infer / rt on the imported {tag} checkpoint: "
              f"{rc_inf} / {rc_rt}")
        # infer against the same decode in process
        got = np.asarray([json.loads(r)["blendshapes"] for r in
                          rows_path.read_text().splitlines()])
        model = SequentialDualStreamModel(
            use_learnable_weights=learnable, dropout=0.0)
        model.load_state_dict(imported)
        audio = infer.load_audio(str(wav), SR, 256, HOP)
        want = BatchedSequentialDecoder(model, dev, graphs=False)(
            audio[None])[0].cpu().numpy()
        d_infer = (float(np.abs(got - want).max())
                   if got.shape == want.shape else None)
        rt_bs = np.asarray([json.loads(r)["blendshapes"] for r in
                            rt_rows.read_text().splitlines()])
        # test_model against its first batch in process
        seq_args = argparse.Namespace(
            model_name="sequential_dual_stream", d_model=256, num_heads=8,
            fps=30, emotion_backend="egemaps")
        tm_model, tm_span = tm.build_model(
            seq_args, **read_model_state(out_dir)[1])
        tm_model.load_state_dict(imported)
        loader, _ = create_sequential_dataloader(
            synth, batch_size=4, window_frames=tm_span,
            stride_frames=tm_span, drop_last=True)
        pred, target = tm.predict(tm_model.eval().to(dev),
                                  "sequential_dual_stream", 256,
                                  next(iter(loader())), dev)
        metrics = BlendshapeMetrics()
        metrics.update(pred, np.asarray(target))
        d_tm = max(abs(result[k] - float(v))
                   for k, v in metrics.compute().items())
        imp[tag] = {"seconds": time.perf_counter() - t0,
                    "infer_rows": len(got),
                    "infer_max_abs_diff_in_process": d_infer,
                    "launches": launches,
                    "launches_by_shape": {
                        f"{a}{list(b)}": v for (a, b), v in
                        out["shapes"][f"import_{tag}"].items()},
                    "rt_frames": len(rt_bs),
                    "rt_finite_in_range": bool(
                        np.isfinite(rt_bs).all() and rt_bs.min() >= 0
                        and rt_bs.max() <= 1),
                    "test_model": result,
                    "test_model_max_abs_diff_in_process": d_tm}
        check(d_infer is not None and d_infer <= IMPORT_ATOL,
              f"infer on the imported {tag} checkpoint vs in process: "
              f"{d_infer}")
        check(all(launches[k] > 0 for k in FLAGSHIP_KERNELS),
              f"infer, rt and test_model on the imported {tag} checkpoint "
              f"launched {launches}")
        check(len(rt_bs) == 30 and imp[tag]["rt_finite_in_range"],
              f"rt on the imported {tag} checkpoint: {rt_bs.shape}")
        check(rc == 0 and d_tm <= IMPORT_ATOL,
              f"test_model on the imported {tag} checkpoint: {d_tm}")
        del model, tm_model
    emit({"phase": "reference_import", "card": card, **imp})

    # ---- rehearsal: the lip-sync demo and reproduce_results --smoke ----
    ck.reset_launch_counts()
    with recording_kernels(out["rec"], "demo"):
        rc, demo = _stdout_json(lambda: demo_lipsync_learning.main(
            ["--work-dir", str(work / "lipsync_demo")]))
    out["shapes"]["demo"] = dict(ck.SHAPE_LAUNCHES)
    demo_launches = ck.launches()
    ck.reset_launch_counts()
    with recording_kernels(out["rec"], "rehearsal"):
        rc_r, rep = _stdout_json(lambda: reproduce_results.main(
            ["--smoke", "--val-every", "1",
             "--work-dir", str(work / "reproduce")]))
    out["shapes"]["rehearsal"] = dict(ck.SHAPE_LAUNCHES)
    rep_launches = ck.launches()
    report = Path(rep["report"])
    val_losses = rep["val_losses"]
    emit({"phase": "rehearsal", "card": card, "demo": demo,
          "demo_launches": demo_launches,
          "demo_launches_by_shape": {f"{a}{list(b)}": v for (a, b), v in
                                     out["shapes"]["demo"].items()},
          "reproduce_smoke": rep, "reproduce_launches": rep_launches,
          "reproduce_launches_by_shape": {
              f"{a}{list(b)}": v
              for (a, b), v in out["shapes"]["rehearsal"].items()}})
    check(rc == 0 and demo["loss_last"] < demo["loss_first"]
          and np.isfinite(demo["jaw_corr_after"]),
          f"the lip-sync demo: {demo}")
    check(demo_launches["logmel"] > 0, f"the demo launched {demo_launches}")
    # the smoke's four one-step epochs each train on a reshuffled batch,
    # so the train loss of one epoch is not comparable with another's;
    # learning is read on the held-out windows, the same in every round
    check(rc_r == 0 and report.exists()
          and "NOT corpus results" in report.read_text()
          and np.isfinite(rep["mae"]) and len(val_losses) == 4
          and val_losses[-1] < val_losses[0],
          f"reproduce_results --smoke: {rep}")
    check(all(rep_launches[k] > 0 for k in FLAGSHIP_KERNELS),
          f"reproduce_results --smoke launched {rep_launches}")

    # every launch shape of the import, demo and rehearsal paths, on the
    # arguments those runs passed, against the kernel's plain form
    held = hold_recorded(out["rec"], SLICE11_PATHS)
    emit({"phase": "slice11_kernels_vs_plain", "card": card,
          "held": {f"{name} {tag} {shape}": {
              k: v for k, v in r.items() if k != "plain_misses_rounded"}
              for (name, tag, shape), r in held.items()}})
    check(held and all(r["ok"] for r in held.values()),
          "kernels vs plain forms on the phase-15 paths: "
          + str([k for k, r in held.items() if not r["ok"]]))
    out["held"] = held

    # ---- extractor: the fallback matrix, then integration_check ----
    audio = voiced_audio(2.0, seed=12)
    ext, matrix = {}, {}

    def run(name, ex, x=audio):
        res = ex.extract_features(x)
        emb, bw = res["embeddings"], res["blendshape_weights"]
        matrix[name] = {"level": ex.fallback_level,
                        "served": res["metadata"]["backend_used"],
                        "dim": int(emb.shape[-1]),
                        "finite": bool(np.isfinite(emb).all()),
                        "blendshapes_valid": bool((bw >= 0).all()
                                                  and (bw <= 1).all())}
        return res

    ck.reset_launch_counts()
    res_eg = run("egemaps", EmotionExtractor(backend="egemaps",
                                             enable_caching=False))
    ext["egemaps_launches"] = ck.launches()
    with plain_forms():
        plain_eg = EmotionExtractor(backend="egemaps", enable_caching=False
                                    ).extract_features(audio)
    ext["egemaps_max_abs_diff_plain"] = float(np.abs(
        res_eg["embeddings"] - plain_eg["embeddings"]).max())
    run("emotion2vec without a source", EmotionExtractor(
        enable_caching=False))
    run("basic", EmotionExtractor(backend="basic", enable_caching=False))
    torch.manual_seed(0)
    conv_sd = ConvEmotionEncoder().state_dict()
    run("emotion2vec, ConvEmotionEncoder", EmotionExtractor(
        emotion2vec_params=conv_sd, enable_caching=False))
    feats = np.random.default_rng(0).standard_normal(
        (7, 1024)).astype(np.float32)
    PrecomputedEmotionFeatures.save(work / "precomputed", audio, feats)
    pre = EmotionExtractor(precomputed_dir=work / "precomputed",
                           enable_caching=False)
    hit = run("emotion2vec, precomputed hit", pre)
    run("emotion2vec, precomputed miss", pre,
        voiced_audio(2.0, seed=14))
    ext["precomputed_restored_level"] = pre.fallback_level
    ext["precomputed_hit_exact"] = bool(np.array_equal(
        hit["embeddings"][0], feats.mean(0)))
    bad = {k: v[..., :1] for k, v in conv_sd.items()}
    demoted = EmotionExtractor(emotion2vec_params=bad, enable_caching=False)
    run("emotion2vec, bad weights (runtime demotion)", demoted)
    shutil.rmtree(work / "emotion_cache", ignore_errors=True)
    cached = EmotionExtractor(backend="basic",
                              cache_dir=work / "emotion_cache")
    run("basic, cache miss", cached)
    run("basic, cache hit", cached)
    ext["cache_stats"] = cached.get_statistics()
    rc_i, integ = _stdout_json(
        lambda: integration_check.main(["--seconds", "4"]), last_line=False)
    want_served = {
        "egemaps": ("opensmile", 264), "emotion2vec without a source":
        ("opensmile", 264), "basic": ("basic", 9),
        "emotion2vec, ConvEmotionEncoder": ("emotion2vec", 1024),
        "emotion2vec, precomputed hit": ("emotion2vec", 1024),
        "emotion2vec, precomputed miss": ("opensmile", 264),
        "emotion2vec, bad weights (runtime demotion)": ("opensmile", 264),
        "basic, cache miss": ("basic", 9), "basic, cache hit": ("basic", 9)}
    emit({"phase": "extractor", "card": card, "matrix": matrix, **ext,
          "integration_check": integ})
    check(all((m["served"], m["dim"]) == want_served[k] and m["finite"]
              and m["blendshapes_valid"] for k, m in matrix.items()),
          f"the extractor's fallback matrix: {matrix}")
    check(ext["precomputed_restored_level"] == 0
          and ext["precomputed_hit_exact"] and demoted.fallback_level == 1
          and ext["cache_stats"]["cache_hits"] == 1,
          f"extractor levels, precomputed store, cache: {ext}")
    check(ext["egemaps_launches"]["cycle_dsum"] > 0
          and ext["egemaps_launches"]["dk_roots"] > 0,
          f"the eGeMAPS extractor launched {ext['egemaps_launches']}")
    check(ext["egemaps_max_abs_diff_plain"] <= EXTRACTOR_PLAIN_MAX,
          "the eGeMAPS extractor vs the plain forms: "
          f"{ext['egemaps_max_abs_diff_plain']}")
    check(rc_i == 0 and integ["ok"]
          and integ["device"] == card,
          f"integration_check: {integ}")
    emit({"phase": "slice11", "seconds": time.perf_counter() - t_phase})
    return out


#: phase 16's paths whose kernel arguments are recorded: tag -> the
#: path's name in the kernels line
SLICE12_PATHS = {"sliding_window": "sliding window",
                 "egemaps_extractor": "eGeMAPS extractor",
                 "export": "exported program"}
#: the eGeMAPS extractor's functionals, kernels against the plain forms:
#: the CPU tests' bound of the port against JAX (rtol 1e-3 / atol 1e-4;
#: rtol 1e-2 for the F0 slope and jitter functionals, which amplify
#: period rounding)
SHIM_EGEMAPS_RTOL, SHIM_EGEMAPS_ATOL = 1e-3, 1e-4
SHIM_EGEMAPS_RTOL_LOOSE = 1e-2
#: the sliding window's normalized mel and the frame function's outputs
#: against the plain forms (the stream's bound)
SHIM_PLAIN_MAX = 1e-4
#: the exported program against the live module (the exporter's gate) and
#: against the live module with the plain forms
EXPORT_LIVE_MAX, EXPORT_PLAIN_MAX = 1e-5, 1e-4
EXPORT_FRAMES = 30
#: the frames of the exported program's run that are profiled
EXPORT_PROFILED = 5
#: the live frame's two dispatch routes timed in alternating rounds:
#: rounds, calls per round
ROUTE_ROUNDS, ROUTE_CALLS = 8, 20

#: run in a fresh process: load the exported program, run it for
#: EXPORT_FRAMES frames with the EMA carry threaded (CUDA events around
#: each), profile EXPORT_PROFILED more, print one JSON line
EXPORT_RUN = """
import json, sys
import numpy as np, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from koemorph_tpu_torch.export import load_program
from koemorph_tpu_torch.ops import cuda as ck
path, out_npy, device = sys.argv[1], sys.argv[2], sys.argv[3]
loaded = load_program(path)
targets = sorted({str(n.target) for n in loaded.graph.nodes
                  if n.op == 'call_function'})
# what each operator's frames come from in the graph (a view, or a copy
# the export made)
op_inputs = {str(n.target): str(getattr(n.args[0], 'target', n.args[0]))
             for n in loaded.graph.nodes
             if str(n.target).startswith('koemorph_torch.')}
program = loaded.module()
dev = torch.device(device)
frames = cs.export_frames(dev)


def run(n):
    prev = torch.zeros((1, 52), device=dev)
    init = torch.zeros((1,), dtype=torch.bool, device=dev)
    outs, evs = [], []
    for a in frames[:n]:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        b, prev, init = program(a, prev, init)
        e1.record()
        outs.append(b)
        evs.append((e0, e1))
    return outs, evs


with torch.no_grad():
    run(1)                   # loads the kernels' libraries
    ck.reset_launch_counts()
    outs, evs = run(len(frames))
    torch.cuda.synchronize()
    launches = ck.launches()
    shapes = [[k, list(v), n] for (k, v), n in ck.SHAPE_LAUNCHES.items()]
    ks = cs.device_kernels(lambda: run(cs.EXPORT_PROFILED))
np.save(out_npy, torch.cat(outs).cpu().numpy())
print(json.dumps({'targets': targets, 'op_inputs': op_inputs,
                  'launches': launches, 'launches_by_shape': shapes,
                  'activities_per_frame': len(ks) / cs.EXPORT_PROFILED,
                  'busy_ms_per_frame': sum(us for _, us in ks)
                  / cs.EXPORT_PROFILED / 1e3,
                  'copies_per_frame': cs.copies(ks, cs.EXPORT_PROFILED),
                  'top_kernels_us': cs.profile_summary(
                      ks, cs.EXPORT_PROFILED),
                  'frame_ms': [a.elapsed_time(b) for a, b in evs],
                  'profiled_kernels': cs.own_kernels(ks),
                  'profiled_frames': cs.EXPORT_PROFILED,
                  'device': torch.cuda.get_device_name(dev)}))
"""


def export_frames(dev):
    """(EXPORT_FRAMES, 1, 256 * HOP) float32 on ``dev``: the flagship
    window sliding one hop per frame over voiced audio."""
    import torch
    n = 256 * HOP
    audio = voiced_audio(((EXPORT_FRAMES - 1) * HOP + n) / SR, seed=23)
    return torch.from_numpy(np.stack(
        [audio[i * HOP:i * HOP + n][None] for i in range(EXPORT_FRAMES)])
    ).to(dev)


def slice12_phases(card: str, work: Path, env: dict, checkpoint: Path,
                   alongside=None) -> dict:
    """Phase 16: the reference-named feature extractors, reconstruction,
    prosody and export, each through its entry points on the card with the
    launch counts set to 0 just before. ``sliding_window``:
    ``MelSlidingWindowExtractor`` at its defaults fed 8.5 s hop by hop,
    then its batch path on the window (``logmel`` once per extraction at
    T = 257); the window's dB rows against the plain form by K3's rule,
    the normalized mel within 1e-4. ``egemaps_extractor``:
    ``EgemapsStreamingExtractor`` on a 20 s context with the 3-window
    concatenation, two refreshes (``cycle_dsum`` twice and ``dk_roots``
    once per window on 1,997 LLD rows), the functionals against the plain
    forms. ``mel_prosody``: ``MelSpectrogramExtractor``,
    ``InverseMelSpectrogram`` (the pitch round trip) and
    ``extract_prosody``, which launch no kernel, against the same calls on
    the CPU. ``export``: ``python -m koemorph_tpu_torch.export_model
    --benchmark`` on ``checkpoint`` (flagship, egemaps with the
    concatenation) in a subprocess, the ``.pt2`` reloaded and run in
    another for 30 frames with the carry threaded (launches counted and
    profiled there), within 1e-5 of the live module and 1e-4 of the plain
    forms, the three operators in its graph; the live frame through the
    operators (:func:`through_operators`) bitwise equal to the direct
    route with the same launches, the two routes' frame times and each
    kernel call's host time (:func:`dispatch_host_ms`) in alternating
    rounds. ``alongside()``, when given, runs in this process while the
    export CLI runs in its own (phase 17's smoke rehearsal: the CLI's
    tracing keeps one host core busy for about a minute); its result is
    returned under ``"alongside"``. Returns the recorded kernel
    arguments, the checks against the plain forms and the launch counts
    for the kernels table."""
    import torch
    from koemorph_tpu_torch.export import FrameFunction, benchmark_rounds
    from koemorph_tpu_torch.features import (EgemapsStreamingExtractor,
                                             InverseMelSpectrogram,
                                             MelSlidingWindowExtractor,
                                             MelSpectrogramExtractor)
    from koemorph_tpu_torch.models.dual_stream_model import (
        SimplifiedDualStreamModel)
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.ops import frontend
    from koemorph_tpu_torch.ops.egemaps import FEATURE_NAMES
    from koemorph_tpu_torch.ops.library import OPS
    from koemorph_tpu_torch.ops.prosody import extract_prosody
    from koemorph_tpu_torch.utils.params import (load_model_state,
                                                 read_model_state)

    out: dict = {"rec": {}, "shapes": {}}
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    none = dict.fromkeys(KERNEL_PATTERNS, 0)

    # ---- sliding_window: the host ring, K3 per extraction ----
    audio = voiced_audio(8.5, seed=21)
    ex = MelSlidingWindowExtractor()
    check(ex.device.type == dev.type, f"the extractor runs on {ex.device}")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_kernels(out["rec"], "sliding_window"):
        for i in range(len(audio) // HOP):
            win = ex.process_audio_frame(audio[i * HOP:(i + 1) * HOP])
        loop_s = time.perf_counter() - t0
        window_audio = ex.buffer.get_current_audio()
        batch = ex.process_audio_batch(window_audio)
    launches = ck.launches()
    out["shapes"]["sliding_window"] = shapes = dict(ck.SHAPE_LAUNCHES)
    stats = ex.get_stats()
    t_win = 1 + len(window_audio) // HOP
    mel_k, det_k = ex._compute(window_audio)
    with torch.inference_mode():
        x_win = torch.from_numpy(window_audio).to(dev)
        db_k = frontend.fused_log_mel_frontend(x_win)
    with plain_forms():
        mel_p, det_p = ex._compute(window_audio)
        with torch.inference_mode():
            db_p = frontend.fused_log_mel_frontend(x_win)
    d_mel = float(max(np.abs(mel_k - mel_p).max(),
                      np.abs(det_k - det_p).max()))
    want = {**none, "logmel": stats["extractions"] + 1}
    emit({"phase": "sliding_window", "card": card, "frames_fed": i + 1,
          "window_frames": int(win.shape[0]), "logmel_T": t_win,
          "stats": stats, "loop_s": loop_s, "launches": launches,
          "launches_by_shape": {f"{a}{list(b)}": v
                                for (a, b), v in shapes.items()},
          "expected_launches": want,
          "batch_shape": list(batch.shape),
          "mel_max_abs_diff_plain": d_mel, "bound_plain": SHIM_PLAIN_MAX,
          "db_max_abs_diff_plain": float((db_k - db_p).abs().max()),
          "db_k3_rule": k3_rule(db_k, db_p)})
    check(win.shape == (256, 80) and batch.shape == (1, t_win, 80)
          and bool(np.isfinite(batch).all()),
          f"sliding window shapes {win.shape} {batch.shape}")
    check(launches == want and shapes == {("logmel", (t_win,)):
                                          want["logmel"]},
          f"the sliding window launched {launches} ({shapes}), expected "
          f"{want} at T = {t_win}")
    check(d_mel <= SHIM_PLAIN_MAX and k3_rule(db_k, db_p),
          f"the sliding window vs the plain forms: {d_mel}")

    # ---- egemaps_extractor: 3 windows of 20 s per refresh ----
    context = voiced_audio(22.6, seed=22)
    gex = EgemapsStreamingExtractor()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_kernels(out["rec"], "egemaps_extractor"):
        first = gex.process_audio_frame(context[:-HOP], timestamp=0.0)
        cached = gex.process_audio_frame(context[-HOP:], timestamp=0.1)
        gex.process_audio_frame(context[-2 * HOP:-HOP], timestamp=0.4)
        torch.cuda.synchronize()
    refresh_s = (time.perf_counter() - t0) / 2
    launches = ck.launches()
    out["shapes"]["egemaps_extractor"] = shapes = dict(ck.SHAPE_LAUNCHES)
    concat = gex.get_concatenated_features()
    rows = 1 + (int(20.0 * SR) - 512) // 160
    n_win = 2 * len(gex.window_intervals)
    want = {"cycle_dsum": 2 * n_win, "dk_roots": n_win, "logmel": 0,
            "linear_3xtf32": 0}
    want_shapes = {("cycle_dsum", (rows, 8, 17, 512)): n_win,
                   ("cycle_dsum", (rows, 5, 33, 1024)): n_win,
                   ("dk_roots", (rows,)): n_win}
    with plain_forms():
        pex = EgemapsStreamingExtractor()
        pex.process_audio_frame(context[:-HOP], timestamp=0.0)
        pex.process_audio_frame(context[-HOP:], timestamp=0.1)
        pex.process_audio_frame(context[-2 * HOP:-HOP], timestamp=0.4)
    plain_concat = pex.get_concatenated_features()
    rtol = np.tile([SHIM_EGEMAPS_RTOL_LOOSE
                    if (n.startswith("F0semitone") and "Slope" in n)
                    or n.startswith("jitterLocal") else SHIM_EGEMAPS_RTOL
                    for n in FEATURE_NAMES], 3)
    excess = (np.abs(concat - plain_concat)
              - (SHIM_EGEMAPS_ATOL + rtol * np.abs(plain_concat)))
    emit({"phase": "egemaps_extractor", "card": card,
          "context_s": gex.context_window, "lld_rows": rows,
          "extractions": gex.extractions, "served_cache": cached is first,
          "refresh_host_s": refresh_s, "launches": launches,
          "launches_by_shape": {f"{a}{list(b)}": v
                                for (a, b), v in shapes.items()},
          "expected_launches": want, "feature_dim": int(concat.shape[0]),
          "finite": bool(np.isfinite(concat).all()),
          "max_abs_diff_plain": float(np.abs(concat - plain_concat).max()),
          "worst_excess_plain": float(excess.max()),
          "worst_feature": FEATURE_NAMES[int(np.argmax(excess)) % 88]})
    check(gex.extractions == 2 and cached is first and concat.shape == (264,)
          and bool(np.isfinite(concat).all()),
          f"the eGeMAPS extractor: {gex.get_stats()}")
    check(launches == want and shapes == want_shapes,
          f"the eGeMAPS extractor launched {launches} ({shapes}), expected "
          f"{want_shapes}")
    check(float(excess.max()) <= 0,
          "the eGeMAPS extractor vs the plain forms beyond the bound at "
          f"{FEATURE_NAMES[int(np.argmax(excess)) % 88]}")

    # ---- mel_prosody: no kernel on these paths; the card vs the CPU ----
    clip = voiced_audio(2.0, seed=24)
    tone = (0.5 * np.sin(2 * np.pi * 220.0 * np.arange(SR) / SR)).astype(
        np.float32)
    ck.reset_launch_counts()
    mx = MelSpectrogramExtractor()
    log_mel = mx(clip).cpu().numpy()
    ex60 = MelSpectrogramExtractor(n_fft=1024, target_fps=60.0)
    rec = InverseMelSpectrogram(n_fft=1024, target_fps=60.0, n_iter=32)(
        ex60(tone)).cpu().numpy()[0]
    with torch.inference_mode():
        pros = extract_prosody(torch.from_numpy(clip).to(dev)).cpu().numpy()
    launches = ck.launches()
    log_mel_cpu = MelSpectrogramExtractor(device="cpu")(clip).numpy()
    pros_cpu = extract_prosody(torch.from_numpy(clip)).numpy()
    spec = np.abs(np.fft.rfft(rec))
    dominant = float(np.fft.rfftfreq(len(rec), 1 / SR)[np.argmax(spec)])
    both = (pros[:, 0] > 0) & (pros_cpu[:, 0] > 0)
    d_f0 = float(np.median(np.abs(pros[both, 0] - pros_cpu[both, 0])))
    emit({"phase": "mel_prosody", "card": card, "launches": launches,
          "log_mel_shape": list(log_mel.shape),
          "log_mel_max_abs_diff_cpu": float(np.abs(log_mel
                                                   - log_mel_cpu).max()),
          "griffin_lim_dominant_hz": dominant,
          "griffin_lim_peak": float(np.abs(rec).max()),
          "prosody_shape": list(pros.shape),
          "prosody_voiced_frames": int(both.sum()),
          "prosody_f0_median_abs_diff_cpu_hz": d_f0,
          "prosody_voicing_agreement": float(
              ((pros[:, 0] > 0) == (pros_cpu[:, 0] > 0)).mean()),
          "prosody_energy_max_abs_diff_cpu": float(
              np.abs(pros[:, 1] - pros_cpu[:, 1]).max())})
    check(launches == none, f"mel / reconstruction / prosody launched "
          f"{launches}")
    check(log_mel.shape == (1, 60, 80)
          and float(np.abs(log_mel - log_mel_cpu).max()) <= SHIM_PLAIN_MAX,
          "MelSpectrogramExtractor on the card vs the CPU")
    check(abs(dominant - 220.0) < 15.0 and 0.05 < np.abs(rec).max() < 5.0
          and bool(np.isfinite(rec).all()),
          f"the Griffin-Lim round trip: {dominant} Hz")
    check(pros.shape == (60, 4) and bool(np.isfinite(pros).all())
          and both.sum() > 20 and d_f0 < 0.01
          and float(np.abs(pros[:, 1] - pros_cpu[:, 1]).max()) <= 1e-3,
          f"extract_prosody on the card vs the CPU: {d_f0} Hz")

    # ---- export: the CLI, then the program reloaded in another process ----
    check((checkpoint / "state.pth").exists(),
          f"no checkpoint at {checkpoint}")
    export_dir = work / "export"
    proc, beside, export_s = run_beside(
        [sys.executable, "-m", "koemorph_tpu_torch.export_model",
         "--model", str(checkpoint), "--output", str(export_dir),
         "--benchmark"], env, alongside or (lambda: None))
    check(proc.returncode == 0,
          f"export_model failed:\n{proc.stderr[-3000:]}")
    (report,) = json.loads(proc.stdout)
    out_npy = work / "export_frames.npy"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", EXPORT_RUN, report["path"], str(out_npy),
         DEVICE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    reload_s = time.perf_counter() - t0
    check(run.returncode == 0,
          f"the reloaded program failed:\n{run.stderr[-3000:]}")
    ran = json.loads(run.stdout.strip().splitlines()[-1])
    got = np.load(out_npy)
    # the live module on the same frames, its kernels' arguments recorded
    sd, fixed = read_model_state(checkpoint)
    model = SimplifiedDualStreamModel(dropout=0.0, **fixed)
    load_model_state(model, sd, str(checkpoint))
    frame_fn = FrameFunction(model.eval().to(dev))
    frames = export_frames(dev)

    def live_run():
        prev = torch.zeros((1, 52), device=dev)
        init = torch.zeros((1,), dtype=torch.bool, device=dev)
        outs = []
        for a in frames:
            b, prev, init = frame_fn(a, prev, init)
            outs.append(b)
        return torch.cat(outs).cpu().numpy()

    with torch.no_grad():
        with recording_kernels(out["rec"], "export"):
            frame_fn(frames[0], torch.zeros((1, 52), device=dev),
                     torch.zeros((1,), dtype=torch.bool, device=dev))
        live = live_run()
        live_ms = _event_ms(lambda: frame_fn(
            frames[0], torch.zeros((1, 52), device=dev),
            torch.zeros((1,), dtype=torch.bool, device=dev)), 20)
        live_ks = device_kernels(lambda: [frame_fn(
            a, torch.zeros((1, 52), device=dev),
            torch.zeros((1,), dtype=torch.bool, device=dev))
            for a in frames[:EXPORT_PROFILED]])
        with plain_forms():
            plain = live_run()
        # the live frame with the dispatchers as they are (the wrappers
        # direct) against the same frame through the operators
        carry = (torch.zeros((1, 52), device=dev),
                 torch.zeros((1,), dtype=torch.bool, device=dev))
        direct_b = frame_fn(frames[0], *carry)[0]
        ck.reset_launch_counts()
        with through_operators():
            routed_b = frame_fn(frames[0], *carry)[0]
        routed_launches = ck.launches()

        def routed(*args):
            with through_operators():
                return frame_fn(*args)

        route_ms = round_stats(benchmark_rounds(
            {"direct": frame_fn, "operators": routed}, (frames[0], *carry),
            rounds=ROUTE_ROUNDS, warmup=3, iters=ROUTE_CALLS))
        dispatch = dispatch_host_ms(out["rec"], "export", ROUTE_ROUNDS, 200)
    route_equal = bool(torch.equal(direct_b, routed_b))
    d_live = float(np.abs(got - live).max())
    d_plain = float(np.abs(got - plain).max())
    out["shapes"]["export"] = {(k, tuple(v)): n
                               for k, v, n in ran["launches_by_shape"]}
    per_frame = {"cycle_dsum": 2, "dk_roots": 1, "logmel": 1,
                 "linear_3xtf32": 0}
    prof_want = {k: v * EXPORT_PROFILED * KERNELS_PER_LAUNCH[k]
                 for k, v in per_frame.items()}
    emit({"phase": "export", "card": card, "report": report,
          "export_cli_s": export_s, "reload_run_s": reload_s,
          "operators_in_graph": [t for t in ran["targets"]
                                 if t.startswith("koemorph_torch.")],
          "launches": ran["launches"],
          "launches_by_shape": ran["launches_by_shape"],
          "profiled_kernels": ran["profiled_kernels"],
          "profiled_expected": prof_want,
          "frames": int(got.shape[0]),
          "exported_frame_ms": q(ran["frame_ms"][1:]),
          "exported_first_frame_ms": ran["frame_ms"][0],
          "live_frame_ms": q(live_ms),
          "exported_profile": {k: ran[k] for k in (
              "op_inputs", "activities_per_frame", "busy_ms_per_frame",
              "copies_per_frame", "top_kernels_us")},
          "live_profile": {
              "activities_per_frame": len(live_ks) / EXPORT_PROFILED,
              "busy_ms_per_frame": sum(us for _, us in live_ks)
              / EXPORT_PROFILED / 1e3,
              "copies_per_frame": copies(live_ks, EXPORT_PROFILED),
              "top_kernels_us": profile_summary(live_ks,
                                                EXPORT_PROFILED)},
          "benchmark_ms": {**round_stats(report["latency_rounds_ms"]),
                           "device": report["device"]},
          "max_abs_diff_live": d_live, "bound_live": EXPORT_LIVE_MAX,
          "max_abs_diff_plain": d_plain, "bound_plain": EXPORT_PLAIN_MAX,
          "live_route": {**route_ms, "launches_operators": routed_launches,
                         "bitwise_equal": route_equal},
          "dispatch_host_ms_per_call": dispatch})
    check(report["passed"] and report["max_abs_diff"] < EXPORT_LIVE_MAX,
          f"export_model's gate: {report}")
    check({f"{op}.default" for op in OPS} <= set(ran["targets"]),
          f"the exported graph lacks an operator: {ran['targets']}")
    check(got.shape == (EXPORT_FRAMES, 52) and bool(np.isfinite(got).all())
          and got.min() >= 0.0 and got.max() <= 1.0,
          f"the exported program's output {got.shape}")
    check(d_live <= EXPORT_LIVE_MAX and d_plain <= EXPORT_PLAIN_MAX,
          f"the exported program vs the live module {d_live}, vs the plain "
          f"forms {d_plain}")
    check(route_equal and routed_launches == per_frame,
          f"the live frame through the operators launched "
          f"{routed_launches}, bitwise equal to the direct route: "
          f"{route_equal}")
    check(ran["launches"] == {k: v * EXPORT_FRAMES
                              for k, v in per_frame.items()},
          f"the exported program launched {ran['launches']} in "
          f"{EXPORT_FRAMES} frames")
    check(ran["profiled_kernels"] == prof_want,
          f"the profiler saw {ran['profiled_kernels']} in the exported "
          f"program's {EXPORT_PROFILED} frames, expected {prof_want}")
    rows_f = 1 + (256 * HOP - 512) // 160
    want_shapes = {("cycle_dsum", (rows_f, 8, 17, 512)): EXPORT_FRAMES,
                   ("cycle_dsum", (rows_f, 5, 33, 1024)): EXPORT_FRAMES,
                   ("dk_roots", (rows_f,)): EXPORT_FRAMES,
                   ("logmel", (1 + 256,)): EXPORT_FRAMES}
    check(out["shapes"]["export"] == want_shapes,
          f"the exported program's launches by shape "
          f"{out['shapes']['export']}, expected {want_shapes}")

    # every launch shape of the phase's paths, on the arguments recorded,
    # against the kernel's plain form
    held = hold_recorded(out["rec"], SLICE12_PATHS)
    emit({"phase": "slice12_kernels_vs_plain", "card": card,
          "held": {f"{name} {tag} {shape}": {
              k: v for k, v in r.items() if k != "plain_misses_rounded"}
              for (name, tag, shape), r in held.items()}})
    check(held and all(r["ok"] for r in held.values()),
          "kernels vs plain forms on the phase-16 paths: "
          + str([k for k, r in held.items() if not r["ok"]]))
    out["held"] = held
    out["alongside"] = beside
    emit({"phase": "slice12", "seconds": time.perf_counter() - t_phase})
    return out


#: the compiled train step's paths (phase 17), whose kernel arguments the
#: eager twins record; their launch shapes are those of phases 10 and 14,
#: whose rows of the kernels line count their launches too
SLICE13_TAGS = ("train_graph", "legacy_graph", "e2v_graph")
#: graphed and eager steps of the flagship sequential trainer, and of the
#: legacy and emotion2vec trainers
GRAPH_STEPS, GRAPH_STEPS_SHORT = 12, 4
#: the legacy trainer's batch: 16 files of 12 s (192,000 samples, 361
#: frames of K3 each)
LEGACY_SAMPLES = 192000


def rehearsal_smoke(work: Path) -> dict:
    """``python -m koemorph_tpu_torch.training_rehearsal --smoke`` through
    its ``main()`` in this process: its return code (0: the gate passed),
    its summary line and its wall seconds."""
    from koemorph_tpu_torch import training_rehearsal
    t0 = time.perf_counter()
    rc, summary = _stdout_json(lambda: training_rehearsal.main([
        "--smoke", "--work-dir", str(work / "s13_rehearsal"),
        "--report-dir", str(work / "s13_rehearsal_report")]))
    return {"rc": rc, "summary": summary,
            "wall_s": time.perf_counter() - t0}


def host_scalar_step(opt, grads) -> None:
    """The optimizer update as it was before the compiled step (its
    learning rate and bias corrections Python floats, the moments and the
    accumulator reassigned), for :func:`optimizer_scalars_phase`."""
    import torch
    from koemorph_tpu_torch.train.optim import global_norm
    if opt.acc is not None:
        n = opt.mini_step
        for k, g in grads.items():
            opt.acc[k] = opt.acc[k] + (g - opt.acc[k]) / (n + 1)
        opt.mini_step = (n + 1) % opt.accumulate
        if n != opt.accumulate - 1:
            return
        opt.gradient_step += 1
        grads = opt.acc
        opt.acc = {k: torch.zeros_like(p) for k, p in opt.params.items()}
    if opt.clip is not None:
        norm = global_norm(grads.values())
        keep = norm < opt.clip
        grads = {k: torch.where(keep, g, g / norm * opt.clip)
                 for k, g in grads.items()}
    lr = opt.schedule(opt.count)
    opt.count += 1
    if opt.name == "sgd":
        for k, p in opt.params.items():
            opt.trace[k] = grads[k] + opt.momentum * opt.trace[k]
            p.add_(opt.trace[k] * -lr)
        return
    bc1 = 1.0 - opt.b1 ** opt.count
    bc2 = 1.0 - opt.b2 ** opt.count
    for k, p in opt.params.items():
        g = grads[k]
        opt.mu[k] = (1.0 - opt.b1) * g + opt.b1 * opt.mu[k]
        opt.nu[k] = (1.0 - opt.b2) * (g * g) + opt.b2 * opt.nu[k]
        update = (opt.mu[k] / bc1) / (torch.sqrt(opt.nu[k] / bc2) + opt.eps)
        if opt.weight_decay:
            update = update + opt.weight_decay * p
        p.add_(update * -lr)


def optimizer_scalars_phase(card: str) -> None:
    """``optimizer_scalars``: on the card, the optimizer's update with its
    per-update scalars read from device rows and its state written in
    place, bit for bit the update with host scalars
    (:func:`host_scalar_step`), over 10 updates that cross a warm-up ->
    cosine boundary, with clipping triggered and not, for AdamW (with and
    without accumulation) and SGD."""
    import torch
    from koemorph_tpu_torch.train.optim import create_optimizer
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    start = {"w": rng.normal(0, 1, (256, 264)).astype(np.float32),
             "b": rng.normal(0, 1, (52,)).astype(np.float32)}
    res = {}
    for name, acc in (("adamw", 1), ("adamw", 2), ("sgd", 1)):
        cfg = {"optimizer": {"name": name, "lr": 5e-4, "weight_decay": 1e-5,
                             "betas": [0.9, 0.999]},
               "lr_scheduler": {"name": "cosine", "t_max": 4,
                                "warmup_steps": 3, "eta_min": 1e-6},
               "gradient_clip_val": 1.0, "accumulate_grad_batches": acc}
        new, old = (create_optimizer(cfg, {k: torch.from_numpy(v).to(dev)
                                           for k, v in start.items()},
                                     steps_per_epoch=2)
                    for _ in range(2))
        differ = []
        for i in range(10 * acc):
            scale = 3.0 if i % 3 == 0 else 0.01
            g = {k: torch.from_numpy(rng.normal(0, scale, v.shape).astype(
                np.float32)).to(dev) for k, v in start.items()}
            new.step(g)
            host_scalar_step(old, g)
            differ += [(i, k) for k in start
                       if not torch.equal(new.params[k], old.params[k])]
        res[f"{name} k={acc}"] = {"updates": new.count,
                                  "differ": differ[:4]}
    emit({"phase": "optimizer_scalars", "card": card, **res})
    check(all(not r["differ"] and r["updates"] == 10 for r in res.values()),
          f"device-scalar updates != host-scalar updates: {res}")


def _train_state(trainer) -> dict:
    """Copies of the tensors a train step writes (the parameters and the
    optimizer's moments, momentum and accumulator) by name."""
    out = {f"param {k}": v.detach().clone()
           for k, v in trainer.params.items()}
    for name in ("mu", "nu", "trace", "acc"):
        for k, v in (getattr(trainer.optimizer, name, None) or {}).items():
            out[f"{name} {k}"] = v.clone()
    return out


def _differ(a: dict, b: dict) -> list:
    """The names whose tensors are not bitwise equal."""
    import torch
    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def graphed_vs_eager(out: dict, card: str, tag: str, make, batches: list,
                     n_steps: int, snapshot_at: int = 0) -> dict:
    """One trainer's compiled step against its eager step, from one start.
    The eager twin (``graphs=False``) runs ``n_steps`` steps first, timed
    between CUDA events, recording the kernels' arguments under ``tag``.
    Then, with the launch counts set to 0 just before it is built, the
    graphed trainer runs the same steps in profiling windows: its state
    (parameters, moments, count) and every step's metrics are held bit for
    bit against the eager twin's, and the kernels the profiler saw in its
    replays against what its graphs recorded. ``n_steps`` more graphed
    steps are timed between CUDA events. Returns the record of the run
    (and, with ``snapshot_at``, the graphed state after that step)."""
    import torch
    from koemorph_tpu_torch.ops import cuda as ck

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    eager = make(False, f"{tag}_eager")
    ck.reset_launch_counts()
    m_eager, ev_eager = [], []
    with recording_kernels(out["rec"], tag):
        for i in range(n_steps):
            e0, e1 = events()
            e0.record()
            m_eager.append(eager.train_step(batches[i % len(batches)]))
            e1.record()
            ev_eager.append((e0, e1))
    torch.cuda.synchronize()
    eager_per_step = {k: v / n_steps for k, v in ck.launches().items()}
    eager_ms = np.asarray([a.elapsed_time(b) for a, b in ev_eager])

    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    graphed = make(None, f"{tag}_graphed")
    m_graphed, snap = [], {}

    def run(lo, hi):
        for i in range(lo, hi):
            m_graphed.append(graphed.compiled_step(
                batches[i % len(batches)]))
            if i + 1 == snapshot_at:
                snap.update(_train_state(graphed))

    graphs = graphed.step_graphs
    ks = []
    for fn in in_windows(n_steps, run):
        ks += device_kernels(None, profiled(fn))
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wrapper, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
    seen = {src: n / KERNELS_PER_LAUNCH[src]
            for src, n in own_kernels(ks).items()}
    check(len(graphs) == 1, f"{tag}: {len(graphs)} graphs for one shape")
    per_replay = recorded(graphs, graphs.keys()[0])
    total = collections.Counter(shapes)
    for key, n in graphs.replays.items():
        for shape_key, c in graphs.launches(key).items():
            total[shape_key] += n * c
    # the profiled windows ran the replays and the capture's eager warm-up
    # step, whose launches the wrappers counted besides the capture's record
    warm = {name: wrapper[name] - per_replay[name] for name in KERNEL_PATTERNS}
    want = {name: sum(n * recorded(graphs, key)[name]
                      for key, n in graphs.replays.items()) + warm[name]
            for name in KERNEL_PATTERNS}
    state_diff = _differ(_train_state(eager), _train_state(graphed))
    metric_diff = [(i, k) for i, (a, b) in enumerate(zip(m_eager, m_graphed))
                   for k in a if not torch.equal(a[k], b[k])]
    counts = (eager.optimizer.count, graphed.optimizer.count)

    # activities and device time of replays alone, then more replays
    # timed between CUDA events, no profiler
    ks = device_kernels(None, profiled(lambda: [
        graphed.compiled_step(batches[i % len(batches)])
        for i in range(WINDOW)]))
    ev_graphed = []
    for i in range(n_steps):
        e0, e1 = events()
        e0.record()
        graphed.compiled_step(batches[i % len(batches)])
        e1.record()
        ev_graphed.append((e0, e1))
    torch.cuda.synchronize()
    graphed_ms = np.asarray([a.elapsed_time(b) for a, b in ev_graphed])
    busy_ms = sum(us for _, us in ks) / 1e3 / WINDOW
    res = {"phase": tag, "card": card, "steps": n_steps,
           "batch": int(batches[0]["audio"].shape[0]),
           "bitwise_equal": not state_diff and not metric_diff,
           "state_diff": state_diff[:8], "metric_diff": metric_diff[:8],
           "count": list(counts),
           "graphed_step_ms": q(graphed_ms),
           "eager_first_step_ms": float(eager_ms[0]),
           "eager_step_ms": q(eager_ms[1:]),
           "speedup_median": float(np.median(eager_ms[1:])
                                   / np.median(graphed_ms)),
           "activities_per_step": len(ks) / WINDOW,
           "device_busy_ms_per_step": busy_ms,
           "device_busy_share": busy_ms / float(np.median(graphed_ms)),
           "peak_gb": peak_gb, "capture_s": graphs.capture_s,
           "graphs": len(graphs),
           "launches_per_replay": per_replay,
           "eager_launches_per_step": eager_per_step,
           "launches_by_shape": {f"{k[0]}{list(k[1])}": v
                                 for k, v in total.items()},
           "warm_and_capture_launches": wrapper,
           "profiled_kernels": seen,
           "recorded_x_replays_and_warm_up": want}
    emit(res)
    check(res["bitwise_equal"] and counts[0] == counts[1] == n_steps,
          f"{tag}: graphed != eager: {state_diff[:8]} {metric_diff[:8]} "
          f"{counts}")
    check({k: float(v) for k, v in per_replay.items()} == eager_per_step,
          f"{tag}: a replay's launches {per_replay} != an eager step's "
          f"{eager_per_step}")
    check(seen == {k: float(v) for k, v in want.items()},
          f"{tag}: profiled kernels {seen} != the record x replays and "
          f"the warm-up's {want}")
    out["shapes"][tag] = dict(total)
    res["snapshot"] = snap
    res["trainer"] = graphed
    del eager
    return res


def slice13_phases(card: str, work: Path, synth: Path, rehearsal=None,
                   train_hold=None) -> dict:
    """Phase 17: the compiled train step, the scan epochs, the profiling
    entry points and the microphone flags. ``optimizer_scalars``: the
    device-scalar update against the host-scalar one
    (:func:`optimizer_scalars_phase`); ``train_graph``: 12 flagship
    steps (``configs/dual_stream_config.yaml``, batch 16, span 288,
    dropout 0.1) graphed and 12 eager from one start, bitwise
    (:func:`graphed_vs_eager`); ``legacy_graph`` and ``e2v_graph``: the
    same for ``KoeMorphTrainer`` (``configs/config.yaml``, batch 16, 12 s)
    and the emotion2vec trainer (batch 16), 4 steps each; ``train_resume
    _graphed``: 2 graphed steps, a checkpoint, a fresh graphed trainer's
    ``resume()`` and 2 more, bitwise the uninterrupted graphed run;
    ``train_scan``: ``train_epochs_scan`` over 2 epochs of phase 10's 12
    batches, bitwise per-epoch ``train_epoch_scan`` in the same orders,
    with the host-to-device copies the profiler saw in it and its peak
    memory (phase 10's ``train_cli`` trains through ``--scan-epochs``
    and serves what it wrote); ``rehearsal_scan``:
    ``training_rehearsal --smoke``, its gate; ``profile_entry_points``:
    ``profile_training`` and ``profile_multistream``; ``mic_flags``: ``rt
    --list-devices`` and ``rt --mic`` without ``pyaudio`` (the entry
    points' ``main()`` in this process; phase 10 runs the CLIs in
    subprocesses). ``rehearsal``: :func:`rehearsal_smoke`'s result when
    it ran already (beside phase 16's export CLI), else it runs here.
    ``train_hold``: phase 10's K2 arguments and hold at the training rows,
    reused where the eager twin passed the same rows. Returns the
    kernels' recorded arguments, their launch counts per path and their
    plain-form holds, for the kernels table."""
    import torch
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.train.__main__ import build_model
    from koemorph_tpu_torch.train.trainer import (KoeMorphTrainer,
                                                  SequentialTrainer,
                                                  scan_orders)
    from koemorph_tpu_torch.utils.config import load_config, to_dict

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out: dict = {"rec": {}, "shapes": {}}
    config_path = ROOT / "configs" / "dual_stream_config.yaml"
    optimizer_scalars_phase(card)

    def sequential(overrides=()):
        cfg = load_config(config_path, overrides=list(overrides))
        batch_size = int(cfg.data.batch_size)

        def make(graphs, name):
            model, kind = build_model(cfg)
            check(kind == "sequence", f"the config's model is {kind}")
            return SequentialTrainer(
                model, to_dict(cfg), work_dir=work / f"s13_{name}",
                steps_per_epoch=12, span_frames=model.window_frames + 32,
                graphs=graphs)

        loader_fn, _ = create_sequential_dataloader(
            synth, batch_size=batch_size, window_frames=256 + 32,
            stride_frames=int(cfg.data.stride_frames),
            sample_rate=int(cfg.data.sample_rate),
            target_fps=float(cfg.data.target_fps))
        return make, loader_fn, batch_size

    # ---- train_graph: the flagship sequential trainer ----
    make_s, loader_fn, batch_size = sequential()
    host_batches = list(loader_fn())
    check(len(host_batches) == GRAPH_STEPS
          and all(int(b["audio"].shape[0]) == batch_size
                  for b in host_batches),
          f"{len(host_batches)} flagship batches")
    probe = make_s(False, "probe")
    batches = [probe._prepare(b) for b in host_batches]
    del probe
    seq = graphed_vs_eager(out, card, "train_graph", make_s, batches,
                           GRAPH_STEPS, snapshot_at=4)
    check(seq["launches_per_replay"] == {"cycle_dsum": 2, "dk_roots": 1,
                                         "logmel": 2, "linear_3xtf32": 0},
          f"a flagship replay's launches: {seq['launches_per_replay']}")
    graphed_median = seq["graphed_step_ms"]["median_ms"]
    trainer = seq.pop("trainer")
    snap4 = seq.pop("snapshot")
    del trainer

    # ---- train_resume_graphed: 2 graphed steps, save, resume, 2 more ----
    first = make_s(None, "resume")
    for b in batches[:2]:
        first.compiled_step(b)
    first._save(None)
    del first
    resumed = make_s(None, "resume")
    check(resumed.resume() and resumed.global_step == 2,
          "the resumed graphed trainer did not find its checkpoint")
    for b in batches[2:4]:
        resumed.compiled_step(b)
    diff = _differ(snap4, _train_state(resumed))
    emit({"phase": "train_resume_graphed", "steps": 4, "dropout": 0.1,
          "bitwise_equal": not diff, "differ": diff[:8],
          "count": resumed.optimizer.count})
    check(not diff and resumed.optimizer.count == 4,
          f"a resumed graphed run != the uninterrupted one: {diff[:8]}")
    del resumed, snap4

    # ---- legacy_graph: KoeMorphTrainer on configs/config.yaml ----
    lcfg = load_config(ROOT / "configs" / "config.yaml")
    l_batch = int(lcfg.data.batch_size)

    def make_l(graphs, name):
        model, kind = build_model(lcfg)
        check(kind == "frame", f"the legacy config's model is {kind}")
        return KoeMorphTrainer(model, to_dict(lcfg),
                               work_dir=work / f"s13_{name}",
                               steps_per_epoch=12, graphs=graphs)

    rng = np.random.default_rng(13)
    # 2 batches of the voiced pattern, each row shifted 0.25 s
    base = voiced_audio((LEGACY_SAMPLES + (2 * l_batch - 1) * SERVE_SHIFT)
                        / SR, seed=10)
    l_batches = []
    for s in range(2):
        audio = np.stack([base[(s * l_batch + i) * SERVE_SHIFT:
                               (s * l_batch + i) * SERVE_SHIFT
                               + LEGACY_SAMPLES] for i in range(l_batch)])
        l_batches.append({
            "audio": torch.from_numpy(audio).to(dev),
            "arkit": torch.from_numpy(rng.uniform(
                0, 0.3, (l_batch, 360, 52)).astype(np.float32)).to(dev),
            "sample_mask": torch.ones((l_batch,), device=dev)})
    leg = graphed_vs_eager(out, card, "legacy_graph", make_l, l_batches,
                           GRAPH_STEPS_SHORT)
    check(leg["launches_per_replay"] == {"cycle_dsum": 0, "dk_roots": 0,
                                         "logmel": 1, "linear_3xtf32": 0},
          f"a legacy replay's launches: {leg['launches_per_replay']}")
    del leg["trainer"]

    # ---- e2v_graph: the emotion2vec trainer's step ----
    make_e, _, _ = sequential(["model.emotion_config.backend=emotion2vec"])
    e2v = graphed_vs_eager(out, card, "e2v_graph", make_e, batches[:2],
                           GRAPH_STEPS_SHORT)
    check(e2v["launches_per_replay"]["logmel"] == 2
          and e2v["launches_per_replay"]["cycle_dsum"] == 0
          and e2v["launches_per_replay"]["linear_3xtf32"] == 0,
          f"an emotion2vec replay's launches: {e2v['launches_per_replay']}")
    del e2v["trainer"]
    torch.cuda.empty_cache()

    # ---- train_scan: 2 epochs at once against per-epoch scans ----
    torch.cuda.reset_peak_memory_stats()
    multi = make_s(None, "scan_multi")
    t0 = time.perf_counter()
    box = []
    prof = profiled(lambda: box.append(multi.train_epochs_scan(
        iter(host_batches), n_epochs=2, shuffle_seed=13)))
    scan_wall = time.perf_counter() - t0
    hist = box[0]
    scan_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    acts = [e.name for e in measured_events(prof)
            if str(e.device_type).endswith("CUDA")]
    htod = sum(n.startswith("Memcpy HtoD") for n in acts)
    arrays = len({k for b in host_batches for k, v in b.items()
                  if not isinstance(v, list)}) + 1        # + sample_mask
    per_epoch = make_s(None, "scan_per_epoch")
    orders = scan_orders(len(host_batches), 2, 13)
    hist_ref = [per_epoch.train_epoch_scan(iter([host_batches[i]
                                                 for i in o]))
                for o in orders]
    diff = _differ(_train_state(multi), _train_state(per_epoch))
    steps = 2 * len(host_batches)
    emit({"phase": "train_scan", "card": card, "epochs": 2,
          "steps": steps, "orders": orders,
          "bitwise_equal": not diff and hist == hist_ref,
          "differ": diff[:8], "memcpy_htod_in_scan": htod,
          "stacked_arrays_plus_table": arrays + 1,
          "device_activities": len(acts),
          "wall_s": scan_wall,
          "steps_per_wall_s": steps / scan_wall,
          "peak_gb": scan_peak_gb,
          "epoch_losses": [h["loss"] for h in hist]})
    check(not diff and hist == hist_ref,
          f"train_epochs_scan != per-epoch scans: {diff[:8]}")
    check(htod <= arrays + 1 < steps,
          f"{htod} host-to-device copies in a {steps}-step scan")
    check(multi.global_step == per_epoch.global_step == steps
          and multi.epoch == 2, "scan step counts")
    del multi, per_epoch
    torch.cuda.empty_cache()

    from koemorph_tpu_torch import profile_multistream, profile_training
    from koemorph_tpu_torch import rt as rt_cli

    # ---- rehearsal_scan: the smoke rehearsal, trained by scan ----
    reh = rehearsal or rehearsal_smoke(work)
    rc, summary = reh["rc"], reh["summary"]
    emit({"phase": "rehearsal_scan", "card": card, "rc": rc,
          "wall_s": reh["wall_s"],
          "beside_the_export_cli": rehearsal is not None,
          **{k: summary.get(k) for k in (
              "epochs", "steps_per_epoch", "correlation_last", "f1_last",
              "range_ratio_first", "range_ratio_last", "mae_last",
              "train_seconds", "cli")}})
    check(rc == 0, f"training_rehearsal --smoke failed its gate: {summary}")

    # ---- profile_entry_points: the training and session sweeps ----
    t0 = time.perf_counter()
    rc, pt = _stdout_json(lambda: profile_training.main([
        "--batches", "4", "8", "16", "--steps", "8"]), last_line=False)
    pt_s = time.perf_counter() - t0
    check(rc == 0, "profile_training failed")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_multistream.main(["--sessions", "64", "256",
                                       "--frames", "30"])
    pm = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    pm_s = time.perf_counter() - t0
    check(rc == 0, "profile_multistream failed")
    b16 = next(r for r in pt["results"] if r["batch"] == 16)
    emit({"phase": "profile_entry_points", "card": card,
          "profile_training": pt, "profile_training_s": pt_s,
          "profile_multistream": pm, "profile_multistream_s": pm_s,
          "batch16_ms_per_step": b16["ms_per_step"],
          "train_graph_median_ms": graphed_median,
          "ratio": b16["ms_per_step"] / graphed_median})
    check([r["batch"] for r in pt["results"]] == [4, 8, 16]
          and all(r["ms_per_step"] > 0 for r in pt["results"]),
          f"profile_training: {pt}")
    check([r["sessions"] for r in pm[:2]] == [64, 256]
          and all(r["step_ms"] > 0 for r in pm[:2]),
          f"profile_multistream: {pm}")

    # ---- mic_flags: rt without pyaudio ----
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lst_rc = rt_cli.main(["--list-devices"])
    try:
        rt_cli.main(["--mic", "--output", "none"])
        mic_error = None
    except RuntimeError as e:
        mic_error = str(e)
    emit({"phase": "mic_flags", "list_devices_rc": lst_rc,
          "list_devices_stdout": buf.getvalue(), "mic_error": mic_error})
    check(lst_rc == 0 and buf.getvalue() == "",
          f"rt --list-devices: {lst_rc} {buf.getvalue()!r}")
    check(mic_error is not None and "pyaudio not available" in mic_error,
          f"rt --mic without pyaudio: {mic_error}")

    # every launch shape of the three train graphs, on the arguments their
    # eager twins passed, against the kernel's plain form
    held = hold_recorded(out["rec"], SLICE13_TAGS, known=train_hold)
    emit({"phase": "slice13_kernels_vs_plain", "card": card,
          "held": {f"{name} {tag} {shape}": {
              k: v for k, v in r.items() if k != "plain_misses_rounded"}
              for (name, tag, shape), r in held.items()}})
    check(held and all(r["ok"] for r in held.values()),
          "kernels vs plain forms on the train graphs: "
          + str([k for k, r in held.items() if not r["ok"]]))
    out["held"] = held
    emit({"phase": "slice13", "seconds": time.perf_counter() - t_phase})
    return out


#: the paths of phase 18, named in the kernels table
SLICE14_PATHS = {"mesh_server": "mesh server entry",
                 "mesh_decode": "mesh decode entry",
                 "mesh_sequence_parallel": "sequence-parallel entry",
                 "dp_train": "data-parallel rank"}
#: a mesh path (two entries of one card) against its one-device path
MESH_MAX = 1e-5
#: the data-parallel steps at world 2 against the single-process steps
#: (tests/parallel/'s bounds for a sharded step)
DP_LOSS_RTOL, DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-5, 2e-4, 2e-6
#: the batch block of each data-parallel rank (batch 16 over 2 ranks)
DP_BLOCK = 8
DP_STEPS = 4


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def wall_ms(fn, n: int = 5) -> dict:
    """Host ms of ``n`` calls of ``fn``, each waited for, after one."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) * 1e3)
    return q(np.asarray(t))


def epoch_step_ms(stderr: str) -> list:
    """ms per step of each epoch the train CLI logged (its own wall clock
    over the epoch, the loader's batches included)."""
    return [1e3 * float(s) / int(n) for n, s in re.findall(
        r"epoch \d+(?: \(scan\))?: (\d+) steps in ([0-9.]+)s", stderr)]


def slice14_phases(card: str, work: Path, env: dict, decoder, dec_out,
                   audio_b, synth: Path) -> dict:
    """Phase 18: several devices, driven on one card.

    ``mesh_server``: the 64-session flagship server (8 cohorts) as a mesh
    of two ``cuda:0`` entries for ``SERVE_STEPS`` steps, graphed and
    counted (the counts set to 0 just before it is built), against the
    one-engine server within ``MESH_MAX`` and its eager twin bit for bit;
    ``serve_mesh_cli``: ``serve --mesh-devices 1`` and a two-entry replay
    (``--device cuda:0 --mesh-devices 2``) against the one-device CLI's
    rows; ``mesh_decode``: phase 7's 8 x 17.06 s decode and one
    utterance's ``decode_sequence_parallel`` over two entries against the
    one-device decode; ``dp_nccl``: a world-1 NCCL process group in this
    process, ``SequentialTrainer(mesh=make_mesh())`` through
    ``compiled_step`` (the all-reduces issued at the capture, none at a
    replay) bit for bit the single-process compiled step, at the ranks'
    batch block; ``dp_cli``: the train CLI under ``torch.distributed.run``
    with one NCCL rank and ``--scan-epochs`` bit for bit the
    single-process CLI, with two gloo ranks on the one card within the
    sharded-step bounds of it, and a two-rank resume bit for bit the
    uninterrupted two-rank run. Returns the kernels' recorded arguments
    and launch counts by path, for the kernels table."""
    import torch
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.data.wav import write_wav
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.parallel import (BatchedSequentialDecoder,
                                             distributed, make_mesh)
    from koemorph_tpu_torch.runtime import MultiStreamInference
    from koemorph_tpu_torch.runtime.engine import build_streaming_model
    from koemorph_tpu_torch.train.__main__ import build_model
    from koemorph_tpu_torch.train.checkpoint import load_opt_state
    from koemorph_tpu_torch.train.trainer import SequentialTrainer
    from koemorph_tpu_torch.utils.config import load_config, to_dict
    from koemorph_tpu_torch.utils.params import read_state_dict

    out: dict = {"rec": {}, "shapes": {}}
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[dev, dev])
    check(mesh.size == 2 and not mesh.distributed, "a one-process mesh")

    # ---- mesh_server: 64 sessions over two entries of the card ----
    model, cfg = build_streaming_model(device=dev)
    lanes = lane_audio(SERVE_S, SERVE_STEPS)
    g, k = 8, cfg.emotion_update_frames

    def steps(srv, lo=0, hi=SERVE_STEPS):
        return torch.stack([srv.step(lanes[:, i * HOP:(i + 1) * HOP])
                            for i in range(lo, hi)])

    one = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=g)
    one.warmup()
    want = steps(one).cpu().numpy()
    ck.reset_launch_counts()
    srv = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=g,
                               mesh=mesh)
    srv.warmup()
    box = []
    seen, replayed = replayed_launches(
        [e.step_graphs for e in srv.entries], in_windows(
            SERVE_STEPS, lambda lo, hi: box.append(steps(srv, lo, hi))))
    launches = ck.launches()
    out["shapes"]["mesh_server"] = shapes = dict(ck.SHAPE_LAUNCHES)
    got = torch.cat(box).cpu().numpy()
    eager = MultiStreamInference(model, cfg, SERVE_S, refresh_cohorts=g,
                                 mesh=mesh, graphs=False)
    with recording_kernels(out["rec"], "mesh_server"):
        eager_o = steps(eager).cpu().numpy()
    per = SERVE_S // 2
    rows = per // g * cfg.lld_block_rows
    refreshing = sum(len(range(-p % k, SERVE_STEPS, k)) for p in srv.phases)
    want_shapes = {("logmel", (per,)), ("dk_roots", (rows,)),
                   ("cycle_dsum", (rows, 8, 17, 512)),
                   ("cycle_dsum", (rows, 5, 33, 1024))}
    d_srv = float(np.abs(got - want).max())
    times = {"one_engine": wall_ms(lambda: one.step(lanes[:, :HOP]), 18),
             "mesh_2_entries": wall_ms(lambda: srv.step(lanes[:, :HOP]), 18)}
    emit({"phase": "mesh_server", "card": card, "sessions": SERVE_S,
          "entries": srv.num_devices, "lanes_per_entry": per,
          "refresh_cohorts": g, "steps": SERVE_STEPS,
          "max_abs_diff_vs_one_engine": d_srv, "bound": MESH_MAX,
          "bitwise_vs_eager": bool(np.array_equal(got, eager_o)),
          "launches": launches,
          "launches_by_shape": {f"{a}{list(b)}": v
                                for (a, b), v in shapes.items()},
          "replays_ran": seen, "replays_recorded": replayed,
          "graphs_per_entry": [len(e.step_graphs) for e in srv.entries],
          "step_ms_host_to_sync": times,
          "at_s": round(time.perf_counter() - T_START, 1)})
    check(d_srv <= MESH_MAX, f"mesh server vs one engine: {d_srv}")
    check(np.array_equal(got, eager_o), "graphed mesh server != eager")
    check(set(shapes) == want_shapes and all(
        launches.get(n, 0) > 0 for n in FLAGSHIP_KERNELS),
          f"mesh server launched {shapes}, expected {want_shapes}")
    check(seen == replayed == {"cycle_dsum": 4 * refreshing,
                               "dk_roots": 2 * refreshing,
                               "logmel": 2 * SERVE_STEPS,
                               "linear_3xtf32": 0},
          f"mesh server replays ran {seen}, recorded {replayed}")
    del one, srv, eager

    # ---- serve_mesh_cli: the CLI over one and two entries ----
    wav = work / "mesh_serve.wav"
    write_wav(wav, voiced_audio(2.0, seed=5), SR)
    cli = [sys.executable, "-m", "koemorph_tpu_torch.serve", "--replay",
           str(wav), "--sessions", "16", "--refresh-cohorts", "8",
           "--output", "file", "--no-realtime", "--max-frames", "18"]
    flags = {"one": [], "mesh1": ["--mesh-devices", "1"],
             "mesh2": ["--device", "cuda:0", "--mesh-devices", "2"]}
    files = {n: work / f"mesh_serve_{n}.jsonl" for n in flags}
    procs = run_at_once({n: cli + ["--output-file", str(files[n])] + f
                         for n, f in flags.items()}, env)
    for n, p in procs.items():
        check(p.returncode == 0, f"serve {n} failed:\n{p.stderr[-3000:]}")
    served = {n: [json.loads(ln) for ln in f.read_text().splitlines()]
              for n, f in files.items()}
    stats = {n: json.loads([ln for ln in p.stdout.splitlines()
                            if "performance_stats" in ln][-1])[
                                "performance_stats"]
             for n, p in procs.items()}
    base = np.asarray([r["blendshapes"] for r in served["one"]])
    d_cli = {n: float(np.abs(np.asarray([r["blendshapes"] for r in rows_])
                             - base).max())
             for n, rows_ in served.items() if n != "one"}
    emit({"phase": "serve_mesh_cli", "card": card, "rows": len(base),
          "max_abs_diff_vs_one_device": d_cli, "bound": MESH_MAX,
          "devices": {n: s["devices"] for n, s in stats.items()},
          "step_p50_ms": {n: s["step"]["p50_step_ms"]
                          for n, s in stats.items()}})
    check(len(base) == 16 * 18 and all(
        [r["session"] for r in rows_] == [r["session"]
                                          for r in served["one"]]
        for rows_ in served.values()), "serve mesh rows")
    check(max(d_cli.values()) <= MESH_MAX, f"serve mesh rows: {d_cli}")
    check({n: s["devices"] for n, s in stats.items()}
          == {"one": 1, "mesh1": 1, "mesh2": 2}, f"serve devices {stats}")

    # ---- mesh_decode: phase 7's decode over two entries ----
    audio_dev = torch.from_numpy(audio_b).to(dev)
    ck.reset_launch_counts()
    mdec = BatchedSequentialDecoder(decoder.model, mesh=mesh)
    m_out = mdec(audio_b).cpu().numpy()
    dec_launches = ck.launches()
    out["shapes"]["mesh_decode"] = dict(ck.SHAPE_LAUNCHES)
    ck.reset_launch_counts()
    m_seq = mdec.decode_sequence_parallel(audio_b[0]).cpu().numpy()
    seq_launches = ck.launches()
    out["shapes"]["mesh_sequence_parallel"] = dict(ck.SHAPE_LAUNCHES)
    edec = BatchedSequentialDecoder(decoder.model, mesh=mesh, graphs=False)
    with recording_kernels(out["rec"], "mesh_decode"):
        e_out = edec(audio_b).cpu().numpy()
    with recording_kernels(out["rec"], "mesh_sequence_parallel"):
        e_seq = edec.decode_sequence_parallel(audio_b[0]).cpu().numpy()
    d_dec = float(np.abs(m_out - dec_out).max())
    d_seq = float(np.abs(m_seq - dec_out[0]).max())
    dec_t = {"one_device": wall_ms(lambda: decoder(audio_dev)),
             "mesh_2_entries": wall_ms(lambda: mdec(audio_dev)),
             "sequence_parallel_one_device": wall_ms(
                 lambda: decoder.decode_sequence_parallel(audio_b[0])),
             "sequence_parallel_2_entries": wall_ms(
                 lambda: mdec.decode_sequence_parallel(audio_b[0]))}
    emit({"phase": "mesh_decode", "card": card, "batch": DECODE_B,
          "entries": mdec.num_devices, "shape": list(m_out.shape),
          "max_abs_diff_vs_one_device": d_dec,
          "sequence_parallel_max_abs_diff": d_seq, "bound": MESH_MAX,
          "bitwise_vs_eager": bool(np.array_equal(m_out, e_out)),
          "sequence_parallel_bitwise_vs_eager": bool(
              np.array_equal(m_seq, e_seq)),
          "launches": dec_launches, "sequence_parallel_launches":
          seq_launches, "call_ms_host_to_sync": dec_t,
          "at_s": round(time.perf_counter() - T_START, 1)})
    check(m_out.shape == dec_out.shape and d_dec <= MESH_MAX,
          f"mesh decode vs one device: {d_dec}")
    check(d_seq <= MESH_MAX, f"sequence-parallel decode: {d_seq}")
    check(np.array_equal(m_out, e_out) and np.array_equal(m_seq, e_seq),
          "graphed mesh decode != eager")
    check(all(dec_launches.get(n, 0) > 0 and seq_launches.get(n, 0) > 0
              for n in FLAGSHIP_KERNELS),
          f"mesh decode launches {dec_launches}, {seq_launches}")
    del mdec, edec

    # ---- dp_nccl: a world-1 NCCL group in this process ----
    config_path = ROOT / "configs" / "dual_stream_config.yaml"
    tcfg_c = load_config(config_path)
    tcfg = to_dict(tcfg_c)

    def trainer(tag, mesh_=None, graphs=None):
        m, kind = build_model(tcfg_c)
        return SequentialTrainer(
            m, tcfg, work_dir=work / f"dp_{tag}", steps_per_epoch=DP_STEPS,
            span_frames=m.window_frames + 32, mesh=mesh_, graphs=graphs)

    loader_fn, _ = create_sequential_dataloader(
        synth, batch_size=DP_BLOCK, window_frames=288,
        stride_frames=int(tcfg_c.data.stride_frames),
        sample_rate=int(tcfg_c.data.sample_rate),
        target_fps=float(tcfg_c.data.target_fps))
    batches = [b for _, b in zip(range(DP_STEPS), loader_fn())]
    pg_env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
              "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(pg_env)
    try:
        distributed.init_process_group()
        single = trainer("single")
        dp = trainer("nccl", make_mesh())
        check(single.mesh is None and dp.mesh is not None and dp.world == 1
              and distributed.backend() == "nccl",
              f"trainers: {single.mesh}, {dp.mesh}, {distributed.backend()}")
        prep_s = [single._prepare(b) for b in batches]
        prep_d = [dp._prepare(b) for b in batches]
        ck.reset_launch_counts()
        before = distributed.collectives()
        m_dp = [dp.compiled_step(prep_d[0])]
        at_capture = distributed.collectives()["all_reduce"] \
            - before.get("all_reduce", 0)
        prof = profiled(lambda: m_dp.extend(dp.compiled_step(p)
                                            for p in prep_d[1:]))
        at_replays = distributed.collectives()["all_reduce"] \
            - before.get("all_reduce", 0) - at_capture
        out["shapes"]["dp_train"] = dict(ck.SHAPE_LAUNCHES)
        dp_launches = ck.launches()
        ks = device_kernels(None, prof)
        nccl = sorted({n for n, _ in ks if "nccl" in n.lower()})
        m_single = [single.compiled_step(p) for p in prep_s]
        twin = trainer("eager", make_mesh(), graphs=False)
        with recording_kernels(out["rec"], "dp_train"):
            m_twin = [twin.train_step(p) for p in prep_d]
        diff = {k: float((dp.params[k] - v).abs().max())
                for k, v in single.params.items()
                if not torch.equal(dp.params[k], v)}
        twin_diff = [k for k, v in twin.params.items()
                     if not torch.equal(dp.params[k], v)]
        loss = [[float(m["loss"]) for m in ms]
                for ms in (m_dp, m_single, m_twin)]
        ms_dp = _event_ms(lambda: dp.compiled_step(prep_d[0]), 6)
        ms_single = _event_ms(lambda: single.compiled_step(prep_s[0]), 6)
    finally:
        distributed.destroy_process_group()
        for key in pg_env:
            os.environ.pop(key, None)
    emit({"phase": "dp_nccl", "card": card, "world": 1, "backend": "nccl",
          "batch": DP_BLOCK, "steps": DP_STEPS, "losses": loss[0],
          "params_bitwise_vs_single_process": not diff,
          "params_differing": diff, "eager_twin_differing": twin_diff,
          "losses_equal": loss[0] == loss[1] == loss[2],
          "all_reduces_at_capture": at_capture,
          "all_reduces_at_replays": at_replays,
          "nccl_kernels_in_replays": nccl, "launches": dp_launches,
          "own_kernels_in_replays": own_kernels(ks),
          "step_ms_events": {"data_parallel_nccl_world_1": q(ms_dp),
                             "single_process": q(ms_single)},
          "at_s": round(time.perf_counter() - T_START, 1)})
    # the step's collectives: the three gathers (predictions, targets,
    # mask), the predictions' gradient and the flat gradient reduce, in
    # the warm-up run and in the capture
    check(at_capture == 2 * 5 and at_replays == 0,
          f"all-reduces issued: {at_capture} at the capture, {at_replays} "
          "at the replays")
    check(not diff and not twin_diff and loss[0] == loss[1] == loss[2],
          f"NCCL world-1 step != single process: {diff} {twin_diff}")
    check(all(dp_launches.get(n, 0) > 0 for n in FLAGSHIP_KERNELS),
          f"dp launches {dp_launches}")
    del single, dp, twin

    # ---- dp_cli: the train CLI under torch.distributed.run ----
    def train_cli(work_dir, epochs, *extra, ranks=0, backend=None):
        args = ["--config", str(config_path), "--synthetic", "2",
                "--max-epochs", str(epochs), "--work-dir", str(work_dir),
                *extra, "data.stride_frames=4"]
        if backend:
            args = ["--dist-backend", backend] + args
        if not ranks:
            return [sys.executable, "-m", "koemorph_tpu_torch.train", *args]
        return [sys.executable, "-m", "torch.distributed.run",
                "--nproc-per-node", str(ranks), "--master-port",
                str(free_port()), "-m", "koemorph_tpu_torch.train", *args]

    runs = {"single": train_cli(work / "dp_cli_single", 2, "--scan-epochs"),
            "single_eager": train_cli(work / "dp_cli_single_eager", 2),
            "nccl1": train_cli(work / "dp_cli_nccl1", 2, "--scan-epochs",
                               ranks=1),
            "gloo2": train_cli(work / "dp_cli_gloo2", 2, ranks=2,
                               backend="gloo"),
            "gloo2_first": train_cli(work / "dp_cli_gloo2r", 1, ranks=2,
                                     backend="gloo")}
    t0 = time.perf_counter()
    done = run_at_once(runs, env, timeout=600)
    done.update(run_at_once({"gloo2_resumed": train_cli(
        work / "dp_cli_gloo2r", 2, "--resume", ranks=2, backend="gloo")},
        env, timeout=600))
    cli_s = time.perf_counter() - t0
    for n, p in done.items():
        check(p.returncode == 0, f"train CLI {n} failed:\n{p.stderr[-3000:]}")
    finals = {n: json.loads(p.stdout.strip().splitlines()[-1])
              for n, p in done.items()}
    ckpt = {n: work / d / "checkpoints" / "last" for n, d in (
        ("single", "dp_cli_single"), ("nccl1", "dp_cli_nccl1"),
        ("gloo2", "dp_cli_gloo2"), ("gloo2_resumed", "dp_cli_gloo2r"))}
    sds = {n: read_state_dict(c) for n, c in ckpt.items()}
    counts = {n: load_opt_state(c)["optimizer"]["count"]
              for n, c in ckpt.items()}

    def differing(a, b):
        return [k for k in a if not torch.equal(a[k], b[k])]

    nccl_diff = differing(sds["nccl1"], sds["single"])
    resume_diff = differing(sds["gloo2_resumed"], sds["gloo2"])
    outside = {}
    for k, v in sds["single"].items():
        bad = ~torch.isclose(sds["gloo2"][k], v, rtol=DP_PARAM_RTOL,
                             atol=DP_PARAM_ATOL)
        if bad.any():
            outside[k] = [int(bad.sum()), v.numel(), float(
                (sds["gloo2"][k] - v).abs().max())]
    loss_rel = abs(finals["gloo2"]["final_train_metrics"]["loss"]
                   / finals["single"]["final_train_metrics"]["loss"] - 1)
    step_ms = {n: epoch_step_ms(done[n].stderr) for n in
               ("single", "nccl1", "single_eager", "gloo2")}
    emit({"phase": "dp_cli", "card": card, "batch": 16,
          "steps": counts, "nccl_world_1_bitwise_vs_single": not nccl_diff,
          "nccl_differing": nccl_diff,
          "gloo_world_2_loss_rel_diff": loss_rel,
          "gloo_world_2_params_outside_bounds": outside,
          "bounds": {"loss_rtol": DP_LOSS_RTOL, "param_rtol": DP_PARAM_RTOL,
                     "param_atol": DP_PARAM_ATOL},
          "gloo_world_2_resume_bitwise": not resume_diff,
          "resume_differing": resume_diff,
          "final_loss": {n: f["final_train_metrics"]["loss"]
                         for n, f in finals.items()},
          "epoch_ms_per_step_cli_log": step_ms,
          "note": "the five first runs shared the card and the host at "
                  "once; an epoch's wall holds its batches' loading",
          "cli_s": round(cli_s, 1),
          "at_s": round(time.perf_counter() - T_START, 1)})
    check(set(counts.values()) == {2 * 2}, f"train CLI steps: {counts}")
    check(not nccl_diff, f"NCCL world-1 CLI != single CLI: {nccl_diff}")
    check(not resume_diff, f"world-2 resume != uninterrupted: {resume_diff}")
    check(loss_rel <= DP_LOSS_RTOL and not outside,
          f"gloo world-2 CLI vs single: loss {loss_rel}, {outside}")

    held = hold_recorded(out["rec"], SLICE14_PATHS)
    emit({"phase": "slice14_held", "held": {
        f"{name} {tag} {shape}": {
            k: v for k, v in r.items() if not isinstance(v, list)}
        for (name, tag, shape), r in held.items()},
        "seconds": round(time.perf_counter() - t_phase, 1)})
    check(held and all(r["ok"] for r in held.values()),
          "a kernel disagrees with its plain form on phase 18's arguments: "
          + str([k for k, r in held.items() if not r["ok"]]))
    out["held"] = held
    return out


#: phase 19's runs, named in the kernels table
SLICE15_PATHS = {"tp 1x2": "tensor-parallel rank (1, 2)",
                 "tp 2x2": "tensor-parallel rank (2, 2)"}
#: the grids phase 19 trains on (gloo ranks sharing the card)
TP_GRIDS = ((1, 2), (2, 2))
TP_STEPS = 4
TP_BATCH = 16
#: a tensor-parallel gradient leaf against the single process's float64
#: gradient after the features: within this share of the leaf's largest
#: element, or within twice the distance of a float32 evaluation of the
#: same gradient where that is larger (tests/test_torch_train.py's rule,
#: the single process in JAX's place: the larger distance of its gradient
#: and of the two data-parallel ranks'); a leaf past that (one that sums terms far larger
#: than itself, as smoothing_alpha) is held within the rule's loosest
#: bound, 20 x TP_GRAD_TOL, where the tensor-parallel gradient in float64
#: is, within TP_GRAD64_TOL, that of the run with the same data blocks and
#: no split layer (the single process, or the data-parallel ranks): the
#: same function, rounded otherwise
TP_GRAD_TOL = 1e-4
TP_GRAD64_TOL = 1e-9
#: the parameters after TP_STEPS steps: the bounds JAX's own
#: tensor-parallel trainer test holds a two-step run to
#: (tests/parallel/test_tp_sp.py), since Adam amplifies reduction-order
#: noise wherever a moment nears zero; after the first step the
#: sharded-step bounds (DP_PARAM_RTOL / DP_PARAM_ATOL) hold
TP_RUN_RTOL, TP_RUN_ATOL = 1e-3, 1e-5


def _phase19_trainer(work_dir: Path, mesh=None, tp: bool = False,
                     graphs=None):
    """The flagship ``SequentialTrainer`` (``configs/dual_stream_config.
    yaml``, span 288) of phase 19."""
    from koemorph_tpu_torch.train.__main__ import build_model
    from koemorph_tpu_torch.train.trainer import SequentialTrainer
    from koemorph_tpu_torch.utils.config import load_config, to_dict
    cfg = load_config(ROOT / "configs" / "dual_stream_config.yaml")
    model, _ = build_model(cfg)
    return SequentialTrainer(
        model, to_dict(cfg), work_dir=work_dir, steps_per_epoch=TP_STEPS,
        span_frames=model.window_frames + 32, mesh=mesh,
        tensor_parallel=tp, graphs=graphs)


def _whole_grads(trainer, prepared: dict) -> dict:
    """The whole reduced gradients of the trainer's next step, its dropout
    masks included (nothing updated): tensor-parallel, gathered over the
    model group."""
    import torch
    from koemorph_tpu_torch.parallel.tp import gather_shards
    from koemorph_tpu_torch.train.trainer import dropout_generator
    trainer.model.train()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        loss, _ = trainer._loss(prepared, dropout_generator(
            trainer.dropout_seed, trainer.global_step, trainer.device))
        grads = torch.autograd.grad(loss, list(trainer.params.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(trainer.params.items(), grads)}
    if trainer.mesh is not None:
        grads = trainer._reduce_grads(grads)
    return {k: v.detach() for k, v in gather_shards(
        grads, trainer.tp_specs, trainer.mesh).items()} \
        if trainer.tp_specs else {k: v.detach() for k, v in grads.items()}


@contextlib.contextmanager
def _float64_after_features(model):
    """``model`` in float64 after its features, in place: its log-mel
    frames (K3) and emotion features (K1, K2) are computed in float32 by
    the kernels and cast up, everything after them runs in float64, as
    the CPU tests take JAX's float64 gradient; the dropout masks are drawn
    in float32, so they are the float32 step's. The float32 parameters
    round-trip exactly."""
    import torch
    from koemorph_tpu_torch.ops import frontend
    real_logmel, real_emotion = frontend.frames_to_logmel, model.emotion_raw
    real_rand = torch.rand
    frontend.frames_to_logmel = \
        lambda frames, **kw: real_logmel(frames.float(), **kw).double()
    model.emotion_raw = lambda audio: real_emotion(audio.float()).double()
    torch.rand = lambda *a, dtype=None, **kw: real_rand(
        *a, dtype=torch.float32 if dtype == torch.float64 else dtype, **kw)
    model.double()
    try:
        yield
    finally:
        model.float()
        del model.emotion_raw
        torch.rand = real_rand
        frontend.frames_to_logmel = real_logmel


def _adam_first_spread(g, bound: float, lr: float, eps: float):
    """How far Adam's first update ``lr * g / (|g| + eps)`` moves over the
    gradients within ``bound`` of ``g``: the parameters of two steps whose
    gradients both pass the gradient check differ by at most this."""
    a = g.abs()

    def f(x):
        return x / (x.abs() + eps)

    return lr * (f(a + bound) - f(a - bound))


def _tp_batches(path: Path) -> list:
    data = np.load(path)
    return [{k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith(f"{i}/")} for i in range(TP_STEPS)]


def tp_rank_main(spec_path: str) -> int:
    """One gloo rank of phase 19, started by ``python -m
    torch.distributed.run ... chip_smoke.py --tp-rank <spec.json>`` on the
    card: the flagship trainer on a ``(data, model)`` grid
    (tensor-parallel) or a row of ranks (data-parallel), the whole first
    gradients, ``TP_STEPS`` eager steps with the launch counts set to 0
    just before them, the collectives and the step times, the whole
    parameters after them; rank 0 writes them and the kernels' recorded
    arguments under the spec's ``out``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.parallel import (distributed, make_mesh,
                                             make_mesh_2d)
    from koemorph_tpu_torch.parallel.tp import gather_shards

    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.init_process_group(backend="gloo")
    try:
        me = distributed.rank()
        mesh = make_mesh_2d(*spec["grid"]) if spec["tp"] else make_mesh()
        t = _phase19_trainer(out / f"work{me}", mesh, spec["tp"],
                             graphs=False)
        prep = [t._prepare(b) for b in _tp_batches(Path(spec["batches"]))]
        rec: dict = {}
        with recording_kernels(rec, spec["tag"]):
            grads = _whole_grads(t, prep[0])
        with _float64_after_features(t.model):
            grads64 = _whole_grads(t, prep[0])
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        before = collections.Counter(distributed.collectives())
        losses, ms = [], []
        for i, p in enumerate(prep):
            t0 = time.perf_counter()
            m = t.train_step(p)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:              # (its gathers are not the step's)
                held = collections.Counter(distributed.collectives())
                first = {k: v.detach().cpu().clone() for k, v in
                         gather_shards(dict(t.params), t.tp_specs,
                                       mesh).items()}
                before.update(distributed.collectives())
                before.subtract(held)
        launches = ck.launches()
        shapes = [[n, list(s), c] for (n, s), c in ck.SHAPE_LAUNCHES.items()]
        per_step = {k: (v - before[k]) / TP_STEPS
                    for k, v in distributed.collectives().items()
                    if v != before[k]}
        params = gather_shards(dict(t.params), t.tp_specs, mesh)
        opt = t.optimizer
        split = sorted(t.tp_specs)

        def nbytes(ts):
            return int(sum(v.numel() * v.element_size() for v in ts))

        res = {"rank": me, "coords": [mesh.data_rank, mesh.model_rank],
               "block_rows": int(prep[0]["sample_mask"].shape[0]),
               "losses": losses, "step_ms_host_to_sync": ms,
               "collectives_per_step": per_step, "launches": launches,
               "launches_by_shape": shapes, "split_leaves": len(split),
               "bytes": {
                   "split_params_local": nbytes(t.params[k] for k in split),
                   "split_params_whole": nbytes(params[k] for k in split),
                   "split_moments_local": nbytes(
                       [opt.mu[k] for k in split]
                       + [opt.nu[k] for k in split]),
                   "params_local": nbytes(t.params.values()),
                   "params_whole": nbytes(params.values())}}
        if me == 0:
            torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                        "grads64": {k: v.cpu() for k, v in grads64.items()},
                        "first": first,
                        "params": {k: v.detach().cpu()
                                   for k, v in params.items()}},
                       out / "result.pt")
            torch.save(rec, out / "rec.pt")
        (out / f"rank{me}.json").write_text(json.dumps(res))
    finally:
        distributed.destroy_process_group()
    return 0


def _launch_ranks(name: str, work: Path, env: dict, world: int, spec: dict,
                  timeout: float = 300) -> tuple[list, float]:
    """Phase 19's ``world`` gloo ranks of ``spec`` under
    ``torch.distributed.run``, in a session of their own (killed whole
    past ``timeout``); returns each rank's result and the wall seconds."""
    import signal
    out = work / f"tp_{name}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    spec = dict(spec, out=str(out))
    (out / "spec.json").write_text(json.dumps(spec))
    argv = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
            str(world), "--master-port", str(free_port()),
            str(ROOT / "chip_smoke.py"), "--tp-rank", str(out / "spec.json")]
    t0 = time.perf_counter()
    with open(out / "log.txt", "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t0
    check(rc == 0, f"tensor-parallel ranks {name} failed ({rc}):\n"
          + (out / "log.txt").read_text()[-4000:])
    return ([json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)], wall)


def slice15_phases(card: str, work: Path, env: dict, synth: Path) -> dict:
    """Phase 19: tensor-parallel training on the one card.

    ``tp``: the flagship ``SequentialTrainer`` (``configs/dual_stream_
    config.yaml``, batch 16, span 288, on phase 10's synthetic files)
    with ``tensor_parallel=True`` as gloo ranks sharing ``cuda:0``, on
    grids (1, 2) and (2, 2), ``TP_STEPS`` eager steps each, against the
    single-process eager trainer of this process from the same seed: the
    losses at rtol 1e-5; the first step's whole gradients against the
    single process's float64 gradient after the features
    (:func:`_float64_after_features`) by ``TP_GRAD_TOL``'s rule, and the
    ranks' own float64 gradient within ``TP_GRAD64_TOL`` of the float64
    gradient of the run with the same data blocks (the single process at
    D = 1, the data-parallel ranks at D = 2); the
    parameters after the first step at rtol 2e-4 / atol 2e-6 (an element
    outside accepted where Adam's first update spreads as far over the
    gradients the gradient check allows, :func:`_adam_first_spread`) and
    after the last at ``TP_RUN_RTOL`` / ``TP_RUN_ATOL``; the losses alike
    on every rank; the
    bytes of the split parameters and their moments per rank; the
    collectives per step by name; step times beside the single process's
    and two data-parallel gloo ranks'. ``tp_nccl``: a world-1 NCCL group
    in this process, grid (1, 1), the tensor-parallel trainer through
    ``compiled_step`` bit for bit the single-process compiled step.
    Each grid's rank 0 records K1-K3's arguments, held against their
    plain forms here; the ranks count their launches. Returns the
    recorded arguments, launch counts and holds by path, for the kernels
    table."""
    import torch
    from koemorph_tpu_torch.data.sequential import (
        create_sequential_dataloader)
    from koemorph_tpu_torch.ops import cuda as ck
    from koemorph_tpu_torch.parallel import distributed, make_mesh_2d
    from koemorph_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    out: dict = {"rec": {}, "shapes": {}}
    cfg = load_config(ROOT / "configs" / "dual_stream_config.yaml")
    loader_fn, _ = create_sequential_dataloader(
        synth, batch_size=TP_BATCH, window_frames=288,
        stride_frames=int(cfg.data.stride_frames),
        sample_rate=int(cfg.data.sample_rate),
        target_fps=float(cfg.data.target_fps))
    batches = [b for _, b in zip(range(TP_STEPS), loader_fn())]
    check(len(batches) == TP_STEPS and all(
        b["audio"].shape[0] == TP_BATCH for b in batches),
        f"phase 19's batches: {[b['audio'].shape for b in batches]}")
    batch_file = work / "tp_batches.npz"
    np.savez(batch_file, **{f"{i}/{k}": np.asarray(v)
                            for i, b in enumerate(batches)
                            for k, v in b.items() if not isinstance(v, list)})

    # ---- the single-process eager reference ----
    single = _phase19_trainer(work / "tp_single", graphs=False)
    prep_s = [single._prepare(b) for b in batches]
    g_single = {k: v.cpu() for k, v in _whole_grads(single,
                                                     prep_s[0]).items()}
    with _float64_after_features(single.model):
        g64 = {k: v.cpu() for k, v in _whole_grads(single,
                                                    prep_s[0]).items()}
    scale = {k: float(g.abs().max()) for k, g in g64.items()}
    lr0, eps = single.optimizer.lr, single.optimizer.eps
    loss_s = [float(single.train_step(prep_s[0])["loss"])]
    p_first = {k: v.detach().cpu().clone()
               for k, v in single.params.items()}
    loss_s += [float(single.train_step(p)["loss"]) for p in prep_s[1:]]
    p_single = {k: v.detach().cpu() for k, v in single.params.items()}
    ms_single = wall_ms(lambda: single.train_step(prep_s[0]), 3)
    del single

    # ---- the gloo ranks: two grids, and two data-parallel ranks ----
    runs, walls = {}, {}
    for grid in TP_GRIDS:
        tag = f"tp {grid[0]}x{grid[1]}"
        runs[tag], walls[tag] = _launch_ranks(
            f"{grid[0]}x{grid[1]}", work, env, grid[0] * grid[1],
            {"grid": list(grid), "tp": True, "tag": tag,
             "batches": str(batch_file)})
        res = torch.load(work / f"tp_{grid[0]}x{grid[1]}" / "result.pt")
        out["rec"].update(torch.load(
            work / f"tp_{grid[0]}x{grid[1]}" / "rec.pt",
            map_location=torch.device(DEVICE)))
        out["shapes"][tag] = {(n, tuple(s)): c for n, s, c in
                              runs[tag][0]["launches_by_shape"]}
        runs[tag + " result"] = res
    runs["dp 2"], walls["dp 2"] = _launch_ranks(
        "dp2", work, env, 2, {"grid": None, "tp": False, "tag": "dp 2",
                              "batches": str(batch_file)})
    res_dp = torch.load(work / "tp_dp2" / "result.pt")
    g_dp = res_dp["grads"]
    # the float32 evaluations of the gradient that split no layer
    d_single = {k: max(float((g_[k].double() - g).abs().max())
                       for g_ in (g_single, g_dp))
                for k, g in g64.items()}
    grad_bound = {k: max(TP_GRAD_TOL * scale[k], 2 * d_single[k])
                  for k in g64}

    report, bad = {}, {}
    for grid in TP_GRIDS:
        tag = f"tp {grid[0]}x{grid[1]}"
        ranks_, res = runs[tag], runs[tag + " result"]
        r0 = ranks_[0]
        loss_rel = max(abs(a / b - 1) for a, b in zip(r0["losses"], loss_s))
        grad_d = {k: float((res["grads"][k].double() - g).abs().max())
                  for k, g in g64.items()}
        # in float64 against the run with the same data blocks (their
        # float32 features) and no split layer
        ref64 = g64 if grid[0] == 1 else res_dp["grads64"]
        grad64_d = {k: float((res["grads64"][k] - ref64[k]).abs().max())
                    for k in g64}
        grad_ok = {k: grad_d[k] <= grad_bound[k] or (
            grad_d[k] <= 20 * TP_GRAD_TOL * scale[k]
            and grad64_d[k] <= TP_GRAD64_TOL * scale[k]) for k in g64}
        # after the first step: the sharded-step bounds; an element outside
        # is accepted where Adam's first update, over the gradients within
        # the gradient bound of its own, spreads as far (near a zero
        # gradient, a sign; near eps, a share of lr)
        outside_first = {}
        for k, v in p_first.items():
            diff = (res["first"][k] - v).abs()
            miss = diff > DP_PARAM_ATOL + DP_PARAM_RTOL * v.abs()
            if miss.any():
                spread = _adam_first_spread(
                    g64[k], max(grad_bound[k], grad_d[k]), lr0, eps)
                unexplained = miss & (diff > DP_PARAM_ATOL
                                      + DP_PARAM_RTOL * v.abs()
                                      + spread.float())
                outside_first[k] = [int(miss.sum()), int(unexplained.sum()),
                                    float(diff.max())]
        outside = {}
        for k, v in p_single.items():
            miss = ~torch.isclose(res["params"][k], v, rtol=TP_RUN_RTOL,
                                  atol=TP_RUN_ATOL)
            if miss.any():
                outside[k] = [int(miss.sum()),
                              float((res["params"][k] - v).abs().max())]
        alike = all(r["losses"] == r0["losses"] for r in ranks_)
        report[tag] = {
            "ranks": len(ranks_), "block_rows": r0["block_rows"],
            "losses": r0["losses"], "loss_max_rel_diff": loss_rel,
            "grad_max_share_of_bound": max(
                grad_d[k] / grad_bound[k] if grad_bound[k]
                else float(grad_d[k] > 0) for k in g64),
            "grad_past_1e-4_of_leaf_max": {
                k: {"tp": grad_d[k] / scale[k],
                    "unsplit_float32": d_single[k] / scale[k],
                    "tp_float64": grad64_d[k] / scale[k]}
                for k in g64 if grad_d[k] > TP_GRAD_TOL * scale[k]},
            "grad64_max_share_of_leaf_max": max(
                grad64_d[k] / scale[k] if scale[k] else float(
                    grad64_d[k] > 0) for k in g64),
            "params_first_step_outside_bounds": outside_first,
            "params_outside_run_bounds": outside,
            "losses_alike_on_every_rank": alike,
            "split_leaves": r0["split_leaves"],
            "bytes_per_rank": {f"rank {r['rank']}": r["bytes"]
                               for r in ranks_},
            "collectives_per_step": r0["collectives_per_step"],
            "launches": r0["launches"],
            "launches_by_shape": {f"{n}{s}": c for n, s, c in
                                  r0["launches_by_shape"]},
            "step_ms_host_to_sync": {f"rank {r['rank']}":
                                     r["step_ms_host_to_sync"]
                                     for r in ranks_},
            "launch_wall_s": round(walls[tag], 1)}
        bad[tag] = (loss_rel > DP_LOSS_RTOL
                    or not all(grad_ok.values())
                    or any(o[1] for o in outside_first.values())
                    or bool(outside) or not alike)
        check(r0["split_leaves"] == 17 and all(
            r["bytes"]["split_params_local"] * grid[1]
            == r["bytes"]["split_params_whole"]
            and r["bytes"]["split_moments_local"]
            == 2 * r["bytes"]["split_params_local"] for r in ranks_),
            f"{tag}: the split leaves' bytes per rank {report[tag]}")
        check(all(r0["launches"].get(n, 0) == TP_STEPS * k for n, k in
                  (("cycle_dsum", 2), ("dk_roots", 1), ("logmel", 2))),
              f"{tag}: rank 0 launched {r0['launches']}")
    d2 = runs["dp 2"]
    report["dp 2"] = {"losses": d2[0]["losses"],
                      "grad_max_share_of_leaf_max_vs_single": max(
                          float((g_dp[k] - g).abs().max()) / max(
                              scale[k], 1e-30)
                          for k, g in g_single.items()),
                      "collectives_per_step": d2[0]["collectives_per_step"],
                      "step_ms_host_to_sync": {f"rank {r['rank']}":
                                               r["step_ms_host_to_sync"]
                                               for r in d2},
                      "launch_wall_s": round(walls["dp 2"], 1)}
    emit({"phase": "tp", "card": card, "batch": TP_BATCH,
          "steps": TP_STEPS, "single_process": {
              "losses": loss_s, "step_ms_host_to_sync": ms_single,
              "unsplit_float32_grad_past_1e-4_of_leaf_max": {
                  k: d_single[k] / scale[k] for k in g64
                  if d_single[k] > TP_GRAD_TOL * scale[k]}},
          **report,
          "bounds": {"loss_rtol": DP_LOSS_RTOL, "grad": TP_GRAD_TOL,
                     "grad64": TP_GRAD64_TOL,
                     "first_step_param_rtol": DP_PARAM_RTOL,
                     "first_step_param_atol": DP_PARAM_ATOL,
                     "run_param_rtol": TP_RUN_RTOL,
                     "run_param_atol": TP_RUN_ATOL},
          "note": "every rank shares the one card and its host; a step's "
                  "host-to-sync ms include gloo's host round trips",
          "at_s": round(time.perf_counter() - T_START, 1)})
    check(not any(bad.values()),
          f"tensor-parallel steps against the single process: {bad}")

    # ---- tp_nccl: grid (1, 1) of a world-1 NCCL group, compiled ----
    pg_env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
              "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(pg_env)
    try:
        distributed.init_process_group()
        single = _phase19_trainer(work / "tp_nccl_single")
        tp1 = _phase19_trainer(work / "tp_nccl", make_mesh_2d(1, 1),
                               tp=True)
        check(single.mesh is None and tp1.mesh is not None
              and tp1.mesh.shape == {"data": 1, "model": 1}
              and not tp1.tp_specs and distributed.backend() == "nccl",
              f"grid (1, 1) trainers: {tp1.mesh}, {tp1.tp_specs}")
        prep_1 = [tp1._prepare(b) for b in batches]
        prep_s = [single._prepare(b) for b in batches]
        before = distributed.collectives()
        m_tp = [float(tp1.compiled_step(p)["loss"]) for p in prep_1]
        issued = {k: v - before.get(k, 0)
                  for k, v in distributed.collectives().items()
                  if v != before.get(k, 0)}
        m_s = [float(single.compiled_step(p)["loss"]) for p in prep_s]
        diff = [k for k, v in single.params.items()
                if not torch.equal(tp1.params[k], v)]
        ms_tp = _event_ms(lambda: tp1.compiled_step(prep_1[0]), 6)
        ms_s = _event_ms(lambda: single.compiled_step(prep_s[0]), 6)
    finally:
        distributed.destroy_process_group()
        for key in pg_env:
            os.environ.pop(key, None)
    emit({"phase": "tp_nccl", "card": card, "grid": [1, 1],
          "backend": "nccl", "batch": TP_BATCH, "steps": TP_STEPS,
          "losses": m_tp, "losses_equal": m_tp == m_s,
          "params_bitwise_vs_single_process": not diff,
          "params_differing": diff, "collectives_issued": issued,
          "step_ms_events": {"grid_1x1_nccl": q(ms_tp),
                             "single_process": q(ms_s)},
          "at_s": round(time.perf_counter() - T_START, 1)})
    check(not diff and m_tp == m_s,
          f"NCCL grid (1, 1) compiled step != single process: {diff}")
    del single, tp1

    held = hold_recorded(out["rec"], SLICE15_PATHS)
    emit({"phase": "slice15_held", "held": {
        f"{name} {tag} {shape}": {
            k: v for k, v in r.items() if not isinstance(v, list)}
        for (name, tag, shape), r in held.items()},
        "seconds": round(time.perf_counter() - t_phase, 1)})
    check(held and len(held) == 2 * 5 and all(r["ok"] for r in held.values()),
          "a kernel disagrees with its plain form on phase 19's arguments: "
          + str([k for k, r in held.items() if not r["ok"]]))
    out["held"] = held
    return out


def main() -> int:  # noqa: C901
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--tp-rank":
        return tp_rank_main(sys.argv[2])
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

    native_emit_phase(card)

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
    # is a row of a (64, 5,330) tensor, read in place
    lanes_np = lane_audio(SERVE_S, SERVE_STEPS)
    ring_len = StreamingConfig().audio_ring_len
    rings = torch.from_numpy(
        np.ascontiguousarray(lanes_np[:, -ring_len:])).to(dev)
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
        exact = exact_roots(a)
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
    exact = exact_roots(a[tame])
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
    n_frames = len(audio) // HOP
    seen, want = replayed_launches(engine.step_graphs, in_windows(
        n_frames, lambda lo, hi: box.extend(engine.process_audio(
            audio[lo * HOP:hi * HOP if hi < n_frames else None]))))
    launches = ck.launches()
    stream_shapes = dict(ck.SHAPE_LAUNCHES)
    bs = np.stack(box)
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
                           "dk_roots": n_refresh, "logmel": n_frames,
                           "linear_3xtf32": 0},
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
        before = ck.launches()
        plain = np.stack(plain_engine.process_audio(audio))
        check(ck.launches() == before, "the plain stream launched a "
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
        decoder.step_graphs, [lambda: box.append(decoder(audio_dev))])
    dec_launches = ck.launches()
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
    check(seen == want == {"cycle_dsum": 2, "dk_roots": 1, "logmel": 2,
                           "linear_3xtf32": 0},
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
        before = ck.launches()
        plain_out = eager_decoder(audio_dev).cpu().numpy()
        emo_plain = decoder.model.emotion_raw(audio_dev)
        check(ck.launches() == before, "the plain decode launched a "
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
    check(len(decoder.step_graphs) == 3,
          "the new length's graph (beside the decode's and decode_scheduled's)")

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
        seen, want = replayed_launches(srv.step_graphs, in_windows(
            SERVE_STEPS, lambda lo, hi: box.append(serve_steps(
                srv, lanes_np, first=lo, steps=hi - lo))))
        launches, shapes = ck.launches(), dict(ck.SHAPE_LAUNCHES)
        out_g = torch.cat(box)
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
                               "logmel": SERVE_STEPS, "linear_3xtf32": 0},
              f"G={g}: the replays ran {seen}, their captures recorded "
              f"{want}, for {SERVE_STEPS} steps and {refreshing} "
              f"refreshing cohort-steps of {rows} rows")
        check(all(launches[k] > 0 for k in FLAGSHIP_KERNELS),
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
        before = ck.launches()
        for g in (1, 8):
            srv = MultiStreamInference(model, cfg, SERVE_S,
                                       refresh_cohorts=g, graphs=False)
            plain_g = serve_steps(srv, lanes_np).cpu().numpy()
            d_plain[g] = float(np.abs(plain_g - serve_out[g]).max())
        check(ck.launches() == before, "the plain server launched a "
              "kernel")
        del srv
    emit({"phase": "multistream_plain", "max_abs_diff_blendshapes":
          {f"G={g}": d for g, d in d_plain.items()},
          "bound": SERVE_PLAIN_MAX})
    check(max(d_plain.values()) <= SERVE_PLAIN_MAX,
          f"kernel server != plain server: {d_plain}")

    # a lane reset mid-run: a fresh session whose clock is its cohort's;
    # graphed (captured at the first step) and eager
    half, reset_lane = SERVE_STEPS * 3 // 7, 5              # step 15
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
    check(all(g1["profile"]["refresh"]["own_kernels_per_step"][k] > 0
              for k in FLAGSHIP_KERNELS),
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
    # with it, phase 9's offline CLI, each in its own process
    wav, jsonl = work / "speech.wav", work / "frames.jsonl"
    write_wav(wav, voiced_audio(10.0, seed=10), SR)
    t0 = time.perf_counter()
    procs = run_at_once({
        "serve": [sys.executable, "-m", "koemorph_tpu_torch.serve",
                  "--replay", str(serve_wav), "--sessions", "16",
                  "--refresh-cohorts", "8", "--output", "file",
                  "--output-file", str(serve_jsonl), "--no-realtime",
                  "--max-frames", "30"],
        "infer": [sys.executable, "-m", "koemorph_tpu_torch.infer",
                  "--input", str(wav), "--output", str(jsonl)]}, env)
    cli_s = time.perf_counter() - t0
    proc = procs["serve"]
    check(proc.returncode == 0, f"serve CLI failed:\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in serve_jsonl.read_text().splitlines()]
    stats = [json.loads(ln)["performance_stats"]
             for ln in proc.stdout.splitlines() if "performance_stats" in ln]
    emit({"phase": "serve_cli", "rows": len(rows),
          "sessions": sorted({r["session"] for r in rows}),
          "seconds_with_infer_cli": round(cli_s, 2),
          "performance_stats": stats[-1] if stats else None})
    check(len(rows) == 30 * 16
          and sorted({r["session"] for r in rows}) == list(range(16))
          and all(len(r["blendshapes"]) == 52 for r in rows),
          "serve CLI rows")
    check(bool(stats) and stats[-1]["ticks"] == 30
          and stats[-1]["frames_sent"] == 480
          and stats[-1]["emit_path"] == "native", "serve CLI stats line")

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

    # ---- 9. the offline CLI (run beside the serve CLI) ----
    proc = procs["infer"]
    check(proc.returncode == 0, f"infer CLI failed:\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    n_cli = (160000 // HOP - 256) + 1
    stamps_ok = all(r["timestamp"] == round((255 + i) / 30, 6)
                    for i, r in enumerate(rows))
    emit({"phase": "infer_cli", "rows": len(rows), "expected": n_cli,
          "timestamps_ok": stamps_ok,
          "seconds_with_serve_cli": round(cli_s, 2),
          "log": [ln for ln in proc.stderr.splitlines() if "RTF" in ln]})
    check(len(rows) == n_cli and stamps_ok, "infer CLI output")

    # ---- 10. training ----
    train = train_phases(card, work, env)

    # ---- 12. the configurations without the LLD ring, emotion2vec ----
    s8 = slice8_phases(card, work, env, train["synth"])

    # ---- 13. the remaining eGeMAPS, F0, frontend and decoder options ----
    s9 = slice9_phases(card)

    # ---- 14. the legacy model family ----
    s10 = slice10_phases(card, work, env)

    # ---- 15. files to a checked, trained model ----
    s11 = slice11_phases(card, work, s10)

    # ---- 16. the feature shims, reconstruction, prosody and export ----
    # (phase 17's smoke rehearsal trains beside phase 16's export CLI)
    s12 = slice12_phases(card, work, env, work / "imported_learnable",
                         alongside=lambda: rehearsal_smoke(work))

    # ---- 17. the compiled train step, scan epochs, profiling, mic ----
    s13 = slice13_phases(
        card, work, train["synth"], rehearsal=s12["alongside"],
        train_hold=(train["rec"][("dk_roots", "train", train["lld_rows"])][0],
                    train["dk_held"]))
    s14 = slice14_phases(card, work, env, decoder, out_np, audio_b,
                         train["synth"])

    # ---- 19. tensor-parallel training ----
    s15 = slice15_phases(card, work, env, train["synth"])
    # the trainer allocates from the default pool, never from a graph's:
    # the decode's and the stream's graphs replay bitwise as before
    dec_after = decoder(audio_dev).cpu().numpy()
    engine.reset()
    stream_after = np.stack(engine.process_audio(audio))
    emit({"phase": "graphs_after_training",
          "decode_bitwise_equal": bool(np.array_equal(dec_after, out_np)),
          "stream_bitwise_equal": bool(np.array_equal(stream_after,
                                                      stream_again))})
    check(np.array_equal(dec_after, out_np)
          and np.array_equal(stream_after, stream_again),
          "a graph's output changed after training in the same process")

    # ---- 11. times ----
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
    check(all(own[k] > 0 for k in FLAGSHIP_KERNELS),
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
    check(all(own[k] > 0 for k in FLAGSHIP_KERNELS),
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
                      eigvals_ms(comp))
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
            exact = exact_roots(a_s)
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
                eigvals_ms(comp_s),
                "torch.linalg.eigvals of the companion matrices"))

    # the training shapes, on the arguments the train step passed them
    # (phase 10): K3 on the batch's global STFT frames and window edges,
    # K1 and K2 on the eGeMAPS LLD rows of the batch's spans
    rec_t, shapes_t, rows_t = train["rec"], train["shapes"], train["lld_rows"]
    # phase 17's train graphs launch the kernels at these shapes (the
    # flagship and emotion2vec graphs on the same batches): their rows
    # count those launches too (each replay's record times the replays,
    # and the warm-up's and capture's), and their error is the larger of
    # the two holds
    g13 = s13["shapes"]
    check(set(g13["train_graph"]) == {
        ("cycle_dsum", (rows_t, 8, 17, 512)),
        ("cycle_dsum", (rows_t, 5, 33, 1024)), ("dk_roots", (rows_t,)),
        ("logmel", (train["t_global"],)), ("logmel", (train["t_edges"],))}
        and set(g13["e2v_graph"]) == {("logmel", (train["t_global"],)),
                                      ("logmel", (train["t_edges"],))}
        and set(g13["legacy_graph"]) == {("logmel", (s10["t_train"],))},
        f"the train graphs' launch shapes: {g13}")

    def with_graphs(key, tags=("train_graph", "e2v_graph")):
        return sum(g13[tag].get(key, 0) for tag in tags)

    def held13(name, tags, shape):
        return max(s13["held"][(name, tag, shape)]["max_abs_err"]
                   for tag in tags)

    with torch.inference_mode():
        for n, n_cyc, L in ((512, 8, 17), (1024, 5, 33)):
            (frames_a, st, tau, off), kw = rec_t[("cycle_dsum", "train",
                                                  (rows_t, n))]
            got = ck.cycle_dsum(frames_a, st, tau, off, **kw)
            want = f0_ops.cycle_dsum_plain(frames_a, st, tau, off, **kw)
            key = ("cycle_dsum", (rows_t, n_cyc, L, n))
            kernels.append(k1_entry(
                f"train + train graph args n{n} x{rows_t}", frames_a, st,
                tau, off, kw, shapes_t.get(key, 0) + with_graphs(key),
                max(float((got - want).abs().max()),
                    held13("cycle_dsum", ("train_graph",), (rows_t, n)))))
        (a_t,), _ = rec_t[("dk_roots", "train", rows_t)]
        a_t = a_t.reshape(rows_t, a_t.shape[-1])
        r_t = train["dk_held"]           # held on these arguments there
        check(dk_train_ok(r_t), f"dk_roots at the training rows: {r_t}")
        comp_t = companion(a_t)
        kernels.append(entry(
            f"dk_roots[train + train graph, {rows_t} rows]",
            "koemorph_tpu_torch/ops/cuda/dk_roots.cu",
            "koemorph_tpu/ops/pallas/dk_roots_kernel.py:95",
            shapes_t.get(("dk_roots", (rows_t,)), 0)
            + with_graphs(("dk_roots", (rows_t,))),
            max(r_t["hausdorff_max_held"],
                held13("dk_roots", ("train_graph",), rows_t)),
            lambda: ck.dk_roots(a_t), "dk_roots_kernel",
            lambda: eg.poly_roots_plain(a_t),
            rows_t * 11 * 4 + rows_t * 10 * 8 + 10 * 8,
            20.0 * 10 * (10 * 11 + 10 * 10 + 14) * rows_t,
            eigvals_ms(comp_t),
            "torch.linalg.eigvals of the companion matrices"))
        for t in (train["t_global"], train["t_edges"]):
            (x_t,), kw_t = rec_t[("logmel", "train", t)]
            err_t = float((ck.logmel(x_t, **kw_t)
                           - frontend.frames_to_logmel_plain(x_t, **kw_t))
                          .abs().max())
            x_flat = x_t.reshape(-1, 1024)
            kernels.append(entry(
                f"logmel[train + train graphs T={t}]",
                "koemorph_tpu_torch/ops/cuda/logmel.cu",
                "koemorph_tpu/ops/pallas/frontend_kernel.py:93",
                shapes_t.get(("logmel", (t,)), 0)
                + with_graphs(("logmel", (t,))),
                max(err_t, held13("logmel", ("train_graph", "e2v_graph"),
                                  t)),
                lambda: ck.logmel(x_t, **kw_t), "logmel_",
                lambda: frontend.frames_to_logmel_plain(x_t, **kw_t),
                4.0 * (t * 1024 + 2 * 1024 * live + nnz + t * 80),
                t * (2.0 * 1024 * live * 2 + 2.0 * nnz),
                time_ms(lambda: cublas_chain(x_flat), iters=50),
                "chain: window, 2 DFT matmuls, power, mel matmul, dB "
                "(3 cuBLAS fp32 products)", tensor_cores=True))

    # the shapes of phase 12: K1 and K2 on the full-ring refresh's ~2,057
    # LLD rows (the stream's 20.6 s context), K3 on the 16 lanes of the
    # emotion2vec server
    rows_f = s8["rows_full_ring"]
    sh_f = s8["shapes"]["stream_full_ring"]
    with torch.inference_mode():
        for n, n_cyc, L in ((512, 8, 17), (1024, 5, 33)):
            (frames_a, st, tau, off), kw = s8["rec"][
                ("cycle_dsum", "stream_full_ring", (rows_f, n))]
            got = ck.cycle_dsum(frames_a, st, tau, off, **kw)
            want = f0_ops.cycle_dsum_plain(frames_a, st, tau, off, **kw)
            kernels.append(k1_entry(
                f"full-ring args n{n} x{rows_f}", frames_a, st, tau, off, kw,
                sh_f.get(("cycle_dsum", (rows_f, n_cyc, L, n)), 0),
                float((got - want).abs().max())))
        (a_f,), _ = s8["rec"][("dk_roots", "stream_full_ring", rows_f)]
        a_f = a_f.reshape(rows_f, a_f.shape[-1])
        comp_f = companion(a_f)
        kernels.append(entry(
            f"dk_roots[full-ring, {rows_f} rows]",
            "koemorph_tpu_torch/ops/cuda/dk_roots.cu",
            "koemorph_tpu/ops/pallas/dk_roots_kernel.py:95",
            sh_f.get(("dk_roots", (rows_f,)), 0),
            s8["dk_full_ring"]["hausdorff_max_held"],
            lambda: ck.dk_roots(a_f), "dk_roots_kernel",
            lambda: eg.poly_roots_plain(a_f),
            rows_f * 11 * 4 + rows_f * 10 * 8 + 10 * 8,
            20.0 * 10 * (10 * 11 + 10 * 10 + 14) * rows_f,
            eigvals_ms(comp_f),
            "torch.linalg.eigvals of the companion matrices"))
        (x_e,), kw_e = s8["rec"][("logmel", "multistream_e2v G=8", 16)]
        err_e = float((ck.logmel(x_e, **kw_e)
                       - frontend.frames_to_logmel_plain(x_e, **kw_e))
                      .abs().max())
        kernels.append(entry(
            "logmel[T=16]", "koemorph_tpu_torch/ops/cuda/logmel.cu",
            "koemorph_tpu/ops/pallas/frontend_kernel.py:93",
            s8["shapes"]["multistream_e2v"][8].get(("logmel", (16,)), 0),
            err_e, lambda: ck.logmel(x_e, **kw_e), "logmel_",
            lambda: frontend.frames_to_logmel_plain(x_e, **kw_e),
            4.0 * (16 * 1024 + 2 * 1024 * live + nnz + 16 * 80),
            16 * (2.0 * 1024 * live * 2 + 2.0 * nnz),
            time_ms(lambda: cublas_chain(x_e.reshape(-1, 1024)), iters=50),
            "chain: window, 2 DFT matmuls, power, mel matmul, dB "
            "(3 cuBLAS fp32 products)", tensor_cores=True))

    # the shapes of phase 13: K1 on the arguments the Viterbi smoother's
    # picks gave it on the decode's 13,624 LLD rows
    rows_v = s9["rows_viterbi"]
    sh_v = s9["shapes"]["viterbi"]
    with torch.inference_mode():
        for n, n_cyc, L in ((512, 8, 17), (1024, 5, 33)):
            (frames_a, st, tau, off), kw = s9["rec"][
                ("cycle_dsum", "viterbi", (rows_v, n))]
            got = ck.cycle_dsum(frames_a, st, tau, off, **kw)
            want = f0_ops.cycle_dsum_plain(frames_a, st, tau, off, **kw)
            kernels.append(k1_entry(
                f"viterbi args n{n} x{rows_v}", frames_a, st, tau, off, kw,
                sh_v.get(("cycle_dsum", (rows_v, n_cyc, L, n)), 0),
                float((got - want).abs().max())))

    # the shapes of phase 14: K3 per rt_simplified frame (T = 31), per
    # legacy train step (16 x 361 frames) and per evaluation batch (4 x
    # 257), on the arguments those runs passed it
    with torch.inference_mode():
        for label, tag, t in (("rt_simplified", "rt_simplified",
                               s10["t_rt"]),
                              ("legacy train", "legacy_train",
                               s10["t_train"]),
                              ("evaluation", "eval", s10["t_eval"])):
            (x_l,), kw_l = s10["rec"][("logmel", tag, t)]
            err_l = float((ck.logmel(x_l, **kw_l)
                           - frontend.frames_to_logmel_plain(x_l, **kw_l))
                          .abs().max())
            x_flat = x_l.reshape(-1, 1024)
            graphed = tag == "legacy_train"      # + phase 17's legacy graph
            kernels.append(entry(
                f"logmel[{label}{' + legacy graph' if graphed else ''} "
                f"T={t}]",
                "koemorph_tpu_torch/ops/cuda/logmel.cu",
                "koemorph_tpu/ops/pallas/frontend_kernel.py:93",
                s10["shapes"][tag].get(("logmel", (t,)), 0)
                + (with_graphs(("logmel", (t,)), ("legacy_graph",))
                   if graphed else 0),
                max(err_l, held13("logmel", ("legacy_graph",), t)
                    if graphed else 0.0),
                lambda: ck.logmel(x_l, **kw_l), "logmel_",
                lambda: frontend.frames_to_logmel_plain(x_l, **kw_l),
                4.0 * (t * 1024 + 2 * 1024 * live + nnz + t * 80),
                t * (2.0 * 1024 * live * 2 + 2.0 * nnz),
                time_ms(lambda: cublas_chain(x_flat), iters=50),
                "chain: window, 2 DFT matmuls, power, mel matmul, dB "
                "(3 cuBLAS fp32 products)", tensor_cores=True))

    # the shapes of phase 15, on the arguments its paths passed them: the
    # imported checkpoints served (infer's decode, rt's stream, test_model's
    # batch; both fusion modes pass the kernels the same audio, so one row
    # per shape counts the launches of both), the lip-sync demo's batch-8
    # step and reproduce_results --smoke (its batch-4 train step and its
    # validation batch); each was held against its plain form in phase 15
    # and of phase 16: the sliding window (K3 at T = 257), the eGeMAPS
    # extractor (K1 and K2 on a 20 s window's 1,997 LLD rows) and the
    # exported program's frames (its launches counted in the process that
    # ran it, the arguments recorded from the live module's frame)
    for s_, paths in ((s11, SLICE11_PATHS), (s12, SLICE12_PATHS),
                      (s14, SLICE14_PATHS), (s15, SLICE15_PATHS)):
        rows_: dict = {}
        for (kname, tag, shape), r in sorted(s_["held"].items()):
            row = rows_.setdefault((kname, paths[tag], shape),
                                   {"tags": [], "err": 0.0})
            row["tags"].append(tag)
            row["err"] = max(row["err"], r["max_abs_err"])
        with torch.inference_mode():
            for (kname, path, shape), row in rows_.items():
                args, kw = s_["rec"][(kname, row["tags"][0], shape)]
                if kname == "cycle_dsum":
                    frames_a, st, tau, off = args
                    key = (st.numel(), kw["n_cycles"],
                           2 * kw["half_lag"] + 1, shape[1])
                else:
                    key = (shape,)
                launches = sum(s_["shapes"][tag].get((kname, key), 0)
                               for tag in row["tags"])
                if kname == "cycle_dsum":
                    kernels.append(k1_entry(
                        f"{path} args n{shape[1]} x{shape[0]}", frames_a,
                        st, tau, off, kw, launches, row["err"]))
                elif kname == "dk_roots":
                    a_p = args[0].reshape(shape, args[0].shape[-1])
                    comp_p = companion(a_p)
                    kernels.append(entry(
                        f"dk_roots[{path}, {shape} rows]",
                        "koemorph_tpu_torch/ops/cuda/dk_roots.cu",
                        "koemorph_tpu/ops/pallas/dk_roots_kernel.py:95",
                        launches, row["err"], lambda: ck.dk_roots(a_p),
                        "dk_roots_kernel", lambda: eg.poly_roots_plain(a_p),
                        shape * 11 * 4 + shape * 10 * 8 + 10 * 8,
                        20.0 * 10 * (10 * 11 + 10 * 10 + 14) * shape,
                        eigvals_ms(comp_p),
                        "torch.linalg.eigvals of the companion matrices"))
                else:
                    (x_p,) = args
                    x_flat = x_p.reshape(-1, 1024)
                    kernels.append(entry(
                        f"logmel[{path} T={shape}]",
                        "koemorph_tpu_torch/ops/cuda/logmel.cu",
                        "koemorph_tpu/ops/pallas/frontend_kernel.py:93",
                        launches, row["err"], lambda: ck.logmel(x_p, **kw),
                        "logmel_",
                        lambda: frontend.frames_to_logmel_plain(x_p, **kw),
                        4.0 * (shape * 1024 + 2 * 1024 * live + nnz
                               + shape * 80),
                        shape * (2.0 * 1024 * live * 2 + 2.0 * nnz),
                        time_ms(lambda: cublas_chain(x_flat), iters=50),
                        "chain: window, 2 DFT matmuls, power, mel matmul, dB "
                        "(3 cuBLAS fp32 products)", tensor_cores=True))

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
