"""Offline decoding: ``BatchedSequentialDecoder.__call__`` (the path
``infer`` runs) on batches of equal-length utterances.

Set-up builds the configuration's sequential model (its stride, the
parallel decode of every window) with weights from the seed, makes a pool
of seeded utterances on the card and captures the decode's graph with a
first call. Each call of the window decodes a new batch: ``batch`` rows,
each ``utterance_frames`` hops of a pool utterance from a seeded offset,
wrapping around, so every call has the same shape. Calls run back to back
with at most two in flight (the next batch is cut and launched while the
card finishes the last); a call is complete when the card has finished
it, and the window closes when every call launched has.

After the window a sample of the calls (``check_calls``, drawn from the
seed by reservoir over the calls made) is held against the plain
reference decoding the same utterances one by one (:func:`gaps`): the
mouth blendshapes (frontend, windows, mel attention, EMA) and the
expression blendshapes (eGeMAPS, attention, EMA). With ``--trace 1``
``slice_calls`` calls from call ``slice_after_calls`` on are profiled.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import audio, compare, model_cfg, roofline, weights
from perfbench.harness.flops import count_flops
from perfbench.harness.kernels import LaunchRecorder, bounds
from perfbench.harness.trace import Slice, warm_profiler


class Batches:
    """Batch ``i``'s rows: utterance ``utt[i, r]`` of the pool from offset
    ``off[i, r]``, ``length`` samples, wrapping around (drawn as needed,
    in call order, from ``rng``)."""

    def __init__(self, pool: torch.Tensor, batch: int, length: int,
                 rng: np.random.Generator):
        self.n, self.span = pool.shape
        if length > self.span:
            raise ValueError(f"utterances of {length} samples need a pool "
                             f"at least as long, got {self.span}")
        self.pool = torch.cat([pool, pool[:, :length]], 1)
        self.batch, self.length, self.rng = batch, length, rng
        self.picks: list = []

    def __call__(self, i: int) -> torch.Tensor:
        while len(self.picks) <= i:
            self.picks.append((self.rng.integers(self.n, size=self.batch),
                               self.rng.integers(self.span, size=self.batch)))
        utt, off = self.picks[i]
        return torch.stack([self.pool[u, o:o + self.length]
                            for u, o in zip(utt.tolist(), off.tolist())])


def _model(cfg: dict, state: dict, device, reference: bool):
    if reference:
        from perfbench.reference.model import SequentialDualStreamModel
    else:
        from koemorph_tpu_torch.models.dual_stream_model import (
            SequentialDualStreamModel)
    model = SequentialDualStreamModel(**model_cfg.sequential_kwargs(cfg))
    model = model.to(device).eval()
    if state is not None:
        model.load_state_dict(state)
    return model


def _reference(ref, x: torch.Tensor) -> np.ndarray:
    """The reference's blendshapes of batch ``x``, one utterance at a
    time."""
    with torch.no_grad():
        return np.stack([ref(x[r:r + 1])["blendshapes"][0].cpu().numpy()
                         for r in range(x.shape[0])])


def gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """The numbers compared, of the checked calls' blendshapes ``(calls,
    batch, frames, 52)``: ``decode_mouth_err``, the widest gap over the
    mouth blendshapes (the frontend with K3, the windows, the mel
    attention, the EMA); ``decode_expression_err``, the median over the
    checked utterances of each one's widest gap over the expression
    blendshapes (eGeMAPS with K1 and K2, the emotion attention, the EMA):
    on a few utterances a formant row that K2 and its plain form round
    apart moves the whole utterance's expression, a change of precision
    moves every utterance's."""
    from perfbench.reference.blendshapes import (EXPRESSION_INDICES,
                                                 MOUTH_INDICES)
    gap = np.abs(np.asarray(got, np.float64) - want)
    per_utterance = gap[..., list(EXPRESSION_INDICES)].max(axis=(-2, -1))
    return {"decode_mouth_err": compare.widest(got, want, MOUTH_INDICES),
            "decode_expression_err": float(np.median(per_utterance))}


def control(cell, device, calls: int) -> dict:
    """The control: the reference in TF32 put in the program's place, its
    widest gap from the float32 reference over ``calls`` batches."""
    cfg, tr = cell.config, cell.traffic
    ref = _model(cfg, None, device, reference=True)
    ref.load_state_dict(weights.seeded_state(ref, cell.seed, device))
    pool = audio.utterance_pool(tr["pool_utterances"], tr["pool_seconds"],
                                cell.seed, device)
    batches = Batches(pool, tr["batch"],
                      tr["utterance_frames"] * model_cfg.hop(cfg),
                      np.random.default_rng(cell.seed))
    got, want = [], []
    for b in range(1, calls + 1):
        want.append(_reference(ref, batches(b)))
        with compare.tf32():
            got.append(_reference(ref, batches(b)))
    return gaps(np.stack(got), np.stack(want))


def run(cell, t_start: float, device: str) -> dict:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(cell.seed)
    # the weights drawn with the reference's model as the template (its
    # constructor's constants included), loaded into the program's
    state = weights.seeded_state(_model(cfg, None, dev, reference=True),
                                 cell.seed, dev)
    model = _model(cfg, state, dev, reference=False)
    from koemorph_tpu_torch.parallel.batched_decode import (
        BatchedSequentialDecoder)
    decoder = BatchedSequentialDecoder(model, device=dev)
    hop = model_cfg.hop(cfg)
    pool = audio.utterance_pool(tr["pool_utterances"], tr["pool_seconds"],
                                cell.seed, dev)
    batches = Batches(pool, tr["batch"], tr["utterance_frames"] * hop, rng)
    del pool
    recorder = LaunchRecorder() if (cell.trace and on_card) else None
    with (recorder.installed() if recorder else contextlib.nullcontext()):
        if recorder:
            recorder.watch(decoder.step_graphs)
        warm = decoder(batches(0))          # the capture (or an eager run)
    rows_per_call = warm.shape[0] * warm.shape[1]
    del warm
    check_rng = np.random.default_rng([cell.seed, 1])
    n_check = tr["check_calls"]
    slice_calls = range(tr["slice_after_calls"],
                        tr["slice_after_calls"] + tr["slice_calls"])
    if recorder:
        warm_profiler()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    kept: dict = {}
    pending = collections.deque()
    prof = traced = None
    t0 = time.perf_counter()
    t_end = t0 + cell.seconds
    i = 0
    while time.perf_counter() < t_end or prof is not None:
        if recorder and i == slice_calls.start:
            while pending:
                pending.popleft().synchronize()
            prof = Slice(cell.root / "build" / "perfbench" /
                         f"{cell.name}.trace.json")
            prof.__enter__()
            recorder.recording = True
        with record_function("perfbench.prepare"):
            x = batches(i + 1)
        with record_function("perfbench.dispatch"):
            out = decoder(x)
        # a reservoir of n_check calls, drawn from the seed
        slot = i if i < n_check else int(check_rng.integers(i + 1))
        if slot < n_check:
            kept[slot] = (i + 1, out)
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            with record_function("perfbench.wait"):
                while len(pending) >= 2:
                    pending.popleft().synchronize()
        if prof is not None:
            if i == slice_calls.stop - 1:
                recorder.recording = False
                prof.__exit__(None, None, None)
                traced, prof = prof, None
        i += 1
    if on_card:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    if recorder and traced is None:
        raise RuntimeError("the window ended before the profiled slice "
                           "did; give the run more seconds")
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    checked = {b: o.cpu().numpy() for b, o in kept.values()}
    del decoder, model, out, kept
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = _model(cfg, state, dev, reference=True)
    got = np.stack([o for _, o in sorted(checked.items())])
    want = np.stack([_reference(ref, batches(b)) for b in sorted(checked)])
    finite = bool(np.isfinite(got).all())
    numbers = gaps(got, want)
    print(f"perfbench: set-up {setup_s:.1f} s, {i} calls, reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    rec = {"setup_s": setup_s, "window_s": window_s, "attempted": i,
           "failed": int(not finite), "decode_rows": i * rows_per_call,
           "memory_peak_bytes": memory_peak,
           "compared": {k: (v, tr["limits"][k])
                        for k, v in numbers.items()}}
    if recorder:
        mel = cfg["mel"]
        live, nnz = roofline.logmel_live(mel["n_fft"], cfg["sample_rate"],
                                         mel["n_mels"], float(mel["f_min"]),
                                         float(mel["f_max"]))
        kb = bounds(recorder.snapshots, live, nnz)
        x = batches(slice_calls.start + 1)[:1]
        per_row = count_flops(lambda: ref(x))
        flops = (len(slice_calls) * tr["batch"] * per_row
                 + sum(e["ops"] for e in kb.values()))
        rec.update(trace=traced.result, kernel_bounds=kb, slice_flops=flops)
    return rec
