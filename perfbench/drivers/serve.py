"""Serving: ``MultiStreamInference`` (the path ``serve`` runs) over many
sessions in refresh cohorts, driven in a closed loop.

Set-up builds the configuration's streaming model with weights from the
seed, the server with ``sessions`` lanes in ``cohorts`` cohorts, and
captures its int16 graphs (every due set and buffer parity). Each session
reads its own audio out of a pool of seeded utterances, from its own
offset, wrapping around; the audio is handed to the server as int16 PCM,
one hop per session per step. The window runs steps back to back with one
step in flight: a step is handed its audio, the next step's audio is
prepared while the card runs, and the step ends when its ``(S, 52)``
blendshapes are in host memory. A step's latency runs from the hand-off
to that point.

After the window the program's outputs are held against the plain
reference (:func:`gaps`). A sample of lanes (``check_lanes`` of each of
``check_cohorts`` cohorts, drawn from the seed) at every step of the
window, against the reference streaming the same audio from fresh
sessions with each lane's cohort clock: the mouth blendshapes (the frame
path), and the lanes' emotion vectors after the window (the refresh:
eGeMAPS, its jitter through K1 and its formants through K2). Every
lane's last step, against the reference's model and EMA worked out from
the program's state after that step (the stage from the emotion vector
on, where the formant rows that K2 and its plain form round apart would
otherwise move the expression blendshapes).

With ``--trace 1`` one slice of whole refresh cadences, starting at the
first cadence after ``slice_after_steps`` steps, is profiled; the kernels
the slice replayed are bounded from their recorded arguments, and the
slice's floating-point work is counted on the reference.
"""

from __future__ import annotations

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


class SessionAudio:
    """Each session's hops as int16 PCM: session ``s`` reads utterance
    ``u_s`` of the pool from offset ``o_s``, wrapping around."""

    def __init__(self, n_sessions: int, hop: int, pool: np.ndarray,
                 rng: np.random.Generator):
        n_pool, length = pool.shape
        self.hop, self.length = hop, length
        self.pool = np.concatenate([pool, pool[:, :hop]], 1)
        self.flat = self.pool.reshape(-1)
        self.utt = rng.integers(n_pool, size=n_sessions)
        self.off = rng.integers(length, size=n_sessions)
        self._cols = np.arange(hop)

    def hops(self, step: int, lanes=slice(None), out=None) -> np.ndarray:
        """The hops of ``step`` (of ``lanes``), into ``out`` if given."""
        pos = (self.off[lanes] + step * self.hop) % self.length
        base = self.utt[lanes] * self.pool.shape[1] + pos
        return np.take(self.flat, base[:, None] + self._cols, out=out)


#: the LLD ring's channels that the formant check reads: K2's (``dk_roots``)
#: roots give each row's formant frequencies
LLD_KEYS = ("voiced", "formant_freq", "formant_valid")


def jitter_columns(width: int) -> tuple:
    """The emotion vector's jitter functionals (``width`` = 88 x offsets,
    offset-major): the per-cycle periods of K1 (``cycle_dsum``) reach it
    only through them."""
    from perfbench.reference.egemaps import FEATURE_NAMES
    n = len(FEATURE_NAMES)
    return tuple(o * n + i for o in range(width // n)
                 for i, name in enumerate(FEATURE_NAMES)
                 if name.startswith("jitter"))


def formant_share(got: dict, want: dict, hz: float = 1.0) -> float:
    """The share of the LLD rows, voiced with a valid formant in the
    reference's ring, whose formant frequency lies more than ``hz`` from
    the reference's."""
    rows = want["voiced"][..., None] & want["formant_valid"]
    gap = np.abs(got["formant_freq"].astype(np.float64)
                 - want["formant_freq"])
    return float((gap[rows] > hz).mean())


def _reference_model(cfg: dict, state: dict, device):
    from perfbench.reference import stream as ref
    rcfg = ref.StreamingConfig(**model_cfg.stream_kwargs(cfg))
    model = ref.model_for_config(rcfg).to(device).eval()
    model.load_state_dict(state)
    return model, rcfg


def _reference_outputs(model, rcfg, traffic: SessionAudio,
                       lanes: np.ndarray, phases: list, n_steps: int,
                       device) -> tuple[np.ndarray, object]:
    """``(n_steps, len(lanes), 52)``: the plain reference's blendshapes of
    the sampled lanes from fresh sessions, lane ``i`` refreshing where
    ``(phases[i] + step) % K == 0``; and its state after the last step."""
    from perfbench.reference import stream as ref
    k = rcfg.emotion_update_frames
    st = ref.init_stream_state(rcfg, device, len(lanes))
    out = np.empty((n_steps, len(lanes), rcfg.num_blendshapes), np.float32)
    with torch.no_grad():
        for f in range(n_steps):
            hop = torch.from_numpy(traffic.hops(f, lanes)).to(device)
            hop = hop.to(torch.float32) * (2.0 ** -15)
            due = [i for i, p in enumerate(phases) if (p + f) % k == 0]
            y, st = ref.stream_frame_lanes(model, st, hop, rcfg, due)
            out[f] = y.cpu().numpy()
    return out, st


def _head(model, rcfg, mel_db: torch.Tensor, emotion_raw: torch.Tensor,
          prev: np.ndarray, block: int = 256) -> np.ndarray:
    """The reference's model and EMA over every lane of a given state
    (:func:`perfbench.reference.stream.head_step`), in blocks of lanes."""
    from perfbench.reference import stream as ref
    dev = mel_db.device
    prev = torch.from_numpy(np.ascontiguousarray(prev)).to(dev)
    with torch.no_grad():
        return np.concatenate([
            ref.head_step(model, mel_db[i:i + block],
                          emotion_raw[i:i + block], prev[i:i + block],
                          rcfg).cpu().numpy()
            for i in range(0, mel_db.shape[0], block)])


def _lld(ring: dict, index) -> dict:
    return {k: ring[k][index].cpu().numpy() for k in LLD_KEYS}


def gaps(a: dict) -> dict:
    """The numbers compared, from the arrays of one run (or of the
    control): ``got`` / ``want`` the checked lanes' blendshapes at every
    step, ``emo_got`` / ``emo_want`` their emotion vectors and
    ``lld_got`` / ``lld_want`` their LLD rings after the window,
    ``head_got`` / ``head_want`` every lane's last step and the
    reference's from the same state.

    - ``serve_mouth_err``: the widest gap over the 28 mouth blendshapes of
      every checked step and lane (the frame path: mel row with K3, the
      window, the mel attention, the EMA);
    - ``serve_emotion_err``: the median over the 264 features of each
      feature's widest relative gap over the lanes (the refresh's LLDs
      and functionals);
    - ``serve_jitter_err``: the median over the lanes of each lane's
      widest relative gap over the jitter functionals (K1): where two
      lags' sums of a glottal cycle tie to rounding, K1 and its plain form
      may pick either, and that one period moves one lane's jitter;
    - ``serve_formant_share``: the share of the lanes' voiced LLD rows
      whose formant frequency (K2) lies more than 1 Hz from the
      reference's (:func:`formant_share`): on a few rows Durand-Kerner
      has not converged, and K2 and its plain form give other roots
      there;
    - ``serve_head_err``: the widest gap over the 52 blendshapes of every
      lane's last step, the reference's worked out from the program's
      state (dB rows, emotion vector, the step before): the emotion
      projection, the dual-stream attention, the heads and the EMA."""
    from perfbench.reference.blendshapes import MOUTH_INDICES
    emo_got, emo_want = a["emo_got"], a["emo_want"]
    width = emo_want.shape[-1]
    jit = compare.relative_gaps(emo_got, emo_want)[:, jitter_columns(width)]
    return {"serve_mouth_err": compare.widest(a["got"], a["want"],
                                              MOUTH_INDICES),
            "serve_emotion_err": compare.feature_gap(emo_got, emo_want),
            "serve_jitter_err": float(np.median(jit.max(axis=1))),
            "serve_formant_share": formant_share(a["lld_got"],
                                                 a["lld_want"]),
            "serve_head_err": compare.widest(a["head_got"], a["head_want"])}


def _step_flops(cfg: dict, state: dict, device) -> tuple[float, float]:
    """(frame, refresh) floating-point operations of one lane's step
    outside the kernels: every step, and on top on a refreshing step."""
    from perfbench.reference import stream as ref
    model, rcfg = _reference_model(cfg, state, device)
    st = ref.init_stream_state(rcfg, device, 1)
    hop = torch.zeros((1, rcfg.hop_length), device=device)
    frame = count_flops(lambda: ref.stream_frame(model, st, hop, rcfg, False))
    both = count_flops(lambda: ref.stream_frame(model, st, hop, rcfg, True))
    return frame, both - frame


def sessions(cell, hop: int, k: int, device
             ) -> tuple[SessionAudio, np.ndarray, list]:
    """The cell's traffic from its seed: each session's audio, the lanes
    whose outputs are checked (``check_lanes`` of each of ``check_cohorts``
    cohorts) and their cohorts' phases (lane ``l`` is in cohort ``c = l %
    G``, whose clock starts at ``c K // G``)."""
    tr = cell.traffic
    rng = np.random.default_rng(cell.seed)
    pool = audio.utterance_pool(tr["pool_utterances"], tr["pool_seconds"],
                                cell.seed, device)
    traffic = SessionAudio(tr["sessions"], hop, audio.to_int16(pool), rng)
    s, g = tr["sessions"], tr["cohorts"]
    cohorts = rng.choice(g, tr["check_cohorts"], replace=False)
    lanes = np.sort(np.concatenate([
        rng.choice(np.arange(c, s, g), tr["check_lanes"], replace=False)
        for c in cohorts]))
    return traffic, lanes, [(int(lane) % g) * k // g for lane in lanes]


def seeded_state(cfg: dict, seed: int, device) -> dict:
    """The weights from the seed, drawn with the reference's model as the
    template (its constructor's constants included)."""
    from perfbench.reference import stream as ref
    rcfg = ref.StreamingConfig(**model_cfg.stream_kwargs(cfg))
    return weights.seeded_state(ref.model_for_config(rcfg), seed, device)


def control(cell, device, steps: int) -> dict:
    """The control's numbers (:func:`gaps`): the reference in TF32 put in
    the program's place over ``steps`` steps of the checked lanes (its
    last step's reference worked out from its own state), against the
    float32 reference."""
    cfg = cell.config
    model, rcfg = _reference_model(cfg, seeded_state(cfg, cell.seed,
                                                     device), device)
    traffic, lanes, phases = sessions(cell, rcfg.hop_length,
                                      rcfg.emotion_update_frames, device)
    want, st_want = _reference_outputs(model, rcfg, traffic, lanes, phases,
                                       steps, device)
    with compare.tf32():
        got, st_got = _reference_outputs(model, rcfg, traffic, lanes,
                                         phases, steps, device)
    everyone = slice(None)
    return gaps({"got": got, "want": want,
                 "emo_got": st_got.emotion_raw.cpu().numpy(),
                 "emo_want": st_want.emotion_raw.cpu().numpy(),
                 "lld_got": _lld(st_got.lld_ring, everyone),
                 "lld_want": _lld(st_want.lld_ring, everyone),
                 "head_got": got[-1],
                 "head_want": _head(model, rcfg, st_got.mel_db,
                                    st_got.emotion_raw, got[-2])})


def build_server(cfg: dict, tr: dict, state: dict, device):
    from koemorph_tpu_torch.runtime.multistream import MultiStreamInference
    from koemorph_tpu_torch.runtime.streaming import (StreamingConfig,
                                                      model_for_config)
    scfg = StreamingConfig(**model_cfg.stream_kwargs(cfg))
    model = model_for_config(scfg).to(device)
    model.load_state_dict(state)
    server = MultiStreamInference(model, scfg, n_sessions=tr["sessions"],
                                  device=device,
                                  refresh_cohorts=tr["cohorts"])
    return server, scfg


def run(cell, t_start: float, device: str) -> dict:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = [("start", t_start), ("import", time.perf_counter())]
    state = seeded_state(cfg, cell.seed, dev)
    server, scfg = build_server(cfg, tr, state, dev)
    marks.append(("model", time.perf_counter()))
    recorder = LaunchRecorder() if (cell.trace and on_card) else None
    with (recorder.installed() if recorder else contextlib.nullcontext()):
        if recorder:
            recorder.watch(server.step_graphs)
        server.warmup(torch.int16)
    marks.append(("graphs", time.perf_counter()))
    traffic, lanes, phases = sessions(cell, scfg.hop_length,
                                      scfg.emotion_update_frames, dev)
    marks.append(("traffic", time.perf_counter()))
    s, g, k = tr["sessions"], tr["cohorts"], scfg.emotion_update_frames
    slice_start = -(-tr["slice_after_steps"] // k) * k
    slice_steps = range(slice_start, slice_start + k * tr["slice_cadences"])
    if recorder:
        warm_profiler()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    latency, dispatch, refresh, kept = [], [], [], []
    refreshed_lanes = 0
    prof = traced = None
    # the hand-off's buffers in page-locked host memory, two of each: the
    # next step's audio is filled while the card runs the other, and the
    # last two steps' blendshapes stay for the check
    pinned = dict(pin_memory=on_card)
    hop_bufs = [torch.empty((s, scfg.hop_length), dtype=torch.int16,
                            **pinned) for _ in range(2)]
    host_outs = [torch.empty((s, scfg.num_blendshapes), **pinned)
                 for _ in range(2)]
    traffic.hops(0, out=hop_bufs[0].numpy())
    t0 = time.perf_counter()
    t_end = t0 + cell.seconds
    step = 0
    while True:
        if recorder and step == slice_steps.start:
            prof = Slice(cell.root / "build" / "perfbench" /
                         f"{cell.name}.trace.json")
            prof.__enter__()
            recorder.recording = True
        a = time.perf_counter()
        if a >= t_end and prof is None:
            break
        due = server.due_cohorts()
        with record_function("perfbench.dispatch"):
            out = server.step(hop_bufs[step % 2])
        b = time.perf_counter()
        with record_function("perfbench.prepare"):
            traffic.hops(step + 1, out=hop_bufs[(step + 1) % 2].numpy())
        with record_function("perfbench.wait"):
            host_out = host_outs[step % 2]
            host_out.copy_(out, non_blocking=True)
            if on_card:
                torch.cuda.current_stream(dev).synchronize()
            host = host_out.numpy()
        c = time.perf_counter()
        latency.append(c - a)
        dispatch.append(b - a)
        refresh.append(bool(due))
        kept.append(host[lanes])          # a copy (fancy index)
        if prof is not None:
            refreshed_lanes += len(due) * (s // g)
            if step == slice_steps.stop - 1:
                recorder.recording = False
                prof.__exit__(None, None, None)
                traced, prof = prof, None
        step += 1
    window_s = time.perf_counter() - t0 if not latency else c - t0
    if recorder and traced is None:
        raise RuntimeError("the window ended before the profiled slice "
                           "did; give the run more seconds")
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    n = len(kept)
    final = server.states
    index = torch.from_numpy(lanes).to(dev)
    arrays = {"got": np.stack(kept),
              "emo_got": final.emotion_raw[index].cpu().numpy(),
              "lld_got": _lld(final.lld_ring, index),
              "head_got": host_outs[(n - 1) % 2].numpy().copy()}
    mel_db, emotion_raw = final.mel_db.clone(), final.emotion_raw.clone()
    del server, out, final
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    model, rcfg = _reference_model(cfg, state, dev)
    arrays["want"], ref_state = _reference_outputs(
        model, rcfg, traffic, lanes, phases, n, dev)
    arrays["emo_want"] = ref_state.emotion_raw.cpu().numpy()
    arrays["lld_want"] = _lld(ref_state.lld_ring, slice(None))
    arrays["head_want"] = _head(model, rcfg, mel_db, emotion_raw,
                                host_outs[(n - 2) % 2].numpy())
    del mel_db, emotion_raw, model, ref_state
    print(f"perfbench: set-up {setup_s:.1f} s ("
          + ", ".join(f"{b[0]} {b[1] - a[1]:.1f}"
                      for a, b in zip(marks, marks[1:]))
          + f"), {n} steps (median dispatch {np.median(dispatch) * 1e3:.3f}"
          f" ms, latency {np.median(latency) * 1e3:.3f} ms), reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    got = arrays["got"]
    numbers = gaps(arrays)
    rec = {"setup_s": setup_s, "window_s": window_s, "attempted": n,
           "failed": int(not np.isfinite(got).all()),
           "session_frames": n * s, "latency_s": latency,
           "dispatch_s": dispatch, "refresh": refresh,
           "in_slice": [i in slice_steps for i in range(n)]
           if recorder else [False] * n,
           "memory_peak_bytes": memory_peak,
           "compared": {k: (v, tr["limits"][k])
                        for k, v in numbers.items()}}
    if recorder:
        tr_res = traced.result
        live, nnz = roofline.logmel_live(scfg.n_fft, scfg.sample_rate,
                                         scfg.n_mels, scfg.f_min, scfg.f_max)
        kb = bounds(recorder.snapshots, live, nnz)
        f_frame, f_refresh = _step_flops(cfg, state, dev)
        flops = (len(slice_steps) * s * f_frame + refreshed_lanes * f_refresh
                 + sum(e["ops"] for e in kb.values()))
        rec.update(trace=tr_res, kernel_bounds=kb, slice_flops=flops)
    return rec
