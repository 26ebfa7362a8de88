"""Serving the ``emotion2vec`` variant: ``MultiStreamInference`` (the path
``serve`` runs) with the model's wav2vec2 encoder as the emotion stream,
over a few sessions in refresh cohorts, driven in a closed loop.

Set-up builds the configuration's streaming model (the encoder at the
widths of the configuration's ``emotion2vec`` block) with weights from the
seed (:func:`seeded_state`), the server with ``sessions`` lanes in
``cohorts`` cohorts, and captures its int16 graphs (every due set and
buffer parity). The traffic, the hand-off and the window are those of the
``serve`` driver (:mod:`perfbench.drivers.serve`): each session reads its
own seeded utterance, one int16 hop per step, one step in flight. A
refresh encodes each due lane's last ``context + margin`` samples of its
audio ring.

After the window the program's outputs are held against the plain
reference (:mod:`perfbench.reference.stream_e2v`, :func:`gaps`): the
checked lanes (``check_lanes`` of each of ``check_cohorts`` cohorts,
drawn from the seed) at every step of the window against the reference
streaming the same audio from fresh sessions with each lane's cohort
clock, their emotion vectors after the window, and every lane's last step
against the reference's head worked out from the program's state.

With ``--trace 1`` one slice of whole refresh cadences is profiled, as in
the ``serve`` driver; the record also carries the encoder's closed-form
work per lane by stage and the program's count of encoder frames over the
slice (:mod:`perfbench.harness.e2v_flops`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.drivers import serve
from perfbench.harness import compare, e2v_flops, model_cfg, program, \
    roofline, weights
from perfbench.harness.flops import count_flops
from perfbench.harness.kernels import LaunchRecorder, bounds
from perfbench.harness.trace import Slice, warm_profiler

#: the encoder the program and the reference implement: the published
#: fields of the configuration's ``emotion2vec`` block must say so
ARCHITECTURE = {"feat_extract_norm": "layer", "do_stable_layer_norm": True,
                "hidden_act": "gelu", "feat_extract_activation": "gelu"}


def encoder_fields(cfg: dict) -> dict:
    """The configuration's ``Wav2Vec2Config`` fields (lists as lists)."""
    block = cfg["emotion2vec"]
    for k, v in ARCHITECTURE.items():
        if block.get(k) != v:
            raise ValueError(f"the encoder implements {k} = {v!r}, the "
                             f"configuration says {block.get(k)!r}")
    from perfbench.reference.wav2vec2 import EncoderConfig
    names = [f.name for f in dataclasses.fields(EncoderConfig)]
    return {k: block[k] for k in names}


def reference_config(cfg: dict):
    from perfbench.reference.stream_e2v import E2VStreamConfig
    from perfbench.reference.wav2vec2 import EncoderConfig
    names = {f.name for f in dataclasses.fields(E2VStreamConfig)}
    kw = {k: v for k, v in model_cfg.stream_kwargs(cfg).items()
          if k in names}
    return E2VStreamConfig(
        **kw, emotion_margin_s=float(max(
            cfg["emotion_config"]["window_intervals"])),
        encoder=EncoderConfig.from_dict(encoder_fields(cfg)))


def _reference_model(cfg: dict, state: dict, device):
    from perfbench.reference.stream_e2v import StreamingE2VModel
    rcfg = reference_config(cfg)
    model = StreamingE2VModel(rcfg).to(device).eval()
    model.load_state_dict(state)
    return model, rcfg


def conv_kernels(template: torch.nn.Module) -> list[str]:
    """The state-dict keys of every convolution kernel of ``template``."""
    return [f"{name}.weight" for name, m in template.named_modules()
            if isinstance(m, torch.nn.Conv1d)]


def seeded_state(cfg: dict, seed: int, device) -> dict:
    """The weights from the seed, drawn with the reference's model as the
    template: :func:`perfbench.harness.weights.seeded_state` for every
    leaf, then every convolution kernel anew from its own stream of the
    seed, LeCun truncated normal over its fan-in (input channels of a
    group x kernel), as Flax's initializer draws it. (The shared draw's
    1 + N(0, 0.02) for a 3-D kernel would scale the positional
    convolution's output by ~sqrt(8,192) over its input.)"""
    from perfbench.reference.stream_e2v import StreamingE2VModel
    template = StreamingE2VModel(reference_config(cfg))
    state = weights.seeded_state(template, seed, device)
    keys = conv_kernels(template)
    total = sum(state[k].numel() for k in keys)
    sub = int(np.random.SeedSequence([int(seed), 1]).generate_state(
        2, np.uint32).view(np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(sub)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    u = u.clamp(1e-12, 1.0 - 1e-12)
    pos = 0
    for k in keys:
        ref = state[k]
        x = u[pos: pos + ref.numel()].reshape(ref.shape)
        pos += ref.numel()
        fan_in = ref.shape[1] * ref.shape[2]
        state[k] = (weights._truncated_normal(x) / math.sqrt(fan_in)
                    / weights.TRUNC_STD).to(ref.dtype)
    return state


def _reference_outputs(model, rcfg, traffic, lanes: np.ndarray,
                       phases: list, n_steps: int, device):
    """``(n_steps, len(lanes), 52)``: the plain reference's blendshapes of
    the checked lanes from fresh sessions, lane ``i`` refreshing where
    ``(phases[i] + step) % K == 0``; and its state after the last step."""
    from perfbench.reference import stream_e2v as ref
    k = rcfg.emotion_update_frames
    st = ref.init_state(rcfg, device, len(lanes))
    out = np.empty((n_steps, len(lanes), rcfg.num_blendshapes), np.float32)
    with torch.no_grad():
        for f in range(n_steps):
            hop = torch.from_numpy(traffic.hops(f, lanes)).to(device)
            hop = hop.to(torch.float32) * (2.0 ** -15)
            due = [i for i, p in enumerate(phases) if (p + f) % k == 0]
            y, st = ref.stream_frame_lanes(model, st, hop, rcfg, due)
            out[f] = y.cpu().numpy()
    return out, st


def gaps(a: dict) -> dict:
    """The numbers compared, from the arrays of one run (or of the
    control): ``got`` / ``want`` the checked lanes' blendshapes at every
    step, ``emo_got`` / ``emo_want`` their emotion vectors after the
    window, ``head_got`` / ``head_want`` every lane's last step and the
    reference's from the same state.

    - ``serve_mouth_err``: the widest gap over the 28 mouth blendshapes
      (the frame path: mel row with K3, the window, the mel attention,
      the EMA);
    - ``serve_blend_err``: the widest gap over all 52 blendshapes: the
      expression blendshapes read the emotion vector, so they hold every
      refresh's encoder (no K2 or other root finder runs on this path to
      move them by a branch);
    - ``serve_e2v_err``: the widest gap over the checked lanes' 1,024-D
      vectors after the window, over the vectors' largest magnitude (the
      encoder's output, by itself);
    - ``serve_head_err``: the widest gap over every lane's last step, the
      reference's worked out from the program's state (dB rows, emotion
      vector, the step before): the emotion projection, the dual-stream
      attention, the heads and the EMA."""
    from perfbench.reference.blendshapes import MOUTH_INDICES
    emo_want = np.asarray(a["emo_want"], np.float64)
    scale = max(float(np.abs(emo_want).max()), 1e-12)
    return {"serve_mouth_err": compare.widest(a["got"], a["want"],
                                              MOUTH_INDICES),
            "serve_blend_err": compare.widest(a["got"], a["want"]),
            "serve_e2v_err": compare.widest(a["emo_got"], emo_want) / scale,
            "serve_head_err": compare.widest(a["head_got"], a["head_want"])}


def _step_flops(cfg: dict, state: dict, device) -> tuple[float, float]:
    """(frame, refresh) floating-point operations of one lane's step
    outside the kernels: every step, and on top on a refreshing step."""
    from perfbench.reference import stream_e2v as ref
    model, rcfg = _reference_model(cfg, state, device)
    st = ref.init_state(rcfg, device, 1)
    hop = torch.zeros((1, rcfg.hop_length), device=device)
    frame = count_flops(lambda: ref.stream_frame_lanes(model, st, hop, rcfg,
                                                       []))
    both = count_flops(lambda: ref.stream_frame_lanes(model, st, hop, rcfg,
                                                      [0]))
    return frame, both - frame


def control(cell, device, steps: int) -> dict:
    """The control's numbers (:func:`gaps`): the reference in TF32 put in
    the program's place over ``steps`` steps of the checked lanes (its
    last step's reference worked out from its own state), against the
    float32 reference."""
    cfg = cell.config
    model, rcfg = _reference_model(cfg, seeded_state(cfg, cell.seed, device),
                                   device)
    traffic, lanes, phases = serve.sessions(cell, rcfg.hop_length,
                                            rcfg.emotion_update_frames,
                                            device)
    want, st_want = _reference_outputs(model, rcfg, traffic, lanes, phases,
                                       steps, device)
    with compare.tf32():
        got, st_got = _reference_outputs(model, rcfg, traffic, lanes,
                                         phases, steps, device)
    return gaps({"got": got, "want": want,
                 "emo_got": st_got.emotion_raw.cpu().numpy(),
                 "emo_want": st_want.emotion_raw.cpu().numpy(),
                 "head_got": got[-1],
                 "head_want": serve._head(model, rcfg, st_got.mel_db,
                                          st_got.emotion_raw, got[-2])})


def build_server(cfg: dict, tr: dict, state: dict, device):
    from koemorph_tpu_torch.features.wav2vec2 import Wav2Vec2Config
    from koemorph_tpu_torch.runtime.multistream import MultiStreamInference
    from koemorph_tpu_torch.runtime.streaming import (StreamingConfig,
                                                      model_for_config)
    enc = {k: tuple(v) if isinstance(v, list) else v
           for k, v in encoder_fields(cfg).items()}
    scfg = StreamingConfig(**model_cfg.stream_kwargs(cfg),
                           emotion2vec_config=Wav2Vec2Config(**enc))
    model = model_for_config(scfg).to(device)
    model.load_state_dict(state)
    server = MultiStreamInference(model, scfg, n_sessions=tr["sessions"],
                                  device=device,
                                  refresh_cohorts=tr["cohorts"])
    return server, scfg


def _encoder_frames() -> int:
    """The program's count of encoder frames so far (0 for a program
    without the counter)."""
    spans = program.spans_module()
    if spans is None:
        return 0
    return int(spans.counters(e2v_flops.COUNTER).get(e2v_flops.COUNTER, 0))


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
    traffic, lanes, phases = serve.sessions(cell, scfg.hop_length,
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
    refreshed_lanes = slice_refresh_steps = frames0 = slice_frames = 0
    prof = traced = None
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
            frames0 = _encoder_frames()
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
            slice_refresh_steps += bool(due)
            if step == slice_steps.stop - 1:
                recorder.recording = False
                slice_frames = _encoder_frames() - frames0
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
    arrays["head_want"] = serve._head(model, rcfg, mel_db, emotion_raw,
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
        live, nnz = roofline.logmel_live(scfg.n_fft, scfg.sample_rate,
                                         scfg.n_mels, scfg.f_min, scfg.f_max)
        kb = bounds(recorder.snapshots, live, nnz)
        f_frame, f_refresh = _step_flops(cfg, state, dev)
        flops = (len(slice_steps) * s * f_frame + refreshed_lanes * f_refresh
                 + sum(e["ops"] for e in kb.values()))
        ctx = rcfg.context_samples
        rec.update(trace=traced.result, kernel_bounds=kb, slice_flops=flops,
                   e2v={"frames_per_lane": rcfg.encoder.frames(ctx),
                        "stage_flops": e2v_flops.stage_flops(
                            encoder_fields(cfg), ctx),
                        "slice_encoder_frames": slice_frames,
                        "slice_refresh_steps": slice_refresh_steps})
    return rec
