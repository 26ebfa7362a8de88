"""Multi-session streaming: ``n_sessions`` independent 30 fps sessions in
one batched step on one GPU.

Every field of the stream's state gains a leading lane dim (the audio
rings are one ``(S, audio_ring_len)`` tensor, the LLD rings ``(S, rows,
...)``), so one step runs the per-frame work of all sessions as
``(S, ...)``-sized kernels: the new mel row of every lane is one launch of
the fused frontend over a view of the rings, the attention one batch of S
windows. Each lane's window is normalized to its own max.

The emotion refresh clock stays on the host. With ``refresh_cohorts=G``
the lanes split into G cohorts, lane ``l`` in cohort ``l % G``, and cohort
``c``'s clock starts at phase ``c*K//G`` of the K-frame refresh cadence,
so at most one cohort refreshes in a step (G = 1: every lane refreshes
together every K frames). The refresh runs once per due cohort on its
lanes' views ``[c::G]`` of the rings (read in place), batched over the
cohort's lanes (the ``emotion2vec`` encoder: one pass over all of
them), and writes the cohort's results back into the lane-batched state
in place. A lane is
exactly a dedicated :class:`~koemorph_tpu_torch.runtime.streaming.
StreamingInference` whose clock started at its cohort's phase, up to the
summation order of batched products.

The state lives in static buffers (:class:`~koemorph_tpu_torch.runtime.
streaming.StaticStream`): the audio rings and dB rows ping-pong between
two buffers, every other field is written in place. On the card a step is
one CUDA graph replay: a graph per due set (no cohort, or cohort ``c``),
buffer parity and input dtype, 2(G+1) per dtype, captured by
:meth:`MultiStreamInference.warmup` or at the first step with that dtype,
in one memory pool. The host keeps the clocks and picks the graph; no
step reads anything back from the device.

In the span registry (:mod:`koemorph_tpu_torch.utils.spans`) a step is the
host span ``koemorph.serve.step`` with children ``.h2d`` (the hops copied
in), ``.launch`` and ``.out``, and one step of the ``serve`` track on the
device: ``ingest`` (int16 to float), ``ring``, ``mel``, one ``refresh``
per due cohort (the ``emotion2vec`` backend's preceded by its encoder's
``e2v_front``, ``e2v_layers`` and ``e2v_pool``) and ``model``
(:func:`~koemorph_tpu_torch.runtime.streaming.stream_step_`). It counts
``koemorph.serve.steps``, ``koemorph.serve.refreshed_lanes``,
``koemorph.serve.lld_rows`` (rows rolled into the LLD rings) and, with
the ``emotion2vec`` backend, ``koemorph.serve.encoder_frames`` (lanes x
encoder frames of the refreshes).

With ``mesh`` (:func:`~koemorph_tpu_torch.parallel.make_mesh`, one process
driving every entry) the lanes split into one contiguous block of ``S/D``
per entry, each served by an engine of its own (its model replica, state
and graphs on that entry's device), the counterpart of the JAX server's
``PartitionSpec(axis)`` on every per-session leaf. Inference has no
collectives: a step copies every entry's block of the hops in, launches
every entry's step, and stitches the outputs in lane order on the first
entry's device. Cohort membership stays ``lane % G``; each block holds
``S/(D*G)`` lanes of every cohort, its local lanes ``c::G`` being cohort
``c``, so a due cohort refreshes on every entry at the same step (JAX's
device-local cohort layout). The one refresh clock lives on the host.
"""

from __future__ import annotations

import functools
import logging
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.models.dual_stream_model import (
    StreamingDualStreamModel)
from koemorph_tpu_torch.runtime.graphs import StepGraphs
from koemorph_tpu_torch.parallel.mesh import Mesh, block_rows, replicate
from koemorph_tpu_torch.runtime.streaming import (STAGES, StaticStream,
                                                  StreamingConfig,
                                                  StreamState,
                                                  TemporalState,
                                                  init_stream_state,
                                                  stream_step_)
from koemorph_tpu_torch.utils import spans

logger = logging.getLogger(__name__)

__all__ = ["MultiStreamInference"]


class MultiStreamInference:
    """Serve ``n_sessions`` independent streaming sessions in one step.

    Typical use::

        server = MultiStreamInference(model, cfg, n_sessions=64)
        server.warmup()
        frames = server.step(hops)     # (64, hop) audio -> (64, 52)

    Every session shares ``model``. Runs on ``cuda`` unless ``device``
    says otherwise; raises when CUDA is asked for and absent. On the card
    each step is a CUDA graph replay; ``graphs=False`` runs it eagerly,
    and the CPU has no graphs (``graphs=True`` there raises
    ``ValueError``). Each returned frame is a fresh tensor that no later
    step writes.

    ``mesh`` serves the lanes over the mesh's entries, one engine each
    (:attr:`entries`); ``n_sessions`` and each cohort must divide over
    them, and ``device`` is the mesh's.
    """

    def __init__(self, model: StreamingDualStreamModel,
                 cfg: StreamingConfig, n_sessions: int,
                 device: DeviceLike = None, refresh_cohorts: int = 1,
                 graphs: Optional[bool] = None,
                 mesh: Optional[Mesh] = None):
        if n_sessions < 1:
            raise ValueError("n_sessions must be >= 1")
        k = cfg.emotion_update_frames
        if not 1 <= refresh_cohorts <= max(k, 1):
            raise ValueError(
                f"refresh_cohorts {refresh_cohorts} must be in [1, "
                f"emotion_update_frames={k}] (distinct phases mod the "
                f"cadence keep at most one cohort refreshing per step)")
        if n_sessions % refresh_cohorts:
            raise ValueError(
                f"n_sessions {n_sessions} must divide into "
                f"{refresh_cohorts} cohorts")
        self.cfg = cfg
        self.n_sessions = n_sessions
        self.refresh_cohorts = refresh_cohorts
        #: each cohort's clock at ``states.frame_count == 0``
        self.phases = tuple((c * k) // refresh_cohorts
                            for c in range(refresh_cohorts))
        self.frames_emitted = 0
        # bounded: a long-running server must not grow host memory one
        # float per frame
        self.step_times: deque[float] = deque(maxlen=300)
        self.mesh = mesh
        #: the engine of each mesh entry (None without a mesh)
        self.entries: Optional[list[MultiStreamInference]] = None
        if mesh is not None:
            self._init_entries(model, mesh, device, graphs)
            return
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.step_graphs = StepGraphs(self.device, graphs,
                                      span="koemorph.serve")
        with torch.inference_mode():
            self._static = StaticStream(
                init_stream_state(cfg, self.device, n_sessions))
        #: LLD rows one refreshing lane rolls into its ring
        self._lld_rows = cfg.lld_block_rows if cfg.use_lld_ring else 0
        #: encoder frames of one refreshing lane (the emotion2vec backend)
        self._encoder_frames = (
            cfg.emotion2vec_config.frames(cfg.emotion_context_samples)
            if cfg.emotion_backend == "emotion2vec" else 0)
        #: the static input buffer of each input dtype in use
        self._inputs: dict[torch.dtype, torch.Tensor] = {}

    def _init_entries(self, model, mesh: Mesh, device: DeviceLike,
                      graphs: Optional[bool]) -> None:
        """One engine per mesh entry, each with its block of the lanes and
        the server's cohorts (their phases are the server's)."""
        if mesh.distributed:
            raise ValueError("one process drives every entry of a serving "
                             "mesh; got a process group's mesh")
        if device is not None:
            raise ValueError("pass the mesh or a device, not both")
        n, g, d = self.n_sessions, self.refresh_cohorts, mesh.size
        axis = mesh.axis_names[0]
        if n % d:
            raise ValueError(
                f"n_sessions {n} must divide over the mesh's {d}-device "
                f"'{axis}' axis")
        if (n // g) % d:
            raise ValueError(
                f"each cohort ({n // g} sessions) must divide over the "
                f"mesh's {d} devices")
        self.entries = [
            MultiStreamInference(m, self.cfg, n // d, device=dev,
                                 refresh_cohorts=g, graphs=graphs)
            for m, dev in zip(replicate(model.eval(), mesh), mesh.devices)]
        self.device = self.entries[0].device
        self.model = self.entries[0].model
        #: the one refresh clock of the entries (frames stepped)
        self._frames = 0

    @property
    def num_devices(self) -> int:
        """Mesh entries the lanes are served on (1 without a mesh)."""
        return 1 if self.entries is None else len(self.entries)

    @property
    def frame_count(self) -> int:
        """Frames stepped since the start (the refresh clock)."""
        if self.entries is None:
            return self._static.state.frame_count
        return self._frames

    @property
    def states(self) -> StreamState:
        """The current lane-batched state (static buffers, ``frame_count``
        on the host). With a mesh: the entries' states stitched in lane
        order on the first entry's device, a copy."""
        if self.entries is None:
            return self._static.state
        return _cat_states([e.states for e in self.entries], self.device,
                           self._frames)

    @property
    def clocks(self) -> list[int]:
        """Each cohort's refresh clock (frames since its phase 0)."""
        return [p + self.frame_count for p in self.phases]

    def due_cohorts(self) -> list[int]:
        """The cohorts that refresh in the next step."""
        k = self.cfg.emotion_update_frames
        return [c for c, clock in enumerate(self.clocks) if clock % k == 0]

    def _input(self, dtype: torch.dtype) -> torch.Tensor:
        buf = self._inputs.get(dtype)
        if buf is None:
            buf = torch.zeros((self.n_sessions, self.cfg.hop_length),
                              dtype=dtype, device=self.device)
            self._inputs[dtype] = buf
        return buf

    def _body(self, state: StreamState, out: tuple, dtype: torch.dtype,
              due: Sequence[int]) -> torch.Tensor:
        """One frame of every lane from the static input of ``dtype``
        (float32, or int16 PCM converted on the device: x * 2^-15 is
        exact, the same bits as x / 32768.0 on the host); the cohorts in
        ``due`` refresh on their lanes' views ``[c::G]``."""
        with spans.track("serve", self.device, STAGES):
            hops = self._inputs[dtype]
            if dtype == torch.int16:
                hops = hops.to(torch.float32) * (2.0 ** -15)
            spans.mark("ingest")
            g = self.refresh_cohorts
            return stream_step_(self.model, state, out, hops, self.cfg,
                                [slice(c, None, g) for c in due])

    def _put_hops(self, hops) -> torch.Tensor:
        if not isinstance(hops, torch.Tensor):
            hops = np.asarray(hops)
            if hops.dtype != np.int16:
                hops = np.asarray(hops, np.float32)
            hops = torch.from_numpy(np.ascontiguousarray(hops))
        elif hops.dtype not in (torch.int16, torch.float32):
            hops = hops.to(torch.float32)
        if tuple(hops.shape) != (self.n_sessions, self.cfg.hop_length):
            raise ValueError(
                f"expected ({self.n_sessions}, {self.cfg.hop_length}) "
                f"audio, got {tuple(hops.shape)}")
        return self._input(hops.dtype).copy_(hops)

    def _step(self, hops) -> torch.Tensor:
        if self.entries is not None:
            return self._mesh_step(hops)
        with spans.host("koemorph.serve.h2d"):
            dtype = self._put_hops(hops).dtype
        return self._run(dtype, tuple(self.due_cohorts()))

    def _mesh_step(self, hops) -> torch.Tensor:
        """Every entry's block of ``hops`` copied in first, then every
        entry's step launched, then the outputs stitched in lane order."""
        if not isinstance(hops, torch.Tensor):
            hops = np.asarray(hops)
            if hops.dtype != np.int16:
                hops = np.asarray(hops, np.float32)
            hops = torch.from_numpy(np.ascontiguousarray(hops))
        if tuple(hops.shape) != (self.n_sessions, self.cfg.hop_length):
            raise ValueError(
                f"expected ({self.n_sessions}, {self.cfg.hop_length}) "
                f"audio, got {tuple(hops.shape)}")
        d = len(self.entries)
        with spans.host("koemorph.serve.h2d"):
            dtypes = [
                e._put_hops(hops[block_rows(self.n_sessions, d, i)]).dtype
                for i, e in enumerate(self.entries)]
        due = tuple(self.due_cohorts())
        outs = [e._run(dt, due) for e, dt in zip(self.entries, dtypes)]
        self._frames += 1
        return torch.cat([o.to(self.device, non_blocking=True)
                          for o in outs])

    def _run(self, dtype: torch.dtype, due: tuple) -> torch.Tensor:
        """The step of the loaded input of ``dtype`` with the cohorts in
        ``due`` refreshing."""
        key = (due, self._static.parity, dtype)
        graphs = self.step_graphs
        if graphs.enabled and key not in graphs:
            if ((), 0, dtype) not in graphs:
                logger.info("capturing the server's CUDA graphs for %s "
                            "input at first use", dtype)
                self.warmup(dtype)
            if key not in graphs:        # a due set the phases never give
                logger.info("capturing the server's CUDA graph of %s", key)
                self._capture(key)
        out = graphs.run(key, functools.partial(
            self._body, *self._static.buffers(key[1]), dtype, due))
        self._static.advance()
        if due:
            lanes = len(due) * (self.n_sessions // self.refresh_cohorts)
            spans.count("koemorph.serve.refreshed_lanes", lanes)
            spans.count("koemorph.serve.lld_rows", lanes * self._lld_rows)
            if self._encoder_frames:
                spans.count("koemorph.serve.encoder_frames",
                            lanes * self._encoder_frames)
        return out

    def _capture(self, key, warm: bool = True) -> None:
        due, parity, dtype = key
        self.step_graphs.capture(
            key, functools.partial(self._body,
                                   *self._static.buffers(parity), dtype, due),
            functools.partial(self._body, *self._static.scratch(), dtype,
                              due) if warm else None)

    # -- serving -----------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, dtype=torch.float32) -> None:
        """Capture the step's graphs for input ``dtype`` (``int16`` for
        raw PCM), for every due set and buffer parity (on the card); or
        run each due set's step once (eagerly). The warm-up runs write a
        scratch copy of the state, so kernel builds and first-call costs
        land before the real-time loop and the state stays as it was."""
        if self.entries is not None:
            for e in self.entries:
                e.warmup(dtype)
            return
        self._input(dtype)
        g = self.refresh_cohorts
        for due in [()] + [(c,) for c in range(g)]:
            if not self.step_graphs.enabled:
                self._body(*self._static.scratch(), dtype, due)
                continue
            for parity in (0, 1):
                self._capture((due, parity, dtype), warm=parity == 0)

    @torch.inference_mode()
    def step(self, hops) -> torch.Tensor:
        """One frame for every session: ``(S, hop)`` audio -> ``(S, 52)``.

        Takes float32 in [-1, 1] or raw int16 PCM (converted on the
        device), as a numpy array or a tensor on any device. Returns the
        device tensor without waiting for it."""
        t0 = time.perf_counter()
        with spans.host("koemorph.serve.step"):
            out = self._step(hops)
        self.step_times.append(time.perf_counter() - t0)
        spans.count("koemorph.serve.steps")
        self.frames_emitted += self.n_sessions
        return out

    @torch.inference_mode()
    def reset_sessions(self, indices: Sequence[int]) -> None:
        """Re-admit the given lanes as fresh sessions (silence rings,
        unsmoothed first frame), written into the state's buffers in
        place. The refresh clocks keep running: a new session's first
        refresh lands on its cohort's next phase boundary."""
        idx = sorted(set(int(i) for i in indices))
        if not idx:
            return
        if idx[0] < 0 or idx[-1] >= self.n_sessions:
            raise ValueError(f"session index out of range: {idx}")
        if self.entries is not None:
            per = self.n_sessions // len(self.entries)
            for i, e in enumerate(self.entries):
                e.reset_sessions([j - i * per for j in idx
                                  if j // per == i])
            return
        self._static.write_fresh(init_stream_state(self.cfg, self.device, 1),
                                 torch.tensor(idx, device=self.device))

    # -- measurement ---------------------------------------------------------

    @torch.inference_mode()
    def run_scan(self, audio) -> torch.Tensor:
        """Decode ``(S, T*hop)`` audio as T batched steps (the audio is
        uploaded once and sliced on the device). Returns ``(T, S, 52)``;
        updates ``self.states``."""
        hop = self.cfg.hop_length
        if isinstance(audio, torch.Tensor):
            audio = audio.to(self.device, torch.float32)
        else:
            audio = torch.from_numpy(np.ascontiguousarray(
                audio, np.float32)).to(self.device)
        s, total = audio.shape
        if s != self.n_sessions or total % hop:
            raise ValueError(
                f"audio must be ({self.n_sessions}, k*{hop}), got "
                f"{tuple(audio.shape)}")
        frames = [self._step(audio[:, t * hop:(t + 1) * hop])
                  for t in range(total // hop)]
        self.frames_emitted += len(frames) * s
        return torch.stack(frames)

    def sustained_stats(self, n_frames: int = 300,
                        warmup_frames: Optional[int] = None) -> dict:
        """Sustained batched throughput on silence: warm-up scans of
        ``n_frames`` steps (enough to cover ``warmup_frames``), then one
        timed scan, host clock to a device synchronization. Reports the
        per-step latency across all sessions and the real-time headroom.
        """
        hop = self.cfg.hop_length
        silence = torch.zeros((self.n_sessions, n_frames * hop),
                              device=self.device)
        n_warm_scans = max(1, -(-(warmup_frames or n_frames) // n_frames))
        for _ in range(n_warm_scans):
            f = self.run_scan(silence)
        float(f[-1, 0, 0])
        t0 = time.perf_counter()
        f = self.run_scan(silence)
        float(f[-1, 0, 0])                               # device sync
        dt = time.perf_counter() - t0
        per_frame = dt / n_frames
        budget = 1.0 / self.cfg.target_fps
        return {
            "sessions": self.n_sessions,
            "frames": n_frames,
            "scans_run": n_warm_scans + 1,
            "step_ms": per_frame * 1e3,
            "per_session_us": per_frame / self.n_sessions * 1e6,
            "rtf": per_frame / budget,
            "realtime": bool(per_frame < budget),
            "frames_per_s": self.n_sessions / per_frame,
        }

    def performance_stats(self) -> dict:
        """Host time per ``step`` call (the dispatch, not waited for) over
        the last ``step_times.maxlen`` steps."""
        if not self.step_times:
            return {"frames": 0}
        times = np.asarray(self.step_times)
        budget = 1.0 / self.cfg.target_fps
        return {
            "sessions": self.n_sessions,
            "frames": self.frames_emitted,
            "avg_step_ms": float(times.mean() * 1e3),
            "p50_step_ms": float(np.percentile(times, 50) * 1e3),
            "p99_step_ms": float(np.percentile(times, 99) * 1e3),
            "max_step_ms": float(times.max() * 1e3),
            "rtf": float(times.mean() / budget),
        }


def _cat_states(states: list[StreamState], device: torch.device,
                frame_count: int) -> StreamState:
    """The lane-batched states of a mesh's entries as one, in lane order,
    on ``device`` (a copy)."""
    def cat(*parts):
        return torch.cat([p.to(device) for p in parts])

    first = states[0]
    ring = None if first.lld_ring is None else {
        k: cat(*(s.lld_ring[k] for s in states)) for k in first.lld_ring}
    carry = None if first.lld_carry is None else type(first.lld_carry)(*(
        None if f is None else cat(*(s.lld_carry[i] for s in states))
        for i, f in enumerate(first.lld_carry)))
    return StreamState(
        audio_ring=cat(*(s.audio_ring for s in states)),
        mel_db=cat(*(s.mel_db for s in states)),
        emotion_raw=cat(*(s.emotion_raw for s in states)),
        frame_count=frame_count,
        temporal=TemporalState(
            prev=cat(*(s.temporal.prev for s in states)),
            initialized=cat(*(s.temporal.initialized for s in states))),
        lld_ring=ring, lld_carry=carry)
