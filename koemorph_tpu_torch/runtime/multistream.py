"""Multi-session streaming: ``n_sessions`` independent 30 fps sessions in
one batched step on one GPU.

Every field of the stream's state gains a leading lane dim (the audio
rings are one ``(S, ring_len)`` tensor, the LLD rings ``(S, rows, ...)``),
so one step runs the per-frame work of all sessions as ``(S, ...)``-sized
kernels: the new mel row of every lane is one launch of the fused
frontend over a view of the rings, the attention one batch of S windows.
Each lane's window is normalized to its own max.

The emotion refresh clock stays on the host. With ``refresh_cohorts=G``
the lanes split into G cohorts, lane ``l`` in cohort ``l % G``, and cohort
``c``'s clock starts at phase ``c*K//G`` of the K-frame refresh cadence,
so at most one cohort refreshes in a step (G = 1: every lane refreshes
together every K frames). The refresh runs once per due cohort on its
lanes' views ``[c::G]`` of the rings (read in place) and writes the
cohort's results back into the lane-batched state in place. A lane is
exactly a dedicated :class:`~koemorph_tpu_torch.runtime.streaming.
StreamingInference` whose clock started at its cohort's phase, up to the
summation order of batched products.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.models.dual_stream_model import (
    StreamingDualStreamModel, TemporalState)
from koemorph_tpu_torch.ops.egemaps import LldCarry
from koemorph_tpu_torch.runtime.streaming import (StreamingConfig,
                                                  StreamState,
                                                  _stream_post, _stream_pre,
                                                  _stream_refresh,
                                                  init_stream_state)

__all__ = ["MultiStreamInference"]


def _map_carry(fn, carry: LldCarry) -> LldCarry:
    return LldCarry(*(None if f is None else fn(f) for f in carry))


def _clone_state(st: StreamState) -> StreamState:
    return StreamState(
        audio_ring=st.audio_ring.clone(), mel_db=st.mel_db.clone(),
        emotion_raw=st.emotion_raw.clone(), frame_count=st.frame_count,
        temporal=TemporalState(prev=st.temporal.prev.clone(),
                               initialized=st.temporal.initialized.clone()),
        lld_ring={k: v.clone() for k, v in st.lld_ring.items()},
        lld_carry=_map_carry(torch.clone, st.lld_carry))


class MultiStreamInference:
    """Serve ``n_sessions`` independent streaming sessions in one step.

    Typical use::

        server = MultiStreamInference(model, cfg, n_sessions=64)
        server.warmup()
        frames = server.step(hops)     # (64, hop) audio -> (64, 52)

    Every session shares ``model``. Runs on ``cuda`` unless ``device``
    says otherwise; raises when CUDA is asked for and absent.
    """

    def __init__(self, model: StreamingDualStreamModel,
                 cfg: StreamingConfig, n_sessions: int,
                 device: DeviceLike = None, refresh_cohorts: int = 1):
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
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        #: each cohort's clock at ``states.frame_count == 0``
        self.phases = tuple((c * k) // refresh_cohorts
                            for c in range(refresh_cohorts))
        with torch.inference_mode():
            self.states = init_stream_state(cfg, self.device, n_sessions)
        self.frames_emitted = 0
        # bounded: a long-running server must not grow host memory one
        # float per frame
        self.step_times: deque[float] = deque(maxlen=300)

    @property
    def clocks(self) -> list[int]:
        """Each cohort's refresh clock (frames since its phase 0)."""
        return [p + self.states.frame_count for p in self.phases]

    def due_cohorts(self) -> list[int]:
        """The cohorts that refresh in the next step."""
        k = self.cfg.emotion_update_frames
        return [c for c, clock in enumerate(self.clocks) if clock % k == 0]

    def _advance(self, st: StreamState, hops: torch.Tensor,
                 due: Sequence[int]) -> tuple[torch.Tensor, StreamState]:
        """One frame of every lane: ``(S, hop)`` float32 or int16 audio on
        the device -> ``((S, 52), new state)``; the cohorts in ``due``
        refresh. The refresh fields of ``st`` (``emotion_raw``,
        ``lld_ring``, ``lld_carry``) are updated in place and carried
        into the new state; every other field is a new tensor, so the
        returned blendshapes (also the new EMA carry) are never written
        again."""
        cfg, g = self.cfg, self.refresh_cohorts
        if hops.dtype == torch.int16:
            # int16 PCM converts on the device: x * 2^-15 is exact, the
            # same bits as x / 32768.0 on the host
            hops = hops.to(torch.float32) * (2.0 ** -15)
        ring, mel_db, mel, detail = _stream_pre(st, hops, cfg)
        for c in due:
            lanes = slice(c, None, g)
            cohort = dataclasses.replace(
                st, emotion_raw=st.emotion_raw[lanes],
                lld_ring={k: v[lanes] for k, v in st.lld_ring.items()},
                lld_carry=_map_carry(lambda f: f[lanes], st.lld_carry))
            feats, lld_ring, carry = _stream_refresh(cohort, ring[lanes], cfg,
                                                     True)
            st.emotion_raw[lanes] = feats
            for k, v in lld_ring.items():
                st.lld_ring[k][lanes] = v
            for dst, src in zip(st.lld_carry, carry):
                if dst is not None:
                    dst[lanes] = src
        out, temporal = _stream_post(self.model, mel, detail, st.emotion_raw,
                                     st.temporal)
        return out, StreamState(
            audio_ring=ring, mel_db=mel_db, emotion_raw=st.emotion_raw,
            frame_count=st.frame_count + 1, temporal=temporal,
            lld_ring=st.lld_ring, lld_carry=st.lld_carry)

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
        return hops.to(self.device)

    # -- serving -----------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, dtype=torch.float32) -> None:
        """Run one step in which every cohort refreshes, on a copy of the
        states, and discard it, so kernel builds and first-call costs land
        before the real-time loop. ``dtype`` is the input's (``int16`` for
        raw PCM)."""
        hops = torch.zeros((self.n_sessions, self.cfg.hop_length),
                           dtype=dtype, device=self.device)
        out, _ = self._advance(_clone_state(self.states), hops,
                               range(self.refresh_cohorts))
        out.cpu()

    @torch.inference_mode()
    def step(self, hops) -> torch.Tensor:
        """One frame for every session: ``(S, hop)`` audio -> ``(S, 52)``.

        Takes float32 in [-1, 1] or raw int16 PCM (converted on the
        device), as a numpy array or a tensor on any device. Returns the
        device tensor without waiting for it."""
        hops = self._put_hops(hops)
        t0 = time.perf_counter()
        out, self.states = self._advance(self.states, hops,
                                         self.due_cohorts())
        self.step_times.append(time.perf_counter() - t0)
        self.frames_emitted += self.n_sessions
        return out

    @torch.inference_mode()
    def reset_sessions(self, indices: Sequence[int]) -> None:
        """Re-admit the given lanes as fresh sessions (silence rings,
        unsmoothed first frame). The refresh clocks keep running: a new
        session's first refresh lands on its cohort's next phase
        boundary."""
        idx = sorted(set(int(i) for i in indices))
        if not idx:
            return
        if idx[0] < 0 or idx[-1] >= self.n_sessions:
            raise ValueError(f"session index out of range: {idx}")
        lanes = torch.tensor(idx, device=self.device)
        st = self.states
        fresh = init_stream_state(self.cfg, self.device, 1)
        for dst, src in ((st.audio_ring, fresh.audio_ring),
                         (st.mel_db, fresh.mel_db),
                         (st.emotion_raw, fresh.emotion_raw),
                         *((st.lld_ring[k], fresh.lld_ring[k])
                           for k in st.lld_ring),
                         *((d, s) for d, s in zip(st.lld_carry,
                                                  fresh.lld_carry)
                           if d is not None)):
            dst[lanes] = src
        # the EMA carry is the last step's output tensor: new tensors, so
        # an output still being read is not written
        zero = torch.zeros((), device=self.device)
        self.states = dataclasses.replace(st, temporal=TemporalState(
            prev=st.temporal.prev.index_fill(0, lanes, zero),
            initialized=st.temporal.initialized.index_fill(0, lanes, False)))

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
        frames = []
        for t in range(total // hop):
            out, self.states = self._advance(
                self.states, audio[:, t * hop:(t + 1) * hop],
                self.due_cohorts())
            frames.append(out)
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
