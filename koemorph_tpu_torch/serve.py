"""Multi-session streaming server: N concurrent avatars on one GPU.

Fronts :class:`koemorph_tpu_torch.runtime.MultiStreamInference` (all
sessions in one batched step) with two ingest modes:

replay
    Feed WAV files (tiled across the session lanes) through the batched
    step, paced at the target fps or as fast as possible
    (``--no-realtime``).

listen
    One UDP socket ingests interleaved audio datagrams from any number
    of clients: ``!I`` session id (0..sessions-1) followed by int16
    little-endian mono PCM at the configured sample rate. Sessions that
    underrun a tick receive silence. An EMPTY payload for a session id
    re-admits that lane as a fresh session
    (``MultiStreamInference.reset_sessions``).

Output fan-out (``--output``):
    udp   one socket, one JSON datagram per session per frame with a
          ``session`` field (consumers demux on it)
    osc   per-session OSC address ``<base>/<session>``
    file  one JSONL stream with a ``session`` field per row
    none  discard (capacity testing)

``udp`` and ``file`` rows come from the native batch emitter (built with
``g++`` at start-up); ``--python-emit`` writes them with ``json.dumps``
instead. The stats line names the path as ``emit_path``.

Usage:
    python -m koemorph_tpu_torch.serve --replay a.wav b.wav --sessions 4 \\
        --output file --output-file frames.jsonl --no-realtime
    python -m koemorph_tpu_torch.serve --listen --listen-port 9100 \\
        --sessions 16 --output udp --port 9200

Runs on the GPU (``--device cuda``, the default) and fails when there is
none; ``--device cpu`` runs the same step on the CPU. ``--mesh-devices N``
serves the sessions over N mesh entries from this one process (one engine
per entry; the stats line's ``devices``). ``--model`` loads a
checkpoint the trainer wrote (``<work>/checkpoints/last``) or a ``.pth``
state dict; without it the weights are random, drawn from ``--seed``.
``--spans`` switches the span registry on before the graphs are captured
(:mod:`koemorph_tpu_torch.utils.spans`); the stats line at exit then adds
``spans``, and every ``--stats-every`` line is followed by a ``spans``
line: the median device ms of each stage of the step (read from the
stamp ring at each such line), the median host ms of
``koemorph.serve.launch`` and the serve counters.
"""

from __future__ import annotations

import argparse
import json
import logging
import socket
import struct
import sys
import time

import numpy as np
import torch

from koemorph_tpu_torch.utils import spans

logger = logging.getLogger("serve")

_HEADER = struct.Struct("!I")


class SessionIngest:
    """Assembles per-session sample queues from interleaved datagrams.

    Host-side bookkeeping only: feed datagrams with :meth:`push`, then
    :meth:`take_block` returns the next (sessions, hop) int16 block,
    zero-filling lanes that underran. Session ids outside [0, sessions)
    and malformed datagrams are counted and dropped, never raised: one
    bad client must not stop the server.
    """

    def __init__(self, sessions: int, hop: int,
                 max_buffer_hops: int = 300):
        self.sessions = sessions
        self.hop = hop
        # each lane's backlog is bounded (~10 s at 30 fps) so one fast
        # client cannot grow host memory without limit; overflow drops the
        # OLDEST samples (the stream stays current, like a real-time mic)
        self.max_samples = max_buffer_hops * hop
        # raw int16 PCM: the server converts on the device
        self.queues: list[np.ndarray] = [
            np.zeros(0, np.int16) for _ in range(sessions)]
        self.resets: set[int] = set()
        self.dropped_datagrams = 0
        self.overflowed_samples = 0

    def push(self, datagram: bytes) -> None:
        if len(datagram) < _HEADER.size:
            self.dropped_datagrams += 1
            return
        (sid,) = _HEADER.unpack_from(datagram)
        if sid >= self.sessions:
            self.dropped_datagrams += 1
            return
        payload = datagram[_HEADER.size:]
        if not payload:                       # empty payload = lane reset
            self.resets.add(sid)
            self.queues[sid] = np.zeros(0, np.int16)
            return
        if len(payload) % 2:
            self.dropped_datagrams += 1
            return
        pcm = np.frombuffer(payload, "<i2")
        q = np.concatenate([self.queues[sid], pcm])
        if q.size > self.max_samples:
            self.overflowed_samples += q.size - self.max_samples
            q = q[-self.max_samples:]
        self.queues[sid] = q

    def take_resets(self) -> list[int]:
        out = sorted(self.resets)
        self.resets.clear()
        return out

    def take_block(self) -> np.ndarray:
        """Next (sessions, hop) int16 block; lanes with fewer than hop
        samples queued are zero-filled (silence) without consuming their
        partial data."""
        block = np.zeros((self.sessions, self.hop), np.int16)
        for i, q in enumerate(self.queues):
            if q.size >= self.hop:
                block[i] = q[: self.hop]
                self.queues[i] = q[self.hop:]
        return block


class SessionSender:
    """Per-session output fan-out: UDP JSON with a ``session`` field, a
    per-session OSC address, or one JSONL file with a ``session`` field.

    ``udp`` and ``file`` rows go through the native batch emitter
    (:mod:`koemorph_tpu_torch.data.native`, the whole frame batch in one
    call; it is built here, and a build failure raises) unless
    ``python_emit``; then, and for ``osc``, each row goes through
    ``json.dumps``, the wire contract. Both write a non-finite value as
    ``NaN`` / ``Infinity``, which ``json.loads`` reads. ``emit_path`` says
    which path the rows take."""

    def __init__(self, mode: str, host: str, port: int,
                 osc_address: str, output_file: str | None,
                 python_emit: bool = False):
        self.mode = mode
        self.host = host
        self.port = port
        self.osc_address = osc_address
        self.frames_sent = 0
        self._sock = None
        self._fh = None
        if mode in ("udp", "osc"):
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        elif mode == "file":
            if not output_file:
                raise ValueError("output_file required for file mode")
            self._fh = open(output_file, "w")
        elif mode != "none":
            raise ValueError(f"unknown output mode: {mode}")
        self.emit_path = "python"
        if mode in ("udp", "file") and not python_emit:
            from koemorph_tpu_torch.data.native import emit_lib
            emit_lib()
            self.emit_path = "native"
            if mode == "udp":
                self._ip = socket.gethostbyname(host)

    def send(self, frames: np.ndarray, timestamp: float) -> None:
        """``frames`` is (sessions, 52)."""
        if self.mode == "none":
            self.frames_sent += len(frames)
            return
        if self.mode == "osc":
            from koemorph_tpu_torch.runtime.streamers import \
                encode_osc_message
            for i, row in enumerate(frames):
                self._sock.sendto(
                    encode_osc_message(f"{self.osc_address}/{i}",
                                       np.asarray(row).tolist()),
                    (self.host, self.port))
                self.frames_sent += 1
            return
        if self.emit_path == "native":
            from koemorph_tpu_torch.data import native
            if self.mode == "udp":
                self.frames_sent += native.emit_frames_udp_native(
                    frames, timestamp, self._sock.fileno(), self._ip,
                    self.port)
            else:
                self._fh.write(native.format_frames_jsonl_native(
                    frames, timestamp).decode("ascii"))
                self._fh.flush()
                self.frames_sent += len(frames)
            return
        for i, row in enumerate(frames):
            payload = json.dumps({
                "timestamp": timestamp,
                "session": i,
                "blendshapes": np.asarray(row, np.float32).tolist(),
            })
            if self.mode == "udp":
                self._sock.sendto(payload.encode("utf-8"),
                                  (self.host, self.port))
            else:
                self._fh.write(payload + "\n")
            self.frames_sent += 1
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
        if self._fh is not None:
            self._fh.close()


class _HostFrames:
    """Two host buffers for the pipelined emit. Tick t's output is copied
    into buffer ``t % 2`` (pinned memory, a non-blocking copy and an event
    on a GPU) while tick t-1's buffer is emitted, so a buffer is written
    again only after its frames were sent."""

    def __init__(self, shape: tuple, device: torch.device):
        pinned = device.type == "cuda"
        self._bufs = [torch.empty(shape, pin_memory=pinned)
                      for _ in range(2)]
        self._events = [torch.cuda.Event() if pinned else None
                        for _ in range(2)]
        self._next = 0

    def start(self, frames: torch.Tensor) -> int:
        """Start copying ``frames`` to the host; returns its slot."""
        slot, self._next = self._next, self._next ^ 1
        self._bufs[slot].copy_(frames, non_blocking=True)
        if self._events[slot] is not None:
            self._events[slot].record()
        return slot

    def wait(self, slot: int) -> np.ndarray:
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        return self._bufs[slot].numpy()


def build_server(args):
    from koemorph_tpu_torch.runtime import MultiStreamInference
    from koemorph_tpu_torch.runtime.engine import build_streaming_model

    model, cfg = build_streaming_model(
        d_model=args.d_model, num_heads=args.num_heads, fps=args.fps,
        emotion_backend=args.emotion_backend, sample_rate=args.sample_rate,
        checkpoint=args.model, device=args.device, seed=args.seed)
    mesh = mesh_for(args.device, args.mesh_devices)
    return MultiStreamInference(model, cfg, n_sessions=args.sessions,
                                device=None if mesh else args.device,
                                mesh=mesh,
                                refresh_cohorts=args.refresh_cohorts)


def mesh_for(device: str, n: int):
    """The serving mesh of ``--mesh-devices n``: None for 0 (one device);
    the first ``n`` visible cards for ``--device cuda``; ``n`` entries of
    the one device ``--device`` names otherwise (``cpu``, ``cuda:0``)."""
    if not n:
        return None
    from koemorph_tpu_torch.device import resolve_device
    from koemorph_tpu_torch.parallel import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(num_devices=n)
    return make_mesh(devices=[dev] * n)


def _load_replay_lanes(paths: list[str], sessions: int, sample_rate: int,
                       hop: int) -> np.ndarray:
    """WAV files tiled across lanes -> (sessions, k*hop) float32."""
    from koemorph_tpu_torch.data.wav import read_wav

    cache: dict[str, np.ndarray] = {}
    lanes = []
    for i in range(sessions):
        path = str(paths[i % len(paths)])
        a = cache.get(path)
        if a is None:
            audio, sr = read_wav(path, mono=True)
            if sr != sample_rate:
                raise ValueError(
                    f"{path}: sample rate {sr} != {sample_rate} "
                    f"(resample offline)")
            a = np.asarray(audio, np.float32).reshape(-1)
            cache[path] = a
        lanes.append(a)
    n = max(a.size for a in lanes)
    n = ((n + hop - 1) // hop) * hop
    block = np.zeros((sessions, n), np.float32)
    for i, a in enumerate(lanes):
        block[i, : a.size] = a
    return block


def _emit_stats(server, sender, *, mode: str, ticks: int, elapsed: float,
                work_s: list[float], late: int, ingest=None,
                pipelined: bool = True) -> None:
    """One JSON line of live-loop serving stats on stdout: the sustained
    tick rate through the whole ingest -> step -> emit loop, the per-tick
    host work, late ticks, and drop and overflow counts."""
    w = np.asarray(work_s) if work_s else np.zeros(1)
    stats = {
        "mode": mode,
        "ticks": ticks,
        "sustained_fps": round(ticks / elapsed, 2) if elapsed > 0 else 0.0,
        "target_fps": server.cfg.target_fps,
        "work_p50_ms": round(float(np.percentile(w, 50)) * 1e3, 3),
        "work_p99_ms": round(float(np.percentile(w, 99)) * 1e3, 3),
        "work_max_ms": round(float(w.max()) * 1e3, 3),
        "late_ticks": late,
        "late_frac": round(late / max(ticks, 1), 4),
        "frames_sent": sender.frames_sent,
        "emit_path": sender.emit_path,
        "emit_mode": "pipelined" if pipelined else "sync",
        "devices": server.num_devices,
        "step": {k: round(v, 3) if isinstance(v, float) else v
                 for k, v in server.performance_stats().items()},
    }
    if ingest is not None:
        stats["dropped_datagrams"] = ingest.dropped_datagrams
        stats["overflowed_samples"] = ingest.overflowed_samples
    if spans.enabled():
        stats["spans"] = span_stats()
    print(json.dumps({"performance_stats": stats}), flush=True)


def _log_spans() -> None:
    """With ``--spans``, the periodic stats line's span figures."""
    if spans.enabled():
        logger.info("spans %s", json.dumps(span_stats()))


def span_stats() -> dict:
    """The stats line's ``spans``: the median device ms of each stage of
    the serve step, the median host ms of ``koemorph.serve.launch`` (over
    the last 300 of each) and the serve counters."""
    got = spans.summary()
    launch = got["host_ms"].get("koemorph.serve.launch")
    return {"stage_ms": {k: round(v, 4) for k, v in
                         got["stage_ms"].get("serve", {}).items()},
            "launch_ms": None if launch is None else round(launch, 4),
            "counters": {k: v for k, v in got["counters"].items()
                         if k.startswith("koemorph.serve.")}}


@torch.inference_mode()
def serve_replay(server, sender, args) -> int:
    hop = server.cfg.hop_length
    lanes = _load_replay_lanes(args.replay, args.sessions,
                               args.sample_rate, hop)
    n_frames = lanes.shape[1] // hop
    if args.max_frames is not None:
        n_frames = min(n_frames, args.max_frames)
    budget = hop / args.sample_rate
    logger.info("replay: %d sessions x %d frames", args.sessions, n_frames)
    server.warmup()
    # --device-replay stages the whole (S, T*hop) lane block on the device
    # and hands the step a view of each tick's hop: no per-tick upload
    lanes_dev = (torch.from_numpy(lanes).to(server.device)
                 if args.device_replay else None)
    # pipelined emit (default): tick t's output starts its copy to the
    # host while tick t-1's frames are emitted, at the price of one frame
    # of output latency; --sync-emit waits for and emits each tick's own
    pipeline = not args.sync_emit
    host = _HostFrames((args.sessions, server.cfg.num_blendshapes),
                       server.device)
    work_s: list[float] = []
    late = 0
    pending = None                       # (host slot, wall timestamp)
    next_tick = time.perf_counter()
    t_start = time.perf_counter()
    for t in range(n_frames):
        if not args.no_realtime:
            now = time.perf_counter()
            if now < next_tick:
                time.sleep(next_tick - now)
            # resync after a stall: a deadline more than one budget behind
            # would mark every later tick late and skip every later sleep
            next_tick = max(next_tick + budget, now)
        w0 = time.perf_counter()
        if lanes_dev is not None:
            out = server.step(lanes_dev[:, t * hop: (t + 1) * hop])
        else:
            out = server.step(lanes[:, t * hop: (t + 1) * hop])
        if pipeline:
            slot = host.start(out)
            if pending is not None:
                sender.send(host.wait(pending[0]), pending[1])
            pending = (slot, time.time())
        else:
            sender.send(out.cpu().numpy(), time.time())
        work_s.append(time.perf_counter() - w0)
        if not args.no_realtime and time.perf_counter() > next_tick:
            late += 1                    # tick finished past its deadline
        if args.stats_every and (t + 1) % args.stats_every == 0:
            ms = 1e3 * float(np.mean(server.step_times or [0.0]))
            logger.info("frame %d/%d  step %.2f ms (%d sessions)",
                        t + 1, n_frames, ms, args.sessions)
            _log_spans()
    if pending is not None:              # flush the last pipelined frame
        sender.send(host.wait(pending[0]), pending[1])
    elapsed = time.perf_counter() - t_start
    logger.info("done: %d frames sent", sender.frames_sent)
    _emit_stats(server, sender, mode="replay", ticks=n_frames,
                elapsed=elapsed, work_s=work_s, late=late,
                pipelined=pipeline)
    return 0


@torch.inference_mode()
def serve_listen(server, sender, args) -> int:
    hop = server.cfg.hop_length
    budget = hop / args.sample_rate
    ingest = SessionIngest(args.sessions, hop)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind((args.listen_host, args.listen_port))
    logger.info("listening on udp://%s:%d for %d sessions (hop %d)",
                args.listen_host, args.listen_port, args.sessions, hop)
    server.warmup(dtype=torch.int16)     # the loop feeds raw PCM blocks
    # a first reset outside the loop (all lanes are fresh: no change), so
    # a client's first reset datagram pays no first-call cost in a tick
    server.reset_sessions([0])
    logger.info("serving: warmup complete, loop is live")
    pipeline = not args.sync_emit        # see serve_replay
    host = _HostFrames((args.sessions, server.cfg.num_blendshapes),
                       server.device)
    sent = 0
    work_s: list[float] = []
    late = 0
    pending = None
    t_start = time.perf_counter()
    next_tick = time.perf_counter() + budget
    try:
        while args.max_frames is None or sent < args.max_frames:
            # take everything already queued even when the previous tick
            # overran its budget, so sustained overload gives late frames
            # rather than starved ingest
            sock.settimeout(0.0)
            while True:
                try:
                    datagram, _addr = sock.recvfrom(65536)
                except (BlockingIOError, socket.timeout):
                    break
                ingest.push(datagram)
            # then wait for datagrams until the tick's deadline
            while True:
                remain = next_tick - time.perf_counter()
                if remain <= 0:
                    break
                sock.settimeout(remain)
                try:
                    datagram, _addr = sock.recvfrom(65536)
                except socket.timeout:
                    break
                ingest.push(datagram)
            # resync after overload: a deadline behind the wall clock would
            # make every later tick skip its wait
            behind = time.perf_counter() > next_tick + budget
            next_tick = max(next_tick + budget, time.perf_counter())
            resets = ingest.take_resets()
            if resets:
                server.reset_sessions(resets)
                logger.info("reset sessions %s", resets)
            w0 = time.perf_counter()
            out = server.step(ingest.take_block())
            if pipeline:
                slot = host.start(out)
                if pending is not None:
                    sender.send(host.wait(pending[0]), pending[1])
                pending = (slot, time.time())
            else:
                sender.send(out.cpu().numpy(), time.time())
            work_s.append(time.perf_counter() - w0)
            if behind:
                late += 1
            sent += 1
            if args.stats_every and sent % args.stats_every == 0:
                ms = 1e3 * float(np.mean(server.step_times or [0.0]))
                logger.info(
                    "tick %d  step %.2f ms (%d sessions)  dropped=%d "
                    "overflowed=%d", sent, ms, args.sessions,
                    ingest.dropped_datagrams, ingest.overflowed_samples)
                _log_spans()
    except KeyboardInterrupt:
        logger.info("interrupted")
    finally:
        sock.close()
    if pending is not None:              # flush the last pipelined frame
        sender.send(host.wait(pending[0]), pending[1])
    logger.info("done: %d ticks, %d frames sent, %d dropped datagrams",
                sent, sender.frames_sent, ingest.dropped_datagrams)
    _emit_stats(server, sender, mode="listen", ticks=sent,
                elapsed=time.perf_counter() - t_start, work_s=work_s,
                pipelined=pipeline, late=late, ingest=ingest)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--sessions", type=int, default=4)
    p.add_argument("--replay", nargs="+",
                   help="WAV files tiled across session lanes")
    p.add_argument("--listen", action="store_true",
                   help="ingest UDP audio datagrams (see above)")
    p.add_argument("--listen-host", default="127.0.0.1")
    p.add_argument("--listen-port", type=int, default=9100)
    p.add_argument("--model", help="checkpoint directory (with state.pth) "
                   "or .pth state dict; default: random weights")
    p.add_argument("--output", default="file",
                   choices=["udp", "osc", "file", "none"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9200)
    p.add_argument("--osc-address", default="/blendshapes")
    p.add_argument("--output-file", default="sessions.jsonl")
    p.add_argument("--fps", type=int, default=30, choices=[30, 60])
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--emotion-backend", default="egemaps",
                   choices=["egemaps", "basic"])
    p.add_argument("--refresh-cohorts", type=int, default=1,
                   help="stagger the emotion refresh over this many "
                        "session cohorts (1..emotion_update_frames)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="stop after this many ticks")
    p.add_argument("--no-realtime", action="store_true",
                   help="replay mode: as fast as possible")
    p.add_argument("--device-replay", action="store_true",
                   help="replay mode: stage the whole lane block on the "
                        "device and slice each tick's hop there")
    p.add_argument("--stats-every", type=int, default=0)
    p.add_argument("--sync-emit", action="store_true",
                   help="copy and emit each tick's frames before the next "
                        "tick; the default pipelined emit overlaps tick "
                        "t's copy to the host with tick t-1's emit, at one "
                        "frame of output latency")
    p.add_argument("--python-emit", action="store_true",
                   help="emit udp / file rows through json.dumps, one per "
                        "session, instead of the native batch emitter")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default), cuda:K or cpu")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="serve the sessions over this many mesh entries, "
                        "one engine each, all driven by this process (0: "
                        "one device; sessions and each cohort must divide "
                        "over them; no collectives): the first N visible "
                        "cards with --device cuda, N entries of the named "
                        "device with --device cpu or cuda:K")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--spans", action="store_true",
                   help="switch the span registry on: the stats line adds "
                        "the median device ms of each stage of the step, "
                        "the launch's host ms and the serve counters")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if bool(args.replay) == bool(args.listen):
        p.error("exactly one of --replay or --listen is required")

    if args.spans:
        spans.enable()                 # before any graph is captured
    server = build_server(args)
    sender = SessionSender(args.output, args.host, args.port,
                           args.osc_address,
                           args.output_file if args.output == "file"
                           else None, python_emit=args.python_emit)
    try:
        if args.replay:
            return serve_replay(server, sender, args)
        return serve_listen(server, sender, args)
    finally:
        sender.close()


if __name__ == "__main__":
    sys.exit(main())
