"""UDP feeder for the multi-session server: replay WAV lanes into
``python -m koemorph_tpu_torch.serve --listen`` at the real-time cadence.

One process stands in for N independent capture clients: every tick it
sends one int16 PCM datagram per session (``!I`` session id + one hop of
little-endian samples, the listen protocol of
:mod:`koemorph_tpu_torch.serve`), paced at the target fps. The sessions
fed are ``--first-session`` .. ``--first-session + --sessions - 1``.

Usage (feed 64 lanes for 500 ticks):

    python -m koemorph_tpu_torch.serve --listen --listen-port 9100 \\
        --sessions 64 &
    # wait for the server's "loop is live" log line, then:
    python -m koemorph_tpu_torch.feed_serve --port 9100 --sessions 64 \\
        --ticks 500 a.wav b.wav
"""

from __future__ import annotations

import argparse
import socket
import struct
import time

import numpy as np

_HEADER = struct.Struct("!I")


def main(argv=None) -> int:
    from koemorph_tpu_torch.data.wav import read_wav

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("wavs", nargs="+", help="WAV files tiled across lanes")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--first-session", type=int, default=0,
                    help="session id of the first lane fed")
    ap.add_argument("--ticks", type=int, default=None,
                    help="stop after this many ticks (default: shortest "
                         "lane)")
    ap.add_argument("--fps", type=int, default=30, choices=(30, 60))
    ap.add_argument("--sample-rate", type=int, default=16000)
    args = ap.parse_args(argv)

    hop = args.sample_rate // args.fps
    lanes = []
    for i in range(args.sessions):
        path = args.wavs[i % len(args.wavs)]
        audio, sr = read_wav(path, mono=True)
        if sr != args.sample_rate:
            raise SystemExit(f"{path}: sample rate {sr} != "
                             f"{args.sample_rate}")
        lanes.append(np.clip(np.asarray(audio) * 32767.0,
                             -32768, 32767).astype("<i2"))
    n = min(lane.size // hop for lane in lanes)
    if args.ticks is not None:
        n = min(n, args.ticks)

    budget = hop / args.sample_rate
    late = 0
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        next_tick = time.perf_counter()
        t0 = time.perf_counter()
        for t in range(n):
            now = time.perf_counter()
            if now < next_tick:
                time.sleep(next_tick - now)
            next_tick = max(next_tick + budget, now)
            for s in range(args.sessions):
                sock.sendto(
                    _HEADER.pack(args.first_session + s)
                    + lanes[s][t * hop:(t + 1) * hop].tobytes(),
                    (args.host, args.port))
            if time.perf_counter() > next_tick:
                late += 1
        elapsed = time.perf_counter() - t0
    print(f"fed {n} ticks x {args.sessions} lanes in {elapsed:.1f}s "
          f"({n / max(elapsed, 1e-9):.1f} ticks/s, {late} late)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
