"""PyTorch port: the multi-session server CLI (``koemorph_tpu_torch.serve``)
and its UDP feeder (``koemorph_tpu_torch.feed_serve``).

The ingest bookkeeping and the Python wire contract are held against
``scripts/serve.py`` (loaded as a module, as tests/cli/test_serve.py does)
on the same datagrams and rows; the replay and listen loops run end to
end on the CPU at d_model 32.
"""

import importlib.util
import json
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from koemorph_tpu_torch import feed_serve, serve
from koemorph_tpu_torch.data.wav import write_wav

REPO = Path(__file__).resolve().parents[1]
SR, HOP = 16000, 533
TINY_ARGS = ["--device", "cpu", "--d-model", "32", "--num-heads", "2"]


@pytest.fixture(scope="module")
def jax_serve():
    spec = importlib.util.spec_from_file_location(
        "serve_cli_reference", REPO / "scripts" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_wavs")
    paths = []
    for k, f0 in enumerate((160.0, 220.0)):
        t = np.arange(int(1.5 * SR)) / SR
        x = (0.4 * np.sin(2 * np.pi * f0 * t)
             * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
        p = d / f"speech{k}.wav"
        write_wav(p, x, SR)
        paths.append(p)
    return paths


def _pcm(values) -> bytes:
    return (np.asarray(values, np.float32) * 32767).astype("<i2").tobytes()


INGEST_CASES = {
    "push_take": (3, 4, 300, [struct.pack("!I", 1)
                              + _pcm([.5, -.5, .25, -.25])]),
    "partial_lane": (1, 4, 300, [struct.pack("!I", 0) + _pcm([.5, .5]), None,
                                 struct.pack("!I", 0) + _pcm([.5, .5])]),
    "bad_datagrams": (2, 4, 300, [b"\x00", struct.pack("!I", 9) + b"\x00\x00",
                                  struct.pack("!I", 0) + b"\x00"]),
    "reset": (2, 2, 300, [struct.pack("!I", 1) + _pcm([.5, .5]),
                          struct.pack("!I", 1)]),
    "backlog": (1, 2, 2, [struct.pack("!I", 0)
                          + _pcm(np.arange(8) / 8)]),
}


@pytest.mark.parametrize("name", list(INGEST_CASES))
def test_session_ingest_matches_reference(jax_serve, name):
    """The same datagrams through both ingests; ``None`` takes a block
    between pushes. Blocks, resets, drops and overflow agree."""
    sessions, hop, max_hops, datagrams = INGEST_CASES[name]
    ours = serve.SessionIngest(sessions, hop, max_buffer_hops=max_hops)
    ref = jax_serve.SessionIngest(sessions, hop, max_buffer_hops=max_hops)
    blocks = []
    for d in datagrams + [None, None]:
        if d is None:
            a, b = ours.take_block(), ref.take_block()
            assert a.dtype == b.dtype == np.int16
            np.testing.assert_array_equal(a, b)
            blocks.append(a)
        else:
            ours.push(d)
            ref.push(d)
        assert ours.take_resets() == ref.take_resets()
    assert ours.dropped_datagrams == ref.dropped_datagrams
    assert ours.overflowed_samples == ref.overflowed_samples
    if name == "bad_datagrams":
        assert ours.dropped_datagrams == 3
    if name == "backlog":
        assert ours.overflowed_samples == 4
    if name == "partial_lane":
        assert not blocks[0].any() and blocks[1].any()


def test_sender_file_rows_match_reference(jax_serve, tmp_path):
    """The Python wire contract: one JSON row per session with a
    ``session`` field; a NaN value is written as ``NaN``, which
    ``json.loads`` reads, as the reference's Python path does."""
    frames = np.linspace(0, 1, 3 * 52, dtype=np.float32).reshape(3, 52)
    frames[1, 7] = np.nan
    paths = {}
    for name, sender in (
            ("port", serve.SessionSender("file", "127.0.0.1", 0, "/bs",
                                         str(tmp_path / "port.jsonl"),
                                         python_emit=True)),
            ("ref", jax_serve.SessionSender("file", "127.0.0.1", 0, "/bs",
                                            str(tmp_path / "ref.jsonl"),
                                            native=False))):
        sender.send(frames, 12.5)
        assert sender.frames_sent == 3 and sender.emit_path == "python"
        sender.close()
        paths[name] = tmp_path / f"{name}.jsonl"
    text = paths["port"].read_text()
    assert text == paths["ref"].read_text()
    rows = [json.loads(line) for line in text.splitlines()]
    assert [r["session"] for r in rows] == [0, 1, 2]
    assert np.isnan(rows[1]["blendshapes"][7])
    none = serve.SessionSender("none", "127.0.0.1", 0, "/bs", None)
    none.send(frames, 0.0)
    assert none.frames_sent == 3
    with pytest.raises(ValueError):
        serve.SessionSender("file", "127.0.0.1", 0, "/bs", None)


def _stats(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if '"performance_stats"' in ln]
    assert lines, stdout[-500:]
    return json.loads(lines[-1])["performance_stats"]


def test_replay_cli(wavs, tmp_path):
    out = tmp_path / "sessions.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.serve", "--replay",
         *map(str, wavs), "--sessions", "3", "--refresh-cohorts", "3",
         "--output", "file", "--output-file", str(out), "--no-realtime",
         "--max-frames", "6", *TINY_ARGS],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 6 * 3
    assert [row["session"] for row in rows] == [0, 1, 2] * 6
    bs = np.asarray([row["blendshapes"] for row in rows])
    assert bs.shape == (18, 52) and bs.min() >= 0.0 and bs.max() <= 1.0
    st = _stats(r.stdout)
    assert st["mode"] == "replay" and st["ticks"] == 6
    assert st["frames_sent"] == 18 and st["emit_path"] == "native"
    assert st["emit_mode"] == "pipelined"
    assert st["step"]["p99_step_ms"] >= st["step"]["p50_step_ms"] > 0


@pytest.mark.parametrize("extra", [["--device-replay"], ["--sync-emit"]])
def test_replay_modes_equal_host_replay(wavs, tmp_path, capsys, extra):
    """Lanes staged on the device and sliced each tick, and the
    synchronous emit, give the pipelined host replay's rows."""
    rows = {}
    for name, flags in (("host", []), ("other", extra)):
        out = tmp_path / f"{name}.jsonl"
        rc = serve.main(["--replay", str(wavs[0]), str(wavs[1]),
                         "--sessions", "2", "--refresh-cohorts", "2",
                         "--output", "file", "--output-file", str(out),
                         "--no-realtime", "--max-frames", "5", *TINY_ARGS,
                         *flags])
        assert rc == 0
        rows[name] = out.read_text().splitlines()
    assert len(rows["host"]) == 10
    strip = [[{k: v for k, v in json.loads(r).items() if k != "timestamp"}
              for r in rows[n]] for n in ("host", "other")]
    assert strip[0] == strip[1]
    st = _stats(capsys.readouterr().out)
    assert st["emit_mode"] == ("sync" if "--sync-emit" in extra
                               else "pipelined")


def test_cli_rejects_unported_options(wavs):
    # --emotion-backend takes JAX's choices (egemaps, basic; basic serves,
    # tests/test_torch_native_emit.py); anything else is refused
    with pytest.raises(SystemExit):
        serve.main(["--replay", str(wavs[0]), "--emotion-backend",
                    "emotion2vec", *TINY_ARGS])
    # a checkpoint loads now; a path that holds none fails before serving
    with pytest.raises(FileNotFoundError):
        serve.main(["--replay", str(wavs[0]), "--model", "ckpt",
                    *TINY_ARGS])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])          # neither mode


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_listen_loopback():
    """2 sessions, 8 ticks: the test feeds session 1 while the server
    ticks; session 0 underruns and is served silence."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(60.0)                  # the first frame waits for warmup
    in_port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "koemorph_tpu_torch.serve", "--listen",
         "--listen-port", str(in_port), "--sessions", "2", "--output", "udp",
         "--port", str(rx.getsockname()[1]), "--max-frames", "8",
         *TINY_ARGS],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rows = []
    try:
        pcm = (np.random.default_rng(0).standard_normal(HOP * 10)
               * 0.1 * 32767).astype("<i2").tobytes()
        deadline = time.time() + 60
        while len(rows) < 16 and time.time() < deadline:
            tx.sendto(struct.pack("!I", 1) + pcm, ("127.0.0.1", in_port))
            try:
                data, _ = rx.recvfrom(65536)
            except socket.timeout:
                break
            rows.append(json.loads(data))
        out, err = proc.communicate(timeout=60)
    finally:
        tx.close()
        rx.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert len(rows) == 16, f"{len(rows)} frames received"
    assert sorted(r["session"] for r in rows) == [0] * 8 + [1] * 8
    bs = {s: np.asarray([r["blendshapes"] for r in rows if r["session"] == s])
          for s in (0, 1)}
    assert all(b.shape == (8, 52) for b in bs.values())
    assert np.abs(bs[1] - bs[0]).max() > 0     # session 1's audio arrived
    st = _stats(out)
    assert st["mode"] == "listen" and st["ticks"] == 8
    assert st["dropped_datagrams"] == 0


def test_feeder_datagrams(wavs):
    """``feed_serve`` sends one datagram per session per tick: the session
    id from ``--first-session`` on, then one hop of the lane's int16 PCM."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as rx:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(10.0)
        rc = feed_serve.main(["--port", str(rx.getsockname()[1]),
                              "--sessions", "2", "--first-session", "3",
                              "--ticks", "3", str(wavs[0]), str(wavs[1])])
        assert rc == 0
        got = [rx.recvfrom(65536)[0] for _ in range(6)]
    from koemorph_tpu_torch.data.wav import read_wav
    for t in range(3):
        for s in range(2):
            d = got[2 * t + s]
            assert struct.unpack("!I", d[:4])[0] == 3 + s
            audio, _ = read_wav(wavs[s], mono=True)
            want = np.clip(audio[t * HOP:(t + 1) * HOP] * 32767.0, -32768,
                           32767).astype("<i2")
            np.testing.assert_array_equal(np.frombuffer(d[4:], "<i2"), want)
