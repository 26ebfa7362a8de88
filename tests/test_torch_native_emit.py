"""PyTorch port: the native batch emitter (``koemorph_tpu_torch/native/
emit.cpp``, built with g++ at first use) against the ``json.dumps`` wire
contract, and the ``rt`` / ``serve`` CLIs with ``--emotion-backend
basic``.

The contract (the JAX package's ``tests/data/test_native.py``): the same
fields, values within 5e-10 of the Python path's (up to 4e9, the fixed-point
formatter's range; larger values take ``%.9g``), float32 bit-exact for
``|v| >= 2**-6``, the timestamp within 1e-6, every session delivered. On
top of the JAX package's emitter: a non-finite value is written as
``NaN`` / ``Infinity`` / ``-Infinity`` (``json.loads`` reads the row, as
it reads the Python path's), and a timestamp whose header exceeds the row
budget raises instead of writing past the buffer.
"""

import json
import select
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from koemorph_tpu_torch import serve
from koemorph_tpu_torch.data import native
from koemorph_tpu_torch.data.wav import write_wav

REPO = Path(__file__).resolve().parents[1]
SR = 16000
TINY_ARGS = ["--device", "cpu", "--d-model", "32", "--num-heads", "2"]


def _python_rows(frames, ts):
    """The rows of the ``json.dumps`` path, parsed back."""
    return [json.loads(json.dumps({
        "timestamp": ts, "session": i,
        "blendshapes": np.asarray(row, np.float32).tolist()}))
        for i, row in enumerate(frames)]


def _assert_contract(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"timestamp", "session", "blendshapes"}
        assert g["session"] == w["session"]
        assert abs(g["timestamp"] - w["timestamp"]) <= 1e-6
        gv = np.asarray(g["blendshapes"], np.float64)
        wv = np.asarray(w["blendshapes"], np.float64)
        fin = np.isfinite(wv)
        assert np.array_equal(np.isnan(gv), np.isnan(wv))
        assert np.array_equal(gv[~fin & ~np.isnan(wv)],
                              wv[~fin & ~np.isnan(wv)])
        fixed = fin & (np.abs(wv) <= 4e9)     # the fixed-point range
        assert np.abs(gv[fixed] - wv[fixed]).max(initial=0) <= 5e-10
        big = fin & (np.abs(wv) >= 2.0 ** -6)
        assert (gv[big].astype(np.float32) == wv[big].astype(np.float32)
                ).all()


@pytest.mark.parametrize("sessions", [1, 17, 256])
def test_format_jsonl_meets_contract(sessions):
    rng = np.random.default_rng(sessions)
    frames = rng.uniform(0, 1, (sessions, 52)).astype(np.float32)
    ts = 1760000000.123456
    payload = native.format_frames_jsonl_native(frames, ts)
    assert payload.endswith(b"\n")
    got = [json.loads(line) for line in payload.decode().splitlines()]
    _assert_contract(got, _python_rows(frames, ts))


def test_edge_and_nonfinite_values():
    frames = np.array([[0.0, 1.0, 0.5, 1e-6, 0.9999999, -0.25, 3.25e8,
                        0.03125, 4.5e9, -7e12, np.nan, np.inf, -np.inf,
                        np.float32(2.0 ** -6), -0.0]], np.float32)
    line = native.format_frames_jsonl_native(frames, 0.0).decode()
    assert "NaN, Infinity, -Infinity" in line
    assert "nan" not in line and "inf" not in line
    _assert_contract([json.loads(line)], _python_rows(frames, 0.0))
    # a non-finite timestamp is written as json.dumps writes it
    row = json.loads(native.format_frames_jsonl_native(frames[:, :3],
                                                       float("nan")))
    assert np.isnan(row["timestamp"])


@pytest.mark.parametrize("ts", [1e30, -1e26, 1e300])
def test_huge_timestamp_raises_without_overrun(ts):
    frames = np.full((3, 52), 0.5, np.float32)
    with pytest.raises(ValueError, match="row budget"):
        native.format_frames_jsonl_native(frames, ts)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as send:
        with pytest.raises(ValueError, match="does not fit"):
            native.emit_frames_udp_native(frames, ts, send.fileno(),
                                          "127.0.0.1", 9)
    # the emitter is intact afterwards
    ok = native.format_frames_jsonl_native(frames, 1e20)
    assert len(ok.decode().splitlines()) == 3


def test_emit_udp_delivers_every_session():
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 1, (70, 52)).astype(np.float32)   # 2 batches
    frames[5, 3] = np.nan
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
    recv.bind(("127.0.0.1", 0))
    port = recv.getsockname()[1]
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert native.emit_frames_udp_native(
            frames, 7.5, send.fileno(), "127.0.0.1", port) == 70
        rows = []
        while len(rows) < 70 and select.select([recv], [], [], 2.0)[0]:
            rows.append(json.loads(recv.recvfrom(65536)[0]))
        rows.sort(key=lambda r: r["session"])
        _assert_contract(rows, _python_rows(frames, 7.5))
        with pytest.raises(ValueError, match="dotted-quad"):
            native.emit_frames_udp_native(frames, 0.0, send.fileno(),
                                          "localhost", port)
    finally:
        recv.close()
        send.close()


def test_library_is_built_once_under_build(tmp_path):
    lib = native.emit_lib()
    assert native.emit_lib() is lib
    path = native._lib_path()
    assert path.exists() and path.parent.name == "koemorph_tpu_torch"
    assert path.parent.parent.name == "build"
    with pytest.raises(ValueError):
        native.format_frames_jsonl_native(np.zeros(52, np.float32), 0.0)


@pytest.mark.parametrize("mode", ["file", "udp"])
def test_sender_native_path_meets_contract(tmp_path, mode):
    frames = np.random.default_rng(4).uniform(0, 1, (5, 52)).astype(
        np.float32)
    recv = None
    port = 0
    if mode == "udp":
        recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        recv.bind(("127.0.0.1", 0))
        port = recv.getsockname()[1]
    rows = {}
    try:
        for path in ("native", "python"):
            out = tmp_path / f"{path}.jsonl"
            sender = serve.SessionSender(mode, "127.0.0.1", port, "/bs",
                                         str(out) if mode == "file"
                                         else None,
                                         python_emit=path == "python")
            assert sender.emit_path == path
            sender.send(frames, 3.25)
            assert sender.frames_sent == 5
            sender.close()
            if mode == "file":
                rows[path] = [json.loads(x)
                              for x in out.read_text().splitlines()]
            else:
                got = []
                while len(got) < 5 and select.select([recv], [], [],
                                                     2.0)[0]:
                    got.append(json.loads(recv.recvfrom(65536)[0]))
                rows[path] = sorted(got, key=lambda r: r["session"])
    finally:
        if recv is not None:
            recv.close()
    _assert_contract(rows["native"], rows["python"])
    assert serve.SessionSender("osc", "127.0.0.1", 0, "/bs",
                               None).emit_path == "python"


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    t = np.arange(int(1.2 * SR)) / SR
    x = (0.4 * np.sin(2 * np.pi * 180.0 * t)
         * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    path = tmp_path_factory.mktemp("emit_wav") / "a.wav"
    write_wav(path, x, SR)
    return path


def test_serve_cli_basic_backend(wav, tmp_path):
    out = tmp_path / "rows.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.serve", "--replay",
         str(wav), "--sessions", "3", "--refresh-cohorts", "3",
         "--emotion-backend", "basic", "--output", "file", "--output-file",
         str(out), "--no-realtime", "--max-frames", "7", *TINY_ARGS],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [row["session"] for row in rows] == [0, 1, 2] * 7
    bs = np.asarray([row["blendshapes"] for row in rows])
    assert bs.shape == (21, 52) and np.isfinite(bs).all()
    stats = [json.loads(ln)["performance_stats"] for ln in
             r.stdout.splitlines() if "performance_stats" in ln]
    assert stats[-1]["emit_path"] == "native"
    assert stats[-1]["frames_sent"] == 21


def test_rt_cli_basic_backend(wav, tmp_path):
    out = tmp_path / "frames.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "koemorph_tpu_torch.rt", "--input", str(wav),
         "--emotion-backend", "basic", "--output", "file", "--output-file",
         str(out), "--no-realtime", "--max-frames", "12", *TINY_ARGS],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    bs = np.asarray([row["blendshapes"] for row in rows])
    assert bs.shape == (12, 52) and np.isfinite(bs).all()
    assert bs.min() >= 0 and bs.max() <= 1
