"""The native batch emitter (``koemorph_tpu_torch/native/emit.cpp``):
the multi-session server's ``(sessions, coeffs)`` frame batch as one JSON
row per session, sent as UDP datagrams or formatted as JSONL in one call.

The library is built at first use with ``g++ -O2 -shared -fPIC`` into
``build/koemorph_tpu_torch/`` at the repository root, under a name hashed
from its source, and loaded with ``ctypes``. A build failure raises; there
is no fallback to Python here (``serve --python-emit`` selects the
``json.dumps`` path instead).

The rows carry the fields of the ``json.dumps`` path, values within 5e-10
(float32 bit-exact for ``|v| >= 2**-6``), the timestamp within 1e-6, and a
non-finite value as ``NaN`` / ``Infinity`` / ``-Infinity``. A timestamp
whose row header exceeds 80 bytes (beyond ~1e25) raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["emit_lib", "emit_frames_udp_native", "format_frames_jsonl_native",
           "ROW_HEADER_MAX", "VALUE_MAX"]

_SRC = Path(__file__).resolve().parents[1] / "native" / "emit.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
#: bytes of a row's header and of one value with its separator, at most
#: (``KM_HEADER_MAX`` and ``KM_VALUE_MAX`` in the source)
ROW_HEADER_MAX, VALUE_MAX = 80, 34

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _lib_path() -> Path:
    h = hashlib.sha1(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return (Path(__file__).resolve().parents[2] / "build"
            / "koemorph_tpu_torch" / f"emit_{h.hexdigest()[:12]}.so")


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native emitter is built "
                           "from source at first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name}:\n{proc.stderr}")
    os.replace(tmp, path)


def emit_lib() -> ctypes.CDLL:
    """The emitter library, built at the first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            fp = ctypes.POINTER(ctypes.c_float)
            lib.km_emit_frames_udp.restype = ctypes.c_int64
            lib.km_emit_frames_udp.argtypes = [
                fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
            lib.km_format_frames_jsonl.restype = ctypes.c_int64
            lib.km_format_frames_jsonl.argtypes = [
                fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                ctypes.c_char_p, ctypes.c_int64]
            _LIB = lib
        return _LIB


def _frames_c(frames) -> np.ndarray:
    f = np.ascontiguousarray(frames, np.float32)
    if f.ndim != 2:
        raise ValueError(f"frames must be (sessions, coeffs), got {f.shape}")
    return f


def emit_frames_udp_native(frames, timestamp: float, sockfd: int, ip: str,
                           port: int) -> int:
    """Send one JSON datagram per session row of ``frames`` through an
    existing unconnected UDP socket fd to ``ip`` (a dotted quad) and
    ``port``. Returns the datagrams the kernel took (a full socket buffer
    drops the rest, as a ``sendto`` loop would). Raises ``ValueError`` for
    a bad address or a row that does not fit its 2 KB buffer."""
    f = _frames_c(frames)
    sent = emit_lib().km_emit_frames_udp(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), f.shape[0],
        f.shape[1], float(timestamp), int(sockfd), ip.encode("ascii"),
        int(port))
    if sent == -1:
        raise ValueError(f"not a dotted-quad IPv4 address: {ip!r}")
    if sent < 0:
        raise ValueError(f"a row of {f.shape[1]} values at timestamp "
                         f"{timestamp!r} does not fit its datagram buffer")
    return int(sent)


def format_frames_jsonl_native(frames, timestamp: float) -> bytes:
    """The ``(sessions, coeffs)`` frame batch as JSONL, one row per
    session. Raises ``ValueError`` when a row does not fit its budget (a
    timestamp whose header exceeds ``ROW_HEADER_MAX`` bytes)."""
    f = _frames_c(frames)
    cap = f.shape[0] * (ROW_HEADER_MAX + VALUE_MAX * f.shape[1] + 3)
    out = ctypes.create_string_buffer(cap)
    n = emit_lib().km_format_frames_jsonl(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), f.shape[0],
        f.shape[1], float(timestamp), out, cap)
    if n < 0:
        raise ValueError(f"a row at timestamp {timestamp!r} exceeds the "
                         "row budget")
    return out.raw[:n]
