"""The port's native host libraries, built from ``koemorph_tpu_torch/
native/`` at first use with ``g++ -O2 -shared -fPIC`` into
``build/koemorph_tpu_torch/`` at the repository root, under a name hashed
from the source, and loaded with ``ctypes``. A build failure raises.

- ``emit.cpp``, the multi-session server's batch emitter: the
  ``(sessions, coeffs)`` frame batch as one JSON row per session, sent as
  UDP datagrams or formatted as JSONL in one call. There is no fallback
  to Python here (``serve --python-emit`` selects the ``json.dumps`` path
  instead). The rows carry the fields of the ``json.dumps`` path, values
  within 5e-10 (float32 bit-exact for ``|v| >= 2**-6``), the timestamp
  within 1e-6, and a non-finite value as ``NaN`` / ``Infinity`` /
  ``-Infinity``. A timestamp whose row header exceeds 80 bytes (beyond
  ~1e25) raises ``ValueError``.
- ``host.cpp``, the corpus parsers: WAV decode and blendshape JSONL.
  They return ``None`` on a file or line they decline; the Python readers
  (:func:`koemorph_tpu_torch.data.wav.read_wav`,
  :meth:`koemorph_tpu_torch.data.io.ARKitDataLoader._load_blendshapes`)
  then run their strict loops, which own the error semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["emit_lib", "emit_frames_udp_native", "format_frames_jsonl_native",
           "host_lib", "decode_wav_native", "parse_blendshape_jsonl_native",
           "ROW_HEADER_MAX", "VALUE_MAX"]

_NATIVE = Path(__file__).resolve().parents[1] / "native"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
#: bytes of a row's header and of one value with its separator, at most
#: (``KM_HEADER_MAX`` and ``KM_VALUE_MAX`` in the source)
ROW_HEADER_MAX, VALUE_MAX = 80, 34

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _lib_path(src: Path = _NATIVE / "emit.cpp") -> Path:
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return (Path(__file__).resolve().parents[2] / "build"
            / "koemorph_tpu_torch" / f"{src.stem}_{h.hexdigest()[:12]}.so")


def _build(src: Path, path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native library {src.name} "
                           "is built from source at first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, path)


def _load(name: str, bind) -> ctypes.CDLL:
    """``native/<name>.cpp`` as a loaded library, built at the first call
    and given its signatures by ``bind``."""
    with _LOCK:
        if name not in _LIBS:
            src = _NATIVE / f"{name}.cpp"
            path = _lib_path(src)
            if not path.exists():
                _build(src, path)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def _bind_emit(lib: ctypes.CDLL) -> None:
    fp = ctypes.POINTER(ctypes.c_float)
    lib.km_emit_frames_udp.restype = ctypes.c_int64
    lib.km_emit_frames_udp.argtypes = [
        fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
    lib.km_format_frames_jsonl.restype = ctypes.c_int64
    lib.km_format_frames_jsonl.argtypes = [
        fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_char_p, ctypes.c_int64]


def emit_lib() -> ctypes.CDLL:
    """The emitter library, built at the first call."""
    return _load("emit", _bind_emit)


class _KmWavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("audio_format", ctypes.c_int32),
        ("n_frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
        ("data_size", ctypes.c_int64),
    ]


def _bind_host(lib: ctypes.CDLL) -> None:
    lib.km_wav_info.restype = ctypes.c_int64
    lib.km_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_KmWavInfo)]
    lib.km_wav_decode.restype = ctypes.c_int64
    lib.km_wav_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_KmWavInfo),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
    lib.km_parse_blendshape_jsonl.restype = ctypes.c_int64
    lib.km_parse_blendshape_jsonl.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32]
    lib.km_count_lines.restype = ctypes.c_int64
    lib.km_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_int64]


def host_lib() -> ctypes.CDLL:
    """The corpus parsers' library, built at the first call."""
    return _load("host", _bind_host)


def decode_wav_native(raw: bytes, *, mono: bool = False
                      ) -> Optional[tuple[np.ndarray, int]]:
    """WAV bytes -> ``(float32 audio, sample_rate)``: ``(L,)`` for one
    channel or with ``mono`` (the channels' float32 average), else ``(L,
    C)``. ``None`` for a file it declines (8-bit PCM, a malformed header)."""
    lib = host_lib()
    info = _KmWavInfo()
    if lib.km_wav_info(raw, len(raw), ctypes.byref(info)) != 0:
        return None
    frames, ch = info.n_frames, info.channels
    mix = 1 if (mono and ch > 1) else 0
    out = np.empty(frames if mix else frames * ch, np.float32)
    got = lib.km_wav_decode(
        raw, len(raw), ctypes.byref(info),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), mix)
    if got != frames:
        return None
    if not mix and ch > 1:
        out = out.reshape(frames, ch)
    return out, int(info.sample_rate)


def parse_blendshape_jsonl_native(
        raw: bytes, n_coeffs: int = 52
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """JSONL bytes -> ``(blendshapes (T, n_coeffs) float32, timestamps (T,)
    float64)``; ``None`` when a line is irregular or there is none."""
    lib = host_lib()
    n_lines = lib.km_count_lines(raw, len(raw))
    if n_lines <= 0:
        return None
    ts = np.empty(n_lines, np.float64)
    bs = np.empty((n_lines, n_coeffs), np.float32)
    got = lib.km_parse_blendshape_jsonl(
        raw, len(raw), ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        bs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_lines, n_coeffs)
    if got <= 0:
        return None
    return bs[:got], ts[:got]


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
