"""Hand-written Hopper kernels: lazy ``nvcc`` build, ``ctypes`` binding,
launch wrappers and launch counts.

Each ``*.cu`` file beside this module is compiled on first use into its own
shared library with a plain C entry point (``nvcc -gencode
arch=compute_90a,code=sm_90a -shared``), under ``build/koemorph_tpu_torch/``
at the repository root, named by a hash of the source and flags so an
edited source rebuilds. Nothing here runs ``nvcc`` or touches CUDA when it
is imported. :func:`build` compiles several sources at once, one ``nvcc``
process each, all started together.

A wrapper launches on PyTorch's current stream, allocates its output with
``torch.empty``, checks the launch's error code and raises on failure. It
adds one to ``LAUNCHES[name]`` (and to ``SHAPE_LAUNCHES[(name, shape)]``)
for every launch and nowhere else. The callers in :mod:`..f0`,
:mod:`..egemaps` and :mod:`..frontend` route CUDA tensors here and CPU tensors to the plain
PyTorch form; there is no fallback from one to the other.

Under a CUDA graph the counts are those of the capture: a wrapper runs in
Python, and counts, when its launch is recorded into a graph (and when a
warm-up before the capture launches it eagerly), but a replay runs the
recorded launches without any wrapper and counts nothing.
:func:`capturing` gives the launches one capture recorded; the kernels
each replay ran come from the profiler's kernel names.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from koemorph_tpu_torch.ops.device_cache import device_cache

__all__ = ["SOURCES", "LAUNCHES", "SHAPE_LAUNCHES", "build", "build_dir",
           "reset_launch_counts", "capturing", "FrameLayout",
           "frame_layout", "cycle_dsum", "dk_roots", "logmel"]

_HERE = Path(__file__).resolve().parent

#: kernel name -> (source file, extra nvcc flags)
SOURCES: dict[str, tuple[str, tuple[str, ...]]] = {
    "cycle_dsum": ("cycle_dsum.cu", ()),
    "dk_roots": ("dk_roots.cu", ()),
    "logmel": ("logmel.cu", ()),
}
_COMMON_FLAGS = ("-O3", "-std=c++17", "-gencode",
                 "arch=compute_90a,code=sm_90a", "-shared",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}
SHAPE_LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) per
#: kernel built by this process
BUILD_LOGS: dict[str, str] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPE_LAUNCHES.clear()


@contextlib.contextmanager
def capturing():
    """Yields a ``Counter`` that, when the block ends, holds the launches
    the wrappers made inside it by ``(name, shape)``: around a CUDA graph's
    capture, the launches the graph recorded, which each replay runs."""
    before = collections.Counter(SHAPE_LAUNCHES)
    made: collections.Counter = collections.Counter()
    try:
        yield made
    finally:
        made.update(SHAPE_LAUNCHES)
        made.subtract(before)
        for key in [k for k, n in made.items() if n <= 0]:
            del made[key]


def build_dir() -> Path:
    return _HERE.parents[2] / "build" / "koemorph_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source with the CUDA toolkit's nvcc")


def _lib_path(name: str) -> Path:
    src, flags = SOURCES[name]
    h = hashlib.sha1((_HERE / src).read_bytes())
    h.update(" ".join(_COMMON_FLAGS + flags).encode())
    return build_dir() / f"{name}_{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all at once. Raises on any failure."""
    names = list(SOURCES) if names is None else list(names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            continue
        src, flags = SOURCES[name]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_COMMON_FLAGS, *flags, "-o", str(tmp),
               str(_HERE / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _lib_path(name) for name in names}


#: kernel name -> {C entry point: (pointer arguments, int arguments)}; every
#: entry point takes the stream last and returns a cudaError_t
_ENTRIES = {
    "cycle_dsum": {"km_cycle_dsum": (5, 7)},
    "dk_roots": {"km_dk_roots": (3, 3)},
    "logmel": {"km_logmel_batch": (5, 7), "km_logmel_rows": (7, 7)},
}


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            for entry, (n_ptr, n_int) in _ENTRIES[name].items():
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * n_ptr \
                    + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            _LIBS[name] = lib
        return lib


def _check(t: torch.Tensor, what: str, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def _launched(name: str, shape: tuple, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
    SHAPE_LAUNCHES[(name, shape)] += 1


class FrameLayout(NamedTuple):
    """Where the frames of a ``(..., T, n)`` view lie in its storage, in
    elements: frame ``t`` of batch ``b`` starts at ``offset + b *
    batch_stride + t * frame_stride``."""

    offset: int
    batch_stride: int
    frame_stride: int
    frames: int        # T, frames per batch
    batches: int       # the leading dims, merged


def frame_layout(frames: torch.Tensor) -> FrameLayout:
    """The layout ``cycle_dsum`` and ``logmel`` read ``frames`` in place
    by. Raises ``ValueError`` where the samples of a frame are not adjacent
    (last stride not 1) or the leading dims do not merge into one batch
    dim; the frames are never copied."""
    if frames.dim() < 2:
        raise ValueError(f"need (..., T, n) frames, got "
                         f"{tuple(frames.shape)}")
    n, t = frames.shape[-1], frames.shape[-2]
    if n > 1 and frames.stride(-1) != 1:
        raise ValueError(f"frames: the last stride must be 1, got "
                         f"strides {frames.stride()}")
    lead = [(size, stride) for size, stride in
            zip(frames.shape[:-2], frames.stride()[:-2]) if size != 1]
    for (_, outer), (size, inner) in zip(lead, lead[1:]):
        if outer != inner * size:
            raise ValueError(f"frames: leading dims {tuple(frames.shape)} "
                             f"with strides {frames.stride()} do not merge "
                             "into one batch dim")
    return FrameLayout(
        offset=frames.storage_offset(),
        batch_stride=lead[-1][1] if lead else 0,
        frame_stride=frames.stride(-2) if t > 1 else n,
        frames=t, batches=math.prod(frames.shape[:-2]))


def _check_strides(name: str, frames: torch.Tensor, lay: FrameLayout
                   ) -> None:
    """The kernels take strides as 32-bit ints and reach a frame by
    64-bit arithmetic; the last frame's offset must fit in 32 bits too."""
    if (max(lay.batch_stride, lay.frame_stride,
            (lay.batches - 1) * lay.batch_stride) >= 2 ** 31):
        raise ValueError(f"{name}: strides {frames.stride()} of frames "
                         f"{tuple(frames.shape)} exceed the kernel's "
                         "32-bit strides")


#: the half_lag values ``cycle_dsum.cu`` is compiled for
CYCLE_DSUM_HALF_LAGS = (8, 16)


def cycle_dsum(frames: torch.Tensor, start: torch.Tensor, tau: torch.Tensor,
               off: torch.Tensor, *, n_cycles: int, half_lag: int
               ) -> torch.Tensor:
    """Kernel form of :func:`koemorph_tpu_torch.ops.f0.cycle_dsum_plain`:
    ``(..., T, n)`` frames with ``(..., T)`` start, tau and off ->
    ``(..., T, n_cycles, 2*half_lag+1)`` float32. The frames are read in
    place by their :func:`frame_layout` (an ``unfold`` view is not
    copied); ``half_lag`` is 8 or 16, ``n`` at most 8192, ``n_cycles`` at
    most 32."""
    lay = frame_layout(frames)
    n = frames.shape[-1]
    n_lag = 2 * half_lag + 1
    if (half_lag not in CYCLE_DSUM_HALF_LAGS or not n_lag <= n <= 8192
            or not 1 <= n_cycles <= 32):
        raise ValueError(f"cycle_dsum: unsupported n={n}, "
                         f"n_cycles={n_cycles}, half_lag={half_lag}")
    _check_strides("cycle_dsum", frames, lay)
    if frames.dtype != torch.float32:
        raise ValueError(f"frames: need float32, got {frames.dtype}")
    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"cycle_dsum kernel needs CUDA tensors, got {dev}")
    rows = lay.batches * lay.frames
    # the per-row scalars are tiny: flattened (copied only if strided)
    start, tau, off = (v.reshape(-1).contiguous() for v in (start, tau, off))
    if not start.numel() == tau.numel() == off.numel() == rows:
        raise ValueError(f"cycle_dsum: need {rows} start, tau and off "
                         f"values, got {start.numel()}, {tau.numel()}, "
                         f"{off.numel()}")
    _check(start, "start", torch.int32, dev)
    _check(tau, "tau", torch.float32, dev)
    _check(off, "off", torch.float32, dev)
    out = torch.empty(frames.shape[:-1] + (n_cycles, n_lag),
                      dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    fn = _lib("cycle_dsum").km_cycle_dsum
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(frames.data_ptr(), start.data_ptr(), tau.data_ptr(),
                 off.data_ptr(), out.data_ptr(), lay.batches, lay.frames,
                 lay.batch_stride, lay.frame_stride, n, n_cycles, half_lag,
                 stream)
    _launched("cycle_dsum", (rows, n_cycles, n_lag, n), err)
    return out


@functools.lru_cache(maxsize=8)
def dk_start_np(p: int) -> np.ndarray:
    """Durand-Kerner start table, (p,) complex64: distinct non-symmetric
    points on the 0.9 circle."""
    k = np.arange(p)
    return (0.9 * np.exp(2j * np.pi * (k + 0.35) / p)).astype(np.complex64)


@device_cache(16)
def _dk_start_pairs(p: int, device: torch.device) -> torch.Tensor:
    pairs = dk_start_np(p).view(np.float32).reshape(p, 2).copy()
    return torch.from_numpy(pairs).to(device)


def dk_roots(a: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Kernel form of :func:`koemorph_tpu_torch.ops.egemaps.poly_roots_plain`:
    (..., p+1) coefficients -> (..., p) complex64 roots; p must be 10."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"dk_roots kernel needs CUDA tensors, got {dev}")
    p = a.shape[-1] - 1
    if p != 10:
        raise ValueError(f"dk_roots kernel is compiled for p=10, got p={p}")
    batch = a.shape[:-1]
    flat = a.reshape(-1, p + 1)
    _check(flat, "a", torch.float32, dev)
    rows = flat.shape[0]
    fn = _lib("dk_roots").km_dk_roots
    z0 = _dk_start_pairs(p, dev)
    out = torch.empty((rows, p, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(flat.data_ptr(), z0.data_ptr(), out.data_ptr(), rows, p,
                 iters, stream)
    _launched("dk_roots", (rows,), err)
    return torch.view_as_complex(out).reshape(batch + (p,))


#: frames up to which ``logmel`` takes its single-frame path
LOGMEL_SMALL_T = 8


def logmel(frames: torch.Tensor, *, sample_rate: int = 16000,
           n_mels: int = 80, f_min: float = 80.0, f_max: float = 8000.0
           ) -> torch.Tensor:
    """Kernel form of
    :func:`koemorph_tpu_torch.ops.frontend.frames_to_logmel_plain`:
    ``(..., T, n_fft)`` un-windowed frames -> ``(..., T, n_mels)`` float32
    dB. The frames are read in place by their :func:`frame_layout` (a view
    into audio rings or an ``unfold`` is not copied; a frame may start at
    any 4-byte address); ``n_fft`` must be a multiple of 32, at most
    1024; ``n_mels`` at most 256."""
    from koemorph_tpu_torch.ops.frontend import logmel_kernel_constants

    lay = frame_layout(frames)
    n_fft = frames.shape[-1]
    if n_fft % 32 or not 32 <= n_fft <= 1024 or not 1 <= n_mels <= 256:
        raise ValueError(f"logmel kernel: unsupported n_fft={n_fft}, "
                         f"n_mels={n_mels}")
    _check_strides("logmel", frames, lay)
    if frames.dtype != torch.float32:
        raise ValueError(f"frames: need float32, got {frames.dtype}")
    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"logmel kernel needs CUDA tensors, got {dev}")
    t = lay.batches * lay.frames
    out = torch.empty(frames.shape[:-1] + (n_mels,), dtype=torch.float32,
                      device=dev)
    if t == 0:
        return out
    c = logmel_kernel_constants(n_fft, sample_rate, n_mels, f_min, f_max,
                                dev)
    lib = _lib("logmel")
    geometry = (lay.frames, lay.batch_stride, lay.frame_stride)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if t <= LOGMEL_SMALL_T:
            power = torch.empty((t, c.hi - c.lo), dtype=torch.float32,
                                device=dev)
            err = lib.km_logmel_rows(
                frames.data_ptr(), c.wc.data_ptr(), c.ws.data_ptr(),
                c.fb_nz.data_ptr(), c.spans.data_ptr(), power.data_ptr(),
                out.data_ptr(), t, n_fft, c.hi - c.lo, n_mels, *geometry,
                stream)
        else:
            partial = torch.empty((c.groups, t, n_mels), dtype=torch.float32,
                                  device=dev)
            err = lib.km_logmel_batch(
                frames.data_ptr(), c.bases.data_ptr(), c.fb.data_ptr(),
                partial.data_ptr(), out.data_ptr(), t, n_fft, c.groups,
                n_mels, *geometry, stream)
    _launched("logmel", (t,), err)
    return out
