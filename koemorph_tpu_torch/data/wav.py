"""WAV decode/encode in pure Python over numpy: PCM 8/16/24/32-bit and
IEEE float32/64, any channel count."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: Union[str, Path], *, mono: bool = False,
             dtype=np.float32) -> tuple[np.ndarray, int]:
    """``(audio, sample_rate)``; audio is ``(L,)`` for mono files (or with
    ``mono=True``) else ``(L, C)``, scaled to [-1, 1]."""
    raw = Path(path).read_bytes()
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = fmt_body = data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos: pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8: pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)     # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError(f"Missing fmt/data chunk in WAV: {path}")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _EXTENSIBLE:
        # the real format tag opens the SubFormat GUID at offset 24
        if len(fmt_body) < 26:
            raise ValueError(
                f"WAVE_FORMAT_EXTENSIBLE with truncated extension: {path}")
        (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        if audio_format not in (_PCM, _IEEE_FLOAT):
            raise ValueError(f"Unsupported EXTENSIBLE SubFormat "
                             f"0x{audio_format:04x}: {path}")

    if audio_format == _PCM and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float64) / 32768.0
    elif audio_format == _PCM and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float64) / 2147483648.0
    elif audio_format == _PCM and bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float64)
        x = x / float(1 << 23)
    elif audio_format == _PCM and bits == 8:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float64)
             - 128.0) / 128.0
    elif audio_format == _IEEE_FLOAT and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float64)
    elif audio_format == _IEEE_FLOAT and bits == 64:
        x = np.frombuffer(data, dtype="<f8")
    else:
        raise ValueError(
            f"Unsupported WAV format {audio_format}/{bits}-bit: {path}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
        if mono:
            x = x.mean(axis=1)
    return x.astype(dtype), sample_rate


def write_wav(path: Union[str, Path], audio: np.ndarray, sample_rate: int,
              *, subtype: str = "pcm16") -> None:
    """Write mono or multi-channel audio as ``pcm16`` or ``float32``."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    channels = audio.shape[1]
    if subtype == "pcm16":
        payload = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        audio_format, bits = _PCM, 16
    elif subtype == "float32":
        payload = audio.astype("<f4").tobytes()
        audio_format, bits = _IEEE_FLOAT, 32
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(payload), b"WAVE",
        b"fmt ", 16, audio_format, channels, sample_rate,
        sample_rate * channels * bits // 8, channels * bits // 8, bits,
        b"data", len(payload))
    Path(path).write_bytes(hdr + payload)


def resample_linear(audio: np.ndarray, orig_sr: int,
                    target_sr: int) -> np.ndarray:
    """Linear-interpolation resampling."""
    if orig_sr == target_sr:
        return audio
    n_out = int(round(len(audio) / orig_sr * target_sr))
    t_out = np.arange(n_out) / target_sr
    t_in = np.arange(len(audio)) / orig_sr
    return np.interp(t_out, t_in, audio).astype(audio.dtype)
