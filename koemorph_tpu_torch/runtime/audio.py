"""Audio sources for the real-time loops, each feeding hop-sized chunks
into a bounded queue: WAV replay at the real-time rate on a thread, and
microphone capture through PyAudio's callback thread.

``pyaudio`` is optional (``HAS_PYAUDIO``): without it :class:`MicCapture`
raises ``RuntimeError`` and :func:`list_audio_devices` returns ``[]``.
Capture from a live device has not been exercised; the tests drive it
through a stand-in ``pyaudio`` module."""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np

from koemorph_tpu_torch.data.wav import read_wav, resample_linear

__all__ = ["AudioFileReader", "EOS", "HAS_PYAUDIO", "MicCapture",
           "list_audio_devices"]

try:  # the optional microphone backend
    import pyaudio  # type: ignore
    HAS_PYAUDIO = True
except Exception:  # not installed
    pyaudio = None
    HAS_PYAUDIO = False


class _EndOfStream:
    """``read()`` returns ``EOS`` when the source is finished and ``None``
    only on a transient timeout."""

    def __repr__(self):
        return "EOS"


EOS = _EndOfStream()


class AudioFileReader:
    """Replays a WAV file in hop-sized chunks, at the real-time rate unless
    ``realtime=False``."""

    def __init__(self, path: Union[str, Path], sample_rate: int = 16000,
                 chunk_size: int = 533, realtime: bool = True,
                 loop: bool = False, queue_size: int = 64):
        audio, sr = read_wav(path, mono=True)
        if sr != sample_rate:
            audio = resample_linear(audio, sr, sample_rate)
        self.audio = np.asarray(audio, np.float32).reshape(-1)
        self.sample_rate = sample_rate
        self.chunk_size = chunk_size
        self.realtime = realtime
        self.loop = loop
        self.queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def duration_s(self) -> float:
        return len(self.audio) / self.sample_rate

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        period = self.chunk_size / self.sample_rate
        next_t = time.perf_counter()
        # the final partial chunk is zero-padded and emitted too
        n = len(self.audio)
        n_chunks = max(1, -(-n // self.chunk_size))
        padded = np.pad(self.audio, (0, n_chunks * self.chunk_size - n))
        while not self._stop.is_set():
            for i in range(n_chunks):
                if self._stop.is_set():
                    break
                chunk = padded[i * self.chunk_size:(i + 1) * self.chunk_size]
                try:
                    self.queue.put(chunk, timeout=1.0)
                except queue.Full:
                    pass   # consumer stalled; drop to stay real-time
                if self.realtime:
                    next_t += period
                    delay = next_t - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
            if not self.loop:
                break
        self.queue.put(EOS)

    def read(self, timeout: float = 2.0):
        """Next chunk; ``EOS`` at end of stream; ``None`` on timeout."""
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class MicCapture:
    """PyAudio microphone capture into a bounded queue (the callback
    thread feeds the main loop, as the reference's real-time script
    does): float32 mono chunks of ``chunk_size`` samples; a chunk that
    finds the queue full is dropped."""

    def __init__(self, sample_rate: int = 16000, chunk_size: int = 533,
                 device_index: Optional[int] = None, queue_size: int = 64):
        if not HAS_PYAUDIO:
            raise RuntimeError(
                "pyaudio not available; use AudioFileReader or install "
                "pyaudio")
        self.sample_rate = sample_rate
        self.chunk_size = chunk_size
        self.queue: queue.Queue[np.ndarray] = queue.Queue(maxsize=queue_size)
        self._pa = pyaudio.PyAudio()
        self._stream = self._pa.open(
            format=pyaudio.paFloat32, channels=1, rate=sample_rate,
            input=True, input_device_index=device_index,
            frames_per_buffer=chunk_size,
            stream_callback=self._callback)

    def _callback(self, in_data, frame_count, time_info, status):
        samples = np.frombuffer(in_data, np.float32)
        try:
            self.queue.put_nowait(samples)
        except queue.Full:
            pass   # the consumer lags: skip this chunk
        return (None, pyaudio.paContinue)

    def read(self, timeout: float = 2.0):
        """Next chunk, or ``None`` on timeout (a microphone never reaches
        ``EOS``)."""
        try:
            return self.queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self) -> None:
        self._stream.stop_stream()
        self._stream.close()
        self._pa.terminate()


def list_audio_devices() -> list[dict]:
    """The input devices PyAudio sees: index, name, input channels and
    default sample rate of each (``[]`` without ``pyaudio``)."""
    if not HAS_PYAUDIO:
        return []
    pa = pyaudio.PyAudio()
    devices = []
    for i in range(pa.get_device_count()):
        info = pa.get_device_info_by_index(i)
        if info.get("maxInputChannels", 0) > 0:
            devices.append({"index": i, "name": info["name"],
                            "channels": info["maxInputChannels"],
                            "sample_rate": info["defaultSampleRate"]})
    pa.terminate()
    return devices
