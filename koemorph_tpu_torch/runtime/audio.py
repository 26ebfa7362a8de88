"""WAV replay at the real-time rate on a thread, into a bounded queue."""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np

from koemorph_tpu_torch.data.wav import read_wav, resample_linear

__all__ = ["AudioFileReader", "EOS"]


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
