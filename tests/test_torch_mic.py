"""PyTorch port: microphone capture and the ``--mic`` / ``--list-devices``
flags, with a stand-in ``pyaudio`` module (the real one is not installed;
a live device has not been exercised).

Against the JAX package: ``list_audio_devices`` over the same stand-in
device table, and the error without ``pyaudio``. Port only: the guarded
import (a copy of the module loaded with the stand-in in
``sys.modules``), ``MicCapture``'s chunks, its full-queue drop and its
timeout, and ``rt`` / ``rt_simplified`` streaming from the stand-in
microphone on the CPU at a tiny width.
"""

import importlib.util
import json
import types

import numpy as np
import pytest

from koemorph_tpu.runtime import audio as jaudio
from koemorph_tpu_torch import rt, rt_simplified
from koemorph_tpu_torch.runtime import audio

DEVICES = [{"name": "speaker", "maxInputChannels": 0,
            "defaultSampleRate": 48000.0},
           {"name": "mic one", "maxInputChannels": 1,
            "defaultSampleRate": 16000.0},
           {"name": "mic two", "maxInputChannels": 2,
            "defaultSampleRate": 44100.0}]


def _stand_in(chunks=0, chunk_size=533):
    """A ``pyaudio`` module whose input stream delivers ``chunks`` chunks
    of a 220 Hz tone through the callback as soon as it opens."""
    mod = types.SimpleNamespace(paFloat32=1, paContinue=0, opened=[],
                                terminated=[])

    class Stream:
        def __init__(self, **kw):
            self.kw, self.stopped, self.closed = kw, False, False
            t = np.arange(chunks * chunk_size) / kw["rate"]
            tone = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
            for c in range(chunks):
                kw["stream_callback"](
                    tone[c * chunk_size:(c + 1) * chunk_size].tobytes(),
                    chunk_size, None, 0)

        def stop_stream(self):
            self.stopped = True

        def close(self):
            self.closed = True

    class PyAudio:
        def open(self, **kw):
            s = Stream(**kw)
            mod.opened.append(s)
            return s

        def get_device_count(self):
            return len(DEVICES)

        def get_device_info_by_index(self, i):
            return DEVICES[i]

        def terminate(self):
            mod.terminated.append(self)

    mod.PyAudio = PyAudio
    return mod


@pytest.fixture
def with_pyaudio(monkeypatch):
    def install(chunks=0, chunk_size=533):
        mod = _stand_in(chunks, chunk_size)
        for m in (audio, jaudio):
            monkeypatch.setattr(m, "pyaudio", mod)
            monkeypatch.setattr(m, "HAS_PYAUDIO", True)
        return mod
    return install


def test_guarded_import(monkeypatch):
    def load():
        spec = importlib.util.spec_from_file_location(
            "audio_copy", audio.__file__)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    monkeypatch.setitem(__import__("sys").modules, "pyaudio", _stand_in())
    assert load().HAS_PYAUDIO
    monkeypatch.setitem(__import__("sys").modules, "pyaudio", None)
    copy = load()
    assert not copy.HAS_PYAUDIO and copy.pyaudio is None
    assert not audio.HAS_PYAUDIO       # not installed here


def test_without_pyaudio_as_jax():
    for mod in (audio, jaudio):
        assert mod.list_audio_devices() == []
    with pytest.raises(RuntimeError) as got:
        audio.MicCapture()
    with pytest.raises(RuntimeError) as want:
        jaudio.MicCapture()
    assert str(got.value) == str(want.value)
    assert "pyaudio not available" in str(got.value)


def test_list_audio_devices_matches_jax(with_pyaudio):
    mod = with_pyaudio()
    got = audio.list_audio_devices()
    assert got == jaudio.list_audio_devices()
    assert [d["index"] for d in got] == [1, 2]
    assert got[0] == {"index": 1, "name": "mic one", "channels": 1,
                      "sample_rate": 16000.0}
    assert len(mod.terminated) == 2


def test_mic_capture_chunks_and_stop(with_pyaudio):
    mod = with_pyaudio(chunks=3, chunk_size=160)
    mic = audio.MicCapture(16000, 160, device_index=1, queue_size=2)
    stream = mod.opened[0]
    assert stream.kw["input_device_index"] == 1
    assert stream.kw["frames_per_buffer"] == 160
    assert stream.kw["channels"] == 1 and stream.kw["input"]
    # the third chunk found the queue full and was dropped
    assert mic.queue.qsize() == 2
    first = mic.read()
    assert first.dtype == np.float32 and first.shape == (160,)
    assert mic.read().shape == (160,)
    assert mic.read(timeout=0.01) is None
    mic.stop()
    assert stream.stopped and stream.closed and mod.terminated


def test_rt_flags(with_pyaudio, tmp_path, capsys):
    with pytest.raises(SystemExit):
        rt.main(["--device", "cpu"])            # --input or --mic
    with_pyaudio()
    assert rt.main(["--list-devices"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and "mic one" in lines[0]


def test_rt_list_devices_without_pyaudio(capsys):
    assert rt.main(["--list-devices"]) == 0
    assert capsys.readouterr().out == ""


def test_rt_mic_without_pyaudio_fails():
    with pytest.raises(RuntimeError, match="pyaudio not available"):
        rt.main(["--mic", "--device", "cpu", "--d-model", "32",
                 "--num-heads", "2", "--emotion-backend", "basic",
                 "--output", "none"])


def test_rt_streams_from_the_microphone(with_pyaudio, tmp_path):
    with_pyaudio(chunks=6)
    out = tmp_path / "mic.jsonl"
    assert rt.main(["--mic", "--device", "cpu", "--d-model", "32",
                    "--num-heads", "2", "--emotion-backend", "basic",
                    "--max-frames", "4", "--output-file", str(out)]) == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(rows) == 4
    assert all(len(r["blendshapes"]) == 52 for r in rows)


def test_rt_simplified_streams_from_the_microphone(with_pyaudio, tmp_path):
    with pytest.raises(SystemExit):
        rt_simplified.main(["--device", "cpu"])
    with_pyaudio(chunks=5)
    out = tmp_path / "mic.jsonl"
    assert rt_simplified.main(["--mic", "--device", "cpu", "--d-model", "32",
                               "--num-heads", "2", "--max-frames", "3",
                               "--output-file", str(out)]) == 0
    assert len(out.read_text().splitlines()) == 3
