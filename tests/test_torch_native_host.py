"""PyTorch port: the native corpus parsers (``koemorph_tpu_torch/native/
host.cpp``, built with g++ at first use) against the port's pure-Python
readers and the JAX package's ``read_wav`` / ``ARKitDataLoader``, on the
cases of ``tests/data/test_native.py``.

Every array is held bitwise (``assert_array_equal``), except the native
mono mix of a stereo file against the float64 Python mean (float32
accumulation: within 1e-7, as the JAX package's own test holds it). A file
or line the parser declines goes to the strict Python reader, whose error
and warnings are the JAX package's.
"""

import json
import shutil
import unittest.mock as mock
import warnings

import numpy as np
import pytest

from koemorph_tpu.data import io as jax_io
from koemorph_tpu.data.wav import read_wav as jax_read_wav
from koemorph_tpu_torch.data import dataset as pt_dataset
from koemorph_tpu_torch.data import io as pt_io
from koemorph_tpu_torch.data import native
from koemorph_tpu_torch.data import sequential as pt_seq
from koemorph_tpu_torch.data.wav import (decode_wav_python, read_wav,
                                         write_wav)


def _wav_bytes(audio, bits, fmt):
    """RIFF bytes of ``audio`` (L,) or (L, C) as PCM 8/24/32-bit or
    float64 (``write_wav`` writes pcm16 and float32 only)."""
    import struct
    audio = np.asarray(audio, np.float64)
    if audio.ndim == 1:
        audio = audio[:, None]
    if fmt == 3 and bits == 64:
        payload = audio.astype("<f8").tobytes()
    elif bits == 8:
        payload = (np.round(audio * 127) + 128).astype(np.uint8).tobytes()
    elif bits == 24:
        v = np.round(audio * (2 ** 23 - 1)).astype(np.int32).reshape(-1)
        b = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1)
        payload = b.astype(np.uint8).tobytes()
    else:    # 32-bit PCM
        payload = np.round(audio * (2 ** 31 - 1)).astype("<i4").tobytes()
    ch = audio.shape[1]
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload), b"WAVE",
        b"fmt ", 16, fmt, ch, 16000, 16000 * ch * bits // 8,
        ch * bits // 8, bits, b"data", len(payload)) + payload


WAV_CASES = [("pcm16", None, None), ("float32", None, None),
             ("pcm24", 24, 1), ("pcm32", 32, 1), ("float64", 64, 3),
             ("pcm8", 8, 1)]


@pytest.mark.parametrize("name,bits,fmt", WAV_CASES)
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bitwise_vs_python_and_jax(tmp_path, name, bits, fmt,
                                       channels):
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.9, 0.9, (4000, channels)).squeeze()
    p = tmp_path / "t.wav"
    if bits is None:
        write_wav(p, x.astype(np.float32), 16000, subtype=name)
    else:
        p.write_bytes(_wav_bytes(x, bits, fmt))
    raw = p.read_bytes()
    decoded = native.decode_wav_native(raw)
    assert (decoded is None) == (name == "pcm8")   # 8-bit: Python's
    got, sr = read_wav(p)
    want, sr_py = decode_wav_python(raw, p)
    jax_got, sr_jax = jax_read_wav(p)
    assert sr == sr_py == sr_jax == 16000
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_got)
    if decoded is not None:
        np.testing.assert_array_equal(decoded[0], want)
    # float64 reads skip the native parser, as in the JAX package
    np.testing.assert_array_equal(read_wav(p, dtype=np.float64)[0],
                                  jax_read_wav(p, dtype=np.float64)[0])


def test_stereo_mono_mix(tmp_path):
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (4000, 2))
    p = tmp_path / "s.wav"
    write_wav(p, x.astype(np.float32), 16000)
    got, _ = read_wav(p, mono=True)
    np.testing.assert_array_equal(got, jax_read_wav(p, mono=True)[0])
    ref, _ = decode_wav_python(p.read_bytes(), p, mono=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


def test_garbage_wav_routes_to_python_errors(tmp_path):
    assert native.decode_wav_native(b"not a wav at all") is None
    p = tmp_path / "g.wav"
    p.write_bytes(b"not a wav at all")
    for reader in (read_wav, jax_read_wav):
        with pytest.raises(ValueError, match="Not a RIFF/WAVE"):
            reader(p)
    p.write_bytes(b"RIFF\x04\x00\x00\x00WAVE")     # no fmt/data chunks
    assert native.decode_wav_native(p.read_bytes()) is None
    with pytest.raises(ValueError, match="Missing fmt/data"):
        read_wav(p)


def _jsonl(rows, extra_key=False, ts=None):
    lines = []
    for i, r in enumerate(rows):
        rec = {"timestamp": (i / 30.0 if ts is None else ts[i]),
               "blendshapes": np.asarray(r).round(6).tolist()}
        if extra_key:
            rec["session"] = "abc"
            rec["meta"] = {"a": [1, 2, "x]"]}
        lines.append(json.dumps(rec))
    return "\n".join(lines) + "\n"


def _load_all(path):
    """The port loader's rows, the Python reader's and the JAX loader's,
    with the warnings each raised."""
    out = {}
    for name, fn in (
            ("native", pt_io.ARKitDataLoader()._load_blendshapes),
            ("python", pt_io.load_blendshapes_python),
            ("jax", jax_io.ARKitDataLoader()._load_blendshapes)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            arr = fn(path)
        out[name] = (arr, sorted({str(x.message) for x in w}))
    return out


@pytest.mark.parametrize("extra_key", [False, True])
def test_jsonl_bitwise_vs_python_and_jax(tmp_path, extra_key):
    rows = np.random.default_rng(3).uniform(0, 1, (100, 52))
    p = tmp_path / "a.jsonl"
    p.write_text(_jsonl(rows, extra_key))
    bs, ts = native.parse_blendshape_jsonl_native(p.read_bytes())
    np.testing.assert_array_equal(ts, np.arange(100) / 30.0)
    got = _load_all(p)
    for name in ("native", "python", "jax"):
        np.testing.assert_array_equal(got[name][0], bs)
        assert got[name][1] == []


def test_jsonl_warnings_match_jax(tmp_path):
    """Values outside [0, 1] and non-monotonic timestamps: the native
    path's two warnings are the JAX native path's."""
    rows = np.random.default_rng(4).uniform(0, 1, (6, 52))
    rows[2, 5] = 1.5
    ts = [0.0, 0.1, 0.05, 0.2, 0.3, 0.4]
    p = tmp_path / "w.jsonl"
    p.write_text(_jsonl(rows, ts=ts))
    got = _load_all(p)
    assert got["native"][1] == got["jax"][1] == [
        "Blendshape values outside [0,1] range",
        "Non-monotonic timestamps detected"]
    assert "Blendshape values outside [0,1] range at line 3" in \
        got["python"][1]
    for name in ("python", "jax"):
        np.testing.assert_array_equal(got[name][0], got["native"][0])


BAD_LINES = [
    ({"timestamp": 0.0, "blendshapes": [0.1] * 51},
     "Expected 52 blendshapes, got 51 at line 2"),
    ({"timestamp": 0.0, "blendshapes": [0.1] * 53},
     "Expected 52 blendshapes, got 53 at line 2"),
    ({"blendshapes": [0.1] * 52}, "Missing 'timestamp' field at line 2"),
    ({"timestamp": 0.0}, "Missing 'blendshapes' field at line 2"),
    ("not json", "Invalid JSON at line 2"),
]


@pytest.mark.parametrize("bad,message", BAD_LINES)
def test_irregular_lines_route_to_python_errors(tmp_path, bad, message):
    good = json.dumps({"timestamp": 0.0, "blendshapes": [0.2] * 52})
    line = bad if isinstance(bad, str) else json.dumps(bad)
    p = tmp_path / "bad.jsonl"
    p.write_text(good + "\n" + line + "\n")
    assert native.parse_blendshape_jsonl_native(p.read_bytes()) is None
    for loader in (pt_io.ARKitDataLoader(), jax_io.ARKitDataLoader()):
        with pytest.raises(ValueError, match=message):
            loader._load_blendshapes(p)


def test_empty_file_routes_to_python_error(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("")
    assert native.parse_blendshape_jsonl_native(p.read_bytes()) is None
    for loader in (pt_io.ARKitDataLoader(), jax_io.ARKitDataLoader()):
        with pytest.raises(ValueError, match="No blendshape data"):
            loader._load_blendshapes(p)
    # blank lines alone: the Python reader's JSON error, as JAX's
    p.write_text("\n  \n")
    assert native.parse_blendshape_jsonl_native(p.read_bytes()) is None
    for loader in (pt_io.ARKitDataLoader(), jax_io.ARKitDataLoader()):
        with pytest.raises(ValueError, match="Invalid JSON at line 1"):
            loader._load_blendshapes(p)


def _pair(tmp_path, seconds=1.0, name="a"):
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.5, 0.5, int(16000 * seconds)).astype(np.float32)
    write_wav(tmp_path / f"{name}.wav", x, 16000)
    rows = rng.uniform(0, 1, (int(30 * seconds), 52))
    (tmp_path / f"{name}.jsonl").write_text(_jsonl(rows))
    return tmp_path / f"{name}.jsonl", tmp_path / f"{name}.wav"


def test_loaders_take_the_native_path(tmp_path):
    """``load_sample`` (the legacy dataset's reader) and the sequential
    dataset's file load run the native parsers, and give what the Python
    readers and the JAX loader give, bitwise."""
    jsonl, wav = _pair(tmp_path)
    calls = {"wav": 0, "jsonl": 0}
    real_wav, real_jsonl = (native.decode_wav_native,
                            native.parse_blendshape_jsonl_native)

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with mock.patch.object(native, "decode_wav_native",
                           count("wav", real_wav)), \
            mock.patch.object(native, "parse_blendshape_jsonl_native",
                              count("jsonl", real_jsonl)):
        ds = pt_dataset.KoeMorphDataset(tmp_path)
        fast = ds[0]
        assert calls == {"wav": 1, "jsonl": 1}
        seq = pt_seq.SequentialKoeMorphDataset(
            tmp_path, window_frames=16, stride_frames=8)
        audio, _ = seq._load_file(0)
        assert calls["wav"] == 2
    with mock.patch.object(native, "decode_wav_native",
                           return_value=None), \
            mock.patch.object(native, "parse_blendshape_jsonl_native",
                              return_value=None):
        slow = pt_io.ARKitDataLoader().load_sample(jsonl, wav)
    want = jax_io.ARKitDataLoader().load_sample(jsonl, wav)
    for key in ("wav", "arkit"):
        np.testing.assert_array_equal(fast[key], slow[key])
        np.testing.assert_array_equal(fast[key], want[key])
    np.testing.assert_array_equal(audio, fast["wav"][: len(audio)])


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "_lib_path",
                        lambda src=None: tmp_path / "host_x.so")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.host_lib()
    assert not (tmp_path / "host_x.so").exists()


def test_host_library_is_built_once_under_build():
    lib = native.host_lib()
    assert native.host_lib() is lib
    path = native._lib_path(native._NATIVE / "host.cpp")
    assert path.exists() and path.name.startswith("host_")
    assert path.parent.parent.name == "build"
