"""PyTorch port: the training data path against the JAX package.

- ``utils.config``: the composed dict of every file under ``configs/``,
  and of the root configs under dot-notation overrides and group swaps,
  equal to ``koemorph_tpu.utils.config.load_config``'s, and an override's
  value text parsed alike (scalars, flow collections, interpolations,
  and texts YAML reads otherwise or rejects).
- ``data.io``: the loader's arrays, fps detection, resampling and the
  consistency report equal (bitwise) to the JAX package's, and the same
  errors.
- ``data.sequential``: every batch over two epochs bitwise equal, for the
  fixed-stride loader and for each stride mode (dense, sparse,
  progressive, mixed), and for the file-continuous batch sampler.
- ``train.__main__.write_synthetic_dataset``: byte-identical files.
"""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from koemorph_tpu.data import io as jio
from koemorph_tpu.data import sequential as jseq
from koemorph_tpu.data.wav import write_wav
from koemorph_tpu.train.__main__ import (
    write_synthetic_dataset as jax_synthetic)
from koemorph_tpu.utils import config as jcfg
from koemorph_tpu.utils.config import load_config as jax_load_config
from koemorph_tpu_torch.data import io as tio
from koemorph_tpu_torch.data import sequential as tseq
from koemorph_tpu_torch.train.__main__ import (
    write_synthetic_dataset as torch_synthetic)
from koemorph_tpu_torch.utils.config import load_config as torch_load_config
from koemorph_tpu_torch.utils import config as tcfg

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("**/*.yaml"))
SR = 16000


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: str(
    p.relative_to(REPO / "configs")))
def test_config_files_compose_alike(path):
    """A group file alone may name a key only its root defines: then both
    raise the same error."""
    try:
        want = jax_load_config(path)
    except KeyError as e:
        with pytest.raises(KeyError, match=str(e.args[0]).replace(
                "$", r"\$").replace("{", r"\{").replace("}", r"\}")):
            torch_load_config(path)
        return
    assert torch_load_config(path) == want


@pytest.mark.parametrize("root,overrides", [
    ("dual_stream_config.yaml", ["model.d_model=128", "model.num_heads=4",
                                 "training.optimizer.lr=3e-4",
                                 "data.batch_size=4"]),
    ("dual_stream_config.yaml", ["frame_rate=60",
                                 "training.optimizer.betas=[0.8, 0.99]",
                                 "+extra.flag=true", "+extra.name=abc"]),
    ("dual_stream_config.yaml", ["model=dual_stream_60fps",
                                 "training.lr_scheduler.name=constant"]),
    ("config.yaml", ["model=dual_stream", "experiment.name=x",
                     "training.max_epochs=3", "data.stride_frames=null"]),
])
def test_config_overrides_alike(root, overrides):
    path = REPO / "configs" / root
    assert torch_load_config(path, overrides=overrides) == \
        jax_load_config(path, overrides=overrides)


@pytest.mark.parametrize("text", [
    "128", "-3", "+3", "3_000", "0", "1e-4", "1.0e-4", ".5", "2.", "-1.5",
    ".inf", "-.inf", "true", "False", "yes", "off", "null", "~", "",
    "a:b", "x y z", '"q # not a comment"', "'it''s'", "[0.9, 0.999]",
    "[]", "{a: 1, b: [1, 2], c: {d: x}}", "${frame_rate}",
    "${eval:512 if ${frame_rate} == 60 else 256}",
    "k: v  # comment\nl:\n  - 1\n  - two\n  - m: 3\n    n: [4]\n",
    "&anchor x", "!!str 3", "0x1F", "017", "1:30", "a: |\n  block\n",
    "--- x", "2024-01-02", "[unclosed",
])
def test_override_values_parse_alike(text):
    """An override's value text: the same Python value as the JAX
    package's (``yaml.safe_load`` where it parses, else the text)."""
    got, want = tcfg._parse_value(text), jcfg._parse_value(text)
    assert got == want and type(got) is type(want)


# ---------------------------------------------------------------------------
# data.io
# ---------------------------------------------------------------------------

def _pair(tmp_path, name, duration=2.0, fps=30.0, sr=SR, stereo=False,
          n_coeffs=52, bad_json=False, missing_field=None, seed=0):
    rng = np.random.default_rng(seed)
    n = int(duration * sr)
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / sr)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
    if stereo:
        audio = np.stack([audio, audio * 0.5], axis=1)
    wav = tmp_path / f"{name}.wav"
    write_wav(wav, audio, sr)
    jsonl = tmp_path / f"{name}.jsonl"
    with open(jsonl, "w") as f:
        for t in range(int(duration * fps)):
            if bad_json and t == 1:
                f.write("not json\n")
                continue
            rec = {"timestamp": t / fps,
                   "blendshapes": rng.uniform(0, 1, n_coeffs).tolist()}
            if missing_field:
                rec.pop(missing_field)
            f.write(json.dumps(rec) + "\n")
    return jsonl, wav


def test_io_loader_and_helpers_alike(tmp_path):
    jl, wav = _pair(tmp_path, "a", stereo=True)
    jl60, wav60 = _pair(tmp_path, "b", fps=60.0, seed=1)
    want = jio.ARKitDataLoader().load_sample(jl, wav)
    got = tio.ARKitDataLoader().load_sample(jl, wav)
    for k in ("wav", "arkit"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    for path in (jl, jl60):
        (ga, gf), (wa, wf) = (tio.load_blendshapes_with_fps(path),
                              jio.load_blendshapes_with_fps(path))
        np.testing.assert_array_equal(ga, wa)
        assert gf == wf
        for target in (30.0, 60.0):
            np.testing.assert_array_equal(
                tio.resample_blendshapes(ga, gf, target),
                jio.resample_blendshapes(wa, wf, target))
    for ts in (np.arange(5) / 30, np.arange(5) / 60, np.arange(5) / 45,
               np.zeros(3), np.zeros(1)):
        assert tio.detect_fps(ts) == jio.detect_fps(ts)
    samples = tio.ARKitDataLoader().load_batch([(jl, wav), (jl60, wav60)])
    assert tio.validate_data_consistency(samples) == \
        jio.validate_data_consistency(samples)
    assert tio.validate_data_consistency([]) == \
        jio.validate_data_consistency([])


@pytest.mark.parametrize("case", ["missing_wav", "count", "bad_json",
                                  "missing_field", "drift"])
def test_io_errors_alike(tmp_path, case):
    kw = {"count": dict(n_coeffs=51), "bad_json": dict(bad_json=True),
          "missing_field": dict(missing_field="timestamp")}.get(case, {})
    jl, wav = _pair(tmp_path, case, **kw)
    if case == "missing_wav":
        wav = tmp_path / "none.wav"
    loader_kw = {"max_time_drift": 0.01} if case == "drift" else {}
    if case == "drift":
        write_wav(wav, np.zeros(3 * SR, np.float32), SR)
    errors = []
    for mod in (jio, tio):
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            mod.ARKitDataLoader(**loader_kw).load_sample(jl, wav)
        errors.append((type(e.value), str(e.value).split(":")[0]))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# data.sequential
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four files of 3-4 s: one at 60 fps (resampled), one at 22.05 kHz
    (resampled), and a 45-frame one too short for sparse windows."""
    d = tmp_path_factory.mktemp("seq")
    _pair(d, "f0", duration=3.0, seed=10)
    _pair(d, "f1", duration=4.0, fps=60.0, seed=11)
    _pair(d, "f2", duration=3.5, sr=22050, seed=12)
    _pair(d, "f3", duration=1.5, seed=13)
    return d


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("mode", ["fixed", "dense", "sparse", "progressive",
                                  "mixed"])
def test_sequential_batches_bitwise(corpus, mode):
    kw = dict(batch_size=3, window_frames=32, drop_last=False, seed=5)
    loaders = []
    for mod in (tseq, jseq):
        if mode == "fixed":
            loaders.append(mod.create_sequential_dataloader(
                corpus, stride_frames=7, **kw))
        else:
            sched = mod.StrideSchedule(mode, sparse_stride=9,
                                       progressive_epochs=3, dense_ratio=0.5,
                                       seed=2)
            loaders.append(mod.create_adaptive_dataloader(
                corpus, schedule=sched, stride_frames=4, **kw))
    for epoch in (0, 1):
        out = []
        for loader_fn, dataset in loaders:
            dataset.set_epoch(epoch)
            out.append(list(loader_fn()))
        _assert_batches_equal(*out)
    assert loaders[0][1].get_num_windows() == loaders[1][1].get_num_windows()


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_sampler_bitwise(corpus, drop_last):
    out = []
    for mod in (tseq, jseq):
        ds = mod.SequentialKoeMorphDataset(corpus, window_frames=24,
                                           stride_frames=5, seed=3)
        ds.set_epoch(1)
        out.append(list(mod.SequentialBatchSampler(ds, 4,
                                                   drop_last=drop_last)))
    _assert_batches_equal(*out)


def test_stride_schedule_alike():
    for mode in ("dense", "sparse", "progressive", "mixed"):
        a = tseq.StrideSchedule(mode, sparse_stride=16, dense_ratio=0.3,
                                seed=4)
        b = jseq.StrideSchedule(mode, sparse_stride=16, dense_ratio=0.3,
                                seed=4)
        for epoch in range(12):
            for f in range(5):
                assert a.stride_for(epoch, f, 5) == b.stride_for(epoch, f, 5)
    with pytest.raises(ValueError):
        tseq.StrideSchedule("weekly")


def test_prefetch_reraises_producer_errors():
    def gen():
        yield 1
        raise RuntimeError("loader failed")

    it = tseq.prefetch_iterator(gen)()
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="loader failed"):
        next(it)


def test_synthetic_dataset_byte_identical(tmp_path):
    for correlated in (True, False):
        a = torch_synthetic(tmp_path / f"t{correlated}", 2, duration_s=2.0,
                            seed=7, speech_correlated=correlated)
        b = jax_synthetic(tmp_path / f"j{correlated}", 2, duration_s=2.0,
                          seed=7, speech_correlated=correlated)
        names = sorted(p.name for p in a.iterdir())
        assert names == sorted(p.name for p in b.iterdir()) and len(
            names) == 4
        for name in names:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_no_warnings_on_clean_files(tmp_path):
    jl, wav = _pair(tmp_path, "clean")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tio.ARKitDataLoader().load_sample(jl, wav)
