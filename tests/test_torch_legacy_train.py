"""PyTorch port: the legacy trainer, its data and its entry points.

Against the JAX package, on the same files and the same (converted)
parameters:

- ``KoeMorphDataModule``: every train batch over two epochs (reshuffled
  per epoch) and every validation batch bitwise equal to JAX's, on files
  of two lengths (padding) with one broken pair (the dummy sample);
- ``KoeMorphTrainer``'s first-step loss at d_model 32 within 1e-5
  relative of JAX's, and every gradient leaf within 1e-4 of its largest
  element of JAX's float64 gradient;
- a JAX ``simplified`` run's orbax checkpoint, converted by
  ``scripts/orbax_to_torch.py``: the port's ``rt_simplified --device
  cpu`` streams the frames the JAX frame step gives on the same rolling
  1 s windows within 1e-5, and ``KoeMorphTrainer.resume()`` takes JAX's
  optimizer state and JAX's next step.

Port only: a resumed run bitwise equal to an uninterrupted one (dropout
on); ``python -m koemorph_tpu_torch.train --cpu --config
configs/config.yaml`` (the legacy default config, batch 4 on 4 synthetic
files), then ``rt_simplified`` and ``test_model --model-name simplified``
on what it wrote, in subprocesses, each equal to the same model run in
process; the entry points raise without CUDA unless asked for the CPU.
"""

import json
import os
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from koemorph_tpu.data.dataset import KoeMorphDataModule as JaxDM
from koemorph_tpu.data.dataset import pad_to_multiple as jax_pad
from koemorph_tpu.models.simplified import (
    SimplifiedKoeMorphModel as JaxSimplified)
from koemorph_tpu.train import KoeMorphTrainer as JaxKT
from koemorph_tpu_torch import rt_simplified
from koemorph_tpu_torch import test_model as test_model_cli
from koemorph_tpu_torch.data.dataset import (KoeMorphDataModule,
                                             pad_to_multiple)
from koemorph_tpu_torch.data.wav import write_wav
from koemorph_tpu_torch.models.simplified import SimplifiedKoeMorphModel
from koemorph_tpu_torch.train.__main__ import write_synthetic_dataset
from koemorph_tpu_torch.train.trainer import (KoeMorphTrainer,
                                              dropout_generator)
from koemorph_tpu_torch.utils.params import (flax_from_state_dict,
                                             read_state_dict,
                                             state_dict_from_flax)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import orbax_to_torch  # noqa: E402

TRAIN_CFG = {
    "optimizer": {"name": "adamw", "lr": 1e-3, "weight_decay": 1e-5,
                  "betas": [0.9, 0.999]},
    "lr_scheduler": {"name": "cosine", "t_max": 2, "eta_min": 1e-6},
    "loss": {"mse_weight": 1.0, "l1_weight": 0.1, "perceptual_weight": 0.5},
    "gradient_clip_val": 1.0,
    "max_epochs": 2,
    "logging": {"log_every_n_steps": 1, "tensorboard": False},
    "checkpoint": {"keep_epoch_every": 100},
}
SMALL = dict(d_model=32, num_heads=2)
GRAD_TOL = 1e-4


def _dataset(root: Path) -> Path:
    """Three 2 s and two 1.5 s synthetic pairs, and a pair whose
    blendshapes are 1.9 s shorter than its audio (loaded as the dummy
    sample)."""
    write_synthetic_dataset(root / "a", 3, duration_s=2.0, seed=1)
    write_synthetic_dataset(root / "b", 2, duration_s=1.5, seed=2)
    bad = root / "c"
    bad.mkdir()
    write_wav(bad / "bad.wav", np.zeros(32000, np.float32), 16000)
    (bad / "bad.jsonl").write_text(json.dumps(
        {"timestamp": 0.0, "blendshapes": [0.1] * 52}) + "\n")
    return root


def _batches(dm, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader = dm.train_dataloader()
        loader.set_epoch(epoch)
        out += list(loader)
    return out + list(dm.val_dataloader())


def test_datamodule_batches_bitwise_equal_jax(tmp_path):
    root = _dataset(tmp_path)
    kw = dict(train_data_dir=root, val_data_dir=root / "a", batch_size=2,
              seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = KoeMorphDataModule(**kw)
        want = JaxDM(**kw)
        got.setup()
        want.setup()
        assert len(got.train_dataset) == len(want.train_dataset) == 6
        assert len(got.train_dataloader()) == 3
        gb, wb = _batches(got), _batches(want)
    assert len(gb) == len(wb) == 8
    for g, w in zip(gb, wb):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    # the epochs are shuffled differently; the dummy sample is in them
    assert not all(np.array_equal(a["audio"], b["audio"])
                   for a, b in zip(gb[:3], gb[3:6]))
    with pytest.warns(UserWarning, match="dummy"):
        dummy = got.train_dataset[5]
    assert dummy["wav"].shape == (16000,) and not dummy["arkit"].any()
    # the audio axis padded to a multiple, as JAX pads it
    for multiple in (533, 32000, 7):
        g, w = pad_to_multiple(gb[0], multiple), jax_pad(wb[0], multiple)
        assert g["audio"].shape[1] % multiple == 0
        for k in w:
            assert np.array_equal(g[k], w[k]), (multiple, k)


def _batch(b=8, n=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 120 + 80 * rng.random((b, 1))
    audio = (0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.02 * rng.standard_normal((b, n))).astype(np.float32)
    return {"audio": audio, "audio_mask": np.ones((b, n), bool),
            "arkit": rng.uniform(0, 1, (b, 15, 52)).astype(np.float32),
            "arkit_mask": np.ones((b, 15), bool)}


def _trainers(tmp, cfg=TRAIN_CFG, dropout=0.0):
    """(JAX trainer, port trainer with JAX's initial parameters)."""
    jt = JaxKT(JaxSimplified(**SMALL, dropout=dropout), {"training": cfg},
               work_dir=Path(tmp) / "jax", steps_per_epoch=1,
               audio_samples=8000)
    tt = KoeMorphTrainer(SimplifiedKoeMorphModel(**SMALL, dropout=dropout),
                         {"training": cfg}, work_dir=Path(tmp) / "port",
                         steps_per_epoch=1, device="cpu")
    tt.model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.state.params)))
    return jt, tt


def _jax_grads(jt, prepared, dtype):
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                    jt.state.params)
    batch = {k: np.asarray(v, dtype) if k not in ("audio",)
             and np.asarray(v).dtype == np.float32 else np.asarray(v)
             for k, v in prepared.items()}
    fn = jax.jit(jax.value_and_grad(lambda p, b: jt.loss_fn(p, b, None),
                                    has_aux=True))
    with jax.enable_x64(dtype == np.float64):
        (loss, metrics), grads = fn(params, batch)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32), grads)
    lo = jax.tree_util.tree_map(lambda a, h: (a - h).astype(np.float32),
                                grads, hi)
    hi, lo = state_dict_from_flax(hi), state_dict_from_flax(lo)
    return float(loss), metrics, {k: hi[k].double().numpy()
                                  + lo[k].double().numpy() for k in hi}


def test_first_step_loss_and_gradients_match_jax():
    jt, tt = _trainers(tempfile.mkdtemp())
    batch = _batch()
    jprep = jt._prepare(batch)
    jloss, jmetrics, want32 = _jax_grads(jt, jprep, np.float32)
    _, _, want64 = _jax_grads(jt, jprep, np.float64)
    tt.model.train()
    loss, metrics = tt.loss_fn(tt._prepare(batch),
                               dropout_generator(0, 0, tt.device))
    grads = torch.autograd.grad(loss, list(tt.params.values()))
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    assert sorted(metrics) == sorted(jmetrics)
    got = {k: g.numpy() for k, g in zip(tt.params, grads)}
    assert sorted(got) == sorted(want64)
    for k, w in want64.items():
        scale = np.abs(w).max()
        d_jax = np.abs(want32[k] - w).max()
        assert d_jax <= 10 * GRAD_TOL * scale, (k, d_jax / scale)
        assert np.abs(got[k] - w).max() <= max(GRAD_TOL * scale,
                                               2 * d_jax), k


def test_resume_equals_uninterrupted(tmp_path):
    batches = [_batch(4, 6000, seed=s) for s in range(4)]

    def by_epoch(epoch):
        return iter(batches[2 * epoch: 2 * epoch + 2])

    def trainer(tag):
        return KoeMorphTrainer(
            SimplifiedKoeMorphModel(**SMALL, dropout=0.1),
            {"training": TRAIN_CFG}, work_dir=tmp_path / tag,
            steps_per_epoch=2, device="cpu")

    whole = trainer("whole")
    whole.fit(by_epoch, None, max_epochs=2)
    first = trainer("split")
    first.fit(by_epoch, None, max_epochs=1)
    resumed = trainer("split")
    assert resumed.resume() and resumed.global_step == 2
    resumed.fit(by_epoch, None, max_epochs=2)
    for k, p in whole.params.items():
        assert torch.equal(p, resumed.params[k]), k
    assert whole.optimizer.state_dict()["count"] == \
        resumed.optimizer.state_dict()["count"] == 4


def _voice(n, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * np.sin(3 * t)) * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _windows(audio, n_frames, hop=533, window=16000):
    """The rolling 1 s windows the real-time loop feeds the model."""
    buf = np.zeros(window, np.float32)
    padded = np.pad(audio, (0, -len(audio) % hop))
    out = []
    for i in range(n_frames):
        buf = np.concatenate([buf[hop:], padded[i * hop:(i + 1) * hop]])
        out.append(buf)
    return np.stack(out)


def test_orbax_simplified_run_serves_and_resumes_in_the_port(tmp_path):
    jt, _ = _trainers(tmp_path)
    batches = [_batch(8, 8000, seed=s) for s in range(2)]
    jt.train_epoch(iter(batches[:1]))
    jt.checkpoints.save(jt.state.params, epoch=0, global_step=1,
                        opt_state=jt.state.opt_state)
    port_last = tmp_path / "port" / "checkpoints" / "last"
    orbax_to_torch.main([str(tmp_path / "jax" / "checkpoints" / "last"),
                         str(port_last)])

    # the frames of rt_simplified against the JAX frame step
    wav, rows = tmp_path / "in.wav", tmp_path / "rt.jsonl"
    audio = _voice(20 * 533)
    write_wav(wav, audio, 16000)
    assert rt_simplified.main([
        "--input", str(wav), "--model", str(port_last), "--output", "file",
        "--output-file", str(rows), "--no-realtime", "--device", "cpu",
        "--d-model", "32", "--num-heads", "2"]) == 0
    got = np.asarray([json.loads(r)["blendshapes"]
                      for r in rows.read_text().splitlines()])
    jm = JaxSimplified(**SMALL, dropout=0.0)
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(
        jt.state.params, _windows(audio, 20))
    assert got.shape == (20, 52)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)

    # the port resumes JAX's optimizer state and takes JAX's next step
    tt = KoeMorphTrainer(SimplifiedKoeMorphModel(**SMALL, dropout=0.0),
                         {"training": TRAIN_CFG}, work_dir=tmp_path / "port",
                         steps_per_epoch=1, device="cpu")
    assert tt.resume() and tt.global_step == 1
    assert tt.optimizer.state_dict()["count"] == 1
    start = {k: v.detach().clone().numpy() for k, v in tt.params.items()}
    jt.train_epoch(iter(batches[1:]))
    tt.train_epoch(iter(batches[1:]))
    jp = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.params))
    for k, p in tt.params.items():
        d_jax = jp[k].numpy() - start[k]
        d_port = p.detach().numpy() - start[k]
        ulp = float(np.finfo(np.float32).eps * np.abs(start[k]).max())
        np.testing.assert_allclose(
            d_port, d_jax, rtol=0, err_msg=k,
            atol=1e-3 * np.abs(d_jax).max() + ulp)
    # and the port's checkpoint converts back to JAX's tree
    back = flax_from_state_dict(read_state_dict(port_last))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(np.asarray, jt.checkpoints.latest(
                    target=jt.state.params)[0]))):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_config_yaml_trains_then_serves_and_evaluates(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    work = tmp_path / "w"

    def run(*args):
        out = subprocess.run([sys.executable, "-m", *args], cwd=tmp_path,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "random" not in out.stderr
        return out

    out = run("koemorph_tpu_torch.train", "--cpu", "--config",
              str(REPO / "configs" / "config.yaml"), "--synthetic", "4",
              "--max-epochs", "1", "--work-dir", str(work),
              "data.batch_size=4")
    final = json.loads(out.stdout.strip().splitlines()[-1])
    assert final["work_dir"] == str(work)
    assert np.isfinite(final["final_train_metrics"]["loss"])
    last = work / "checkpoints" / "last"
    assert json.loads((last / "meta.json").read_text())["global_step"] == 1

    model = SimplifiedKoeMorphModel(dropout=0.0)
    model.load_state_dict(read_state_dict(last))
    model.eval()
    wav = work / "synth_data" / "synth_000.wav"
    rows = tmp_path / "rt.jsonl"
    out = run("koemorph_tpu_torch.rt_simplified", "--input", str(wav),
              "--model", str(last), "--output", "file", "--output-file",
              str(rows), "--no-realtime", "--max-frames", "12",
              "--device", "cpu")
    assert "RTF=" in out.stderr
    got = np.asarray([json.loads(r)["blendshapes"]
                      for r in rows.read_text().splitlines()])
    from koemorph_tpu_torch.data.wav import read_wav
    audio, _ = read_wav(wav)
    with torch.no_grad():
        want = np.concatenate([model(torch.from_numpy(w)[None]).numpy()
                               for w in _windows(audio, 12)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    out = run("koemorph_tpu_torch.test_model", "--data-dir",
              str(work / "synth_data"), "--model-name", "simplified",
              "--model", str(last), "--device", "cpu")
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["batches"] == 1.0 and np.isfinite(result["mae"])


def test_entry_points_need_cuda_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = tmp_path / "a.wav"
    write_wav(wav, _voice(4000), 16000)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt_simplified.main(["--input", str(wav), "--output", "none"])
    with pytest.raises(RuntimeError, match="CUDA"):
        test_model_cli.main(["--data-dir", str(tmp_path),
                             "--model-name", "simplified"])
    with pytest.raises(RuntimeError, match="CUDA"):
        KoeMorphTrainer(SimplifiedKoeMorphModel(**SMALL), {},
                        work_dir=tmp_path / "t")
    # the CPU, asked for, runs; graphs there are refused
    step = rt_simplified.FrameStep(
        rt_simplified.build_model(**SMALL, device="cpu"), 16000, "cpu")
    assert step(np.zeros(16000, np.float32)).shape == (52,)
    with pytest.raises(ValueError, match="CUDA graphs"):
        rt_simplified.FrameStep(step.model, 16000, "cpu", graphs=True)


def _console_scripts() -> dict:
    import tomllib
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items()
            if k.startswith("koemorph-torch-")}


@pytest.mark.parametrize("name", sorted(_console_scripts()))
def test_console_scripts_reach_their_entry_points(name, monkeypatch,
                                                  capsys):
    """Each ``koemorph-torch-*`` console script resolves to a function
    that runs its module's argument parser (``--help`` exits 0)."""
    import importlib
    module, func = _console_scripts()[name].split(":")
    entry = getattr(importlib.import_module(module), func)
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as stop:
        entry()
    assert stop.value.code == 0
    assert "usage:" in capsys.readouterr().out
