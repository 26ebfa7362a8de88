"""PyTorch port: the training rehearsal (``training_rehearsal``), its short
form (``demo_lipsync_learning``) and the reproduction recipe
(``reproduce_results --smoke``) on the CPU at a tiny size.

``recall_diagnosis`` is held against the JAX script's on the same
synthetic files and the same parameters (JAX's, perturbed off their
two-valued start and carried to the port through ``utils/params.py``):
every count equal, every rate and mean within 1e-5. The success gate and
the report routing are checked on constructed summaries; the entry points
run end to end and must exit 0, and the demo's training loss must fall.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models.dual_stream_model import (
    SequentialDualStreamModel as JaxSequential)
from koemorph_tpu_torch import demo_lipsync_learning, reproduce_results
from koemorph_tpu_torch import training_rehearsal as reh
from koemorph_tpu_torch.models.dual_stream_model import (
    SequentialDualStreamModel)
from koemorph_tpu_torch.train.__main__ import write_synthetic_dataset
from koemorph_tpu_torch.utils.params import state_dict_from_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
HOP = 533
KW = dict(d_model=32, num_heads=2, mel_sequence_length=64,
          emotion_backend="basic", use_concatenation=False, dropout=0.0,
          stride_frames=4)


def _jax_script(monkeypatch):
    """``scripts/training_rehearsal.py`` as a module, without the
    persistent compilation cache it turns on at import."""
    monkeypatch.setenv("KOEMORPH_COMPILE_CACHE", "off")
    spec = importlib.util.spec_from_file_location(
        "jax_training_rehearsal", REPO / "scripts" / "training_rehearsal.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_json(fn) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn()
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def test_recall_diagnosis_matches_jax(tmp_path, monkeypatch):
    data = write_synthetic_dataset(tmp_path / "data", 2, duration_s=4.0,
                                   seed=7)
    jmodel = JaxSequential(**KW)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 96 * HOP)))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.5, np.shape(x))).astype(
            np.float32), params)
    want_sweep, want = _jax_script(monkeypatch).recall_diagnosis(
        jmodel, params, data)
    port = SequentialDualStreamModel(**KW)
    port.load_state_dict(state_dict_from_flax(params))
    sweep, got = reh.recall_diagnosis(port, data)
    assert len(sweep) == len(want_sweep) == len(reh.THRESH_SWEEP)
    for g, w in zip(sweep, want_sweep):
        assert g.keys() == w.keys()
        for k in g:
            assert abs(g[k] - w[k]) <= 1e-5, (k, g, w)
    channels, want_channels = got.pop("channels"), want.pop("channels")
    assert got["n_frames"] == want["n_frames"] > 0
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert [c["name"] for c in channels] == \
        [c["name"] for c in want_channels]
    assert channels, "no active channel: the check would be vacuous"
    for g, w in zip(channels, want_channels):
        for k in ("active_frac", "tgt_mean", "pred_mean", "recall"):
            assert abs(g[k] - w[k]) <= 1e-5, (g["name"], k, g[k], w[k])
    assert got["pred_sum_mean_active_frames"] > 0


def _summary(**kw):
    base = {"correlation_last": 0.9, "f1_last": 0.5,
            "range_ratio_first": 0.01, "range_ratio_last": 0.8,
            "cli": {"infer": 0, "rt": 0}}
    return {**base, **kw}


@pytest.mark.parametrize("change,ok", [
    ({}, True), ({"correlation_last": 0.3}, False),
    ({"f1_last": 0.2}, False), ({"range_ratio_last": 0.69}, False),
    ({"range_ratio_first": 1.7}, False),
    ({"cli": {"infer": 0, "rt": 1}}, False)])
def test_success_gate(change, ok):
    assert reh.passes_gate(_summary(**change), 0.7) == ok


def test_report_routing(tmp_path):
    assert reh.route_report(tmp_path, False, 10, False).name == \
        reh.REPORT_FAILED
    assert reh.route_report(tmp_path, True, 10, False).name == reh.REPORT
    (tmp_path / reh.REPORT).write_text(
        "... 880 epochs x 10 steps, lr 0.0005 ...")
    assert reh._existing_total_steps(tmp_path / reh.REPORT) == 8800
    assert reh.route_report(tmp_path, True, 4000, False).name == \
        reh.REPORT_SMOKE
    assert reh.route_report(tmp_path, True, 4000, True).name == reh.REPORT
    assert reh.route_report(tmp_path, True, 8800, False).name == reh.REPORT
    assert reh.route_report(tmp_path, False, 9000, True).name == \
        reh.REPORT_FAILED


@pytest.fixture
def cudnn_tf32_on(monkeypatch):
    """PyTorch's default (TF32 convolutions), which each training entry
    point must turn off: the trainer refuses it on the card."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    yield
    assert torch.backends.cudnn.allow_tf32 is False


def test_rehearsal_runs_end_to_end_on_cpu(tmp_path, cudnn_tf32_on):
    rc, summary = _last_json(lambda: reh.main([
        "--cpu", "--files", "2", "--duration", "10", "--epochs", "2",
        "--batch-size", "2", "--d-model", "32",
        "--work-dir", str(tmp_path / "work"),
        "--report-dir", str(tmp_path / "report")]))
    assert summary["cli"] == {"infer": 0, "rt": 0, "export": 0}
    assert summary["epochs"] == 2 and summary["device"] == "cpu"
    # two steps of a random model cannot pass the gate: the failed report
    assert rc == 1
    report = Path(summary["report"])
    assert report.name == reh.REPORT_FAILED and report.exists()
    text = report.read_text()
    assert "2 epochs x 1 steps" in text and "- `export`: ok" in text
    # trained through the scan epochs, in chunks as the JAX script does
    assert "device-resident scan epochs" in text and "2 chunks" in text
    curves = (tmp_path / "report" / "rehearsal_curves_failed.jsonl"
              ).read_text().splitlines()
    assert len(curves) == 2 and "correlation" in json.loads(curves[0])
    assert len(summary["sweep"]) == len(reh.THRESH_SWEEP)


def test_demo_loss_falls_on_cpu(tmp_path, cudnn_tf32_on):
    rc, out = _last_json(lambda: demo_lipsync_learning.main([
        "--cpu", "--steps", "8", "--batch", "2",
        "--work-dir", str(tmp_path)]))
    assert rc == 0 and out["steps"] == 8
    assert np.isfinite(out["jaw_corr_before"])
    assert out["loss_last"] < out["loss_first"]


def test_reproduce_smoke_on_cpu(tmp_path, cudnn_tf32_on):
    rc, out = _last_json(lambda: reproduce_results.main([
        "--smoke", "--cpu", "--epochs", "2", "--val-every", "1",
        "--work-dir", str(tmp_path)]))
    assert rc == 0 and out["mode"] == "smoke" and out["epochs_run"] == 2
    assert np.isfinite(out["mae"]) and out["target_mae"] == 0.028
    report = Path(out["report"])
    assert report.parent == tmp_path
    assert "NOT corpus results" in report.read_text()
    assert (tmp_path / "checkpoints" / "best" / "state.pth").exists()
    assert np.isfinite([out["train_loss_first"], out["train_loss_last"]]
                       ).all()
    # learning shows on the held-out windows, the same in every round
    assert len(out["val_losses"]) == 2
    assert out["val_losses"][-1] < out["val_losses"][0]
