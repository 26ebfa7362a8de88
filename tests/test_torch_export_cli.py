"""PyTorch port: the export CLI (``export_model``) and the exporter's
helpers, on the CPU.

``export_model.main(["--device", "cpu", ...])`` runs at the flagship
window (d_model 32) and prints a passing report with its benchmark;
the TensorFlow formats and ``--quantize`` are refused naming pt2. The legacy ``SimplifiedKoeMorphModel`` of the JAX export tests
(d_model 32, 2 heads, 0.5 s) exports and reloads within 1e-5 of JAX's
forward on the same parameters (the mel and the attention, float32).
``verify_export`` refuses outputs with different leaf counts and
``benchmark_fn`` names its clock and device.
"""

import argparse
import json
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models.simplified import (
    SimplifiedKoeMorphModel as JaxSimplified)
from koemorph_tpu_torch import cli, export_model
from koemorph_tpu_torch.export import (benchmark_fn, benchmark_rounds,
                                       export_program, exporter,
                                       load_program, verify_export)
from koemorph_tpu_torch.models import (SimplifiedDualStreamModel,
                                       SimplifiedKoeMorphModel)
from koemorph_tpu_torch.utils.params import state_dict_from_flax

REPO = Path(__file__).resolve().parents[1]


def test_export_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """In process, at the flagship window (d_model 32, the basic emotion
    path: the eGeMAPS frame function's export is held against JAX in
    ``test_torch_export.py``), with ``--benchmark``'s alternating rounds
    (two here, of two calls)."""
    monkeypatch.setattr(export_model, "BENCHMARK_ROUNDS", 2)
    monkeypatch.setattr(exporter, "benchmark_fn", lambda fn, args, **kw:
                        benchmark_fn(fn, args, warmup=1, iters=2))
    rc = export_model.main(
        ["--device", "cpu", "--d-model", "32", "--num-heads", "2",
         "--emotion-backend", "basic", "--benchmark",
         "--output", str(tmp_path / "exports")])
    assert rc == 0
    (report,) = json.loads(capsys.readouterr().out)
    assert report["passed"] and report["format"] == "pt2"
    assert report["max_abs_diff"] < 1e-5
    path = Path(report["path"])
    assert path == tmp_path / "exports" / "model.pt2"
    assert path.stat().st_size == report["size_bytes"]
    rounds = report["latency_rounds_ms"]
    assert {k: len(v) for k, v in rounds.items()} == {"exported": 2,
                                                       "live": 2}
    assert report["latency_ms"] == float(np.median(rounds["exported"]))
    assert report["live_latency_ms"] == float(np.median(rounds["live"]))
    assert report["device"] == "cpu"


@pytest.mark.parametrize("argv,says", [
    (["--format", "saved_model"], "pt2"),
    (["--format", "tflite"], "pt2"),
    (["--format", "onnx"], "pt2"),
    (["--quantize", "dynamic"], "quantize"),
])
def test_export_cli_refuses_other_formats(argv, says, capsys):
    with pytest.raises(SystemExit) as exc:
        export_model.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


def test_export_cli_takes_reference_and_port_checkpoints(tmp_path):
    """A port checkpoint loads as it is; a reference ``.pth`` (no
    ``emotion_projection``) through the reference import."""
    args = argparse.Namespace(
        d_model=32, num_heads=2, fps=30, emotion_backend="egemaps",
        model=None)
    src = SimplifiedDualStreamModel(d_model=32, num_heads=2, dropout=0.0)
    src.init_random(torch.Generator().manual_seed(9))
    port = tmp_path / "port.pth"
    torch.save(src.state_dict(), port)
    ref = tmp_path / "reference.pth"
    torch.save({"model_state_dict": {
        k: v for k, v in src.state_dict().items()
        if not k.startswith("emotion_projection.")}}, ref)
    args.model = str(port)
    got = export_model.build_frame_function(args, torch.device("cpu"))
    assert all(torch.equal(v, src.state_dict()[k])
               for k, v in got.model.state_dict().items())
    args.model = str(ref)
    got = export_model.build_frame_function(args, torch.device("cpu"))
    sd = got.model.state_dict()
    assert torch.equal(sd["smoothing_alpha"], src.smoothing_alpha.detach())
    assert not torch.equal(sd["emotion_projection.weight"],
                           src.emotion_projection.weight.detach())


def test_console_script_is_declared():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["koemorph-torch-export"] == \
        "koemorph_tpu_torch.cli:export_main"
    assert cli.export_main is not None


def test_simplified_koemorph_export_matches_jax(tmp_path):
    """The JAX export tests' fixture (``tests/export/test_export.py``):
    the legacy simplified model at d_model 32, 2 heads, 0.5 s."""
    jm = JaxSimplified(d_model=32, num_heads=2, decoder_hidden=16,
                       dropout=0.0)
    audio = (np.random.default_rng(0).standard_normal((1, 8000))
             .astype(np.float32) * 0.1)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(audio))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(audio),
                               deterministic=True))
    model = SimplifiedKoeMorphModel(d_model=32, num_heads=2,
                                    decoder_hidden=16, dropout=0.0)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    report = export_program(model, (torch.from_numpy(audio),),
                            tmp_path / "simplified.pt2")
    assert report.passed, report.max_abs_diff
    program = load_program(report.path)
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    assert "koemorph_torch.logmel.default" in targets
    with torch.no_grad():
        got = program.module()(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (1, 52)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_export_program_takes_a_function(tmp_path):
    x = torch.linspace(-1.0, 1.0, 7)
    report = export_program(lambda t: (t * 2.0 + 1.0, t.exp()), (x,),
                            tmp_path / "fn.pt2")
    assert report.passed and report.max_abs_diff == 0.0
    with torch.no_grad():
        got = load_program(report.path).module()(x)
    assert torch.equal(got[0], x * 2.0 + 1.0)


def test_verify_export_and_benchmark_fn():
    x = torch.ones(3)
    ok, diff = verify_export(lambda t: (t, t + 1), lambda t: (t, t + 1),
                             (x,))
    assert ok and diff == 0.0
    ok, diff = verify_export(lambda t: t, lambda t: t + 1e-3, (x,))
    assert not ok and abs(diff - 1e-3) < 1e-6
    with pytest.raises(ValueError, match="leaf count"):
        verify_export(lambda t: (t, t), lambda t: (t,), (x,))
    stats = benchmark_fn(lambda t: t * 2, (x,), warmup=2, iters=5)
    assert set(stats) == {"latency_ms", "iters", "throughput_per_s",
                          "clock", "device"}
    assert stats["iters"] == 5 and stats["latency_ms"] > 0
    assert stats["clock"] == "perf_counter" and stats["device"] == "cpu"


def test_benchmark_rounds_alternate_the_order():
    x = torch.ones(3)
    calls = []
    fns = {name: (lambda t, name=name: calls.append(name))
           for name in ("a", "b")}
    got = benchmark_rounds(fns, (x,), rounds=3, warmup=1, iters=1)
    assert {k: len(v) for k, v in got.items()} == {"a": 3, "b": 3}
    # each side's warm call, then its timed one
    assert calls == ["a", "a", "b", "b", "b", "b", "a", "a", "a", "a",
                     "b", "b"]
