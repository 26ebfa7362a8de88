"""PyTorch port: ``test_model`` for the dual-stream model names.

``python -m koemorph_tpu_torch.test_model --model-name
simplified_dual_stream`` and ``--model-name sequential_dual_stream`` (the
eGeMAPS backend, so the forms of K1, K2 and K3 on the CPU) against the
JAX package's ``scripts/test_model.py`` with the same flags, at d_model 32,
on one batch of the same synthetic 10 s file. The JAX script evaluates its
own ``PRNGKey(0)`` initialization; the test reads those parameters where
the script would load a checkpoint, converts them with
``state_dict_from_flax`` and gives them to the port as a ``.pth``. Every
metric within 1e-5 absolute.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import koemorph_tpu.train.checkpoint as jax_checkpoint
from koemorph_tpu_torch import test_model as port_test_model
from koemorph_tpu_torch.train.__main__ import write_synthetic_dataset
from koemorph_tpu_torch.utils.params import state_dict_from_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
METRIC_ATOL = 1e-5


def _jax_script(monkeypatch):
    """``scripts/test_model.py`` as a module, without the persistent
    compilation cache it turns on at import."""
    monkeypatch.setenv("KOEMORPH_COMPILE_CACHE", "off")
    spec = importlib.util.spec_from_file_location(
        "jax_test_model", REPO / "scripts" / "test_model.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_json(fn) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert fn() == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["simplified_dual_stream",
                                  "sequential_dual_stream"])
def test_dual_stream_names_match_jax(name, tmp_path, monkeypatch):
    data = write_synthetic_dataset(tmp_path / "data", 1, duration_s=10.0)
    flags = ["--data-dir", str(data), "--model-name", name,
             "--d-model", "32", "--num-heads", "2", "--batch-size", "1",
             "--max-batches", "1"]
    script = _jax_script(monkeypatch)
    seen = {}

    def keep_init(path, target):
        """The script's initial parameters, kept, in place of a load."""
        seen["params"] = target
        return target, {}

    monkeypatch.setattr(jax_checkpoint, "load_checkpoint", keep_init)
    monkeypatch.setattr(sys, "argv", ["test_model.py", *flags, "--cpu",
                                      "--model", "init"])
    want = _last_json(script.main)

    pth = tmp_path / "params.pth"
    torch.save(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, seen["params"])), pth)
    got = _last_json(lambda: port_test_model.main(
        [*flags, "--device", "cpu", "--model", str(pth)]))

    assert sorted(got) == sorted(want) and got["batches"] == 1.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=METRIC_ATOL,
                                   err_msg=k)
