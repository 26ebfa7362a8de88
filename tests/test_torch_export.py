"""PyTorch port: the kernels as ``torch.library`` operators and the frame
function exported through ``torch.export`` (``ops/library.py``,
``export/``), on the CPU.

A tiny egemaps ``SimplifiedDualStreamModel`` (d_model 32, 2 heads, a
32-frame window, the 264-D concatenation) carries JAX's parameters. Its
frame function is exported in a fresh process before any live call (the
constant caches cold), and a live call after the export is held within
1e-6 of the same call in this process (float32, two processes). The
``.pt2`` is reloaded in another fresh process that imports only the
port; over 3 calls with the EMA carry threaded its outputs are held
within 1e-5 of JAX's frame function on the same parameters (the
blendshapes through the eGeMAPS chain, the mel and the attention; the
model tests' bound). The program's graph holds the three operators.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.library import opcheck

from koemorph_tpu.models import dual_stream_model as jdm
from koemorph_tpu_torch.export import FrameFunction
from koemorph_tpu_torch.integration_check import synth_speech
from koemorph_tpu_torch.models.dual_stream_model import (
    SimplifiedDualStreamModel)
from koemorph_tpu_torch.ops import library
from koemorph_tpu_torch.ops.window import frame_signal
from koemorph_tpu_torch.utils.params import state_dict_from_flax

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(d_model=32, num_heads=2, mel_sequence_length=32)
LENGTH = 32 * 533
CALLS = 3

EXPORT_CODE = """
import json, sys
import numpy as np, torch
from koemorph_tpu_torch.export import FrameFunction, export_program
from koemorph_tpu_torch.models.dual_stream_model import (
    SimplifiedDualStreamModel)
tmp = sys.argv[1]
model = SimplifiedDualStreamModel(d_model=32, num_heads=2,
                                  mel_sequence_length=32, dropout=0.0)
model.load_state_dict(torch.load(tmp + '/state.pth'))
frame = FrameFunction(model.eval())
audio = torch.from_numpy(np.load(tmp + '/inputs.npz')['audio'][0])
args = (audio, torch.zeros(1, 52), torch.zeros(1, dtype=torch.bool))
report = export_program(frame, args, tmp + '/frame.pt2')
with torch.no_grad():
    after = frame(*args)
np.save(tmp + '/live_after.npy', after[0].numpy())
print(json.dumps(report.as_dict()))
"""

RELOAD_CODE = """
import json, sys
import numpy as np, torch
from koemorph_tpu_torch.export import load_program
import koemorph_tpu_torch.ops.cuda as ck
tmp = sys.argv[1]
loaded = load_program(tmp + '/frame.pt2')
# registering the operators and loading built no kernel, touched no CUDA
print(json.dumps({'kernels_built': sorted(ck._LIBS),
                  'cuda_initialized': torch.cuda.is_initialized(),
                  'targets': sorted({str(n.target) for n in loaded.graph.nodes
                                     if n.op == 'call_function'})}))
program = loaded.module()
audio = np.load(tmp + '/inputs.npz')['audio']
prev, init = torch.zeros(1, 52), torch.zeros(1, dtype=torch.bool)
outs = []
with torch.no_grad():
    for a in audio:
        b, prev, init = program(torch.from_numpy(a), prev, init)
        outs.append(b.numpy())
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'koemorph_tpu'))
assert not bad, bad
np.save(tmp + '/reloaded.npy', np.stack(outs))
"""


def _start(code: str, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return out


def _run(code: str, *args) -> str:
    return _finish(_start(code, *args))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's parameters in the port's names and the inputs under a
    temporary directory; the frame function exported from them in a fresh
    process while JAX's frame function runs its 3 carried calls here; the
    program then reloaded and run in another fresh process."""
    tmp = tmp_path_factory.mktemp("export")
    audio = np.stack([synth_speech(LENGTH / 16000, seed=s)[None]
                      for s in range(CALLS)])                 # (3, 1, L)
    jm = jdm.SimplifiedDualStreamModel(**SMALL, dropout=0.0)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(audio[0]),
        jdm.TemporalState.create(1), jnp.zeros((1, 264)))["params"]
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    torch.save(sd, tmp / "state.pth")
    np.savez(tmp / "inputs.npz", audio=audio)
    exporting = _start(EXPORT_CODE, tmp)

    @jax.jit
    def step(p, a, prev, init):
        out, st = jm.apply({"params": p}, a,
                           jdm.TemporalState(prev=prev, initialized=init))
        return out["blendshapes"], st.prev, st.initialized

    prev, init = jnp.zeros((1, 52)), jnp.zeros((1,), bool)
    want = []
    for a in audio:
        b, prev, init = step(params, jnp.asarray(a), prev, init)
        want.append(np.asarray(b))
    report = json.loads(_finish(exporting).strip().splitlines()[-1])
    reloaded = json.loads(_run(RELOAD_CODE, tmp).strip().splitlines()[-1])
    model = SimplifiedDualStreamModel(**SMALL, dropout=0.0)
    model.load_state_dict(sd)
    return {"tmp": tmp, "want": np.stack(want), "audio": audio,
            "frame": FrameFunction(model.eval()), "report": report,
            "reloaded": reloaded}


def _k1_args(strided: bool):
    rng = np.random.default_rng(0)
    rows, n = 6, 512
    if strided:
        signal = torch.from_numpy(rng.standard_normal(
            160 * (rows - 1) + n).astype(np.float32))
        frames = frame_signal(signal, n, 160, center=False)
        assert not frames.is_contiguous()
    else:
        frames = torch.from_numpy(rng.standard_normal((rows, n)).astype(
            np.float32))
    start = torch.from_numpy(rng.integers(0, 200, rows).astype(np.int32))
    tau = torch.from_numpy(rng.uniform(40, 200, rows).astype(np.float32))
    off = torch.from_numpy(rng.uniform(0, 20, rows).astype(np.float32))
    return (frames, start, tau, off, 8, 8)


@pytest.mark.parametrize("name,args", [
    ("cycle_dsum", _k1_args(False)),
    ("cycle_dsum", _k1_args(True)),
    ("dk_roots", (torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 11)).astype(np.float32)),)),
    ("logmel", (torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 1024)).astype(np.float32)), 16000, 80, 80.0, 8000.0)),
])
def test_operators_pass_opcheck(name, args):
    op = getattr(torch.ops.koemorph_torch, name).default
    opcheck(op, args)
    out = op(*args)
    fake = {"cycle_dsum": (6, 8, 17), "dk_roots": (5, 10),
            "logmel": (4, 80)}[name]
    assert tuple(out.shape) == fake
    assert out.dtype == (torch.complex64 if name == "dk_roots"
                         else torch.float32)


def test_registering_touches_no_cuda(case):
    assert case["reloaded"]["kernels_built"] == []
    assert case["reloaded"]["cuda_initialized"] is False


def test_export_gate_and_graph_hold_the_three_operators(case):
    report = case["report"]
    assert report["passed"] and report["format"] == "pt2"
    assert report["max_abs_diff"] < 1e-5 and report["size_bytes"] > 0
    targets = set(case["reloaded"]["targets"])
    assert {f"{op}.default" for op in library.OPS} <= targets


def test_reloaded_program_matches_jax(case):
    got = np.load(case["tmp"] / "reloaded.npy")
    assert got.shape == case["want"].shape == (CALLS, 1, 52)
    np.testing.assert_allclose(got, case["want"], rtol=0, atol=1e-5)
    # the carry was threaded: the smoothed calls differ from a fresh one
    assert np.abs(got[1] - got[0]).max() > 0


def test_live_call_after_a_cold_export_is_unchanged(case):
    args = (torch.from_numpy(case["audio"][0]), torch.zeros(1, 52),
            torch.zeros(1, dtype=torch.bool))
    with torch.no_grad():
        live = case["frame"](*args)[0]
    assert type(live) is torch.Tensor
    after = np.load(case["tmp"] / "live_after.npy")
    np.testing.assert_allclose(after, live.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(live.numpy(), case["want"][0], rtol=0,
                               atol=1e-5)
