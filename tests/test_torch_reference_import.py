"""PyTorch port: importing a reference PyTorch checkpoint
(``koemorph_tpu_torch/utils/torch_import.py`` and the
``import_torch_checkpoint`` entry point) against the JAX package's
``model_params_from_state_dict``.

One synthetic reference state dict (the port model's names, no
``emotion_projection``, two frontend entries the import ignores; fixed
fusion adds the ``mel_weights`` / ``emotion_weights`` buffers) goes through
both imports onto the same initialized parameters (JAX's ``init``, carried
to the port through ``utils/params.py``). The imported state dicts are
held bitwise and the two models' blendshapes within 1e-5. The written
checkpoint loads in ``infer --device cpu`` and in ``build_streaming_model``
(``rt``, ``serve``), each taking the fusion mode from the file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel as JaxSimple)
from koemorph_tpu.models.dual_stream_model import (
    TemporalState as JaxTemporalState)
from koemorph_tpu.utils.torch_import import (load_torch_state_dict,
                                             model_params_from_state_dict)
from koemorph_tpu_torch import import_torch_checkpoint as cli
from koemorph_tpu_torch import infer
from koemorph_tpu_torch.data.wav import write_wav
from koemorph_tpu_torch.models.dual_stream_model import (
    SimplifiedDualStreamModel)
from koemorph_tpu_torch.runtime.engine import build_streaming_model
from koemorph_tpu_torch.utils.params import (read_state_dict,
                                             state_dict_from_flax)
from koemorph_tpu_torch.utils.torch_import import model_state_from_reference

HOP = 533
KW = dict(d_model=32, num_heads=2, mel_sequence_length=256,
          emotion_backend="basic", use_concatenation=True, dropout=0.0)
CLI = ["--d-model", "32", "--num-heads", "2", "--emotion-backend", "basic",
       "--device", "cpu"]


def _voice(n, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    phase = 2 * np.pi * np.cumsum(140 + 30 * np.sin(2 * np.pi * t)) / 16000
    x = np.sin(phase) + 0.4 * np.sin(2 * phase)
    return (0.3 * x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _port(learnable, **kw):
    return SimplifiedDualStreamModel(**{**KW, **kw},
                                     use_learnable_weights=learnable)


def _reference_pth(tmp_path, learnable, seed=3, **kw):
    """A reference trainer checkpoint: trained attention weights, no
    emotion projection, the reference's frontend entries, and the fixed
    masks as buffers when ``learnable`` is False."""
    model = _port(True, **kw)
    model.init_random(torch.Generator().manual_seed(seed))
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator()
                                    .manual_seed(i))
          for i, (k, v) in enumerate(model.state_dict().items())
          if not k.startswith("emotion_projection.")}
    if not learnable:
        att = _port(False, **kw).dual_stream_attention
        sd["dual_stream_attention.mel_weights"] = att.mel_weights.clone()
        sd["dual_stream_attention.emotion_weights"] = \
            att.emotion_weights.clone()
    sd["mel_extractor.mel_basis"] = torch.ones(80, 513)
    sd["emotion_extractor.scale"] = torch.ones(3)
    path = tmp_path / f"reference_{learnable}.pth"
    torch.save({"model_state_dict": sd, "epoch": 7}, path)
    return path


def _jax_init(learnable):
    model = JaxSimple(**KW, use_learnable_weights=learnable)
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 256 * HOP)),
        JaxTemporalState.create(1))["params"]
    return model, params


@pytest.mark.parametrize("learnable", [True, False])
def test_import_matches_jax(tmp_path, learnable):
    pth = _reference_pth(tmp_path, learnable)
    jmodel, jinit = _jax_init(learnable)
    jparams = model_params_from_state_dict(load_torch_state_dict(pth),
                                           jinit)
    port = _port(learnable)
    port.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jinit)))
    got = model_state_from_reference(read_state_dict(pth), port)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    port.load_state_dict(got)
    audio = np.stack([_voice(256 * HOP, s) for s in (1, 2)])
    jout = jmodel.apply({"params": jparams}, jnp.asarray(audio),
                        deterministic=True)["blendshapes"]
    with torch.no_grad():
        pout = port.eval()(torch.from_numpy(audio))["blendshapes"]
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


def test_import_errors(tmp_path):
    port = _port(True)
    sd = read_state_dict(_reference_pth(tmp_path, True))
    # a fixed-fusion checkpoint into a learnable model: JAX's message
    fixed = {k: v for k, v in sd.items()
             if not k.endswith(("mel_weights", "emotion_weights"))}
    with pytest.raises(ValueError, match="trained with fixed fusion"):
        model_state_from_reference(fixed, port)
    _, jinit = _jax_init(True)
    with pytest.raises(ValueError, match="trained with fixed fusion"):
        model_params_from_state_dict(
            {k: v.numpy() for k, v in fixed.items()}, jinit)
    missing = dict(sd)
    del missing["dual_stream_attention.mel_norm.bias"]
    with pytest.raises(ValueError, match=r"missing attention.*mel_norm"):
        model_state_from_reference(missing, port)
    # a surplus attention name other than the fusion pair raises (JAX's
    # import reads the names it maps and ignores the rest)
    surplus = {**sd, "dual_stream_attention.extra.weight": torch.ones(2)}
    with pytest.raises(ValueError, match="does not expect.*extra"):
        model_state_from_reference(surplus, port)
    # a learnable checkpoint into a fixed model drops the pair, as JAX's
    fixed_model = _port(False)
    state = model_state_from_reference(sd, fixed_model)
    assert "dual_stream_attention.mel_weights" not in state


def test_wrong_width_names_the_flag(tmp_path):
    pth = _reference_pth(tmp_path, True)
    with pytest.raises(ValueError, match="shape mismatch at dual_stream_"
                                         "attention.*--d-model"):
        cli.main([str(pth), "--output", str(tmp_path / "o"),
                  "--d-model", "64", "--num-heads", "2",
                  "--emotion-backend", "basic", "--device", "cpu"])
    _, jinit = _jax_init(True)
    wide = SimplifiedDualStreamModel(**{**KW, "d_model": 64})
    wide.init_random(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shape mismatch"):
        model_params_from_state_dict(
            {k: v.numpy() for k, v in wide.state_dict().items()}, jinit)


@pytest.mark.parametrize("learnable", [True, False])
def test_cli_checkpoint_serves(tmp_path, learnable):
    pth = _reference_pth(tmp_path, learnable)
    out = tmp_path / "imported"
    argv = [str(pth), "--output", str(out), *CLI]
    assert cli.main(argv + ([] if learnable else ["--fixed-fusion"])) == 0
    meta = json.loads((out / "meta.json").read_text())
    assert meta["config"] == {"imported_from": str(pth),
                              "source": "torch-reference"}
    sd = read_state_dict(out)
    assert ("dual_stream_attention.mel_weights" in sd) == learnable
    ref = read_state_dict(pth)
    for k in ref:
        if k in sd:
            assert torch.equal(sd[k], ref[k]), k
    wav = tmp_path / "in.wav"
    write_wav(wav, _voice(300 * HOP), 16000)
    rows = tmp_path / "rows.jsonl"
    assert infer.main(["--input", str(wav), "--output", str(rows),
                       "--model", str(out), *CLI]) == 0
    got = [json.loads(x) for x in rows.read_text().splitlines()]
    assert len(got) == 45 and all(len(r["blendshapes"]) == 52 for r in got)
    model, cfg = build_streaming_model(d_model=32, num_heads=2,
                                       emotion_backend="basic",
                                       checkpoint=str(out), device="cpu")
    assert cfg.use_learnable_weights == learnable
    assert torch.equal(model.smoothing_alpha.detach(),
                       sd["smoothing_alpha"])
