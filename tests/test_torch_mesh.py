"""PyTorch port: device meshes, the session-sharded server and the mesh
decode, against the JAX package's mesh code on its 8 virtual CPU devices.

One process drives every entry of an inference mesh; the port's CPU mesh
lists the CPU once per entry. Held:

- ``shard_batch``'s blocks equal JAX's ``addressable_shards`` on
  ``make_mesh(4)`` (0-d leaves replicated); ``make_mesh`` raises where
  JAX's does, and without CUDA unless the entries are named;
- ``MultiStreamInference`` over 4 entries (16 lanes, 2 cohorts, a lane of
  the second entry reset) at the tiny configuration of
  ``tests/test_torch_multistream.py`` with the ``basic`` emotion backend
  against JAX's ``MultiStreamInference(mesh=make_mesh(4))`` at 1e-6
  absolute, and against the port's one-device server at 1e-6
  (``tests/parallel/``'s sharded-vs-unsharded bound); with the eGeMAPS
  backend (the LLD ring and carry split over the entries) against the
  port's one-device server at 1e-6, states included (JAX's eGeMAPS mesh
  server compiles for ~25 s, so that layout is held port against port and
  the one-device eGeMAPS server against JAX in
  ``tests/test_torch_multistream.py``);
- ``serve --device cpu --mesh-devices 2`` rows against the one-device
  rows at 1e-6 (the entries' products run at other batch sizes);
- ``BatchedSequentialDecoder`` over 4 entries: ``__call__`` and
  ``decode_scheduled`` against JAX's 4-device decoder at 1e-5 (the
  port-vs-JAX decode bound of ``tests/test_torch_sequential.py``) and
  against the port's one-device decoder at 1e-7, and
  ``decode_sequence_parallel`` at 1e-6 against both.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.models import dual_stream_model as jdm
from koemorph_tpu.parallel import BatchedSequentialDecoder as JaxDecoder
from koemorph_tpu.parallel import mesh as jmesh
from koemorph_tpu.runtime import MultiStreamInference as JaxMultiStream
from koemorph_tpu.runtime import streaming as jax_streaming
from koemorph_tpu_torch import serve
from koemorph_tpu_torch.data.wav import write_wav
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.parallel import (BatchedSequentialDecoder, DATA_AXIS,
                                         batch_sharding, distributed,
                                         local_batch_size, make_mesh,
                                         replicate, replicated_sharding,
                                         shard_batch)
from koemorph_tpu_torch.runtime import MultiStreamInference, streaming
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from tests.test_torch_multistream import _lanes
from tests.test_torch_streaming import HOP, KW

torch.set_num_threads(2)


def _cpu_mesh(n: int):
    return make_mesh(devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# mesh functions
# ---------------------------------------------------------------------------

def test_shard_batch_blocks_equal_jax_shards():
    batch = {"audio": np.arange(40, dtype=np.float32).reshape(8, 5),
             "mask": np.arange(8, dtype=np.int32),
             "step": np.float32(3.0)}
    jm = jmesh.make_mesh(4)
    placed = jmesh.shard_batch(batch, jm)
    mesh = _cpu_mesh(4)
    blocks = shard_batch(batch, mesh)
    assert len(blocks) == mesh.size == mesh.devices.shape[0] == 4
    assert mesh.shape == {DATA_AXIS: 4} and not mesh.distributed
    order = {d: i for i, d in enumerate(jm.devices.tolist())}
    for key in ("audio", "mask"):
        shards = sorted(placed[key].addressable_shards,
                        key=lambda s: order[s.device])
        for block, shard in zip(blocks, shards):
            np.testing.assert_array_equal(block[key].numpy(),
                                          np.asarray(shard.data))
            assert block[key].dtype == torch.from_numpy(
                np.asarray(shard.data)).dtype
    for block in blocks:
        assert float(block["step"]) == float(placed["step"])
        assert block["step"].dim() == 0
    assert local_batch_size(8, mesh) == jmesh.local_batch_size(8, jm) == 2
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(6, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"a": np.zeros((6, 2))}, mesh)
    assert batch_sharding(mesh).spec == (DATA_AXIS,)
    assert replicated_sharding(mesh).spec == ()
    copies = replicate({"w": torch.ones(3)}, mesh)
    assert len(copies) == 4 and copies[0]["w"] is not copies[1]["w"]


def test_make_mesh_raises_as_jax():
    with pytest.raises(ValueError, match="Requested 9 devices, have 8"):
        jmesh.make_mesh(9)
    with pytest.raises(ValueError, match="Requested 5 devices, have 4"):
        make_mesh(5, devices=["cpu"] * 4)
    assert make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError):
        make_mesh(0, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


def test_process_group_initialization_raises(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.launched()
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.init_process_group(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="nccl"):
        distributed.init_process_group("nccl", "cpu")
    assert not distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0


# ---------------------------------------------------------------------------
# the session-sharded server
# ---------------------------------------------------------------------------

BASIC = dict(KW, emotion_backend="basic")


@pytest.fixture(scope="module")
def server_model():
    """The eGeMAPS server's model (random weights) and its config."""
    cfg = streaming.StreamingConfig(**KW)
    model = streaming.model_for_config(cfg)
    model.init_random(torch.Generator().manual_seed(3))
    return cfg, model


def _step_all(servers, audio, frames, reset_at):
    """(frames, S, 52) of each server, lane 5 (the second entry's lane 1
    of four) reset before frame ``reset_at``."""
    out = [[] for _ in servers]
    for i in range(frames):
        if i == reset_at:
            for s in servers:
                s.reset_sessions([5])
        hop = audio[:, i * HOP:(i + 1) * HOP]
        for o, s in zip(out, servers):
            o.append(np.asarray(s.step(hop)))
    return [np.stack(o) for o in out]


def test_mesh_server_matches_jax_mesh():
    model = jdm.SimplifiedDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16,
        emotion_backend="precomputed", dropout=0.0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16 * HOP)),
        jdm.TemporalState.create(1),
        emotion_features_raw=jnp.zeros((1, 9)))["params"])
    cfg = streaming.StreamingConfig(**BASIC)
    tm = streaming.model_for_config(cfg)
    tm.load_state_dict(state_dict_from_flax(params))
    n, g, frames = 16, 2, 3
    audio = _lanes(n, frames, seed=50)
    jserver = JaxMultiStream(params, jax_streaming.StreamingConfig(**BASIC),
                             n, mesh=jmesh.make_mesh(4), refresh_cohorts=g)
    server = MultiStreamInference(tm, cfg, n, mesh=_cpu_mesh(4),
                                  refresh_cohorts=g)
    one = MultiStreamInference(tm, cfg, n, device="cpu", refresh_cohorts=g)
    assert server.num_devices == 4 and len(server.entries) == 4
    assert [e.n_sessions for e in server.entries] == [4] * 4
    assert server.clocks == one.clocks == np.asarray(
        jserver.states.frame_count).tolist()
    want, got, ref = _step_all([jserver, server, one], audio, frames, 2)
    assert got.shape == (frames, n, 52)
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(got - ref).max() <= 1e-6
    assert server.clocks == one.clocks == np.asarray(
        jserver.states.frame_count).tolist()
    np.testing.assert_allclose(server.states.emotion_raw.numpy(),
                               np.asarray(jserver.states.emotion_raw),
                               rtol=1e-5, atol=1e-6)


def test_mesh_server_egemaps_matches_one_device(server_model):
    cfg, model = server_model
    n, g, frames = 16, 2, 2 * KW["emotion_update_frames"] + 1
    audio = _lanes(n, frames, seed=50)
    server = MultiStreamInference(model, cfg, n, mesh=_cpu_mesh(4),
                                  refresh_cohorts=g)
    one = MultiStreamInference(model, cfg, n, device="cpu",
                               refresh_cohorts=g)
    got, ref = _step_all([server, one], audio, frames, 4)
    assert np.abs(got - ref).max() <= 1e-6
    assert server.clocks == one.clocks
    st, ref_st = server.states, one.states
    assert st.frame_count == frames
    for a, b in ((st.emotion_raw, ref_st.emotion_raw),
                 (st.temporal.prev, ref_st.temporal.prev),
                 (st.mel_db, ref_st.mel_db)):
        assert (a - b).abs().max() <= 1e-6 * max(1.0, float(b.abs().max()))
    assert torch.equal(st.temporal.initialized, ref_st.temporal.initialized)
    assert torch.equal(st.audio_ring, ref_st.audio_ring)
    assert (st.emotion_raw.abs().amax(-1) > 0).all()
    pairs = [(st.lld_ring[k], v) for k, v in ref_st.lld_ring.items()]
    pairs += [(a, b) for a, b in zip(st.lld_carry, ref_st.lld_carry)
              if b is not None]
    assert len(pairs) > len(ref_st.lld_ring)
    for a, b in pairs:
        a, b = a.double(), b.double()
        assert (a - b).abs().max() <= 1e-6 * max(1.0, float(b.abs().max()))


def test_mesh_server_validation(server_model):
    cfg, model = server_model
    with pytest.raises(ValueError, match="divide over the mesh"):
        MultiStreamInference(model, cfg, 6, mesh=_cpu_mesh(4))
    with pytest.raises(ValueError, match="each cohort"):
        MultiStreamInference(model, cfg, 4, mesh=_cpu_mesh(4),
                             refresh_cohorts=2)
    with pytest.raises(ValueError, match="not both"):
        MultiStreamInference(model, cfg, 4, mesh=_cpu_mesh(2), device="cpu")
    server = MultiStreamInference(model, cfg, 4, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="expected"):
        server.step(np.zeros((3, HOP), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        server.reset_sessions([4])
    server.warmup(torch.int16)
    pcm = np.random.default_rng(1).integers(-3000, 3000, (4, HOP),
                                            dtype=np.int16)
    a = server.step(pcm)
    b = MultiStreamInference(model, cfg, 4, mesh=_cpu_mesh(2)).step(
        pcm.astype(np.float32) / 32768.0)
    assert torch.equal(a, b)                 # int16 in, converted on device


def test_serve_cli_mesh_rows_equal_one_device(tmp_path, capsys):
    t = np.arange(int(0.6 * 16000)) / 16000
    wav = tmp_path / "a.wav"
    write_wav(wav, (0.4 * np.sin(2 * np.pi * 160 * t)).astype(np.float32),
              16000)
    rows, stats = {}, {}
    for n in (0, 2):
        out = tmp_path / f"o{n}.jsonl"
        assert serve.main([
            "--replay", str(wav), "--sessions", "4", "--refresh-cohorts",
            "2", "--output", "file", "--output-file", str(out),
            "--no-realtime", "--max-frames", "4", "--device", "cpu",
            "--d-model", "32", "--num-heads", "2",
            "--mesh-devices", str(n)]) == 0
        rows[n] = [json.loads(line) for line in out.read_text().splitlines()]
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if '"performance_stats"' in ln][-1]
        stats[n] = json.loads(line)["performance_stats"]
    assert [r["session"] for r in rows[2]] == [r["session"] for r in rows[0]]
    assert len(rows[2]) == 16
    got = np.asarray([r["blendshapes"] for r in rows[2]])
    want = np.asarray([r["blendshapes"] for r in rows[0]])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert stats[0]["devices"] == 1 and stats[2]["devices"] == 2
    assert serve.mesh_for("cpu", 0) is None
    assert serve.mesh_for("cpu", 3).size == 3


# ---------------------------------------------------------------------------
# the mesh decode
# ---------------------------------------------------------------------------

def test_mesh_decode_matches_jax_mesh():
    kw = dict(d_model=32, num_heads=2, mel_sequence_length=16,
              stride_frames=3, target_fps=30, emotion_backend="basic",
              use_concatenation=False)
    jm = jdm.SequentialDualStreamModel(**kw, dropout=0.0)
    rng = np.random.default_rng(2)
    audio = (0.2 * rng.standard_normal((4, 40 * HOP))).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.asarray(audio[:1]))["params"]
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, np.shape(x))).astype(
            np.float32), params)
    tm = dm.SequentialDualStreamModel(**kw)
    tm.load_state_dict(state_dict_from_flax(params))
    jdec = JaxDecoder(jm, params, mesh=jmesh.make_mesh(4))
    dec = BatchedSequentialDecoder(tm, mesh=_cpu_mesh(4))
    one = BatchedSequentialDecoder(tm, device="cpu")
    assert dec.num_devices == jdec.num_devices == 4

    got = dec(audio)
    assert got.shape == (4, 9, 52)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdec(audio)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), one(audio).numpy(), rtol=0,
                               atol=1e-7)

    strides = [1, 2, 3, 5]
    out, mask = dec.decode_scheduled(audio, strides)
    jout, jmask = jdec.decode_scheduled(audio, strides)
    ref, ref_mask = one.decode_scheduled(audio, strides)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-7)

    seq = dec.decode_sequence_parallel(audio[2])
    assert seq.shape == (9, 52)
    np.testing.assert_allclose(
        seq.numpy(), np.asarray(jdec.decode_sequence_parallel(audio[2])),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(seq.numpy(), one(audio[2:3])[0].numpy(),
                               rtol=0, atol=1e-6)
    assert dec.throughput_stats(audio, iters=1)["devices"] == 4
    with pytest.raises(ValueError, match="not divisible"):
        dec(audio[:3])
    with pytest.raises(ValueError, match="not divisible"):
        dec.decode_scheduled(audio[:2], 1)
    assert BatchedSequentialDecoder(tm, devices=["cpu"] * 2).num_devices == 2
