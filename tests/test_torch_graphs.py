"""PyTorch port: the compiled step (static buffers, CUDA graphs).

On the card every step of the stream, the server and the decode is a CUDA
graph replay of a body that reads static input buffers and writes a
static state in place (``runtime/graphs.py``). The CPU has no graphs, so
these tests hold what the graphs are built from: the static-buffer steps,
run eagerly, give bitwise the outputs of the functional step
(``stream_frame``, and the ``_stream_pre`` / ``_stream_refresh`` /
``_stream_post`` composition for the lane-batched server) at a tiny
eGeMAPS configuration (the one ``test_torch_streaming`` holds against
JAX), including lane resets and int16 input; an output never changes
after it is returned; and no captured body copies between host and device
or waits for it (every such call is patched to raise while the bodies
run). The launch accounting under graphs (the wrappers count a capture's
launches, which each replay runs again) and the cached device constants a
capture holds are held here too.
"""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from koemorph_tpu_torch.models.dual_stream_model import (
    SequentialDualStreamModel)
from koemorph_tpu_torch.ops import cuda as ck
from koemorph_tpu_torch.ops import device_cache
from koemorph_tpu_torch.parallel.batched_decode import (
    BatchedSequentialDecoder)
from koemorph_tpu_torch.runtime import (MultiStreamInference,
                                        StreamingInference, streaming)
from koemorph_tpu_torch.runtime.graphs import StepGraphs
from tests.test_torch_streaming import HOP, KW, _voice

torch.set_num_threads(2)

K = KW["emotion_update_frames"]


@pytest.fixture(scope="module")
def tcfg():
    return streaming.StreamingConfig(**KW)


@pytest.fixture(scope="module")
def model(tcfg):
    m = streaming.model_for_config(tcfg)
    m.init_random(torch.Generator().manual_seed(3))
    return m


def _pcm(n_lanes: int, n_frames: int, seed: int = 0) -> np.ndarray:
    """(S, T*hop) int16 voiced audio, a different seed and gain per lane."""
    x = np.stack([_voice(n_frames * HOP, seed=seed + s) * g for s, g in
                  zip(range(n_lanes), (1.0, 0.05, 2.0, 0.5))])
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype(np.int16)


def _functional_step(model, cfg, st, hops, due, g):
    """The server's step as a composition of the functional pieces: new
    tensors for every field, the due cohorts refreshed on ``[c::G]``."""
    ring, mel_db, mel, detail = streaming._stream_pre(st, hops, cfg)
    emo = st.emotion_raw.clone()
    lld = {k: v.clone() for k, v in st.lld_ring.items()}
    carry = streaming._map_carry(torch.clone, st.lld_carry)
    for c in due:
        lanes = slice(c, None, g)
        cohort = dataclasses.replace(
            st, emotion_raw=emo[lanes],
            lld_ring={k: v[lanes] for k, v in lld.items()},
            lld_carry=streaming._map_carry(lambda f: f[lanes], carry))
        feats, ring_c, carry_c = streaming._stream_refresh(
            cohort, ring[lanes], cfg, True)
        emo[lanes] = feats
        for k, v in ring_c.items():
            lld[k][lanes] = v
        for dst, src in zip(carry, carry_c):
            if dst is not None:
                dst[lanes] = src
    out, temporal = streaming._stream_post(model, mel, detail, emo,
                                           st.temporal)
    return out, streaming.StreamState(
        audio_ring=ring, mel_db=mel_db, emotion_raw=emo,
        frame_count=st.frame_count + 1, temporal=temporal, lld_ring=lld,
        lld_carry=carry)


def _reset_lane(cfg, st, lane):
    """``st`` with lane ``lane`` replaced by a fresh session (new
    tensors)."""
    fresh = streaming.init_stream_state(cfg, "cpu", 1)

    def put(old, new):
        old = old.clone()
        old[lane] = new[0]
        return old

    return streaming.StreamState(
        audio_ring=put(st.audio_ring, fresh.audio_ring),
        mel_db=put(st.mel_db, fresh.mel_db),
        emotion_raw=put(st.emotion_raw, fresh.emotion_raw),
        frame_count=st.frame_count,
        temporal=type(st.temporal)(
            prev=put(st.temporal.prev, fresh.temporal.prev),
            initialized=put(st.temporal.initialized,
                            fresh.temporal.initialized)),
        lld_ring={k: put(v, fresh.lld_ring[k])
                  for k, v in st.lld_ring.items()},
        lld_carry=type(st.lld_carry)(*(
            None if f is None else put(f, n)
            for f, n in zip(st.lld_carry, fresh.lld_carry))))


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("cohorts", [1, 2])
@pytest.mark.parametrize("voice_quality", ["per_period", "frame_level"])
def test_static_server_step_equals_functional(tcfg, model, cohorts, dtype,
                                              voice_quality):
    """Ping-pong rings and dB rows, refresh fields and EMA carry in place:
    bitwise the functional composition over 2K+1 steps, with a lane reset
    at a refresh boundary and one mid-cadence; with frame-level voice
    quality the LLD carry's period, voicing (bool) and RMS fields too."""
    if voice_quality == "frame_level":
        tcfg = dataclasses.replace(tcfg, egemaps_per_period=False)
    n_steps, lanes = 2 * K + 1, 4
    pcm = _pcm(lanes, n_steps)
    as_float = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    feed = torch.from_numpy(pcm) if dtype == "int16" else as_float
    server = MultiStreamInference(model, tcfg, lanes, device="cpu",
                                  refresh_cohorts=cohorts)
    server.warmup(getattr(torch, dtype))
    ref = streaming.init_stream_state(tcfg, "cpu", lanes)
    resets = {K: 1, K + 2: 2}
    with torch.inference_mode():
        for i in range(n_steps):
            if i in resets:
                server.reset_sessions([resets[i]])
                ref = _reset_lane(tcfg, ref, resets[i])
            due = server.due_cohorts()
            sl = slice(i * HOP, (i + 1) * HOP)
            got = server.step(feed[:, sl])
            want, ref = _functional_step(model, tcfg, ref, as_float[:, sl],
                                         due, cohorts)
            assert torch.equal(got, want), i
            st = server.states
            assert torch.equal(st.audio_ring, ref.audio_ring), i
            assert torch.equal(st.mel_db, ref.mel_db), i
            assert torch.equal(st.emotion_raw, ref.emotion_raw), i
            assert torch.equal(st.temporal.prev, ref.temporal.prev), i
            for k, v in ref.lld_ring.items():
                assert torch.equal(st.lld_ring[k], v), (i, k)
            for a, b in zip(st.lld_carry, ref.lld_carry):
                assert (a is None) == (b is None), i
                assert a is None or torch.equal(a, b), i
            assert (st.lld_carry.prev_voiced is None) == (
                voice_quality == "per_period")
    assert st.frame_count == n_steps


def test_static_stream_equals_stream_frame(tcfg, model):
    """The engine's in-place step (both branches, both parities) is
    bitwise ``stream_frame``, before and after a reset."""
    audio = _voice(3 * K * HOP, seed=5)
    eng = StreamingInference(model, tcfg, device="cpu")
    eng.warmup()

    def reference(samples):
        st = streaming.init_stream_state(tcfg, "cpu")
        out = []
        with torch.inference_mode():
            for i in range(len(samples) // HOP):
                o, st = streaming.stream_frame(
                    model, st, torch.from_numpy(samples[i * HOP:(i + 1) * HOP]),
                    tcfg)
                out.append(o["blendshapes"].numpy())
        return np.stack(out), st

    want, st = reference(audio)
    got = np.stack(eng.process_audio(audio))
    np.testing.assert_array_equal(got, want)
    assert torch.equal(eng.state.emotion_raw, st.emotion_raw)
    assert torch.equal(eng.state.audio_ring, st.audio_ring)
    assert eng.state.frame_count == st.frame_count == 3 * K
    eng.reset()
    part = audio[:K * HOP + HOP]
    np.testing.assert_array_equal(np.stack(eng.process_audio(part)),
                                  reference(part)[0])


def test_returned_outputs_are_never_written(tcfg, model):
    pcm = _pcm(2, 5, seed=7)
    server = MultiStreamInference(model, tcfg, 2, device="cpu",
                                  refresh_cohorts=2)
    eng = StreamingInference(model, tcfg, device="cpu")
    first = server.step(pcm[:, :HOP])
    frame = eng.step(pcm[0, :HOP].astype(np.float32) / 32768.0)
    kept, kept_frame = first.clone(), frame.clone()
    for i in range(1, 4):
        server.step(pcm[:, i * HOP:(i + 1) * HOP])
        eng.step(pcm[0, i * HOP:(i + 1) * HOP].astype(np.float32) / 32768.0)
    server.reset_sessions([0, 1])
    eng.reset()
    assert torch.equal(first, kept) and torch.equal(frame, kept_frame)
    scanned = server.run_scan(pcm[:, :2 * HOP].astype(np.float32))
    again = scanned.clone()
    server.step(pcm[:, :HOP])
    assert torch.equal(scanned, again)


def test_graphs_need_a_cuda_device(tcfg, model):
    dec = SequentialDualStreamModel(d_model=32, num_heads=2,
                                    mel_sequence_length=16)
    for make in (lambda g: MultiStreamInference(model, tcfg, 2, device="cpu",
                                                graphs=g),
                 lambda g: StreamingInference(model, tcfg, device="cpu",
                                              graphs=g),
                 lambda g: BatchedSequentialDecoder(dec, device="cpu",
                                                    graphs=g)):
        with pytest.raises(ValueError, match="CUDA graphs"):
            make(True)
        assert not make(None).step_graphs.enabled
        assert not make(False).step_graphs.enabled


def test_step_graphs_disabled_runs_the_body():
    graphs = StepGraphs(torch.device("cpu"))
    assert not graphs.enabled and len(graphs) == 0
    assert graphs.run(("any",), lambda: 7) == 7
    with pytest.raises(ValueError):
        StepGraphs(torch.device("cpu"), True)


def test_capture_records_and_replays_count(monkeypatch):
    """The wrappers count the launches a capture records, as any other;
    ``capturing`` gives the capture's own record, which each replay
    runs."""
    monkeypatch.setattr(ck, "LAUNCHES", dict.fromkeys(ck.SOURCES, 0))
    monkeypatch.setattr(ck, "SHAPE_LAUNCHES", collections.Counter())
    ck._launched("logmel", (64,), 0)
    with ck.capturing() as recorded:
        ck._launched("logmel", (64,), 0)
        ck._launched("cycle_dsum", (30, 8, 17, 512), 0)
        ck._launched("cycle_dsum", (30, 8, 17, 512), 0)
    assert ck.LAUNCHES == {"cycle_dsum": 2, "dk_roots": 0, "logmel": 2}
    assert recorded == {("logmel", (64,)): 1,
                        ("cycle_dsum", (30, 8, 17, 512)): 2}
    with pytest.raises(RuntimeError, match="failed to launch"):
        with ck.capturing():
            ck._launched("logmel", (1,), 2)


def test_capture_holds_cached_device_constants():
    """A capture holds every cached constant its body reached, built or
    found in the cache, so the cache evicting it frees nothing a graph
    reads."""
    built = []

    @device_cache.device_cache(2)
    def table(n):
        built.append(n)
        return torch.arange(n)

    table(3)
    with device_cache.holding() as held:
        first, again, other = table(3), table(3), table(4)
    assert built == [3, 4]
    assert len(held) == 2
    assert any(t is first for t in held) and any(t is other for t in held)
    assert again is first
    for n in (5, 6, 7):                  # evicts 3 and 4 from the cache
        table(n)
    table.cache_clear()
    assert table.cache_info().currsize == 0
    assert any(t is first for t in held)
    assert table(5) is not None and device_cache._HOLDERS == []


def _raise(*args, **kwargs):
    raise AssertionError("host<->device copy or sync in a captured body")


@contextlib.contextmanager
def _no_host_traffic(monkeypatch):
    """Every call that copies between host and device or waits for the
    device raises; checked to take effect."""
    with monkeypatch.context() as m:
        for name in ("tensor", "as_tensor", "from_numpy"):
            m.setattr(torch, name, _raise)
        for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                     "__float__", "__int__"):
            m.setattr(torch.Tensor, name, _raise)
        probe = torch.zeros(())
        for call in (lambda: torch.tensor([1]), lambda: probe.item(),
                     lambda: bool(probe), lambda: probe.cpu()):
            with pytest.raises(AssertionError, match="captured body"):
                call()
        yield


@pytest.mark.parametrize("cohorts", [1, 2])
def test_captured_bodies_are_capture_safe(tcfg, model, monkeypatch,
                                          cohorts):
    """After warm-up, the server's body for every due set and parity, in
    both input dtypes, both stream branches and one decode call run with
    every host copy and sync patched to raise."""
    server = MultiStreamInference(model, tcfg, 2 * cohorts, device="cpu",
                                  refresh_cohorts=cohorts)
    server._put_hops(_pcm(2 * cohorts, 1, seed=9))
    server._put_hops(_pcm(2 * cohorts, 1, seed=9).astype(np.float32))
    eng = StreamingInference(model, tcfg, device="cpu")
    for dtype in (torch.int16, torch.float32):
        server.warmup(dtype)
    eng.warmup()
    dec_model = SequentialDualStreamModel(d_model=32, num_heads=2,
                                          mel_sequence_length=16,
                                          stride_frames=3)
    dec_model.init_random(torch.Generator().manual_seed(1))
    dec = BatchedSequentialDecoder(dec_model, device="cpu")
    audio = torch.from_numpy(np.stack([_voice(40 * HOP, seed=s)
                                       for s in (1, 2)]))
    want = dec(audio)
    with torch.inference_mode(), _no_host_traffic(monkeypatch):
        for due in [()] + [(c,) for c in range(cohorts)]:
            for parity in (0, 1):
                for dtype in (torch.int16, torch.float32):
                    out = server._body(*server._static.buffers(parity),
                                       dtype, due)
                    assert out.shape == (2 * cohorts, 52)
        for refresh in (True, False):
            for parity in (0, 1):
                assert eng._body(*eng._static.buffers(parity),
                                 refresh).shape == (1, 52)
        got = dec._decode(audio)
    assert torch.equal(got, want)


class _CallingGraphs:
    """Stands in for ``StepGraphs`` on the CPU: a capture keeps the body,
    a replay calls it."""
    enabled = True

    def __init__(self):
        self.bodies, self.dropped = {}, []

    def __contains__(self, key):
        return key in self.bodies

    def capture(self, key, body, warm=None):
        self.bodies[key] = body

    def run(self, key, body):
        return self.bodies[key]()

    def drop(self, key):
        del self.bodies[key]
        self.dropped.append(key)


def _decode_call(dec, method: str, audio: torch.Tensor, stride: int):
    """One decode of ``audio`` (B, L) by ``method``."""
    if method == "call":
        return dec(audio)
    if method == "scheduled":
        return dec.decode_scheduled(audio, [stride, 1][:audio.shape[0]])[0]
    return dec.decode_sequence_parallel(audio[0].numpy())


@pytest.mark.parametrize("method", ["call", "scheduled",
                                    "sequence_parallel"])
def test_decoder_keeps_the_graphs_of_its_recent_shapes(method):
    """Each key's call reads its static buffers (audio, and window starts
    for the scheduled and sequence-parallel decodes), refilled on every
    call: a call of a seen key with other strides or audio replays the
    same graph and gives the eager result; past ``max_graphs`` keys the
    least recently used graph goes."""
    dec_model = SequentialDualStreamModel(d_model=32, num_heads=2,
                                          mel_sequence_length=16,
                                          stride_frames=3)
    dec_model.init_random(torch.Generator().manual_seed(2))
    eager = BatchedSequentialDecoder(dec_model, device="cpu")
    dec = BatchedSequentialDecoder(dec_model, device="cpu")
    dec.step_graphs = graphs = _CallingGraphs()
    dec.max_graphs = 2
    frames = [40, 41, 40, 42, 41]
    stride = 3 if method == "scheduled" else 1
    for seed, n in enumerate(frames):
        audio = torch.from_numpy(_voice(n * HOP, seed=seed + 1)[None])
        if method == "scheduled":
            audio = torch.cat([audio, audio.flip(-1)])
            stride = 2 + seed % 2              # n_max is the stride-1 row's
        assert torch.equal(_decode_call(dec, method, audio, stride),
                           _decode_call(eager, method, audio, stride)), seed
    assert [k[0] for k in graphs.dropped + list(graphs.bodies)] \
        == [method] * 4
    assert [k[1][-1] for k in graphs.dropped] == [41 * HOP, 40 * HOP]
    assert sorted(k[1][-1] for k in graphs.bodies) == [41 * HOP, 42 * HOP]


def test_decode_start_bodies_are_capture_safe(monkeypatch):
    """The bodies of ``decode_scheduled`` and ``decode_sequence_parallel``
    (window starts read from a buffer on the device) run with every host
    copy and sync patched to raise, after warm-up."""
    dec_model = SequentialDualStreamModel(d_model=32, num_heads=2,
                                          mel_sequence_length=16,
                                          stride_frames=3)
    dec_model.init_random(torch.Generator().manual_seed(1))
    dec = BatchedSequentialDecoder(dec_model, device="cpu")
    audio = torch.from_numpy(np.stack([_voice(40 * HOP, seed=s)
                                       for s in (1, 2)]))
    want_sched, _ = dec.decode_scheduled(audio, [1, 4])
    want_seq = dec.decode_sequence_parallel(audio[0].numpy())
    span = 40 - 16
    starts = torch.from_numpy(np.minimum(
        np.arange(span + 1)[None] * np.array([[1], [4]]), span))
    seq_starts = torch.arange(0, span + 1, 3)[None]
    with torch.inference_mode(), _no_host_traffic(monkeypatch):
        got_sched = dec._decode_at(audio, starts)
        got_seq = dec._decode_sequence(audio[:1], seq_starts,
                                       n_out=seq_starts.shape[1])
    assert torch.equal(got_sched, want_sched)
    assert torch.equal(got_seq, want_seq)


@pytest.mark.parametrize("backend,kw", [
    ("basic", dict(emotion_backend="basic", use_concatenation=False)),
    ("emotion2vec", dict(emotion_backend="emotion2vec",
                         use_concatenation=False)),
    ("full_ring", dict(incremental_lld=False))])
def test_refresh_bodies_without_ring_are_capture_safe(monkeypatch, backend,
                                                      kw):
    """The bodies of the refresh without the LLD ring (``basic``,
    ``emotion2vec``'s encoder over every lane of a due cohort at once, the
    full-ring eGeMAPS) and of an ``emotion2vec`` decode run with every host
    copy and sync patched to raise, after warm-up."""
    from koemorph_tpu_torch.features.wav2vec2 import Wav2Vec2Config
    tiny = Wav2Vec2Config(hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=2, intermediate_size=64,
                          conv_dim=(16,), conv_stride=(160,),
                          conv_kernel=(320,), num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4)
    cfg = streaming.StreamingConfig(**KW, **kw, emotion2vec_config=tiny)
    m = streaming.model_for_config(cfg)
    m.init_random(torch.Generator().manual_seed(2))
    server = MultiStreamInference(m, cfg, 4, device="cpu",
                                  refresh_cohorts=2)
    server._put_hops(_pcm(4, 1, seed=3))
    server.warmup(torch.int16)
    eng = StreamingInference(m, cfg, device="cpu")
    eng.warmup()
    decode = backend == "emotion2vec"
    if decode:
        dec_model = SequentialDualStreamModel(
            d_model=32, num_heads=2, mel_sequence_length=16, stride_frames=3,
            emotion_backend="emotion2vec", use_concatenation=False,
            emotion2vec_config=tiny)
        dec_model.init_random(torch.Generator().manual_seed(1))
        dec = BatchedSequentialDecoder(dec_model, device="cpu")
        audio = torch.from_numpy(np.stack([_voice(40 * HOP, seed=s)
                                           for s in (1, 2)]))
        want = dec(audio)
    before = server.states.emotion_raw.clone()
    with torch.inference_mode(), _no_host_traffic(monkeypatch):
        for due in [(), (0,), (1,)]:
            for parity in (0, 1):
                out = server._body(*server._static.buffers(parity),
                                   torch.int16, due)
                assert out.shape == (4, 52)
        for refresh in (True, False):
            for parity in (0, 1):
                assert eng._body(*eng._static.buffers(parity),
                                 refresh).shape == (1, 52)
        got = dec._decode(audio) if decode else None
    assert server.states.lld_ring is None
    assert not torch.equal(server.states.emotion_raw, before)
    if decode:
        assert torch.equal(got, want)
