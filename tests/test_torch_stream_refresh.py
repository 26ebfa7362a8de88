"""PyTorch port: the stream's and the server's refresh without the LLD
ring, which re-derives the emotion vector from the ring's whole context
(20 s + the 0.6 s offsets' margin in production; 2 s + 0.6 s here) at every
refresh: ``basic``, ``emotion2vec`` (the model's wav2vec2 encoder, at the
JAX package's tiny streaming config) and ``egemaps`` with
``incremental_lld=False``.

The JAX ``stream_frame`` / ``MultiStreamInference`` and the port's run the
same converted params and the same seeded audio over at least two
refreshes: per-frame blendshapes at <= 1e-5 absolute; the cached emotion
vector at rtol 1e-5 / atol 1e-6 for ``basic`` and ``emotion2vec``, and at
the incremental stream test's eGeMAPS tolerances (rtol 1e-3, the F0 slope
functionals 1e-2, atol 1e-4) for the full-ring eGeMAPS refresh, except the
F0 semitone contour's rising and falling slope statistics on the server's
lanes (``SPLIT_RTOL``): on a flat pitch stretch (the 180 Hz part of the
test voice) the frame-to-frame differences are rounding residues of
~1e-6 semitones, and their sign decides whether a frame counts as rising
or falling. The two implementations' F0 contours agree within 2e-6
semitones and their voicing exactly, yet one frame more or less among a
window's few falling frames moves the mean falling slope by ~1/n (14% on
lane 0 at the third refresh, seed 5). The JAX package's functionals
share the fragility (ROADMAP.md section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.features.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from koemorph_tpu.ops.egemaps import FEATURE_NAMES
from koemorph_tpu.models.dual_stream_model import (
    SimplifiedDualStreamModel, TemporalState as JaxTemporalState)
from koemorph_tpu.runtime import MultiStreamInference as JaxMultiStream
from koemorph_tpu.runtime import streaming as jax_streaming
from koemorph_tpu_torch.features.wav2vec2 import Wav2Vec2Config
from koemorph_tpu_torch.runtime import (MultiStreamInference,
                                        StreamingInference, streaming)
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from tests.test_torch_streaming import EMOTION_RTOL, HOP, KW, _voice

torch.set_num_threads(2)

# the JAX package's tiny streaming encoder (tests/runtime/test_streaming.py)
TINY_W2V = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=64, conv_dim=(16,), conv_stride=(160,),
                conv_kernel=(320,), num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)
CASES = {
    "basic": dict(emotion_backend="basic", use_concatenation=False),
    "emotion2vec": dict(emotion_backend="emotion2vec",
                        use_concatenation=False),
    "full_ring": dict(incremental_lld=False),
}
K = KW["emotion_update_frames"]
#: the F0 semitone slope statistics, whose rising/falling split counts
#: rounding residues on a flat pitch stretch (see the module docstring)
SPLIT = np.tile([n.startswith("F0semitone") and "Slope" in n
                 for n in FEATURE_NAMES], 3)
SPLIT_RTOL = 0.25


def _configs(case: str):
    kw = dict(KW, **CASES[case])
    if case == "emotion2vec":
        return (jax_streaming.StreamingConfig(
                    **kw, emotion2vec_config=JaxW2VConfig(**TINY_W2V)),
                streaming.StreamingConfig(
                    **kw, emotion2vec_config=Wav2Vec2Config(**TINY_W2V)))
    return (jax_streaming.StreamingConfig(**kw),
            streaming.StreamingConfig(**kw))


def _params(jcfg, seed: int = 1) -> dict:
    """JAX model params of ``jcfg``'s shapes, perturbed off their init."""
    backend = jcfg.emotion_backend
    model = SimplifiedDualStreamModel(
        d_model=32, num_heads=2, mel_sequence_length=16,
        emotion_backend=backend if backend == "emotion2vec"
        else "precomputed", dropout=0.0,
        emotion2vec_config=jcfg.emotion2vec_config)
    extra = ({} if backend == "emotion2vec" else dict(
        emotion_features_raw=jnp.zeros((1, jcfg.emotion_raw_dim))))
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16 * HOP)),
        JaxTemporalState.create(1), **extra)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x)
                   + rng.normal(0, 0.05, np.shape(x))).astype(np.float32),
        params)


def _emotion_close(case, got, want, what, lanes: bool = False):
    if case == "full_ring":
        rtol = np.where(SPLIT, SPLIT_RTOL, EMOTION_RTOL) if lanes \
            else EMOTION_RTOL
        tol = 1e-4 + rtol * np.abs(want)
    else:
        tol = 1e-6 + 1e-5 * np.abs(want)
    err = np.abs(got - want)
    assert (err <= tol).all(), (what, float(err.max()))


@pytest.fixture(scope="module", params=list(CASES))
def setup(request):
    case = request.param
    jcfg, tcfg = _configs(case)
    params = _params(jcfg)
    model = streaming.model_for_config(tcfg)
    model.load_state_dict(state_dict_from_flax(params))
    return case, jcfg, tcfg, params, model


def test_config_without_ring(setup):
    case, jcfg, tcfg, _, model = setup
    assert not tcfg.use_lld_ring and not jcfg.use_lld_ring
    assert tcfg.emotion_raw_dim == jcfg.emotion_raw_dim
    assert (streaming._refresh_tail_len(tcfg)
            == jax_streaming._refresh_tail_len(jcfg) == 2 * 16000 + 9600)
    st = streaming.init_stream_state(tcfg, "cpu")
    assert st.lld_ring is None and st.lld_carry is None
    assert hasattr(model, "emotion2vec") == (case == "emotion2vec")


def test_stream_matches_jax(setup):
    case, jcfg, tcfg, params, model = setup
    n_frames = 2 * K + 2                    # refreshes at 0, 3, 6
    audio = _voice(n_frames * HOP, seed=3)
    step = jax.jit(lambda p, s, a: jax_streaming.stream_frame(p, s, a, jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_streaming.init_stream_state(jcfg)
    tstate = streaming.init_stream_state(tcfg, "cpu")
    seen = []
    for i in range(n_frames):
        hop = audio[i * HOP:(i + 1) * HOP]
        jout, jstate = step(jparams, jstate, jnp.asarray(hop))
        with torch.inference_mode():
            tout, tstate = streaming.stream_frame(model, tstate,
                                                  torch.from_numpy(hop), tcfg)
        got = tout["blendshapes"].numpy()
        assert np.abs(got - np.asarray(jout["blendshapes"])).max() <= 1e-5, i
        _emotion_close(case, tstate.emotion_raw.numpy(),
                       np.asarray(jstate.emotion_raw), i)
        seen.append(tstate.emotion_raw.clone())
    # three distinct refreshed vectors, cached between refreshes
    assert torch.equal(seen[1], seen[2]) and not torch.equal(seen[2], seen[3])
    assert not torch.equal(seen[5], seen[6])
    assert float(seen[-1].abs().max()) > 0


def test_engine_in_place_equals_functional(setup):
    """``StreamingInference`` (static buffers, no LLD ring) gives the
    functional stream's frames."""
    _, _, tcfg, _, model = setup
    audio = _voice((K + 2) * HOP, seed=4)
    eng = StreamingInference(model, tcfg, device="cpu")
    eng.warmup()
    got = np.stack(eng.process_audio(audio))
    state = streaming.init_stream_state(tcfg, "cpu")
    want = []
    with torch.inference_mode():
        for i in range(K + 2):
            out, state = streaming.stream_frame(
                model, state, torch.from_numpy(audio[i * HOP:(i + 1) * HOP]),
                tcfg)
            want.append(out["blendshapes"].numpy())
    np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("cohorts", [1, 3])
def test_server_matches_jax(setup, cohorts):
    """Three lanes at G = 1 and G = 3 (one lane per cohort, one batched
    refresh per due cohort), then a reset of lane 1, against the JAX
    server doing the same."""
    case, jcfg, tcfg, params, model = setup
    n = 2 * K + 1
    audio = np.stack([_voice(n * HOP, seed=s + 5) * g
                      for s, g in enumerate((1.0, 0.2, 2.0))])
    audio = np.clip(audio, -1, 1).astype(np.float32)
    jserver = JaxMultiStream(params, jcfg, 3, refresh_cohorts=cohorts)
    server = MultiStreamInference(model, tcfg, 3, device="cpu",
                                  refresh_cohorts=cohorts)
    for i in range(2 * n):
        if i == n:
            jserver.reset_sessions([1])
            server.reset_sessions([1])
        t = i % n
        hop = audio[:, t * HOP:(t + 1) * HOP]
        want = np.asarray(jserver.step(hop))
        got = server.step(hop).numpy()
        assert np.abs(got - want).max() <= 1e-5, i
        _emotion_close(case, server.states.emotion_raw.numpy(),
                       np.asarray(jserver.states.emotion_raw), i, lanes=True)
    assert server.states.lld_ring is None


def test_server_lane_matches_dedicated_engine(setup):
    """A lane of a G = 3 server is the dedicated engine whose clock starts
    at its cohort's phase."""
    case, _, tcfg, _, model = setup
    n = 2 * K + 1
    audio = np.stack([_voice(n * HOP, seed=s + 9) for s in range(3)])
    server = MultiStreamInference(model, tcfg, 3, device="cpu",
                                  refresh_cohorts=3)
    got = np.stack([server.step(audio[:, i * HOP:(i + 1) * HOP]).numpy()
                    for i in range(n)])
    for lane in range(3):
        eng = StreamingInference(model, tcfg, device="cpu")
        eng.state.frame_count = server.phases[lane]
        want = np.stack(eng.process_audio(audio[lane]))
        np.testing.assert_allclose(got[:, lane], want, atol=1e-5, rtol=0,
                                   err_msg=f"{case} lane {lane}")
