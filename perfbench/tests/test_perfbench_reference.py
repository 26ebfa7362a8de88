"""The frozen plain reference against the program at tiny widths on the
CPU: the served stream frame by frame (refreshing and other frames), the
full-utterance decode, and the weights from the seed."""

import numpy as np
import pytest
import torch

from perfbench.harness import weights

TINY = dict(d_model=32, num_heads=4, window_frames=24,
            emotion_update_frames=3, fusion_temperature=0.5)


def test_stream_frames_match_the_program():
    from koemorph_tpu_torch.runtime import streaming as prog
    from perfbench.reference import stream as ref
    pcfg, rcfg = prog.StreamingConfig(**TINY), ref.StreamingConfig(**TINY)
    pm = prog.model_for_config(pcfg).eval()
    rm = ref.model_for_config(rcfg).eval()
    state = weights.seeded_state(pm, 2 ** 31 + 3, "cpu")
    pm.load_state_dict(state)
    rm.load_state_dict(state)
    g = torch.Generator().manual_seed(0)
    lanes = 3
    audio = 0.1 * torch.randn(lanes, 12 * pcfg.hop_length, generator=g)
    ps = prog.init_stream_state(pcfg, "cpu", lanes)
    rs = ref.init_stream_state(rcfg, "cpu", lanes)
    phases = [0, 1, 2]
    with torch.no_grad():
        for f in range(12):
            hop = audio[:, f * pcfg.hop_length:(f + 1) * pcfg.hop_length]
            due = [i for i, p in enumerate(phases) if (p + f) % 3 == 0]
            out_p = []
            for lane in range(lanes):
                one = prog.StreamState(
                    audio_ring=ps.audio_ring[lane], mel_db=ps.mel_db[lane],
                    emotion_raw=ps.emotion_raw[lane],
                    frame_count=phases[lane] + f,
                    temporal=prog.TemporalState(
                        prev=ps.temporal.prev[lane:lane + 1],
                        initialized=ps.temporal.initialized[lane:lane + 1]),
                    lld_ring={k: v[lane] for k, v in ps.lld_ring.items()},
                    lld_carry=type(ps.lld_carry)(*(
                        None if c is None else c[lane]
                        for c in ps.lld_carry)))
                o, new = prog.stream_frame(pm, one, hop[lane], pcfg)
                out_p.append(o["blendshapes"])
                ps.audio_ring[lane] = new.audio_ring
                ps.mel_db[lane] = new.mel_db
                ps.emotion_raw[lane] = new.emotion_raw
                ps.temporal.prev[lane] = new.temporal.prev[0]
                ps.temporal.initialized[lane] = new.temporal.initialized[0]
                for k in ps.lld_ring:
                    ps.lld_ring[k][lane] = new.lld_ring[k]
                for dst, src in zip(ps.lld_carry, new.lld_carry):
                    if dst is not None:
                        dst[lane] = src
            y, rs = ref.stream_frame_lanes(rm, rs, hop, rcfg, due)
            np.testing.assert_allclose(y.numpy(),
                                       torch.stack(out_p).numpy(),
                                       rtol=0, atol=1e-6)


def test_decode_matches_the_program():
    from koemorph_tpu_torch.models.dual_stream_model import (
        SequentialDualStreamModel as Prog)
    from perfbench.reference.model import SequentialDualStreamModel as Ref
    kw = dict(d_model=32, num_heads=4, mel_sequence_length=24,
              target_fps=60, fusion_temperature=0.5, stride_frames=1)
    pm, rm = Prog(**kw).eval(), Ref(**kw).eval()
    state = weights.seeded_state(pm, 77, "cpu")
    pm.load_state_dict(state)
    rm.load_state_dict(state)
    g = torch.Generator().manual_seed(1)
    audio = 0.1 * torch.randn(2, 60 * pm.hop_length, generator=g)
    with torch.no_grad():
        want = rm(audio)["blendshapes"]
        got = pm(audio)["blendshapes"]
    assert got.shape == want.shape == (2, 37, 52)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_seeded_weights():
    from perfbench.reference.model import SequentialDualStreamModel as Ref
    m = Ref(d_model=256, num_heads=8, mel_sequence_length=256)
    a = weights.seeded_state(m, 2 ** 33 + 1, "cpu")
    b = weights.seeded_state(m, 2 ** 33 + 1, "cpu")
    c = weights.seeded_state(m, 2 ** 33 + 2, "cpu")
    assert a.keys() == m.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["emotion_projection.weight"],
                           c["emotion_projection.weight"])
    w = a["emotion_projection.weight"]               # LeCun, fan_in 264
    assert float(w.std()) == pytest.approx(264 ** -0.5, rel=0.05)
    assert float(w.abs().max()) <= 2 * 264 ** -0.5 / weights.TRUNC_STD
    x = a["dual_stream_attention.mel_attention.in_proj_weight"]
    assert float(x.abs().max()) <= (6 / (768 + 256)) ** 0.5
    assert float(a["dual_stream_attention.mouth_queries"].std()) == \
        pytest.approx(0.02, rel=0.1)
    assert torch.equal(a["smoothing_alpha"], m.state_dict()["smoothing_alpha"])
    assert torch.equal(a["dual_stream_attention.mel_weights"],
                       m.state_dict()["dual_stream_attention.mel_weights"])
    assert all(v.dtype == torch.float32 for v in a.values())
