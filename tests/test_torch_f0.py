"""PyTorch port: YIN and the per-cycle difference sums.

The plain ``cycle_dsum`` is held against the JAX form and the Pallas kernel
(interpret mode) at rtol = atol = 1e-6 at both shapes the streaming
refresh uses: K=8, L=17 on 512-sample frames and K=5, L=33 on the
1024-sample low-pitch frames. ``yin_core``'s discrete picks and voicing
must be equal; its periods within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import f0 as jax_f0
from koemorph_tpu.ops.pallas.cycle_dsum_kernel import cycle_dsum_lanes_pallas
from koemorph_tpu_torch.ops import f0

torch.set_num_threads(2)

TAU_MAX = 291          # ceil(16000 / 55), the eGeMAPS YIN range
SHAPES = {"n512_K8_L17": (512, 8, 8), "n1024_K5_L33": (1024, 5, 16)}


def _inputs(case: str, n: int, half_lag: int, rows: int = 30):
    rng = np.random.default_rng(len(case) + n)
    frames = rng.standard_normal((rows, n)).astype(np.float32) * 0.3
    pick = rng.integers(32, TAU_MAX, size=rows)
    start = np.clip(pick - half_lag, 0, TAU_MAX + half_lag).astype(np.int32)
    tau = (pick + rng.uniform(-0.5, 0.5, rows)).astype(np.float32)
    off = np.zeros(rows, np.float32)
    if case == "extreme":
        # lowest pitch at the clip edge, highest pitch (many cycles)
        start[:4] = [0, TAU_MAX + half_lag, 24, 100]
        tau[:4] = [8.0, TAU_MAX, 32.4, 108.7]
    elif case == "phase":
        off = (rng.uniform(0, 0.5, rows) * tau).astype(np.float32)
    return frames, start, tau, off


def _jax_z(frames, start, half_lag):
    s_max = TAU_MAX + half_lag
    pad = (1 << int(np.ceil(np.log2(s_max + 1)))) - 1
    padded = jnp.concatenate(
        [frames, jnp.zeros((frames.shape[0], pad), frames.dtype)], -1)
    return jax_f0._shift_rows(padded, start, frames.shape[1], s_max)


class TestCycleDsum:
    @pytest.mark.parametrize("case", ["random", "extreme", "phase"])
    @pytest.mark.parametrize("shape", list(SHAPES))
    def test_plain_matches_jax_and_pallas(self, shape, case):
        n, k, h = SHAPES[shape]
        frames, start, tau, off = _inputs(case, n, h)
        jargs = [jnp.asarray(a) for a in (frames, start, tau)]
        want = np.asarray(jax_f0._cycle_dsum(
            *jargs, tau_max=TAU_MAX, n_cycles=k, half_lag=h,
            off=jnp.asarray(off)))
        pallas = np.asarray(cycle_dsum_lanes_pallas(
            jargs[0], _jax_z(jargs[0], jargs[1], h), *jargs[1:],
            jnp.asarray(off), n_cycles=k, half_lag=h, tau_max=TAU_MAX,
            interpret=True))
        got = f0.cycle_dsum_plain(
            *(torch.from_numpy(a) for a in (frames, start, tau, off)),
            n_cycles=k, half_lag=h).numpy()
        assert got.shape == (30, k, 2 * h + 1)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)

    def test_cpu_wrapper_is_the_plain_form(self):
        args = [torch.from_numpy(a) for a in _inputs("phase", 512, 8)]
        np.testing.assert_array_equal(
            f0.cycle_dsum(*args, n_cycles=8, half_lag=8).numpy(),
            f0.cycle_dsum_plain(*args, n_cycles=8, half_lag=8).numpy())


def _voiced(freq=170.0, seconds=0.5, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.4 * np.sin(2 * np.pi * freq * t)
            + 0.2 * np.sin(2 * np.pi * 2 * freq * t + 0.3)
            + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


class TestYinCore:
    @pytest.mark.parametrize("freq", [80.0, 170.0])
    def test_matches_jax(self, freq):
        x = _voiced(freq)
        kw = dict(sample_rate=16000, frame_length=512, hop_length=160,
                  f0_min=55.0, f0_max=500.0, center=False, n_acf_lags=326,
                  subwindow_periods=True, cycle_periods=8)
        jc = jax.jit(lambda a: jax_f0.yin_core(a, **kw))(jnp.asarray(x))
        tc = f0.yin_core(torch.from_numpy(x), **kw)
        voiced = np.asarray(jc.result.voiced_flag)
        assert voiced.sum() >= 20
        np.testing.assert_array_equal(tc.pick.numpy(), np.asarray(jc.pick))
        np.testing.assert_array_equal(tc.result.voiced_flag.numpy(), voiced)
        np.testing.assert_array_equal(tc.cycle_valid.numpy(),
                                      np.asarray(jc.cycle_valid))
        for got, want in ((tc.tau, jc.tau), (tc.result.f0_hz, jc.result.f0_hz),
                          (tc.cycle_period, jc.cycle_period),
                          (tc.result.voiced_prob, jc.result.voiced_prob)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        # the half-window difference functions sum half the samples, so the
        # cancellation at their minimum (r0 + r_tau ~ 2c) leaves about 4x
        # the relative rounding of the full window in the parabola's vertex
        for got, want in ((tc.period_first, jc.period_first),
                          (tc.period_second, jc.period_second)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=5e-5, atol=1e-5)
        np.testing.assert_allclose(tc.acf.numpy(), np.asarray(jc.acf),
                                   rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jc.acf).max()))
        if freq > 150:
            # the short frame serves this pitch with valid cycle pairs
            assert tc.cycle_valid.numpy()[voiced].sum(-1).min() >= 2

    def test_viterbi_smoother_is_not_ported(self):
        # the smoother is ported (held against JAX by
        # test_torch_f0_viterbi.py): silence picks tau_min, unvoiced
        out = f0.yin_core(torch.zeros(2048), smoother="viterbi")
        assert out.pick.shape == (13,) and not out.result.voiced_flag.any()
        with pytest.raises(ValueError, match="smoother"):
            f0.yin_core(torch.zeros(2048), smoother="pyin")
