"""PyTorch port: LPC roots, the LLD block and the 264-D functionals.

- Durand-Kerner roots: the plain form against the JAX form, the Pallas
  kernel (interpret mode) and ``np.roots`` by per-row Hausdorff distance
  between root sets (median < 1e-5, max < 1e-3, the JAX kernel test's
  bounds; root order is arbitrary).
- ``compute_lld_block`` chained by its carry: boolean fields equal, float
  fields at rtol 1e-4 / atol 1e-4, except formant frequencies and
  bandwidths at rtol 1e-3: both are positions of LPC roots, which amplify
  the autocorrelation's rounding (the JAX package's own split-block test
  allows 1e-3 on bandwidths).
- ``functionals_multi_offset`` over an LLD ring: rtol 1e-3 / atol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import egemaps as jeg
from koemorph_tpu.ops.pallas.dk_roots_kernel import poly_roots_dk_pallas
from koemorph_tpu.ops.stft import autocorr_matmul as jax_autocorr
from koemorph_tpu_torch.ops import egemaps as eg

torch.set_num_threads(2)

SR, HOP = 16000, 160
N_ROWS = 10                      # LLD rows per block (the tiny stream's)
CHUNK = (N_ROWS - 1) * HOP + 512


def _lpc_polys(n_frames: int = 24) -> np.ndarray:
    """Monic LPC polynomials from Levinson over vowel-like frames."""
    rng = np.random.default_rng(0)
    t = np.arange(400) / SR
    x = rng.standard_normal((n_frames, 400)).astype(np.float32) * 0.05
    x += (0.5 * np.sin(2 * np.pi * 700 * t) + 0.3 * np.sin(2 * np.pi * 1220 * t)
          + 0.2 * np.sin(2 * np.pi * 2600 * t))[None, :].astype(np.float32)
    x *= np.hanning(400)[None, :].astype(np.float32)
    r = np.asarray(jax_autocorr(jnp.asarray(x), 11)).copy()
    r[..., 0] *= 1.0001
    return np.asarray(jeg._levinson(jnp.asarray(r), 10)).astype(np.float32)


def _hausdorff(za: np.ndarray, zb: np.ndarray) -> np.ndarray:
    d = np.abs(za[:, :, None] - zb[:, None, :])
    return np.maximum(d.min(axis=2).max(axis=1), d.min(axis=1).max(axis=1))


class TestPolyRoots:
    def test_levinson_matches(self):
        r = np.random.default_rng(1).standard_normal((5, 11)).astype(
            np.float32)
        r[:, 0] = np.abs(r).sum(1) + 1.0          # positive definite
        np.testing.assert_allclose(
            eg._levinson(torch.from_numpy(r), 10).numpy(),
            np.asarray(jeg._levinson(jnp.asarray(r), 10)),
            rtol=1e-5, atol=1e-6)

    def test_plain_matches_jax_pallas_and_np_roots(self):
        a = _lpc_polys()
        got = eg.poly_roots_plain(torch.from_numpy(a)).numpy()
        assert got.dtype == np.complex64 and got.shape == (24, 10)
        for ref in (np.asarray(jeg._poly_roots_dk(jnp.asarray(a))),
                    np.asarray(poly_roots_dk_pallas(jnp.asarray(a),
                                                    interpret=True))):
            h = _hausdorff(got, ref)
            assert np.median(h) < 1e-5
            assert np.max(h) < 1e-3, h.max()
        exact = np.stack([np.roots(row).astype(np.complex64)
                          for row in a[:8]])
        assert _hausdorff(got[:8], exact).max() < 1e-3

    def test_plain_diverging_rows_turn_nan_as_jax_and_pallas(self):
        # one huge (or non-finite) coefficient: the first step throws the
        # roots far out, the next step's products overflow to inf - inf,
        # and every form steps on a NaN product, so every root is NaN
        rows = []
        for k, v in ((10, 1e38), (1, 1e30), (5, 1e20), (10, 1e12),
                     (10, -3e37), (3, np.inf), (4, np.nan)):
            a = np.zeros(11, np.float32)
            a[0], a[k] = 1.0, v
            rows.append(a)
        a = np.concatenate([np.stack(rows), _lpc_polys(3)])
        got = eg.poly_roots_plain(torch.from_numpy(a)).numpy()
        for ref in (np.asarray(jeg._poly_roots_dk(jnp.asarray(a))),
                    np.asarray(poly_roots_dk_pallas(jnp.asarray(a),
                                                    interpret=True))):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert np.isnan(got[:7]).all() and np.isfinite(got[7:]).all()

    def test_cpu_wrapper_and_batch_shape(self):
        a = torch.from_numpy(_lpc_polys(6))
        nested = eg.poly_roots(a.reshape(3, 2, 11))
        assert nested.shape == (3, 2, 10)
        np.testing.assert_array_equal(nested.reshape(6, 10).numpy(),
                                      eg.poly_roots_plain(a).numpy())


def _voice(freq: float, n: int, seed: int = 0) -> np.ndarray:
    """Harmonic pulse train through three formant resonances."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = np.zeros(n)
    for h in range(1, 40):
        fh = freq * h
        if fh > 7500:
            break
        gain = sum(np.exp(-((fh - c) / w) ** 2)
                   for c, w in ((700, 250), (1200, 300), (2600, 400))) + 0.05
        x += gain * np.cos(2 * np.pi * fh * t + rng.uniform(0, 0.3))
    x = 0.3 * x / np.abs(x).max() + 0.003 * rng.standard_normal(n)
    return x.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _jax_block():
    cfg = jeg.EgemapsConfig()
    return jax.jit(lambda c, carry: jeg.compute_lld_block(c, cfg, carry))


def _assert_lld_close(got: dict, want: dict, what: str = ""):
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape, (what, key)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")
        else:
            rtol = 1e-3 if key in ("formant_freq", "formant_bw") else 1e-4
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-4,
                                       err_msg=f"{what} {key}")


class TestLldBlock:
    @pytest.mark.parametrize("freq", [80.0, 180.0])
    def test_two_carried_blocks_match_jax(self, freq):
        x = _voice(freq, CHUNK + N_ROWS * HOP, seed=int(freq))
        c1, c2 = x[:CHUNK], x[N_ROWS * HOP:]
        cfg = eg.EgemapsConfig()
        jcarry = jeg.silence_lld_carry(jeg.EgemapsConfig())
        tcarry = eg.silence_lld_carry(cfg)
        for chunk in (c1, c2):
            jl, jcarry = _jax_block()(jnp.asarray(chunk), jcarry)
            tl, tcarry = eg.compute_lld_block(torch.from_numpy(chunk), cfg,
                                              tcarry)
            _assert_lld_close(tl, jl)
            assert bool(np.asarray(jl["voiced"]).all())
            np.testing.assert_array_equal(tcarry.audio_tail.numpy(),
                                          np.asarray(jcarry.audio_tail))
            assert int(tcarry.ctx_filled) == int(jcarry.ctx_filled)
            np.testing.assert_allclose(tcarry.prev_mag.numpy(),
                                       np.asarray(jcarry.prev_mag),
                                       rtol=1e-4, atol=1e-6)

    def test_formant_selection_with_masked_ties(self):
        """Frames with fewer than 3 valid LPC roots leave -inf ties in the
        top-3 selection; the masked slots must match JAX whatever order
        the ties come in."""
        # one narrow resonance: some frames keep only 2 valid roots
        rng = np.random.default_rng(1)
        t = np.arange(CHUNK) / SR
        x = np.zeros(CHUNK)
        for h in range(1, 50):
            x += (np.exp(-((150.0 * h - 700.0) / 200.0) ** 2)
                  * np.cos(2 * np.pi * 150.0 * h * t + rng.uniform(0, 0.3)))
        x = (0.3 * x / np.abs(x).max()
             + 0.01 * rng.standard_normal(CHUNK)).astype(np.float32)
        jl, _ = _jax_block()(jnp.asarray(x),
                             jeg.silence_lld_carry(jeg.EgemapsConfig()))
        tl, _ = eg.compute_lld_block(torch.from_numpy(x), eg.EgemapsConfig(),
                                     eg.silence_lld_carry())
        valid = np.asarray(jl["formant_valid"])
        assert (valid.sum(-1) < 3).any()
        np.testing.assert_array_equal(tl["formant_valid"].numpy(), valid)
        for key in ("formant_freq", "formant_bw", "formant_rel", "h1_a3"):
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                       rtol=1e-3, atol=1e-4, err_msg=key)

    @pytest.mark.parametrize("freq", [80.0, 180.0])
    def test_split_block_matches_single_block(self, freq):
        """Two half-blocks chained by the carry == one block."""
        cfg = eg.EgemapsConfig()
        n_rows = 40
        x = torch.from_numpy(_voice(freq, (n_rows - 1) * HOP + 512, seed=7))
        whole, _ = eg.compute_lld_block(x, cfg, eg.silence_lld_carry(cfg))
        n1 = 25
        b1, carry = eg.compute_lld_block(x[: (n1 - 1) * HOP + 512], cfg,
                                         eg.silence_lld_carry(cfg))
        b2, _ = eg.compute_lld_block(x[n1 * HOP:], cfg, carry)
        for key in whole:
            both = torch.cat([b1[key], b2[key]], 0)
            if whole[key].dtype == torch.bool:
                assert torch.equal(both, whole[key]), key
            else:
                np.testing.assert_allclose(both.numpy(), whole[key].numpy(),
                                           rtol=1e-4, atol=1e-4, err_msg=key)

    def test_unported_configs_raise(self):
        # both options are ported (held against JAX by
        # test_torch_egemaps_frame_level.py and test_torch_f0_viterbi.py);
        # an unknown smoother raises when the block runs
        for cfg in (eg.EgemapsConfig(per_period_voice_quality=False),
                    eg.EgemapsConfig(f0_smoother="viterbi")):
            block, _ = eg.compute_lld_block(torch.zeros(CHUNK), cfg)
            assert block["voiced"].shape == (N_ROWS,)
        with pytest.raises(ValueError, match="smoother"):
            eg.compute_lld_block(torch.zeros(CHUNK),
                                 eg.EgemapsConfig(f0_smoother="median"))


def _lld_ring(rows: int, seed: int = 0) -> dict:
    """A synthetic LLD ring: voiced runs, silent stretches, contours with
    slopes, some frames missing formants or jitter/shimmer validity."""
    rng = np.random.default_rng(seed)
    voiced = np.zeros(rows, bool)
    pos = 0
    while pos < rows:
        run = int(rng.integers(3, 25))
        voiced[pos:pos + run] = rng.random() < 0.6
        pos += run
    voiced[: rows // 5] = False                       # leading silence
    smooth = np.cumsum(rng.normal(0, 1, rows)).astype(np.float32)
    f32 = np.float32
    ring = {
        "f0_semitone": np.where(voiced, 30 + smooth * 0.2, 0).astype(f32),
        "voiced": voiced,
        "jitter": np.where(voiced, rng.uniform(0, 0.03, rows), 0).astype(f32),
        "loudness": np.where(np.arange(rows) < rows // 5, 0.0,
                             rng.uniform(0.1, 3, rows)).astype(f32),
        "shimmer_db": np.where(voiced, rng.uniform(0, 2, rows), 0).astype(f32),
        "hnr_db": np.where(voiced, rng.uniform(0, 20, rows), 0).astype(f32),
        "h1_h2": np.where(voiced, rng.normal(0, 5, rows), 0).astype(f32),
        "h1_a3": np.where(voiced, rng.normal(10, 5, rows), 0).astype(f32),
        "mfcc": rng.normal(0, 10, (rows, 4)).astype(f32),
        "formant_freq": np.sort(rng.uniform(300, 3500, (rows, 3)), -1
                                ).astype(f32),
        "formant_bw": rng.uniform(50, 1500, (rows, 3)).astype(f32),
        "formant_rel": rng.normal(-10, 5, (rows, 3)).astype(f32),
        "formant_valid": rng.random((rows, 3)) < 0.8,
        "jitter_valid": voiced & (rng.random(rows) < 0.9),
        "shimmer_valid": voiced & (rng.random(rows) < 0.9),
        "frame_power": rng.uniform(1e-4, 1e-2, rows).astype(f32),
    }
    for key in ("alpha_ratio", "hammarberg", "slope_0_500",
                "slope_500_1500", "spectral_flux"):
        ring[key] = rng.normal(0, 3, rows).astype(f32)
    return ring


class TestFunctionals:
    def test_multi_offset_matches_jax(self):
        rows = 263                                   # the tiny stream's ring
        ring = _lld_ring(rows)
        cuts = np.asarray([rows, rows - 30, rows - 60])
        masks = np.arange(rows)[None, :] < cuts[:, None]
        want = np.asarray(jax.jit(
            lambda r, m: jeg.functionals_multi_offset(
                r, jeg.EgemapsConfig(), m))(
            {k: jnp.asarray(v) for k, v in ring.items()},
            jnp.asarray(masks)))
        got = eg.functionals_multi_offset(
            {k: torch.from_numpy(v) for k, v in ring.items()},
            eg.EgemapsConfig(), torch.from_numpy(masks)).numpy()
        assert got.shape == (264,)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

    def test_segment_stats_run_lengths(self):
        rng = np.random.default_rng(3)
        mask = rng.random((4, 97)) < 0.5
        want = jeg._segment_stats(jnp.asarray(mask), 0.01)
        got = eg._segment_stats(torch.from_numpy(mask), 0.01)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    def test_ring_helpers(self):
        assert ([k for k, _, _ in eg.LLD_RING_SPEC]
                == [k for k, _, _ in jeg.LLD_RING_SPEC])
        ring = eg.init_lld_ring(12)
        jring = jeg.init_lld_ring(12)
        for k, v in jring.items():
            assert tuple(ring[k].shape) == v.shape, k
            assert (ring[k].dtype == torch.bool) == (v.dtype == bool), k
        block = {k: torch.ones((3,) + v.shape[1:], dtype=v.dtype)
                 for k, v in ring.items()}
        rolled = eg.roll_lld_ring(ring, block)
        assert bool(rolled["voiced"][-3:].all())
        assert not bool(rolled["voiced"][:-3].any())
