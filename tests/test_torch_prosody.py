"""PyTorch port: prosodic features (``ops/prosody.py``) against the JAX
package's ``koemorph_tpu.ops.prosody``.

The same numpy audio goes through both (JAX's ``extract_prosody``
jitted). ``extract_prosody`` is held on a voiced and a silent clip, one
clip and a batch of two: F0 at rtol 1e-5 (on frames both call voiced;
the port's YIN differs from JAX's by float32 rounding), log-energy and
voicing probability at 1e-5, VAD exactly.
``median3``, ``interpolate_unvoiced`` and the ``jnp.interp`` resampling
are held exactly or at 1e-6 (elementwise float32), and normalize /
denormalize round-trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import prosody as jpro
from koemorph_tpu_torch.ops import prosody as pro

SR = 16000


def _voiced(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 110.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = np.cumsum(2 * np.pi * f0 / SR)
    x = sum(np.cos(h * phase) / h for h in range(1, 12))
    gate = ((t % 0.5) < 0.35).astype(np.float64)     # voiced / pause
    return (0.3 * x * gate + 0.002 * rng.standard_normal(t.shape)).astype(
        np.float32)


CLIPS = {
    "voiced": _voiced(1.5, 0),
    "voiced batch": np.stack([_voiced(1.5, 1), _voiced(1.5, 2)]),
    "silent": np.zeros(int(1.5 * SR), np.float32),
}


@pytest.fixture(scope="module")
def jax_prosody():
    fn = jax.jit(jpro.extract_prosody)
    return {k: np.asarray(fn(jnp.asarray(v))) for k, v in CLIPS.items()}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_extract_prosody_matches_jax(name, jax_prosody):
    want = jax_prosody[name]
    got = pro.extract_prosody(torch.from_numpy(CLIPS[name])).numpy()
    assert got.shape == want.shape
    assert want.shape[-2:] == (45, 4)
    voiced = (want[..., 0] > 0) & (got[..., 0] > 0)
    assert (voiced == (want[..., 0] > 0)).all()
    if name != "silent":
        assert voiced.mean() > 0.5
    np.testing.assert_allclose(got[..., 0][voiced], want[..., 0][voiced],
                               rtol=1e-5)
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=0, atol=1e-5)


def test_median_and_interpolation_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        pro.median3(torch.from_numpy(x), k=5).numpy(),
        np.asarray(jpro.median3(jnp.asarray(x), k=5)))
    f0 = rng.uniform(80, 300, (3, 40)).astype(np.float32)
    voiced = rng.uniform(0, 1, (3, 40)) > 0.5
    voiced[0] = False                   # nothing to interpolate from
    voiced[1, :3] = voiced[1, -3:] = False
    got = pro.interpolate_unvoiced(torch.from_numpy(f0),
                                   torch.from_numpy(voiced)).numpy()
    want = np.asarray(jpro.interpolate_unvoiced(jnp.asarray(f0),
                                                jnp.asarray(voiced)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got[0], f0[0])


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(4)
    xp = np.arange(50, dtype=np.float32) * np.float32(0.01)
    fp = rng.standard_normal((2, 50)).astype(np.float32)
    x = np.concatenate([[-0.1, 0.0], rng.uniform(0, 0.5, 30), [0.49, 0.7]]
                       ).astype(np.float32)
    got = pro._interp(torch.from_numpy(x), torch.from_numpy(xp),
                      torch.from_numpy(fp)).numpy()
    want = np.stack([np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                           jnp.asarray(row))) for row in fp])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("log_f0", [True, False])
def test_normalize_round_trip_and_jax(log_f0):
    rng = np.random.default_rng(5)
    feats = np.stack([np.where(rng.uniform(0, 1, 30) > 0.3,
                               rng.uniform(80, 300, 30), 0.0),
                      rng.normal(-5, 2, 30), rng.integers(0, 2, 30),
                      rng.uniform(0, 1, 30)], -1).astype(np.float32)
    norm = pro.normalize_prosody(torch.from_numpy(feats),
                                 f0_log_transform=log_f0)
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jpro.normalize_prosody(
            jnp.asarray(feats), f0_log_transform=log_f0)),
        rtol=1e-5, atol=1e-5)
    back = pro.denormalize_prosody(norm, f0_log_transform=log_f0).numpy()
    np.testing.assert_allclose(back, feats, rtol=1e-4, atol=1e-4)
