"""PyTorch port: mel inversion and Griffin-Lim (``ops/reconstruct.py``)
against the JAX package's ``koemorph_tpu.ops.reconstruct``.

The same numpy inputs go through both. ``mel_to_linear`` and the
overlap-add inverse STFT are held at 1e-5 of the largest value (float32
products and sums in another order; the pseudo-inverse from another SVD).
Griffin-Lim draws its initial phase from ``jax.random`` in JAX and from a
``torch.Generator`` in the port, so the iteration is held from JAX's own
initial spectrum: 8 momentum steps at n_fft 512 over 0.5 s, at 1e-4 of
the signal's peak (each step's rounding differences are amplified by the
momentum 0.99 extrapolation).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import reconstruct as jrec
from koemorph_tpu_torch.ops import reconstruct as rec

SR = 16000


@pytest.mark.parametrize("n_fft,n_mels,f_min,htk,norm", [
    (512, 80, 80.0, True, None),        # the torchaudio-style frontend
    (1024, 80, 80.0, False, "slaney"),  # the librosa-style frontend
    (128, 64, 0.0, True, None),         # filters without a bin
])
def test_mel_to_linear_matches_jax(n_fft, n_mels, f_min, htk, norm):
    rng = np.random.default_rng(n_fft)
    mel = rng.uniform(0.0, 4.0, (2, 20, n_mels)).astype(np.float32)
    kw = dict(sample_rate=SR, n_fft=n_fft, n_mels=n_mels, f_min=f_min,
              htk=htk, norm=norm)
    got = rec.mel_to_linear(torch.from_numpy(mel), **kw).numpy()
    want = np.asarray(jrec.mel_to_linear(jnp.asarray(mel), **kw))
    assert got.shape == want.shape == (2, 20, n_fft // 2 + 1)
    assert (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_istft_overlap_add_matches_jax():
    rng = np.random.default_rng(1)
    spec = (rng.standard_normal((2, 17, 257))
            + 1j * rng.standard_normal((2, 17, 257))).astype(np.complex64)
    got = rec._istft_overlap_add(torch.from_numpy(spec), 512, 128,
                                 2000).numpy()
    want = np.asarray(jrec._istft_overlap_add(jnp.asarray(spec), 512, 128,
                                              2000))
    assert got.shape == want.shape == (2, 2000)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _tone_magnitude(n_fft, hop, length):
    t = np.arange(length) / SR
    x = (0.5 * np.sin(2 * np.pi * 220 * t)
         + 0.2 * np.sin(2 * np.pi * 660 * t)).astype(np.float32)
    from koemorph_tpu.ops.stft import stft_power

    power = np.asarray(stft_power(jnp.asarray(x), n_fft=n_fft,
                                  hop_length=hop))
    return np.sqrt(power).astype(np.float32)


def test_griffin_lim_iteration_matches_jax_from_its_phase():
    n_fft, hop, length, n_iter = 512, 128, 8000, 8
    mag = _tone_magnitude(n_fft, hop, length)
    key = jax.random.PRNGKey(0)
    phase = jax.random.uniform(key, mag.shape, minval=-np.pi, maxval=np.pi)
    spec0 = np.asarray(jnp.asarray(mag)
                       * jnp.exp(1j * phase.astype(jnp.float32)))
    want = np.asarray(jrec.griffin_lim(jnp.asarray(mag), n_fft=n_fft,
                                       hop_length=hop, length=length,
                                       n_iter=n_iter, key=key))
    got = rec._griffin_lim_iterate(
        torch.from_numpy(spec0.copy()), torch.from_numpy(mag), n_fft=n_fft,
        hop_length=hop, length=length, n_iter=n_iter, momentum=0.99).numpy()
    assert got.shape == want.shape == (length,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_griffin_lim_seeded_phase_is_reproducible():
    mag = torch.from_numpy(_tone_magnitude(512, 128, 4000))
    a = rec.griffin_lim(mag, n_fft=512, hop_length=128, length=4000,
                        n_iter=2)
    b = rec.griffin_lim(mag, n_fft=512, hop_length=128, length=4000,
                        n_iter=2, generator=torch.Generator().manual_seed(0))
    c = rec.griffin_lim(mag, n_fft=512, hop_length=128, length=4000,
                        n_iter=2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_reconstruct_audio_round_trip_is_finite():
    n_fft, hop, length = 512, 128, 4000
    mag = torch.from_numpy(_tone_magnitude(n_fft, hop, length))
    from koemorph_tpu_torch.ops.mel import mel_filterbank

    mel = (mag ** 2) @ mel_filterbank(SR, n_fft, 40, htk=True, norm=None)
    out = rec.reconstruct_audio(mel, sample_rate=SR, n_fft=n_fft,
                                hop_length=hop, length=length, n_iter=4)
    assert out.shape == (length,) and torch.isfinite(out).all()


def test_reconstruction_snr_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 1000)).astype(np.float32)
    b = (a[:, :990] + 0.1 * rng.standard_normal((3, 990))).astype(np.float32)
    got = rec.compute_reconstruction_snr(torch.from_numpy(a),
                                         torch.from_numpy(b)).numpy()
    want = np.asarray(jrec.compute_reconstruction_snr(jnp.asarray(a),
                                                      jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    same = rec.compute_reconstruction_snr(torch.from_numpy(a),
                                          torch.from_numpy(a))
    assert torch.all(same > 100.0)       # the 1e-12 noise floor


@pytest.mark.parametrize("args", [
    (16000, 512, 80, 80.0, None, 30.0),       # valid
    (16000, 500, 80, 80.0, 9000.0, 30.0),     # f_max > Nyquist, not 2^k
    (16000, 512, 300, 4000.0, 4000.0, 10.0),  # f_min >= f_max, too many
    (16000, 128, 80, 0.0, None, 30.0),        # empty filters, no overlap
])
def test_validate_mel_parameters_matches_jax(args):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = rec.validate_mel_parameters(*args)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jrec.validate_mel_parameters(*args)
    assert got == want
    assert [str(w.message) for w in got_w] == [str(w.message)
                                               for w in want_w]
    # the checks' own warnings (a filterbank with f_min == f_max also
    # gives numpy's RuntimeWarnings, in both)
    assert [str(w.message) for w in got_w
            if w.category is UserWarning] == got["warnings"]
