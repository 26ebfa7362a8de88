"""PyTorch port: framing, DFT-product spectra and the streaming mel row.

Same numpy inputs through the JAX functions and the port's. Spectra and
autocorrelations are held at rtol 1e-5 with an absolute floor of 1e-5 of
the largest value (near-zero bins carry only rounding); dB mel rows at
1e-4, the incremental-mel bar of the JAX streaming tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import mel as jax_mel
from koemorph_tpu.ops import stft as jax_stft
from koemorph_tpu.ops import window as jax_window
from koemorph_tpu.runtime import streaming as jax_streaming
from koemorph_tpu_torch.ops import mel, stft, window
from koemorph_tpu_torch.runtime import streaming

torch.set_num_threads(2)

KW = dict(window_frames=16, d_model=32, num_heads=2, emotion_context_s=2.0,
          emotion_update_frames=3)


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (0.4 * np.sin(2 * np.pi * 190 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


class TestConstants:
    def test_numpy_builders_are_identical(self):
        for n in (400, 1024):
            np.testing.assert_array_equal(
                window.hann_window(n).numpy(),
                np.asarray(jax_window.hann_window(n)))
        for n_fft in (512, 840, 1024):
            for a, b in zip(stft._dft_matrices_np(n_fft),
                            jax_stft._dft_matrices_np(n_fft)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(stft._iacf_matrix_np(840, 326),
                                      jax_stft._iacf_matrix_np(840, 326))
        for args, kw in (((16000, 1024, 80, 80.0, 8000.0), {}),
                         ((16000, 512, 26, 20.0, 8000.0),
                          dict(htk=True, norm=None))):
            got = mel.mel_filterbank(*args, **kw)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax_mel.mel_filterbank(*args, **kw)))
        np.testing.assert_allclose(mel.hz_to_mel(1234.0, htk=True),
                                   jax_mel.hz_to_mel(1234.0, htk=True))


class TestFraming:
    @pytest.mark.parametrize("center", [False, True])
    @pytest.mark.parametrize("n_fft,hop", [(512, 160), (1024, 533)])
    def test_frame_signal(self, center, n_fft, hop):
        x = _signal(5000)
        got = window.frame_signal(torch.from_numpy(x), n_fft, hop,
                                  center=center)
        want = np.asarray(jax_window.frame_signal(jnp.asarray(x), n_fft, hop,
                                                  center=center))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


class TestSpectra:
    def test_power_spectrum_and_autocorr(self):
        x = _signal(512 * 6).reshape(6, 512)
        x[:, :400] *= np.hanning(400).astype(np.float32)
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
        for n_fft in (512, 840):
            _close(stft.power_spectrum_matmul(tx, n_fft).numpy(),
                   jax_stft.power_spectrum_matmul(jx, n_fft))
        _close(stft.autocorr_matmul(tx, 326).numpy(),
               jax_stft.autocorr_matmul(jx, 326))
        ps = stft.power_spectrum_matmul(tx[:, :400], 512)
        _close(stft.acf_from_power(ps, 512, 11).numpy(),
               jax_stft.acf_from_power(jnp.asarray(ps.numpy()), 512, 11))


class TestStreamingPre:
    def test_new_mel_row_and_stream_pre(self):
        jcfg = jax_streaming.StreamingConfig(**KW)
        tcfg = streaming.StreamingConfig(**KW)
        ring = _signal(jcfg.emotion_ring_len, seed=1)
        np.testing.assert_allclose(
            streaming._new_mel_row(tcfg, torch.from_numpy(ring)).numpy(),
            np.asarray(jax_streaming._new_mel_row(jcfg, jnp.asarray(ring))),
            rtol=1e-4, atol=1e-4)

        jstate = jax_streaming.init_stream_state(jcfg)
        tstate = streaming.init_stream_state(tcfg, "cpu")
        audio = _signal(6 * jcfg.hop_length, seed=2)
        for i in range(6):
            hop = audio[i * jcfg.hop_length:(i + 1) * jcfg.hop_length]
            jring, jdb, jmel, jdet = jax_streaming._stream_pre(
                jstate, jnp.asarray(hop), jcfg)
            tring, tdb, tmel, tdet = streaming._stream_pre(
                tstate, torch.from_numpy(hop), tcfg)
            # the port's ring holds the JAX ring's last audio_ring_len
            # samples: every sample its mel row and refresh read
            np.testing.assert_array_equal(
                tring.numpy(), np.asarray(jring)[-tcfg.audio_ring_len:])
            np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel),
                                       atol=1e-4)
            np.testing.assert_allclose(tdet.numpy(), np.asarray(jdet),
                                       atol=1e-4)
            jstate = jstate.replace(audio_ring=jring, mel_db=jdb)
            tstate.audio_ring, tstate.mel_db = tring, tdb
