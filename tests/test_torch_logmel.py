"""PyTorch port: the fused STFT -> mel -> dB frontend (K3) and the
librosa-style log-mel built on it.

Same numpy inputs through the JAX functions and the port's. The plain form
of the kernel is held against the Pallas kernel (interpret mode on the CPU)
at rtol 1e-4 / atol 1e-3 dB, the bound the JAX package holds its own kernel
to. dB frontends at the same bound; normalized log-mel at 1e-5 absolute
(8e-4 dB); spectra at rtol 1e-5 with an absolute floor of 1e-5 of the
largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import frontend as jax_frontend
from koemorph_tpu.ops import mel as jax_mel
from koemorph_tpu.ops import stft as jax_stft
from koemorph_tpu.ops.pallas import (fused_frames_to_logmel,
                                     fused_log_mel_frontend as jax_fused)
from koemorph_tpu_torch.ops import cuda as ck
from koemorph_tpu_torch.ops import frontend, mel, stft

torch.set_num_threads(2)

SR = 16000


def _audio(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    tone = 0.4 * np.sin(2 * np.pi * (190 + 40 * np.arange(b))[:, None]
                        * t[None, :])
    return (tone + 0.05 * rng.standard_normal((b, n))).astype(np.float32)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_plain_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((37, 1024)).astype(np.float32)
    frames[5] = 0.0                       # a silent frame
    frames[6] *= 1e-4                     # a quiet one
    got = frontend.frames_to_logmel_plain(torch.from_numpy(frames))
    want = np.asarray(fused_frames_to_logmel(jnp.asarray(frames),
                                             interpret=True))
    assert got.shape == (37, 80) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    assert (got[5] == -100.0).all()


def test_dispatch_and_wrapper_devices():
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 3, 1024)).astype(
            np.float32))
    # CPU tensors take the plain form, leading axes kept
    np.testing.assert_array_equal(frontend.frames_to_logmel(x).numpy(),
                                  frontend.frames_to_logmel_plain(x).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        ck.logmel(x[0])
    with pytest.raises(ValueError, match="device"):
        frontend.frames_to_logmel(x.to("meta"))


def test_constants_fold_the_window():
    wc, ws, fb = frontend.logmel_constants(1024, SR, 80, 80.0, 8000.0, "cpu")
    assert wc.shape == ws.shape == (513, 1024) and fb.shape == (513, 80)
    c, s = jax_stft._dft_matrices_np(1024)
    w = np.asarray(jax_stft.hann_window(1024))
    np.testing.assert_allclose(wc.numpy(), (w[:, None] * c).T, atol=1e-7)
    np.testing.assert_allclose(ws.numpy(), (w[:, None] * s).T, atol=1e-7)
    np.testing.assert_array_equal(
        fb.numpy(), np.asarray(jax_mel.mel_filterbank(SR, 1024, 80, 80.0,
                                                      8000.0)))


@pytest.mark.parametrize("hop", [533, 266])
def test_fused_log_mel_frontend(hop):
    a = _audio(2, 12000)
    got = frontend.fused_log_mel_frontend(torch.from_numpy(a),
                                          hop_length=hop)
    want = np.asarray(jax_fused(jnp.asarray(a), hop_length=hop,
                                interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kw", [dict(), dict(center=False, power=1.0),
                                dict(win_length=800, normalized=True),
                                dict(power=0.5)])
def test_stft_power(kw):
    a = _audio(2, 9000, seed=1)
    got = stft.stft_power(torch.from_numpy(a), n_fft=1024, hop_length=533,
                          **kw)
    want = jax_stft.stft_power(jnp.asarray(a), n_fft=1024, hop_length=533,
                               **kw)
    assert got.shape == want.shape
    _close(got.numpy(), want)


def test_stft_power_methods():
    x = torch.zeros(2048)
    # "rfft" is ported (held against JAX by test_torch_frontend_variants.py)
    assert stft.stft_power(x, n_fft=1024, hop_length=533,
                           method="rfft").shape == (4, 513)
    with pytest.raises(ValueError):
        stft.stft_power(x, n_fft=1024, hop_length=533, method="fft2")


@pytest.mark.parametrize("kw", [dict(), dict(ref="max", ref_axes=(-2, -1)),
                                dict(ref="max", top_db=None),
                                dict(ref=3.0, top_db=40.0)])
def test_power_to_db(kw):
    rng = np.random.default_rng(2)
    s = (rng.random((2, 30, 80)) ** 8).astype(np.float32)
    s[0, 3] = 0.0
    got = mel.power_to_db(torch.from_numpy(s), **kw)
    want = np.asarray(jax_mel.power_to_db(jnp.asarray(s), **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        mel.normalize_log_mel(got).numpy(),
        np.asarray(jax_mel.normalize_log_mel(jnp.asarray(got.numpy()))))


@pytest.mark.parametrize("fps", [30.0, 60.0])
def test_log_mel_spectrogram_and_detail(fps):
    a = _audio(2, 20000, seed=4)
    cfg = frontend.LogMelFrontend(target_fps=fps)
    jcfg = jax_frontend.LogMelFrontend(target_fps=fps)
    got = frontend.log_mel_spectrogram(torch.from_numpy(a), cfg)
    want = np.asarray(jax_frontend.log_mel_spectrogram(jnp.asarray(a), jcfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    mel_t, det = frontend.mel_with_temporal_detail(torch.from_numpy(a[0]),
                                                   cfg)
    jmel, jdet = jax_frontend.mel_with_temporal_detail(jnp.asarray(a[0]),
                                                       jcfg)
    np.testing.assert_allclose(mel_t.numpy(), np.asarray(jmel), atol=1e-5)
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), atol=1e-5)
    assert det.shape == (3, 80)


def test_unported_frontend_style_raises():
    # the torchaudio style is ported (test_torch_frontend_variants.py);
    # an unknown style or STFT method raises
    assert frontend.LogMelFrontend(style="torchaudio").style == "torchaudio"
    with pytest.raises(ValueError, match="style"):
        frontend.LogMelFrontend(style="kaldi")
    with pytest.raises(ValueError, match="stft_method"):
        frontend.LogMelFrontend(stft_method="pallas")
