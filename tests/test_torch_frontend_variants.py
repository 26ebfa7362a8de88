"""PyTorch port: the torchaudio-style frontend, the rfft STFT and the
public framing API, against the JAX package on the same seeded audio.

- ``stft_power(method="rfft")`` (plain and window-normalized power,
  magnitude): rtol 1e-5, atol 1e-6 of the spectrum's peak (FFT rounding
  against XLA's FFT).
- ``LogMelFrontend(style="torchaudio")`` at the reference's n_fft 512:
  natural-log mel within 1e-4 absolute on bins within 80 dB (18.4 in
  natural-log units) of the utterance's peak; a bin far below it holds a
  tiny power whose log amplifies the rounding, held within 1e-2. Both
  ends of its frame count: cut to ``int(L / sr * fps)`` (what the STFT's
  ``1 + L // hop`` frames always give at ``hop = int(sr / fps)``), and
  padded with the last frame (a hop above ``sr / fps``, which only a
  configuration overriding ``hop_length`` reaches).
- The librosa style with ``stft_method="rfft"``, and a
  ``SimplifiedDualStreamModel(stft_method="rfft")``: normalized mel within
  1e-4 (the frontend's bound in ``test_torch_logmel``), blendshapes within
  1e-5.
- ``num_frames`` and ``pad_center_reflect`` equal to JAX's; the port's
  ``ops`` exports JAX's ``ops.__all__``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koemorph_tpu.ops as jops
import koemorph_tpu_torch.ops as tops
from koemorph_tpu.models import dual_stream_model as jdm
from koemorph_tpu.ops import frontend as jfront
from koemorph_tpu.ops import stft as jstft
from koemorph_tpu.ops import window as jwindow
from koemorph_tpu_torch.models import dual_stream_model as dm
from koemorph_tpu_torch.ops import frontend, stft, window
from koemorph_tpu_torch.utils.params import state_dict_from_flax
from tests.test_torch_streaming import _voice

torch.set_num_threads(2)

SR = 16000
TORCHAUDIO = dict(style="torchaudio", n_fft=512, f_min=0.0, f_max=None)


def _audio(n: int = 20000) -> np.ndarray:
    rng = np.random.default_rng(3)
    return np.stack([_voice(n, seed=2),
                     0.1 * rng.standard_normal(n).astype(np.float32)])


@pytest.mark.parametrize("kw", [dict(), dict(normalized=True),
                                dict(power=1.0, n_fft=512, hop_length=160)])
def test_stft_power_rfft_matches_jax(kw):
    a = _audio()
    kw = dict(dict(n_fft=1024, hop_length=533), **kw)
    got = stft.stft_power(torch.from_numpy(a), method="rfft", **kw).numpy()
    want = np.asarray(jstft.stft_power(jnp.asarray(a), method="rfft", **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.max()))
    matmul = stft.stft_power(torch.from_numpy(a), method="matmul",
                             **kw).numpy()
    np.testing.assert_allclose(got, matmul, rtol=1e-4,
                               atol=1e-5 * float(want.max()))


class _WideHop(frontend.LogMelFrontend):
    @property
    def hop_length(self) -> int:
        return 600


@dataclasses.dataclass(frozen=True)
class _JaxWideHop(jfront.LogMelFrontend):
    @property
    def hop_length(self) -> int:
        return 600


def _torchaudio_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    peak = want.max(axis=(-2, -1), keepdims=True)
    near = want >= peak - 80.0 * np.log(10.0) / 10.0
    assert near.mean() > 0.5
    err = np.abs(got - want)
    assert err[near].max() <= 1e-4, float(err[near].max())
    assert err.max() <= 1e-2, float(err.max())


@pytest.mark.parametrize("ends", ["cut", "padded"])
def test_torchaudio_style_matches_jax(ends):
    a = _audio()
    cfg, jcfg = ((frontend.LogMelFrontend(**TORCHAUDIO),
                  jfront.LogMelFrontend(**TORCHAUDIO)) if ends == "cut"
                 else (_WideHop(**TORCHAUDIO), _JaxWideHop(**TORCHAUDIO)))
    got = cfg(torch.from_numpy(a)).numpy()
    want = np.asarray(jfront.log_mel_spectrogram(jnp.asarray(a), jcfg))
    expected = int(a.shape[-1] / SR * 30.0)
    frames = 1 + a.shape[-1] // cfg.hop_length
    assert got.shape == (2, expected, 80)
    assert (frames > expected) == (ends == "cut")
    _torchaudio_close(got, want)
    if ends == "padded":
        # the frames past the STFT's last repeat it
        np.testing.assert_array_equal(
            got[:, frames:], np.broadcast_to(got[:, frames - 1:frames],
                                             got[:, frames:].shape))
    # the rfft method gives the same style
    rfft = dataclasses.replace(cfg, stft_method="rfft")
    _torchaudio_close(rfft(torch.from_numpy(a)).numpy(), want)


def test_librosa_rfft_matches_jax_and_the_kernel_path():
    a = _audio()
    cfg = frontend.LogMelFrontend(stft_method="rfft")
    got = cfg(torch.from_numpy(a)).numpy()
    want = np.asarray(jfront.log_mel_spectrogram(
        jnp.asarray(a), jfront.LogMelFrontend(stft_method="rfft")))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    fused = frontend.LogMelFrontend()(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, fused, rtol=0, atol=1e-4)


def test_model_with_rfft_matches_jax():
    small = dict(d_model=32, num_heads=2, mel_sequence_length=16,
                 emotion_backend="basic", use_concatenation=False)
    jm = jdm.SimplifiedDualStreamModel(**small, stft_method="rfft",
                                       dropout=0.0)
    a = _audio(16 * 533)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.asarray(a))["params"]
    tm = dm.SimplifiedDualStreamModel(**small, stft_method="rfft")
    assert tm.mel_frontend.stft_method == "rfft"
    tm.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.eval()
    want = np.asarray(jm.apply({"params": params},
                               jnp.asarray(a))["blendshapes"])
    with torch.inference_mode():
        got = tm(torch.from_numpy(a))["blendshapes"].numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("center", [True, False])
def test_num_frames_and_reflect_pad_match_jax(center):
    for length in (512, 1023, 1024, 16000, 16001):
        for n_fft, hop in ((1024, 533), (512, 160)):
            if not center and length < n_fft:
                continue
            assert window.num_frames(length, n_fft, hop, center=center) \
                == jwindow.num_frames(length, n_fft, hop, center=center)
            x = np.zeros((2, length), np.float32)
            if center and length > n_fft // 2:
                assert window.frame_signal(torch.from_numpy(x), n_fft,
                                           hop).shape[-2] \
                    == window.num_frames(length, n_fft, hop)
    x = _audio(3000)
    got = window.pad_center_reflect(torch.from_numpy(x), 1024).numpy()
    want = np.asarray(jwindow.pad_center_reflect(jnp.asarray(x), 1024))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 3000 + 1024)


def test_ops_exports_match_jax():
    assert set(tops.__all__) == set(jops.__all__)
    for name in tops.__all__:
        assert getattr(tops, name) is not None, name
    assert tops.EGEMAPS_FEATURE_NAMES == jops.EGEMAPS_FEATURE_NAMES
