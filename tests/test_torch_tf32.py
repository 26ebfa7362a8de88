"""PyTorch port: the host side of the ``logmel`` kernel's 3xTF32 design.

- ``tf32_split``: ``big`` and ``small`` have their low 13 mantissa bits
  zero, round to nearest with ties away from zero (``cvt.rna.tf32.f32``),
  and ``|big + small - x| <= 2**-21 |x|``.
- The kernel's arithmetic emulated here in plain torch (its own RNA by bit
  masks, the three products ``big*big + big*small + small*big`` summed in
  float64, over the live bins of the kernel's constants) against the
  Pallas kernel (interpret mode) at rtol 1e-4 / atol 1e-3 dB, the bound the
  JAX package holds its kernel to; on a high-dynamic-range set its error
  against float64 at most twice the plain form's, or 1e-3 dB.
- The live bins ``[lo, hi)``: the plain form restricted to them equals the
  full plain form within 1e-6 dB in float64 arithmetic (in float32 within
  2e-5 dB: the products then sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops.pallas import fused_frames_to_logmel
from koemorph_tpu_torch.ops import frontend

torch.set_num_threads(2)

SR = 16000
FLAGSHIP = dict(sample_rate=SR, n_mels=80, f_min=80.0, f_max=8000.0)


def _rna(x: torch.Tensor) -> torch.Tensor:
    """TF32 round to nearest, ties away from zero, by bit masks: add half
    a TF32 ulp to the magnitude, clear the low 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulated_logmel(frames: torch.Tensor, **kw) -> torch.Tensor:
    """The batch kernel's function on the host: the constants it is handed,
    the frames split as it splits them in shared memory, its three products
    per basis summed in float64, power and mel sums in float64."""
    c = frontend.logmel_kernel_constants(frames.shape[-1], device="cpu",
                                         **kw)
    fb = _rna(frames)
    fs = _rna(frames - fb)
    fb64, fs64 = fb.double(), fs.double()
    parts = []
    for q in (0, 2):                           # Wc, then Ws
        wb, ws = c.bases[q].double(), c.bases[q + 1].double()
        parts.append(fb64 @ wb.T + fs64 @ wb.T + fb64 @ ws.T)
    power = parts[0] ** 2 + parts[1] ** 2
    mel = power @ c.fb.double()
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))


def _frames37() -> np.ndarray:
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((37, 1024)).astype(np.float32)
    frames[5] = 0.0                       # a silent frame
    frames[6] *= 1e-4                     # a quiet one
    return frames


def _hdr_frames(t: int, seed: int = 11) -> np.ndarray:
    """A near-full-scale tone per frame (0.95, frequencies across the mel
    range) plus white noise 90 dB below the tone's power."""
    rng = np.random.default_rng(seed)
    n = np.arange(1024)
    f0 = 200.0 + (7791.0 - 200.0) * rng.random(t)
    ph = 2 * np.pi * rng.random(t)
    tone = 0.95 * np.sin(2 * np.pi * f0[:, None] * n / SR + ph[:, None])
    sigma = 0.95 / np.sqrt(2.0) * 10.0 ** (-90.0 / 20.0)
    return (tone + sigma * rng.standard_normal((t, 1024))).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 1e-41])
def test_tf32_split_bits_and_error(scale):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096) * scale).astype(
        np.float32))
    big, small = frontend.tf32_split(x)
    for part in (big, small):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (big.double() + small.double() - x.double()).abs()
    if scale >= 1e-30:                    # normal numbers: relative bound
        assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    else:       # subnormals: to half of TF32's spacing there, 2**-136
        assert float(err.max()) <= 2.0 ** -137


def test_tf32_split_rounds_ties_away_from_zero():
    # 1 + 2**-11 is halfway between two TF32 neighbours 1 and 1 + 2**-10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0, 0.0],
                     dtype=torch.float32)
    big, small = frontend.tf32_split(x)
    np.testing.assert_array_equal(
        big.numpy(), np.float32([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                                 3.0, 0.0]))
    np.testing.assert_array_equal(
        small.numpy(), np.float32([-(2.0 ** -11), 2.0 ** -11, 2.0 ** -11,
                                   0.0, 0.0]))
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    np.testing.assert_array_equal(frontend.tf32_split(y)[0].numpy(),
                                  _rna(y).numpy())


def test_kernel_constants_layout():
    c = frontend.logmel_kernel_constants(1024, device="cpu", **FLAGSHIP)
    wc, ws, fb = frontend.logmel_constants(1024, device="cpu", **FLAGSHIP)
    assert (c.lo, c.hi, c.groups) == (6, 512, 8)
    assert c.bases.shape == (4, 512, 1024) and c.fb.shape == (512, 80)
    live = c.hi - c.lo
    for q, basis in ((0, wc), (2, ws)):
        big, small = c.bases[q, :live], c.bases[q + 1, :live]
        np.testing.assert_array_equal(big.numpy(),
                                      _rna(basis[c.lo:c.hi]).numpy())
        np.testing.assert_array_equal(
            small.numpy(), _rna(basis[c.lo:c.hi] - big).numpy())
    assert not c.bases[:, live:].any() and not c.fb[live:].any()
    np.testing.assert_array_equal(c.fb[:live].numpy(), fb[c.lo:c.hi].numpy())
    np.testing.assert_array_equal(c.wc.numpy(), wc[c.lo:c.hi].numpy())
    np.testing.assert_array_equal(c.ws.numpy(), ws[c.lo:c.hi].numpy())
    # each mel's span holds exactly its nonzero weights, packed in order
    fb_t = fb[c.lo:c.hi].T
    for m in range(80):
        lo, hi, at = c.spans[m].tolist()
        row = fb_t[m]
        assert bool((row[lo:hi] > 0).all()) and not row[:lo].any() \
            and not row[hi:].any()
        np.testing.assert_array_equal(c.fb_nz[at:at + hi - lo].numpy(),
                                      row[lo:hi].numpy())
    assert c.fb_nz.numel() == int((fb_t > 0).sum()) == c.spans[-1, 2] \
        + c.spans[-1, 1] - c.spans[-1, 0]


def test_emulated_3xtf32_matches_pallas_kernel():
    frames = _frames37()
    got = _emulated_logmel(torch.from_numpy(frames), **FLAGSHIP)
    want = np.asarray(fused_frames_to_logmel(jnp.asarray(frames),
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    assert (got[5] == -100.0).all()


@pytest.mark.parametrize("t", [1, 48])
def test_emulated_3xtf32_high_dynamic_range(t):
    x = torch.from_numpy(_hdr_frames(t))
    wc, ws, fb = (a.double() for a in frontend.logmel_constants(
        1024, device="cpu", **FLAGSHIP))
    x64 = x.double()
    ref = 10.0 * torch.log10(torch.clamp_min(
        ((x64 @ wc.T) ** 2 + (x64 @ ws.T) ** 2) @ fb, 1e-10))
    keep = ref >= ref.amax(1, keepdim=True) - 80.0
    assert int(keep.sum()) >= 5 * t
    e_emul = float((_emulated_logmel(x, **FLAGSHIP) - ref).abs()[keep].max())
    e_plain = float((frontend.frames_to_logmel_plain(x).double()
                     - ref).abs()[keep].max())
    assert e_emul <= max(2.0 * e_plain, 1e-3), (e_emul, e_plain)


@pytest.mark.parametrize("fps", [30.0, 60.0])
def test_live_bins_flagship(fps):
    kw = frontend.LogMelFrontend(target_fps=fps).logmel_kwargs()
    assert frontend.logmel_live_bins(1024, **kw) == (6, 512)


@pytest.mark.parametrize("f_min,f_max", [(80.0, 8000.0), (80.0, 6000.0),
                                         (300.0, 4000.0), (0.0, 7600.0)])
def test_live_bins_restricted_plain_equals_full(f_min, f_max):
    kw = dict(sample_rate=SR, n_mels=80, f_min=f_min, f_max=f_max)
    lo, hi = frontend.logmel_live_bins(1024, **kw)
    wc, ws, fb = frontend.logmel_constants(1024, device="cpu", **kw)
    assert not fb[:lo].any() and not fb[hi:].any()
    assert fb[lo].any() and fb[hi - 1].any()
    x = torch.from_numpy(_frames37())

    def logmel(x, wc, ws, fb):
        re, im = x @ wc.T, x @ ws.T
        return 10.0 * torch.log10(torch.clamp_min((re * re + im * im) @ fb,
                                                  1e-10))

    np.testing.assert_allclose(
        logmel(x.double(), wc[lo:hi].double(), ws[lo:hi].double(),
               fb[lo:hi].double()).numpy(),
        logmel(x.double(), wc.double(), ws.double(), fb.double()).numpy(),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        logmel(x, wc[lo:hi], ws[lo:hi], fb[lo:hi]).numpy(),
        frontend.frames_to_logmel_plain(x, **kw).numpy(), rtol=0, atol=2e-5)

