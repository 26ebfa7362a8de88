"""PyTorch port: the fused STFT -> mel -> dB kernel reads its frames in
place.

``ops.cuda.logmel`` takes the ``(..., T, n_fft)`` views the paths hold
(rows of the multi-session audio rings, at an odd row stride and any
4-byte alignment; the decode's ``unfold`` views) by their frame layout,
and rejects with ``ValueError`` what it cannot address, before it looks
at the device: here on the CPU a view it takes gets as far as "needs CUDA
tensors", one it cannot take fails on its layout. The frontend's plain
form gives a view the same values as its contiguous copy.
"""

import numpy as np
import pytest
import torch

from koemorph_tpu_torch.ops import cuda as ck
from koemorph_tpu_torch.ops import frontend
from koemorph_tpu_torch.ops.window import frame_signal

# the flagship stream's ring: 619 hops of 533 samples, an odd row stride
RING_LEN = 619 * 533
OFFSET = RING_LEN - 1024 - (-512) % 533


def _rings(lanes: int) -> torch.Tensor:
    rng = np.random.default_rng(5)
    return torch.from_numpy(
        (0.3 * rng.standard_normal((lanes, RING_LEN))).astype(np.float32))


ACCEPTED = {
    # the server's newest frame of each lane: (S, n_fft), row stride L
    "ring_rows": (lambda: _rings(64)[:, OFFSET:OFFSET + 1024],
                  ck.FrameLayout(OFFSET, 0, RING_LEN, 64, 1)),
    "ring_rows_s4": (lambda: _rings(4)[:, OFFSET:OFFSET + 1024],
                     ck.FrameLayout(OFFSET, 0, RING_LEN, 4, 1)),
    # contiguous frames starting 12 bytes past a 16-byte boundary
    "unaligned": (lambda: _rings(1)[0, 3:3 + 16 * 1024].reshape(16, 1024),
                  ck.FrameLayout(3, 0, 1024, 16, 1)),
    # the decode's global STFT frames: an unfold per utterance
    "unfold": (lambda: frame_signal(_rings(2)[:, :40000], 1024, 533,
                                    center=False),
               ck.FrameLayout(0, RING_LEN, 533, 1 + (40000 - 1024) // 533,
                              2)),
}


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_logmel_reads_views_in_place(name):
    make, expected = ACCEPTED[name]
    view = make()
    assert not view.is_contiguous() or view.storage_offset() % 4
    assert ck.frame_layout(view) == expected
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ck.logmel(view)
    got = frontend.frames_to_logmel(view).numpy()
    want = frontend.frames_to_logmel_plain(view.contiguous()).numpy()
    assert got.shape == view.shape[:-1] + (80,)
    if view.dim() == 2:                  # the same products, the same bits
        np.testing.assert_array_equal(got, want)
    else:                                # batched products: CPU BLAS order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _meta(shape, strides):
    return torch.empty_strided(shape, strides, device="meta")


REJECTED = {
    "last_stride": (lambda: _rings(2)[:, :2048:2], "last stride"),
    "unmergeable": (lambda: frame_signal(
        torch.zeros(3, 2, 9000).transpose(0, 1), 1024, 533, center=False),
        "do not merge"),
    "frame_stride_2_31": (lambda: _meta((2, 1024), (2 ** 31, 1)),
                          "32-bit strides"),
    "last_batch_2_31": (lambda: _meta((3, 4, 1024), (2 ** 30, 533, 1)),
                        "32-bit strides"),
    "n_fft": (lambda: torch.zeros(4, 1000), "unsupported n_fft"),
    "dtype": (lambda: torch.zeros(4, 1024, dtype=torch.float64),
              "float32"),
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_logmel_rejects_what_it_cannot_address(name):
    make, match = REJECTED[name]
    with pytest.raises(ValueError, match=match):
        ck.logmel(make())


def test_cycle_dsum_rejects_a_last_batch_past_32_bits():
    """A cohort's LLD frames are a view with batch stride G * ring_len:
    the last batch's offset must fit the kernel's 32-bit strides."""
    def scalars(dtype=torch.float32):
        return torch.zeros(3, 30, dtype=dtype, device="meta")

    kw = dict(n_cycles=8, half_lag=8)
    with pytest.raises(ValueError, match="32-bit strides"):
        ck.cycle_dsum(_meta((3, 30, 512), (2 ** 30, 160, 1)),
                      scalars(torch.int32), scalars(), scalars(), **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ck.cycle_dsum(_meta((3, 30, 512), (2 ** 30 - 1, 160, 1)),
                      scalars(torch.int32), scalars(), scalars(), **kw)
