"""PyTorch port: the design of the cycle-dsum kernel (K1), held on the CPU.

The CUDA kernel (``koemorph_tpu_torch/ops/cuda/cycle_dsum.cu``) cannot run
here, so these tests hold what it is built from against the JAX package:

(a) the plain form on the strided frame views the kernel reads in place
    equals the JAX form and the Pallas kernel (interpret mode) on the
    materialized frames, rtol = atol = 1e-6;
(b) a numpy emulation of the kernel's per-cycle integer sample ranges
    (ceil of the separately rounded bounds, clipped to the frame) selects
    exactly the plain form's mask, on integer boundaries, many and few
    cycles, zero phase and non-finite periods and phases;
(c) an emulation of the kernel's summation order (a lane's samples of a
    cycle summed by FMA in sample order, then the cycle's lanes added in
    order) agrees with the Pallas kernel to 1e-6 relative, and with
    float64 at least as closely as the JAX form;
(d) the wrapper's layout helper on the views the paths pass, and the
    layouts it rejects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koemorph_tpu.ops import f0 as jax_f0
from koemorph_tpu.ops.pallas.cycle_dsum_kernel import cycle_dsum_lanes_pallas
from koemorph_tpu_torch.ops import cuda as ck
from koemorph_tpu_torch.ops import f0
from koemorph_tpu_torch.ops.window import frame_signal

torch.set_num_threads(2)

TAU_MAX = 291          # ceil(16000 / 55), the eGeMAPS YIN range
HOP = 160
SHAPES = {"n512_K8_L17": (512, 8, 8), "n1024_K5_L33": (1024, 5, 16)}


def _jax_z(frames, start, half_lag):
    s_max = TAU_MAX + half_lag
    pad = (1 << int(np.ceil(np.log2(s_max + 1)))) - 1
    padded = jnp.concatenate(
        [frames, jnp.zeros((frames.shape[0], pad), frames.dtype)], -1)
    return jax_f0._shift_rows(padded, start, frames.shape[1], s_max)


def _jax_sums(frames, start, tau, off, n_cycles, half_lag):
    """(JAX form, Pallas kernel in interpret mode) on (rows, n) frames."""
    fr, st, tu, of = (jnp.asarray(a) for a in (frames, start, tau, off))
    want = np.asarray(jax_f0._cycle_dsum(
        fr, st, tu, tau_max=TAU_MAX, n_cycles=n_cycles, half_lag=half_lag,
        off=of))
    pallas = np.asarray(cycle_dsum_lanes_pallas(
        fr, _jax_z(fr, st, half_lag), st, tu, of, n_cycles=n_cycles,
        half_lag=half_lag, tau_max=TAU_MAX, interpret=True))
    return want, pallas


def _row_inputs(rng, lead, half_lag):
    pick = rng.integers(32, TAU_MAX, size=lead)
    start = np.clip(pick - half_lag, 0, TAU_MAX + half_lag).astype(np.int32)
    tau = (pick + rng.uniform(-0.5, 0.5, lead)).astype(np.float32)
    off = (rng.uniform(0, 0.5, lead) * tau).astype(np.float32)
    return start, tau, off


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- (a) strided views ----

@pytest.mark.parametrize("batched", [False, True], ids=["1d", "batch2"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_strided_view_matches_jax_and_pallas(shape, batched):
    n, k, h = SHAPES[shape]
    rng = np.random.default_rng(n + batched)
    t = 16 if batched else 30
    length = (t - 1) * HOP + n + 37            # a ragged tail
    audio = (rng.standard_normal((2, length) if batched else (length,))
             * 0.3).astype(np.float32)
    view = frame_signal(torch.from_numpy(audio), n, HOP, center=False)
    lead = tuple(view.shape[:-1])
    assert lead == ((2, t) if batched else (t,))
    assert not view.is_contiguous()
    start, tau, off = _row_inputs(rng, lead, h)
    targs = _torch(start, tau, off)
    got = f0.cycle_dsum_plain(view, *targs, n_cycles=k, half_lag=h).numpy()
    assert got.shape == lead + (k, 2 * h + 1)
    # the CPU dispatcher takes the same view
    np.testing.assert_array_equal(
        f0.cycle_dsum(view, *targs, n_cycles=k, half_lag=h).numpy(), got)
    want, pallas = _jax_sums(view.reshape(-1, n).numpy(), start.reshape(-1),
                             tau.reshape(-1), off.reshape(-1), k, h)
    got = got.reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


# ---- (b) per-cycle integer ranges ----

def kernel_ranges(n, start, tau, off, *, n_cycles, half_lag):
    """The kernel's per-cycle sample ranges, emulated in numpy float32:
    (rows, K) first sample and length. Each bound is one rounded multiply
    then one rounded add; the integers j with lo <= j < hi are
    ceil(lo) <= j < ceil(hi); NaN bounds select nothing."""
    span = n - 2 * half_lag
    st = np.clip(start.astype(np.int64), -n, n)[:, None]
    j_min = np.maximum(0, -st).astype(np.float32)
    j_end = (span - np.maximum(st, 0)).astype(np.float32)
    k = np.arange(n_cycles, dtype=np.float32)[None, :]
    with np.errstate(invalid="ignore", over="ignore"):
        lo = off[:, None] + k * tau[:, None]
        hi = off[:, None] + (k + np.float32(1.0)) * tau[:, None]
        cl, ch = np.ceil(lo), np.ceil(hi)
        ok = ~(np.isnan(cl) | np.isnan(ch))
        jb = np.minimum(np.maximum(np.where(ok, cl, 0), j_min), j_end)
        je = np.minimum(np.maximum(np.where(ok, ch, 0), j_min), j_end)
    jb, je = jb.astype(np.int64), je.astype(np.int64)
    return np.where(ok, jb, 0), np.where(ok, np.maximum(je - jb, 0), 0)


def _range_case(case, rows, half_lag, rng):
    pick = rng.integers(32, TAU_MAX, size=rows)
    start = np.clip(pick - half_lag, 0, TAU_MAX + half_lag).astype(np.int32)
    start[:3] = [0, TAU_MAX + half_lag, 1]
    tau = (pick + rng.uniform(-0.5, 0.5, rows)).astype(np.float32)
    off = (rng.uniform(0, 0.5, rows) * tau).astype(np.float32)
    if case == "integer_bounds":
        # off + k*tau exactly on an integer: integer grids, and half-integer
        # periods whose odd multiples meet a half-integer phase
        tau[::2] = rng.integers(8, TAU_MAX + 1, size=tau[::2].shape)
        off[::2] = rng.integers(0, 40, size=off[::2].shape)
        tau[1::2] = rng.integers(16, 2 * TAU_MAX, size=tau[1::2].shape) + 0.5
        off[1::2] = 0.5
    elif case == "tau8":
        tau[:] = 8.0
        tau[1::2] += rng.uniform(0, 0.5, tau[1::2].shape).astype(np.float32)
        off = (rng.uniform(0, 8, rows)).astype(np.float32)
    elif case == "tau_max":
        tau[:] = TAU_MAX
        tau[1::2] += 0.5
        start[:] = TAU_MAX - half_lag
    elif case == "off0":
        off[:] = 0.0
    elif case == "nonfinite":
        tau[0::5], off[1::5] = np.nan, np.nan
        tau[2::5], off[3::5] = np.inf, -np.inf
        tau[4::10] = -tau[4::10]
    return start, tau, off


RANGE_CASES = ["random", "integer_bounds", "tau8", "tau_max", "off0",
               "nonfinite"]


@pytest.mark.parametrize("case", RANGE_CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_cycle_ranges_select_the_plain_mask(shape, case):
    n, k, h = SHAPES[shape]
    rng = np.random.default_rng(RANGE_CASES.index(case) + n)
    rows = 200
    start, tau, off = _range_case(case, rows, h, rng)
    jb, ln = kernel_ranges(n, start, tau, off, n_cycles=k, half_lag=h)
    j = np.arange(n - 2 * h)
    emulated = (j >= jb[..., None]) & (j < (jb + ln)[..., None])
    plain = f0.cycle_masks(n, *_torch(start, tau, off), n_cycles=k,
                           half_lag=h).numpy()
    np.testing.assert_array_equal(emulated, plain)
    if case == "integer_bounds":
        # the sweep does put a cycle boundary on an integer sample
        lo = off[:, None] + np.arange(1, k, dtype=np.float32) * tau[:, None]
        assert (lo == np.round(lo)).sum() > rows
    if case == "nonfinite":
        bad = ~np.isfinite(tau) | ~np.isfinite(off) | (tau < 0)
        assert not plain[bad].any()
        assert plain[~bad].any(-1).any(-1).all()


# ---- (c) summation order ----

CHUNK, LANES = 15, 32          # cycle_dsum.cu's kChunk, a warp


def kernel_sums(frames, start, tau, off, *, n_cycles, half_lag, run_rows):
    """The kernel's arithmetic in numpy. Rows go in runs of ``run_rows``,
    one warp each. Each cycle is cut into chunks of 15 samples from its
    first, numbered in (row, k, j) order; lane t of ``act = min(32,
    chunks)`` takes chunks [t * chunks / act, (t + 1) * chunks / act) and
    sums each cycle's samples among them by fused multiply-add in sample
    order into slot cycle + t; a cycle's slots are added in lane order.
    Asserts that no slot is written twice and that the reduction reads
    exactly the slots written for the cycle."""
    rows, n = frames.shape
    n_lag = 2 * half_lag + 1
    jb, ln = kernel_ranges(n, start, tau, off, n_cycles=n_cycles,
                           half_lag=half_lag)
    out = np.zeros((rows, n_cycles, n_lag), np.float32)
    for r0 in range(0, rows, run_rows):
        r1 = min(rows, r0 + run_rows)
        pj, pn = jb[r0:r1].reshape(-1), ln[r0:r1].reshape(-1)
        pm = -(-pn // CHUNK)
        pc = np.concatenate([[0], np.cumsum(pm)[:-1]])
        chunks = int(pm.sum())
        act = min(LANES, chunks)
        slots = {}
        for t in range(act):
            for c in range(t * chunks // act, (t + 1) * chunks // act):
                p = int(np.searchsorted(pc, c, side="right")) - 1
                while pm[p] == 0:
                    p -= 1
                x = frames[r0 + p // n_cycles]
                st = int(start[r0 + p // n_cycles])
                if (p, t) not in slots:
                    slots[p, t] = np.zeros(n_lag, np.float64)
                acc = slots[p, t]
                i0 = pj[p] + (c - pc[p]) * CHUNK
                for j in range(i0, min(i0 + CHUNK, pj[p] + pn[p])):
                    e = (x[j] - x[j + st:j + st + n_lag]).astype(np.float64)
                    # e*e is exact in float64: one rounding, as an FMA
                    acc = (acc + e * e).astype(np.float32).astype(np.float64)
                slots[p, t] = acc
        assert len({p + t for p, t in slots}) == len(slots)
        for p in np.flatnonzero(pm):
            t0 = ((pc[p] + 1) * act - 1) // chunks
            t1 = ((pc[p] + pm[p]) * act - 1) // chunks
            acc = np.zeros(n_lag, np.float32)
            for t in range(t0, t1 + 1):
                acc = acc + slots.pop((p, t)).astype(np.float32)
            out[r0 + p // n_cycles, p % n_cycles] = acc
        assert not slots
    return out


def _float64_sums(frames, start, mask, half_lag):
    """The same float32 differences, squared and summed in float64."""
    n_lag = 2 * half_lag + 1
    span = mask.shape[-1]
    idx = start[:, None, None] + np.arange(span)[None, None, :] \
        + np.arange(n_lag)[None, :, None]
    padded = np.pad(frames, ((0, 0), (0, frames.shape[-1])))
    z = np.take_along_axis(padded[:, None, :].repeat(n_lag, 1), idx, -1)
    e = (frames[:, None, :span] - z).astype(np.float64)      # (R, L, J)
    return np.einsum("rkj,rlj->rkl", mask.astype(np.float64), e * e)


@pytest.mark.parametrize("case", ["random", "integer_bounds", "tau8"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_summation_order_matches_jax(shape, case):
    n, k, h = SHAPES[shape]
    rng = np.random.default_rng(7 + n + len(case))
    rows = 12
    frames = (rng.standard_normal((rows, n)) * 0.3).astype(np.float32)
    start, tau, off = _range_case(case, rows, h, rng)
    want, pallas = _jax_sums(frames, start, tau, off, k, h)
    assert (want > 0).sum() > rows
    mask = f0.cycle_masks(n, *_torch(start, tau, off), n_cycles=k,
                          half_lag=h).numpy()
    ref = _float64_sums(frames, np.clip(start, 0, n), mask, h)
    live = ref > 0

    def rel(x):
        return np.abs(x - ref)[live] / ref[live]

    # one frame per warp (the stream) and runs of several (the decode)
    for run_rows in (1, 3, 32 // k):
        got = kernel_sums(frames, start, tau, off, n_cycles=k, half_lag=h,
                          run_rows=run_rows)
        np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=0)
        # against the XLA form through float64: its one (K, J) x (J, L)
        # product rounds up to ~1.3e-6 relative on these rows, the
        # kernel's order (a lane's samples of a cycle, then the lanes)
        # several times less
        assert rel(got).max() <= 1e-6
        assert rel(got).max() <= rel(want).max()


# ---- (d) layouts ----

def _ring_slice_view():
    ring = torch.arange(20000, dtype=torch.float32)
    chunk = ring[-(29 * HOP + 512):]          # the stream's refresh slice
    return frame_signal(chunk, 512, HOP, center=False)


LAYOUTS = {
    "contiguous": (lambda: torch.zeros(30, 512),
                   ck.FrameLayout(0, 0, 512, 30, 1)),
    "unfold_1d": (lambda: frame_signal(torch.zeros(29 * HOP + 1024), 1024,
                                       HOP, center=False),
                  ck.FrameLayout(0, 0, HOP, 30, 1)),
    "unfold_2d": (lambda: frame_signal(torch.zeros(2, 9000), 512, HOP,
                                       center=False),
                  ck.FrameLayout(0, 9000, HOP, 1 + (9000 - 512) // HOP, 2)),
    "ring_slice": (_ring_slice_view,
                   ck.FrameLayout(20000 - (29 * HOP + 512), 0, HOP, 30, 1)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_frame_layout(name):
    make, expected = LAYOUTS[name]
    view = make()
    lay = ck.frame_layout(view)
    assert lay == expected
    # the layout addresses every sample of every frame
    n = view.shape[-1]
    rebuilt = torch.as_strided(view, (lay.batches, lay.frames, n),
                               (lay.batch_stride, lay.frame_stride, 1),
                               lay.offset)
    assert torch.equal(rebuilt, view.reshape(lay.batches, lay.frames, n))


REJECTED = {
    "last_stride": lambda: torch.zeros(30, 1024)[:, ::2],
    "unmergeable_batch": lambda: frame_signal(
        torch.zeros(3, 2, 9000).transpose(0, 1), 512, HOP, center=False),
}


@pytest.mark.parametrize("name", list(REJECTED))
def test_frame_layout_rejects(name):
    with pytest.raises(ValueError):
        ck.frame_layout(REJECTED[name]())
