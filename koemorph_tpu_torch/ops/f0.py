"""YIN F0 with per-glottal-cycle and half-window period estimates.

The difference function ``d(tau) = r0 + r_tau - 2 c(tau)`` takes its cross
term ``c`` from Wiener-Khinchin DFT products (kept as products rather than
an FFT or a direct correlation: a change of rounding flips YIN's pick on
borderline frames) and its energy terms from a running sum over the short
lag axis. The per-cycle difference sums behind exact jitter
(:func:`cycle_dsum`) are a hand-written CUDA kernel on the GPU.
``smoother="viterbi"`` replaces YIN's per-frame pick with a dynamic
programming path over the best CMNDF dips (:func:`_viterbi_pick`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from koemorph_tpu_torch.device import scalar_like
from koemorph_tpu_torch.ops import cuda as cuda_kernels
from koemorph_tpu_torch.ops.device_cache import device_cache
from koemorph_tpu_torch.ops.stft import acf_from_power, power_spectrum_matmul
from koemorph_tpu_torch.ops.window import frame_signal


class F0Result(NamedTuple):
    f0_hz: torch.Tensor        # (..., T) Hz, 0 where unvoiced
    voiced_prob: torch.Tensor  # (..., T) in [0, 1]
    voiced_flag: torch.Tensor  # (..., T) bool


class YinCore(NamedTuple):
    """YIN result plus the intermediates the eGeMAPS chain reuses."""

    result: F0Result
    frames: torch.Tensor         # (..., T, frame_length) raw frames
    acf: torch.Tensor            # (..., T, n_acf_lags) full-frame ACF
    period_first: torch.Tensor   # (..., T) first-half period (samples)
    period_second: torch.Tensor  # (..., T) second-half period
    cycle_period: Optional[torch.Tensor] = None  # (..., T, K) samples
    cycle_valid: Optional[torch.Tensor] = None   # (..., T, K) bool
    pick: Optional[torch.Tensor] = None          # (..., T) int32 lag
    tau: Optional[torch.Tensor] = None           # (..., T) refined period


@functools.lru_cache(maxsize=16)
def _tau_range(sample_rate: int, f0_min: float, f0_max: float
               ) -> tuple[int, int]:
    tau_min = max(int(sample_rate / f0_max), 1)
    tau_max = int(np.ceil(sample_rate / f0_min))
    return tau_min, tau_max


@device_cache(16)
def _span_masks(n: int, spans: tuple, device: torch.device) -> torch.Tensor:
    iota = np.arange(n)
    m = np.stack([((iota >= lo) & (iota < hi)).astype(np.float32)
                  for lo, hi in spans])
    return torch.from_numpy(m).to(device)


def _yin_acfs(frames: torch.Tensor, tau_max: int, n_lags: int,
              subwindows: bool):
    """Autocorrelations of the YIN spans in one DFT product pair: the full
    frame at ``n_lags`` lags, the tail (last ``tau_max`` samples), and with
    ``subwindows`` the first-half restricted cross term
    ``c_first(tau) = sum_{j < W/2} x_j x_{j+tau}``. Each span is selected
    by a mask inside the frame (the ACF is shift-invariant)."""
    n = frames.shape[-1]
    w = n - tau_max
    half = w // 2
    spans = [(0, n), (w, n)]
    if subwindows:
        spans += [(0, half + tau_max), (half, half + tau_max)]
    masks = _span_masks(n, tuple(spans), frames.device)
    stacked = frames[..., None, :, :] * masks[:, None, :]
    n_fft = ((n + n_lags + 7) // 8) * 8
    acfs = acf_from_power(power_spectrum_matmul(stacked, n_fft), n_fft,
                          n_lags)
    c_first = (acfs[..., 2, :, : tau_max + 1] - acfs[..., 3, :, : tau_max + 1]
               if subwindows else None)
    return acfs[..., 0, :, :], acfs[..., 1, :, : tau_max + 1], c_first


def yin_frame_difference(frames: torch.Tensor, tau_max: int
                         ) -> torch.Tensor:
    """YIN difference function ``d(tau)``, ``tau in [0, tau_max]``, of
    ``(..., T, N)`` frames over the correlation window ``W = N - tau_max``:
    ``(..., T, tau_max + 1)``."""
    return _yin_difference_and_acf(frames, tau_max, tau_max + 1)[0]


def _lag_energy(sq: torch.Tensor, lo: int, count: int, tau_max: int):
    """r0 = sum of the ``count`` squares from ``lo``, and r_tau, the same
    window shifted by tau, as r0 plus a running sum over the lag axis."""
    r0 = sq[..., lo: lo + count].sum(-1, keepdim=True)
    diff = (sq[..., lo + count: lo + count + tau_max]
            - sq[..., lo: lo + tau_max])
    return r0, r0 + torch.cat([torch.zeros_like(r0),
                               torch.cumsum(diff, -1)], -1)


def _yin_difference_and_acf(frames: torch.Tensor, tau_max: int,
                            n_acf_lags: int, subwindows: bool = False):
    """(d(tau) for tau in [0, tau_max], full-frame acf[0, n_acf_lags),
    the cross term c(tau) = sum_{j<W} x_j x_{j+tau}, and with
    ``subwindows`` the first-half cross term)."""
    n = frames.shape[-1]
    w = n - tau_max
    if w <= 0:
        raise ValueError(f"frame length {n} must exceed tau_max {tau_max}")
    acf_full, acf_tail, c_first = _yin_acfs(
        frames, tau_max, max(tau_max + 1, n_acf_lags), subwindows)
    c = acf_full[..., : tau_max + 1] - acf_tail
    r0, r_tau = _lag_energy(frames * frames, 0, w, tau_max)
    d = r0 + r_tau - 2.0 * c
    return torch.clamp_min(d, 0.0), acf_full, c, c_first


def cmndf(d: torch.Tensor) -> torch.Tensor:
    """Cumulative-mean-normalized difference function d'(tau)."""
    tau = torch.arange(d.shape[-1], dtype=d.dtype, device=d.device)
    out = d * tau / torch.clamp_min(torch.cumsum(d, -1), 1e-12)
    out[..., 0] = 1.0
    return out


def _parabola_offset(y0, y1, y2):
    denom = y0 - 2 * y1 + y2
    ok = torch.abs(denom) > 1e-12
    off = torch.where(ok, 0.5 * (y0 - y2) / torch.where(ok, denom, 1.0), 0.0)
    return torch.clamp(off, -1.0, 1.0)


def yin_f0(
    audio: torch.Tensor,
    *,
    sample_rate: int = 16000,
    frame_length: int = 1024,
    hop_length: int = 160,
    f0_min: float = 50.0,
    f0_max: float = 400.0,
    threshold: float = 0.15,
    center: bool = True,
    smoother: str = "none",
) -> F0Result:
    """Per-frame F0 of ``audio (..., L)`` -> ``(..., T)`` Hz, 0 where a
    frame's CMNDF minimum is above ~3x ``threshold`` (unvoiced).
    ``smoother="viterbi"`` tracks the contour with :func:`_viterbi_pick`."""
    return yin_core(
        audio, sample_rate=sample_rate, frame_length=frame_length,
        hop_length=hop_length, f0_min=f0_min, f0_max=f0_max,
        threshold=threshold, center=center, smoother=smoother).result


def yin_core(
    audio: torch.Tensor,
    *,
    sample_rate: int = 16000,
    frame_length: int = 1024,
    hop_length: int = 160,
    f0_min: float = 50.0,
    f0_max: float = 400.0,
    threshold: float = 0.15,
    center: bool = True,
    n_acf_lags: Optional[int] = None,
    subwindow_periods: bool = False,
    cycle_periods: int = 0,
    smoother: str = "none",
) -> YinCore:
    """Per-frame YIN F0 of ``audio (..., L)`` plus the frames, the
    full-frame autocorrelation (``n_acf_lags`` lags), and optionally the
    half-window and per-cycle period estimates (see :class:`YinCore`).
    ``smoother="viterbi"`` picks each frame's lag by :func:`_viterbi_pick`
    instead of the first dip below ``threshold``; the path couples frames,
    so a chunked call smooths each chunk on its own."""
    if smoother not in ("none", "viterbi"):
        raise ValueError(f"smoother must be 'none' or 'viterbi', "
                         f"got {smoother!r}")
    tau_min, tau_max = _tau_range(sample_rate, f0_min, f0_max)
    if frame_length <= tau_max + 8:
        raise ValueError(
            f"frame_length {frame_length} too small for f0_min {f0_min} "
            f"(needs > {tau_max + 8})")

    frames = frame_signal(audio, frame_length, hop_length, center=center)
    d, acf, c_all, c_first = _yin_difference_and_acf(
        frames, tau_max, n_acf_lags or (tau_max + 1),
        subwindows=subwindow_periods)
    dprime = cmndf(d)

    # the local minimum of the first dip below threshold; global minimum
    # when no dip qualifies
    region = dprime[..., tau_min:]
    nxt = torch.cat([region[..., 1:],
                     torch.full_like(region[..., :1], float("inf"))], -1)
    candidate = (region < threshold) & (region <= nxt)
    idx = torch.argmax(candidate.to(torch.uint8), -1)
    pick = torch.where(candidate.any(-1), idx,
                       torch.argmin(region, -1)) + tau_min
    if smoother == "viterbi":
        # periodicity hint from the global CMNDF minimum: frames with no
        # deep dip anywhere (or no energy) are free resets of the path
        rms_hint = torch.sqrt(torch.mean(frames * frames, -1))
        hint = ((torch.amin(region, -1) < 3.0 * threshold)
                & (rms_hint > 1e-4))
        pick = _viterbi_pick(dprime, tau_min=tau_min,
                             voiced_hint=hint).to(torch.int64)

    last = dprime.shape[-1] - 1
    ys = torch.gather(dprime, -1, torch.stack(
        [torch.clamp(pick - 1, 0, last), pick,
         torch.clamp(pick + 1, 0, last)], -1))
    y0, y1, y2 = ys[..., 0], ys[..., 1], ys[..., 2]
    tau_refined = pick.to(torch.float32) + _parabola_offset(y0, y1, y2)

    f0 = torch.div(scalar_like(float(sample_rate), tau_refined),
                   torch.clamp_min(tau_refined, 1.0))
    dp_min = y1
    # energy gate: silence has a degenerate all-zero difference function
    rms = torch.sqrt(torch.mean(frames * frames, -1))
    has_energy = rms > 1e-4
    voiced_prob = torch.clamp(1.0 - dp_min / (3.0 * threshold), 0.0, 1.0)
    voiced_prob = torch.where(has_energy, voiced_prob, 0.0)
    voiced = (dp_min < 3.0 * threshold) & has_energy
    f0 = torch.where(voiced, f0, 0.0)
    f0 = torch.where((f0 >= f0_min * 0.9) & (f0 <= f0_max * 1.1), f0, 0.0)
    voiced = voiced & (f0 > 0)
    result = F0Result(f0_hz=f0, voiced_prob=voiced_prob, voiced_flag=voiced)

    if subwindow_periods:
        p1, p2 = _subwindow_periods(frames, tau_max, pick, c_all, c_first)
    else:
        p1 = p2 = torch.zeros_like(f0)
    cp = cv = None
    if cycle_periods > 0:
        cp, cv = _per_cycle_periods(frames, tau_max, pick, tau_refined,
                                    cycle_periods)
    return YinCore(result=result, frames=frames, acf=acf,
                   period_first=p1, period_second=p2,
                   cycle_period=cp, cycle_valid=cv,
                   pick=pick.to(torch.int32), tau=tau_refined)


@device_cache(8)
def _log2_table(n: int, device: torch.device) -> torch.Tensor:
    """``log2(k)`` for ``k in [0, n)`` in float32, as the reference's
    float32 ``log2`` gives it on the CPU: ``log(k)`` rounded to float32,
    times the float32 ``1 / ln 2`` (its ``log(k) / log(2)`` with the
    division by a constant folded into that product). Read by index, so
    the CPU and the GPU use the same values."""
    k = np.arange(n, dtype=np.float64)
    with np.errstate(divide="ignore"):
        log_k = np.log(k).astype(np.float32)
    return torch.from_numpy(log_k * np.float32(1.0 / np.log(2.0))).to(device)


def _viterbi_pick(dprime: torch.Tensor, *, tau_min: int,
                  voiced_hint: torch.Tensor, n_candidates: int = 5,
                  transition_cost: float = 4.0,
                  octave_cost: float = 0.1) -> torch.Tensor:
    """Octave-robust pitch pick: a Viterbi path over CMNDF dip candidates.

    - candidates: the ``n_candidates`` lowest CMNDF values per frame by
      masked argmin, each winner excluding lags within 25% of its period;
    - emission cost: the candidate's CMNDF value plus ``octave_cost *
      log2(lag / tau_min)`` (a mild preference for the higher F0); an
      exhausted slot (all excluded) costs 1e9;
    - transition cost: ``transition_cost * |log2(lag_t / lag_{t-1})|``
      between consecutive frames that are both periodic
      (``voiced_hint``); a gap resets the path for free;
    - a forward pass over frames keeping each candidate's best cost
      (renormalized to a minimum of 0 each frame) and back pointers, then
      a backtrack from the cheapest last candidate.

    The pass is sequential in frames: one loop iteration (a few small
    kernels) per frame forward and one gather per frame back.

    Args:
        dprime: ``(..., T, n_lags)`` CMNDF.
        voiced_hint: ``(..., T)`` bool, the frame shows periodicity.

    Returns:
        ``(..., T)`` int32 chosen lags.
    """
    lead = dprime.shape[:-2]
    t_frames, m = dprime.shape[-2], dprime.shape[-1] - tau_min
    dev = dprime.device
    region = dprime[..., tau_min:].reshape(-1, t_frames, m)
    hint = voiced_hint.reshape(-1, t_frames)
    r = region.shape[0]

    iota = torch.arange(m, dtype=torch.float32, device=dev)
    masked = region
    picks, vals = [], []
    for _ in range(n_candidates):
        best, cidx = torch.min(masked, -1)
        picks.append(cidx)
        vals.append(best)
        excl = 0.25 * (cidx.to(torch.float32) + tau_min)
        near = torch.abs(iota - cidx[..., None].to(torch.float32)) \
            < excl[..., None]
        masked = torch.where(near, float("inf"), masked)
    cand = torch.stack(picks, -1) + tau_min                    # (R, T, N)
    ltau = _log2_table(dprime.shape[-1], dev)[cand]
    log2_min = float(np.float32(np.log2(tau_min)))
    emit = torch.stack(vals, -1) + octave_cost * (ltau - log2_min)
    emit = torch.where(torch.isfinite(emit), emit, 1e9)

    # transitions between frames t-1 and t, (R, T-1, N_prev, N)
    link = (hint[:, 1:] & hint[:, :-1]).to(torch.float32)
    trans = (transition_cost
             * torch.abs(ltau[:, 1:, None, :] - ltau[:, :-1, :, None])
             * link[:, :, None, None])
    cost = emit[:, 0]
    bps = []
    for t in range(1, t_frames):
        best, bp = torch.min(cost[:, :, None] + trans[:, t - 1], 1)
        cost = emit[:, t] + best
        cost = cost - torch.amin(cost, -1, keepdim=True)
        bps.append(bp)

    node = torch.argmin(cost, -1, keepdim=True)                # (R, 1)
    path = [node]
    for bp in reversed(bps):
        node = torch.gather(bp, 1, node)
        path.append(node)
    path = torch.cat(path[::-1], 1)                            # (R, T)
    chosen = torch.gather(cand, -1, path[..., None])[..., 0]
    return chosen.to(torch.int32).reshape(lead + (t_frames,))


def _refine_period_local(d_sub: torch.Tensor, pick: torch.Tensor,
                         half_width: int = 8) -> torch.Tensor:
    """Sub-sample period: the first minimum of ``d_sub`` within
    ``pick +/- half_width`` lags, refined by a parabola."""
    n = d_sub.shape[-1]
    iota = torch.arange(n, dtype=pick.dtype, device=pick.device)
    lo = torch.clamp(pick - half_width, 1, n - 2)[..., None]
    hi = torch.clamp(pick + half_width, 1, n - 2)[..., None]
    masked = torch.where((iota >= lo) & (iota <= hi), d_sub, float("inf"))
    center = torch.argmin(masked, -1)
    y1 = torch.amin(masked, -1)
    ys = torch.gather(d_sub, -1, torch.stack(
        [torch.clamp(center - 1, 0, n - 1),
         torch.clamp(center + 1, 0, n - 1)], -1))
    return (center.to(torch.float32)
            + _parabola_offset(ys[..., 0], y1, ys[..., 1]))


def cycle_masks(n: int, start: torch.Tensor, tau: torch.Tensor,
                off: torch.Tensor, *, n_cycles: int, half_lag: int
                ) -> torch.Tensor:
    """(rows, n_cycles, n - 2*half_lag) bool: sample ``j`` is in cycle
    ``k`` of row ``r`` (see :func:`cycle_dsum_plain`)."""
    dev = tau.device
    span = n - 2 * half_lag
    iota = torch.arange(span, dtype=torch.float32, device=dev)
    k = torch.arange(n_cycles, dtype=torch.float32, device=dev)[:, None]
    tau_b = tau[:, None, None]
    off_b = off[:, None, None]
    lim = ((n - 1.0) - 2.0 * half_lag) - start.to(torch.float32)
    return ((iota >= off_b + k * tau_b) & (iota < off_b + (k + 1.0) * tau_b)
            & (iota <= lim[:, None, None]))


def cycle_dsum_plain(frames: torch.Tensor, start: torch.Tensor,
                     tau: torch.Tensor, off: torch.Tensor, *,
                     n_cycles: int, half_lag: int) -> torch.Tensor:
    """Cycle-restricted difference sums, plain PyTorch form.

    ``d[r, k, o] = sum_j m[r, k, j] * (x[r, j] - x[r, j + start[r] + o])^2``
    with ``x`` zero past its ``n`` samples, ``j < n - 2*half_lag``, and the
    cycle mask ``off + k*tau <= j < off + (k+1)*tau`` (each bound one
    rounded multiply then one rounded add) restricted to
    ``j <= n - 1 - 2*half_lag - start``.

    Args:
        frames: (..., T, n) float32 frames (any view).
        start: (..., T) int comparison-span starts, in [0, n).
        tau: (..., T) float32 frame-level periods.
        off: (..., T) float32 cycle-grid phase offsets.

    Returns:
        (..., T, n_cycles, 2*half_lag + 1) float32.
    """
    lead, n = frames.shape[:-1], frames.shape[-1]
    frames = frames.reshape(-1, n)
    start, tau, off = (v.reshape(-1) for v in (start, tau, off))
    dev = frames.device
    n_lag = 2 * half_lag + 1
    span = n - n_lag + 1
    idx = (start.to(torch.int64)[:, None]
           + torch.arange(n, device=dev)[None, :])
    z = torch.gather(F.pad(frames, (0, n)), 1, idx)         # x[j + start]
    e = (frames[:, None, :span] - z.unfold(1, span, 1)) ** 2   # (R, L, J)
    m = cycle_masks(n, start, tau, off, n_cycles=n_cycles, half_lag=half_lag)
    return torch.einsum("rkj,rlj->rkl", m.to(frames.dtype), e).reshape(
        lead + (n_cycles, n_lag))


def cycle_dsum(frames: torch.Tensor, start: torch.Tensor, tau: torch.Tensor,
               off: torch.Tensor, *, n_cycles: int, half_lag: int
               ) -> torch.Tensor:
    """Cycle-restricted difference sums (see :func:`cycle_dsum_plain`):
    the CUDA kernel for CUDA tensors (the frames read in place), the plain
    form for CPU tensors."""
    if frames.device.type == "cuda":
        return cuda_kernels.cycle_dsum(
            frames, start.to(torch.int32), tau, off,
            n_cycles=n_cycles, half_lag=half_lag)
    if frames.device.type == "cpu":
        return cycle_dsum_plain(frames, start, tau, off,
                                n_cycles=n_cycles, half_lag=half_lag)
    raise ValueError(f"cycle_dsum: unsupported device {frames.device}")


def _per_cycle_periods(frames: torch.Tensor, tau_max: int,
                       pick: torch.Tensor, tau: torch.Tensor,
                       n_cycles: int, half_lag: int = 8):
    """Per-glottal-cycle periods by waveform matching.

    Cycle ``k`` spans ``[off + k*tau, off + (k+1)*tau)`` of the frame, the
    grid phase ``off`` putting the first cycle's largest ``|x|`` mid-cycle;
    its period is the lag minimizing the cycle-restricted difference
    function over ``pick +/- half_lag``, refined by a parabola.

    Returns ``(periods (..., T, K) samples, valid (..., T, K) bool)``: a
    cycle is valid when its compared samples lie inside the frame and the
    minimum is not at an edge of the search band.
    """
    n = frames.shape[-1]
    n_lag = 2 * half_lag + 1
    dev = frames.device
    start = torch.clamp(pick - half_lag, 0, tau_max + half_lag)
    iota_n = torch.arange(n, dtype=torch.float32, device=dev)
    m0 = iota_n < torch.ceil(tau)[..., None]
    p0 = torch.argmax(torch.where(m0, frames.abs(), -1.0), -1)
    grid_off = torch.clamp_min(p0.to(torch.float32) - 0.5 * tau, 0.0)

    d = cycle_dsum(frames, start, tau, grid_off, n_cycles=n_cycles,
                   half_lag=half_lag)

    o_star = torch.argmin(d, -1)
    y1 = torch.amin(d, -1)
    ys = torch.gather(d, -1, torch.stack(
        [torch.clamp(o_star - 1, 0, n_lag - 1),
         torch.clamp(o_star + 1, 0, n_lag - 1)], -1))
    start_f = start.to(torch.float32)[..., None]
    periods = (start_f + o_star.to(torch.float32)
               + _parabola_offset(ys[..., 0], y1, ys[..., 1]))

    k_row = torch.arange(n_cycles, dtype=torch.float32, device=dev)
    # the last sample the in-cycle mask includes
    last_sample = torch.ceil(grid_off[..., None]
                             + (k_row + 1.0) * tau[..., None]) - 1.0
    in_band = (o_star > 0) & (o_star < n_lag - 1)
    valid = ((tau[..., None] > 0) & in_band
             & (last_sample + start_f + 2.0 * half_lag <= n - 1.0))
    return periods, valid


def _subwindow_periods(frames: torch.Tensor, tau_max: int,
                       pick: torch.Tensor, c_all: torch.Tensor,
                       c_first: torch.Tensor):
    """Waveform-matched period over each half of the YIN correlation
    window (correlation restricted to j < W/2, then W/2 <= j < W)."""
    n = frames.shape[-1]
    w = n - tau_max
    half = w // 2
    sq = frames * frames
    r0_1, rtau_1 = _lag_energy(sq, 0, half, tau_max)
    r0_2, rtau_2 = _lag_energy(sq, half, w - half, tau_max)
    d1 = torch.clamp_min(r0_1 + rtau_1 - 2.0 * c_first, 0.0)
    d2 = torch.clamp_min(r0_2 + rtau_2 - 2.0 * (c_all - c_first), 0.0)
    return _refine_period_local(d1, pick), _refine_period_local(d2, pick)
