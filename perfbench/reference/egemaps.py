"""eGeMAPS-style low-level descriptors and 88-D functionals (PyTorch).

The offline decode computes the LLDs of whole utterances
(:func:`compute_llds`, :func:`egemaps_concat_windows`); the streaming
refresh computes LLD rows for the newest audio only
(:func:`compute_lld_block`, with an :class:`LldCarry` that makes chunked
rows equal a single pass), rolls them into a ring, and reduces the ring
into 88 functionals under several offset masks at once
(:func:`functionals_multi_offset`). Every feature implements the eGeMAPS
definition: per-cycle waveform-matched jitter, glottal-cycle peak shimmer,
26-band auditory loudness with equal-loudness weighting, LPC-root formants
(Durand-Kerner roots, :func:`poly_roots`, the plain form), HNR,
spectral balance, flux and MFCC 1-4.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from perfbench.reference.device_cache import scalar_like
from perfbench.reference import f0 as f0_ops
from perfbench.reference.device_cache import device_cache
from perfbench.reference.mel import hz_to_mel, mel_filterbank, mel_to_hz
from perfbench.reference.stft import acf_from_power, power_spectrum_matmul
from perfbench.reference.window import frame_signal, hann_window

NUM_FEATURES = 88

_F0_FUNCTIONALS = (
    "amean", "stddevNorm", "percentile20.0", "percentile50.0",
    "percentile80.0", "pctlrange0-2", "meanRisingSlope", "stddevRisingSlope",
    "meanFallingSlope", "stddevFallingSlope",
)


def feature_names() -> tuple[str, ...]:
    """The 88 eGeMAPSv02 functional names in the order of the functionals
    vector."""
    names: list[str] = []
    names += [f"F0semitoneFrom27.5Hz_sma3nz_{f}" for f in _F0_FUNCTIONALS]
    names += ["jitterLocal_sma3nz_amean", "jitterLocal_sma3nz_stddevNorm"]
    names += [f"loudness_sma3_{f}" for f in _F0_FUNCTIONALS]
    names += ["shimmerLocaldB_sma3nz_amean",
              "shimmerLocaldB_sma3nz_stddevNorm"]
    names += ["HNRdBACF_sma3nz_amean", "HNRdBACF_sma3nz_stddevNorm"]
    names += ["logRelF0-H1-H2_sma3nz_amean",
              "logRelF0-H1-H2_sma3nz_stddevNorm"]
    names += ["logRelF0-H1-A3_sma3nz_amean",
              "logRelF0-H1-A3_sma3nz_stddevNorm"]
    for i in (1, 2, 3):
        names += [f"F{i}frequency_sma3nz_amean",
                  f"F{i}frequency_sma3nz_stddevNorm"]
        names += [f"F{i}bandwidth_sma3nz_amean",
                  f"F{i}bandwidth_sma3nz_stddevNorm"]
        names += [f"F{i}amplitudeLogRelF0_sma3nz_amean",
                  f"F{i}amplitudeLogRelF0_sma3nz_stddevNorm"]
    for band in ("alphaRatioV", "hammarbergIndexV", "slopeV0-500",
                 "slopeV500-1500", "spectralFluxV", "mfcc1V", "mfcc2V",
                 "mfcc3V", "mfcc4V"):
        names += [f"{band}_sma3nz_amean", f"{band}_sma3nz_stddevNorm"]
    for band in ("alphaRatioUV", "hammarbergIndexUV", "slopeUV0-500",
                 "slopeUV500-1500", "spectralFluxUV"):
        names += [f"{band}_sma3nz_amean"]
    for band in ("spectralFlux", "mfcc1", "mfcc2", "mfcc3", "mfcc4"):
        names += [f"{band}_sma3_amean", f"{band}_sma3_stddevNorm"]
    names += ["loudnessPeaksPerSec", "VoicedSegmentsPerSec",
              "MeanVoicedSegmentLengthSec", "StddevVoicedSegmentLengthSec",
              "MeanUnvoicedSegmentLength", "StddevUnvoicedSegmentLength",
              "equivalentSoundLevel_dBp"]
    assert len(names) == NUM_FEATURES, len(names)
    return tuple(names)


FEATURE_NAMES = feature_names()


@dataclasses.dataclass(frozen=True)
class EgemapsConfig:
    sample_rate: int = 16000
    frame_length: int = 400      # 25 ms spectral frame
    hop_length: int = 160        # 10 ms
    n_fft: int = 512
    f0_min: float = 55.0
    f0_max: float = 500.0
    lpc_order: int = 10
    # jitter and shimmer from per-glottal-cycle periods and peaks (the
    # eGeMAPS definitions); False selects the frame-level proxies
    # (frame-to-frame period and RMS changes), which skip the cycle
    # segmentation and so launch no ``cycle_dsum``
    per_period_voice_quality: bool = True
    # cycle slots for consecutive-period jitter in the 512-sample frame
    jitter_cycles: int = 8
    # 1024-sample frames (512 samples of carried left context) give exact
    # cycle pairs to pitches too low for the 512-sample frame
    jitter_long_frames: bool = True
    # "viterbi": YIN's lag picked by a DP path over the best CMNDF dips
    # (ops/f0.py _viterbi_pick). The path couples frames, so a chunked
    # call (the streaming refresh) smooths each block on its own: chunked
    # and monolithic rows may differ near block boundaries, and the
    # chunked == monolithic guarantee holds only for "none"
    f0_smoother: str = "none"


# ---------------------------------------------------------------------------
# masked functional helpers
# ---------------------------------------------------------------------------

def _masked_mean(x, mask, eps=1e-8):
    m = mask.to(x.dtype)
    return torch.sum(x * m, -1) / (torch.sum(m, -1) + eps)


def _masked_std(x, mask, eps=1e-8):
    mean = _masked_mean(x, mask, eps)
    var = _masked_mean((x - mean[..., None]) ** 2, mask, eps)
    return torch.sqrt(torch.clamp_min(var, 0.0))


def _stddev_norm(x, mask, eps=1e-8):
    """Coefficient of variation: stddev / |mean| (eGeMAPS stddevNorm)."""
    return _masked_std(x, mask, eps) / (torch.abs(_masked_mean(x, mask, eps))
                                        + eps)


def _masked_percentiles(x, mask, qs):
    """Percentiles over the masked values, from one sort."""
    s = torch.sort(torch.where(mask, x, float("inf")), -1).values
    n = mask.sum(-1)
    out = []
    for q in qs:
        idx = torch.clamp((q * torch.clamp_min(n - 1, 0)).to(torch.int64),
                          0, x.shape[-1] - 1)
        picked = torch.gather(s, -1, idx[..., None])[..., 0]
        out.append(torch.where(n > 0, picked, 0.0))
    return out


def _shift_right(a, fill):
    return torch.cat([fill, a[..., :-1]], -1)


def _shift_left(a, fill):
    return torch.cat([a[..., 1:], fill], -1)


def _sma3(x, within):
    """3-frame moving average restricted to ``within`` neighbors; frames
    outside ``within`` pass through unchanged."""
    m = within.expand(x.shape).to(x.dtype)
    xm = x * m
    zx = torch.zeros_like(xm[..., :1])
    num = _shift_right(xm, zx) + xm + _shift_left(xm, zx)
    den = _shift_right(m, zx) + m + _shift_left(m, zx)
    sm = num / torch.clamp_min(den, 1.0)
    return torch.where(m > 0, sm, x)


def _majority3(mask):
    """3-frame majority filter on a boolean contour (edges replicate)."""
    m = mask.to(torch.int32)
    l_ = _shift_right(m, m[..., :1])
    r = _shift_left(m, m[..., -1:])
    return (l_ + m + r) >= 2


def _slope_stats(x, mask, frame_period: float):
    """Mean/std of rising and falling slopes of the masked contour."""
    dx = (x[..., 1:] - x[..., :-1]) / frame_period
    valid = mask[..., 1:] & mask[..., :-1]
    rising = valid & (dx > 0)
    falling = valid & (dx < 0)
    return (_masked_mean(dx, rising), _masked_std(dx, rising),
            _masked_mean(dx, falling), _masked_std(dx, falling))


def _segment_stats(mask, frame_period: float, eps=1e-8):
    """``(n_segments, mean_length_s, std_length_s)`` of a boolean contour.

    The run length ending at each frame is its position minus the last
    False position before it (a running max); read at each segment's last
    frame it is that segment's exact length.
    """
    m = mask.to(torch.float32)
    starts = torch.clamp_min(m[..., 1:] - m[..., :-1], 0.0)
    n_segments = torch.sum(starts, -1) + m[..., 0]
    pos = torch.arange(m.shape[-1], device=m.device).expand(m.shape)
    last_zero = torch.cummax(torch.where(mask, -1, pos), -1).values
    runs = torch.where(mask, pos - last_zero, 0).to(torch.float32)
    seg_end = m * torch.cat([1.0 - m[..., 1:], torch.ones_like(m[..., :1])],
                            -1)
    ends = runs * seg_end
    mean_len = torch.sum(ends, -1) / (n_segments + eps)
    var = torch.sum(ends ** 2, -1) / (n_segments + eps) - mean_len ** 2
    std_len = torch.sqrt(torch.clamp_min(var, 0.0)) * frame_period
    return n_segments, mean_len * frame_period, std_len


# ---------------------------------------------------------------------------
# LLD constants
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def equal_loudness_weights(sample_rate: int = 16000, n_bands: int = 26,
                           f_min: float = 20.0,
                           f_max: Optional[float] = None) -> np.ndarray:
    """40-phon equal-loudness contour (Hermansky 1990, eq. 2) at the
    HTK-mel band centres, normalized to 1 at 1 kHz; ``(n_bands,)``."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    grid = mel_to_hz(
        np.linspace(hz_to_mel(f_min, htk=True), hz_to_mel(f_max, htk=True),
                    n_bands + 2), htk=True)
    centers = np.asarray(grid[1:-1], np.float64)

    def contour(f):
        w2 = (2.0 * np.pi * np.asarray(f, np.float64)) ** 2
        return ((w2 + 56.8e6) * w2 ** 2
                / ((w2 + 6.3e6) ** 2 * (w2 + 0.38e9)))

    return (contour(centers) / contour(1000.0)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _mfcc_dct(n_mels: int = 26, n_out: int = 4) -> np.ndarray:
    k = np.arange(1, n_out + 1)[:, None]
    n = np.arange(n_mels)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels))
    return (basis * np.sqrt(2.0 / n_mels)).astype(np.float32)


@device_cache(16)
def _spectral_constants(sr: int, n_fft: int, device: torch.device) -> dict:
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_bins).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def band(lo, hi):
        return t(((freqs >= lo) & (freqs < hi)).astype(np.float32))

    def slope(lo, hi):
        sel = (freqs >= lo) & (freqs < hi)
        fc = freqs[sel] - freqs[sel].mean()
        return (t(np.nonzero(sel)[0]), t(fc), float((fc * fc).sum()))

    return {
        "eq_w": t(equal_loudness_weights(sr, 26, 20.0, sr / 2.0)),
        "dct": t(_mfcc_dct(26, 4)),
        "b_50_1000": band(50, 1000), "b_1000_5000": band(1000, 5000),
        "m02": t((freqs < 2000).astype(np.float32)),
        "m25": band(2000, 5000),
        "slope_0_500": slope(0, 500), "slope_500_1500": slope(500, 1500),
    }


@device_cache(64)
def _index(ids: tuple, device: torch.device) -> torch.Tensor:
    """``ids`` as an int64 tensor on ``device``, built once: no call copies
    an index from the host (a copy that waits for the device, and that a
    CUDA graph cannot capture)."""
    return torch.tensor(ids, dtype=torch.int64, device=device)


@device_cache(16)
def offset_masks(rows: int, cuts: tuple, device: torch.device
                 ) -> torch.Tensor:
    """``(len(cuts), rows)`` frame masks, row ``i`` true before
    ``cuts[i]``; built once per (rows, cuts, device)."""
    return (torch.arange(rows, device=device)[None, :]
            < torch.tensor(cuts, device=device)[:, None])


@device_cache(8)
def _dk_start(p: int, device: torch.device) -> torch.Tensor:
    k = np.arange(p)
    z0 = (0.9 * np.exp(2j * np.pi * (k + 0.35) / p)).astype(np.complex64)
    return torch.from_numpy(z0).to(device)


def _levinson(r: torch.Tensor, order: int) -> torch.Tensor:
    """Levinson-Durbin: autocorrelation (..., order+1) -> error-filter
    coefficients ``A = [1, a_1, ..., a_p]`` (..., order+1)."""
    p: list = [None] * (order + 1)
    err = r[..., 0] + 1e-9
    for i in range(1, order + 1):
        acc = torch.zeros_like(err)
        for j in range(1, i):
            acc = acc + p[j] * r[..., i - j]
        k = (r[..., i] - acc) / err
        updated = {j: p[j] - k * p[i - j] for j in range(1, i)}
        for j, v in updated.items():
            p[j] = v
        p[i] = k
        err = err * (1.0 - k * k) + 1e-12
    return torch.stack([torch.ones_like(err)]
                       + [-p[j] for j in range(1, order + 1)], -1)


def poly_roots_plain(a: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """All ``p`` complex roots of ``P(x) = a_0 x^p + ... + a_p`` for
    coefficients ``a (..., p+1)``, by ``iters`` simultaneous Durand-Kerner
    (Weierstrass) updates from the 0.9-circle start table; a root's step is
    skipped where ``|prod_{j != i} (z_i - z_j)| < 1e-12``. Returns
    (..., p) complex64. Plain PyTorch form of the ``dk_roots`` kernel."""
    p = a.shape[-1] - 1
    dev = a.device
    ac = a.to(torch.complex64)
    z = _dk_start(p, dev).expand(a.shape[:-1] + (p,))
    eye = torch.eye(p, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=torch.complex64, device=dev)
    zero = torch.zeros((), dtype=torch.complex64, device=dev)
    for _ in range(iters):
        diff = torch.where(eye, one, z[..., :, None] - z[..., None, :])
        denom = torch.prod(diff, -1)
        small = torch.abs(denom) < 1e-12
        denom = torch.where(small, one, denom)
        val = ac[..., 0:1].expand(z.shape)
        for i in range(1, p + 1):
            val = val * z + ac[..., i][..., None]
        z = z - torch.where(small, zero, val / denom)
    return z


def poly_roots(a: torch.Tensor) -> torch.Tensor:
    """LPC polynomial roots: the plain form on every device."""
    return poly_roots_plain(a)


def _spectral_peak_db(mag_db: torch.Tensor, center_bin: torch.Tensor
                      ) -> torch.Tensor:
    """Peak dB over the 3 bins around ``center_bin`` (..., T, K)."""
    m3 = torch.maximum(mag_db, torch.maximum(
        _shift_right(mag_db, mag_db[..., :1]),
        _shift_left(mag_db, mag_db[..., -1:])))
    return torch.gather(m3, -1, center_bin.to(torch.int64))


def _cycle_peak_shimmer(yin_frames: torch.Tensor, f0: torch.Tensor,
                        voiced: torch.Tensor, sr: int, max_cycles: int = 8):
    """Per-period shimmer (dB) within each frame: peak |x| of consecutive
    cycles, boundaries at multiples of the frame's period. A frame holding
    fewer than 2 complete cycles reports (0, valid=False)."""
    n = yin_frames.shape[-1]
    dev = yin_frames.device
    tau = torch.where(f0 > 0, torch.div(scalar_like(float(sr), f0),
                                        torch.clamp_min(f0, 1.0)),
                      float("inf"))
    j = torch.arange(n, dtype=torch.float32, device=dev)
    cyc = torch.floor(j / tau[..., None])                     # (..., T, n)
    ci = torch.arange(max_cycles, dtype=torch.float32, device=dev)
    a = torch.where(cyc[..., None, :] == ci[:, None],
                    yin_frames.abs()[..., None, :], 0.0).amax(-1)
    i_idx = torch.arange(max_cycles - 1, dtype=torch.float32, device=dev)
    pair_ok = ((i_idx + 2.0) * tau[..., None] <= n) & voiced[..., None]
    ratio_db = torch.abs(20.0 * (torch.log10(a[..., 1:] + 1e-9)
                                 - torch.log10(a[..., :-1] + 1e-9)))
    s = torch.sum(torch.where(pair_ok, ratio_db, 0.0), -1)
    cnt = torch.sum(pair_ok.to(torch.float32), -1)
    return (torch.where(cnt > 0, s / torch.clamp_min(cnt, 1.0), 0.0),
            voiced & (cnt > 0))


# ---------------------------------------------------------------------------
# LLD block (streaming refresh)
# ---------------------------------------------------------------------------

class LldCarry(NamedTuple):
    """Cross-chunk continuity state: the previous frame's magnitude
    spectrum (spectral flux); with ``per_period_voice_quality=False`` the
    previous frame's period, voicing and RMS (the frame-pairwise jitter
    and shimmer); and for the low-pitch jitter path the 512 samples before
    the next chunk plus how many of them are real stream samples (cycles
    overlapping the zero prefill are masked invalid). Fields a
    configuration does not use are ``None``."""

    prev_mag: torch.Tensor                      # (..., n_bins)
    prev_period: Optional[torch.Tensor] = None  # (...,) seconds
    prev_voiced: Optional[torch.Tensor] = None  # (...,) bool
    prev_amp: Optional[torch.Tensor] = None     # (...,) frame RMS
    audio_tail: Optional[torch.Tensor] = None   # (..., 512)
    ctx_filled: Optional[torch.Tensor] = None   # (...,) int32 in [0, 512]


def _long_jitter_active(cfg: EgemapsConfig) -> bool:
    """The 1024-sample low-pitch jitter path runs when some in-range period
    has no consecutive cycle pair in the 512-sample frame (per-period
    voice quality only)."""
    if not (cfg.per_period_voice_quality and cfg.jitter_cycles
            and cfg.jitter_long_frames):
        return False
    tau_max = int(np.ceil(cfg.sample_rate / cfg.f0_min))
    return 3 * tau_max + 7 > 511


def silence_lld_carry(cfg: EgemapsConfig = EgemapsConfig(),
                      device=None, lanes: Optional[int] = None) -> LldCarry:
    """Carry representing preceding silence (stream start); with
    ``lanes``, one such carry per lane along a leading dim."""
    n_bins = cfg.n_fft // 2 + 1
    lead = () if lanes is None else (lanes,)
    long_fields = {}
    if _long_jitter_active(cfg):
        long_fields = dict(
            audio_tail=torch.zeros(lead + (512,), dtype=torch.float32,
                                   device=device),
            ctx_filled=torch.zeros(lead, dtype=torch.int32, device=device))
    prev_mag = torch.full(lead + (n_bins,), 1e-10, device=device)
    if cfg.per_period_voice_quality:
        return LldCarry(prev_mag=prev_mag, **long_fields)
    return LldCarry(
        prev_mag=prev_mag,
        prev_period=torch.zeros(lead, dtype=torch.float32, device=device),
        prev_voiced=torch.zeros(lead, dtype=torch.bool, device=device),
        prev_amp=torch.zeros(lead, dtype=torch.float32, device=device))


#: LLD channels the streaming ring carries: (name, trailing shape, dtype)
LLD_RING_SPEC: tuple = (
    ("f0_semitone", (), torch.float32), ("voiced", (), torch.bool),
    ("jitter", (), torch.float32), ("loudness", (), torch.float32),
    ("shimmer_db", (), torch.float32), ("hnr_db", (), torch.float32),
    ("h1_h2", (), torch.float32), ("h1_a3", (), torch.float32),
    ("alpha_ratio", (), torch.float32), ("hammarberg", (), torch.float32),
    ("slope_0_500", (), torch.float32),
    ("slope_500_1500", (), torch.float32),
    ("spectral_flux", (), torch.float32), ("mfcc", (4,), torch.float32),
    ("formant_freq", (3,), torch.float32),
    ("formant_bw", (3,), torch.float32),
    ("formant_rel", (3,), torch.float32),
    ("formant_valid", (3,), torch.bool),
    ("jitter_valid", (), torch.bool), ("shimmer_valid", (), torch.bool),
    ("frame_power", (), torch.float32),
)


#: LLD channel -> the position of its row axis, counted from the end
_RING_ROW_AXIS = {k: -1 - len(shape) for k, shape, _ in LLD_RING_SPEC}


def init_lld_ring(rows: int, device=None, lanes: Optional[int] = None
                  ) -> dict[str, torch.Tensor]:
    """All-silence LLD ring: zeros, unvoiced, no formants; ``(rows,
    *trailing)`` per channel, with ``lanes`` ``(lanes, rows, *trailing)``."""
    lead = () if lanes is None else (lanes,)
    return {k: torch.zeros(lead + (rows,) + shape, dtype=dtype,
                           device=device)
            for k, shape, dtype in LLD_RING_SPEC}


def roll_lld_ring(ring: dict[str, torch.Tensor],
                  block: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Shift a block of new rows into the ring (newest rows last). Each
    channel is ``(..., rows, *trailing)``: the roll runs along its row
    axis, so any leading (lane) dims pass through."""
    n_new = block["voiced"].shape[-1]
    out = {}
    for k in ring:
        axis = _RING_ROW_AXIS[k]
        old = ring[k]
        out[k] = torch.cat([old.narrow(axis, n_new, old.shape[axis] - n_new),
                            block[k]], axis)
    return out


def compute_llds(audio: torch.Tensor, cfg: EgemapsConfig = EgemapsConfig()
                 ) -> dict[str, torch.Tensor]:
    """Frame-level LLDs of ``audio (..., L)``: ``(..., T)`` contours (and
    ``(..., T, C)`` channels) for ``T = 1 + (L - 512) // hop`` interior
    frames; the block of :func:`compute_lld_block` from preceding silence
    with frame 0 as its own spectral-flux predecessor."""
    lld, _ = compute_lld_block(audio, cfg, carry=None)
    return lld


def compute_lld_block(chunk: torch.Tensor,
                      cfg: EgemapsConfig = EgemapsConfig(),
                      carry: LldCarry | None = None
                      ) -> tuple[dict[str, torch.Tensor], LldCarry]:
    """LLD rows for a chunk of real samples ``(..., (n_new-1)*hop + 512)``:
    ``n_new`` rows whose 512-sample YIN windows tile the chunk at ``hop``
    spacing, the newest ending at the chunk end. ``carry`` holds the state
    that makes consecutive chunks equal one long chunk; the returned carry
    feeds the next call."""
    hop = cfg.hop_length
    # one ACF serves YIN and HNR: lags up to the deepest voiced period
    n_acf = int(np.ceil(cfg.sample_rate / (cfg.f0_min * 0.9))) + 2
    per_period = cfg.per_period_voice_quality
    core = f0_ops.yin_core(
        chunk, sample_rate=cfg.sample_rate, frame_length=512,
        hop_length=hop, f0_min=cfg.f0_min, f0_max=cfg.f0_max, center=False,
        n_acf_lags=n_acf, subwindow_periods=per_period,
        cycle_periods=cfg.jitter_cycles if per_period else 0,
        smoother=cfg.f0_smoother)
    f0 = core.result.f0_hz
    voiced = core.result.voiced_flag

    # low-pitch per-cycle jitter: 1024-sample frames ending where each
    # 512-sample frame ends, the left context from the carry
    cycles_long = None
    new_tail = new_ctx = None
    if _long_jitter_active(cfg):
        n_new = f0.shape[-1]
        lead = chunk.shape[:-1]
        if carry is None or carry.audio_tail is None:
            audio_tail = torch.zeros(lead + (512,), dtype=chunk.dtype,
                                     device=chunk.device)
            ctx_filled = torch.zeros(lead, dtype=torch.int32,
                                     device=chunk.device)
        else:
            audio_tail, ctx_filled = carry.audio_tail, carry.ctx_filled
        ext = torch.cat([audio_tail, chunk], -1)
        frames_long = frame_signal(ext, 1024, hop, center=False)
        tau_max = int(np.ceil(cfg.sample_rate / cfg.f0_min))
        cp_l, cv_l = f0_ops._per_cycle_periods(
            frames_long, tau_max, core.pick, core.tau,
            n_cycles=min(int(cfg.jitter_cycles), 5), half_lag=16)
        # cycles starting inside the zero prefill compare zeros, not audio
        t_off = torch.arange(n_new, dtype=torch.int32,
                             device=chunk.device) * hop
        ctx_row = torch.clamp_max(ctx_filled[..., None] + t_off, 512)
        zero_len = (512 - ctx_row).to(torch.float32)
        k_row = torch.arange(cp_l.shape[-1], dtype=torch.float32,
                             device=chunk.device)
        cv_l = cv_l & (k_row * core.tau[..., None]
                       >= zero_len[..., None] - 1e-3)
        cycles_long = (cp_l, cv_l)
        new_tail = torch.cat([audio_tail, chunk[..., : n_new * hop]],
                             -1)[..., -512:]
        new_ctx = torch.clamp_max(ctx_filled + n_new * hop, 512)

    # 25 ms spectral frames: the centered slice of the YIN frames
    off = (512 - cfg.frame_length) // 2
    frames = core.frames[..., off:off + cfg.frame_length]
    wframes = frames * hann_window(cfg.frame_length, device=chunk.device)
    cycle_periods = ((core.cycle_period, core.cycle_valid)
                     if per_period and cfg.jitter_cycles else None)
    lld, new_carry = _lld_math(
        frames, wframes, f0, voiced, cfg, carry, yin_acf=core.acf,
        yin_frames=core.frames if per_period else None,
        subwindow_periods=((core.period_first, core.period_second)
                           if per_period else None),
        cycle_periods=cycle_periods, cycle_periods_long=cycles_long)
    if new_tail is not None:
        new_carry = new_carry._replace(audio_tail=new_tail,
                                       ctx_filled=new_ctx)
    return lld, new_carry


def _pair_jitter(t_k, v_k):
    """Mean |consecutive cycle-period difference| / mean period over the
    valid cycle pairs, and the pair count."""
    pair = (v_k[..., :-1] & v_k[..., 1:]).to(t_k.dtype)
    n_pair = torch.sum(pair, -1)
    d_t = torch.abs(t_k[..., 1:] - t_k[..., :-1])
    vf = v_k.to(t_k.dtype)
    mean_t = torch.sum(t_k * vf, -1) / torch.clamp_min(torch.sum(vf, -1), 1.0)
    j = (torch.sum(d_t * pair, -1) / torch.clamp_min(n_pair, 1.0)
         / torch.clamp_min(mean_t, 1e-6))
    return j, n_pair


def _lld_math(frames, wframes, f0, voiced, cfg: EgemapsConfig,
              carry: LldCarry | None, *, yin_acf, yin_frames,
              subwindow_periods, cycle_periods=None,
              cycle_periods_long=None):
    """LLDs of (..., T) frames. ``carry=None`` makes frame 0 its own
    predecessor (zero spectral flux; with ``subwindow_periods`` and
    ``yin_frames`` None, frame 0's own period and RMS for the
    frame-pairwise jitter and shimmer)."""
    sr = cfg.sample_rate
    dev = frames.device
    const = _spectral_constants(sr, cfg.n_fft, dev)

    f0_semitone = torch.where(
        f0 > 0, 12.0 * torch.log2(torch.clamp_min(f0, 1e-3) / 27.5), 0.0)

    ps = power_spectrum_matmul(wframes, cfg.n_fft)
    mag = torch.sqrt(torch.clamp_min(ps, 0.0)) + 1e-10
    power = mag * mag
    n_bins = cfg.n_fft // 2 + 1
    bin_hz = sr / cfg.n_fft

    # loudness: 26-band auditory spectrum, equal-loudness weighted, per-band
    # intensity^0.3 (Stevens) summed; the floor keeps silence at ~0
    fb = mel_filterbank(sr, cfg.n_fft, 26, 20.0, sr / 2, htk=True,
                        norm=None, device=dev)
    mel_energy = torch.matmul(power, fb)
    # summed band by band, left to right: on silence every band is the
    # floor 1e-10 ** 0.3, and the order of the sum decides the sign of what
    # is left after subtracting the floor, which in turn decides whether a
    # silent frame's loudness slope counts as rising or falling
    specific = torch.pow(mel_energy * const["eq_w"] + 1e-10, 0.3)
    loudness = specific[..., 0]
    for b in range(1, specific.shape[-1]):
        loudness = loudness + specific[..., b]
    loudness = loudness - 26 * 1e-3

    amp = torch.sqrt(torch.mean(frames * frames, -1) + 1e-12)
    prev_mag = mag[..., 0, :] if carry is None else carry.prev_mag
    mag_prev = torch.cat([prev_mag[..., None, :], mag[..., :-1, :]], -2)

    if subwindow_periods is not None:
        # jitter: consecutive cycle periods within the frame; low-pitch
        # frames from the 1024-sample frames; else the two half-window
        # periods
        p1, p2 = subwindow_periods
        ok = voiced & (p1 > 0) & (p2 > 0)
        jitter = torch.where(
            ok, torch.abs(p2 - p1) / torch.clamp_min(0.5 * (p1 + p2), 1e-6),
            0.0)
        jitter_valid = ok
        has_cycles = None
        if cycle_periods is not None:
            jitter_cyc, n_pair = _pair_jitter(*cycle_periods)
            has_cycles = voiced & (n_pair >= 1.0)
            jitter = torch.where(has_cycles, jitter_cyc, jitter)
            jitter_valid = jitter_valid | has_cycles
        if cycle_periods_long is not None:
            jitter_long, n_pair_l = _pair_jitter(*cycle_periods_long)
            has_long = voiced & (n_pair_l >= 1.0)
            if has_cycles is not None:
                has_long = has_long & ~has_cycles
            jitter = torch.where(has_long, jitter_long, jitter)
            jitter_valid = jitter_valid | has_long
    else:
        # frame-level jitter: the relative change of the period from the
        # previous frame (the carry's last frame, or frame 0 itself)
        period = _frame_period(f0)
        if carry is not None and carry.prev_period is not None:
            first_p, first_v = carry.prev_period, carry.prev_voiced
        else:
            first_p, first_v = period[..., 0], voiced[..., 0]
        period_prev = torch.cat([first_p[..., None], period[..., :-1]], -1)
        voiced_prev = torch.cat([first_v[..., None], voiced[..., :-1]], -1)
        jitter_valid = voiced & voiced_prev
        jitter = torch.where(jitter_valid,
                             torch.abs(period - period_prev)
                             / torch.clamp_min(period, 1e-6), 0.0)

    if yin_frames is not None:
        shimmer, shimmer_valid = _cycle_peak_shimmer(yin_frames, f0, voiced,
                                                     sr)
    else:
        # frame-level shimmer: the dB change of the frame RMS
        if carry is not None and carry.prev_amp is not None:
            first_a, first_av = carry.prev_amp, carry.prev_voiced
        else:
            first_a, first_av = amp[..., 0], voiced[..., 0]
        amp_prev = torch.cat([first_a[..., None], amp[..., :-1]], -1)
        voiced_prev = torch.cat([first_av[..., None], voiced[..., :-1]], -1)
        shimmer_valid = voiced & voiced_prev
        shimmer = torch.where(
            shimmer_valid,
            torch.abs(20.0 * (torch.log10(amp + 1e-9)
                              - torch.log10(amp_prev + 1e-9))), 0.0)

    # HNR from the YIN frame's ACF at the F0 lag, unbiased for the
    # (N - lag) products the raw ACF sums
    acf = yin_acf
    n_frame = yin_frames.shape[-1] if yin_frames is not None else 512
    r0 = acf[..., 0] + 1e-12
    lag = torch.clamp(torch.div(scalar_like(float(sr), f0),
                                torch.clamp_min(f0, 1.0)).to(torch.int32),
                      1, acf.shape[-1] - 1)
    r_lag = torch.gather(acf, -1, lag.to(torch.int64)[..., None])[..., 0]
    unbias = torch.div(
        scalar_like(float(n_frame), r0),
        torch.clamp_min(n_frame - lag.to(torch.float32), 1.0))
    ratio = torch.clamp(r_lag * unbias / r0, 1e-4, 1 - 1e-4)
    hnr_db = torch.where(voiced, 10.0 * torch.log10(ratio / (1.0 - ratio)),
                         0.0)

    mag_db = 20.0 * torch.log10(mag)

    def band(m):
        return torch.sum(power * m, -1) + 1e-10

    alpha_ratio = 10.0 * (torch.log10(band(const["b_50_1000"]))
                          - torch.log10(band(const["b_1000_5000"])))
    hammarberg = 20.0 * (
        torch.log10(torch.amax(mag * const["m02"], -1) + 1e-10)
        - torch.log10(torch.amax(mag * const["m25"], -1) + 1e-10))

    def slope(key):
        sel, fc, denom = const[key]
        return torch.sum(mag_db.index_select(-1, sel) * fc, -1) / denom

    slope_0_500 = slope("slope_0_500")
    slope_500_1500 = slope("slope_500_1500")

    dmag = mag - mag_prev
    flux = torch.sum(dmag * dmag, -1)

    log_mel = torch.log(mel_energy + 1e-10)
    mfcc = torch.einsum("...tm,km->...tk", log_mel, const["dct"])

    # formants: Levinson -> polynomial roots -> centre frequency from the
    # root angle, -3 dB bandwidth from its radius (bw = -ln|z| sr / pi);
    # the spectral chain's power spectrum already holds the LPC lags
    r = acf_from_power(ps, cfg.n_fft, cfg.lpc_order + 1)
    r = torch.cat([r[..., :1] * (1.0 + 1e-4), r[..., 1:]], -1)
    roots = poly_roots(_levinson(r, cfg.lpc_order))
    cand_f = torch.angle(roots) * (sr / (2.0 * np.pi))
    cand_bw = (-torch.log(torch.clamp(torch.abs(roots), 1e-4, 1.0 - 1e-6))
               * (sr / np.pi))
    cand_ok = ((cand_f > 200.0) & (cand_f < 5450.0) & (cand_bw < 2000.0)
               & torch.isfinite(cand_f))
    # F1..F3 = the three lowest valid centre frequencies, ascending
    top, idx = torch.topk(torch.where(cand_ok, -cand_f, float("-inf")), 3,
                          dim=-1)
    fmt_valid = torch.isfinite(top)
    fmt_f = torch.where(fmt_valid, -top, 0.0)
    fmt_bw = torch.where(fmt_valid, torch.gather(cand_bw, -1, idx), 0.0)

    # spectral peaks: H1, H2 and the harmonic nearest each formant (A1..A3)
    k_max = float(np.ceil(5450.0 / max(cfg.f0_min * 0.9, 1.0)))
    k_harm = torch.clamp(
        torch.round(fmt_f / torch.clamp_min(f0, 1.0)[..., None]), 1.0, k_max)
    mults = torch.cat([torch.ones_like(f0)[..., None],
                       torch.full_like(f0, 2.0)[..., None], k_harm], -1)
    centers = torch.clamp(
        torch.round(torch.div(mults * f0[..., None],
                              scalar_like(bin_hz, f0))).to(torch.int32),
        1, n_bins - 2)
    peaks = _spectral_peak_db(mag_db, centers)
    h1 = peaks[..., 0]
    h2 = peaks[..., 1]
    fmt_amp = peaks[..., 2:5]
    h1_h2 = torch.where(voiced, h1 - h2, 0.0)
    fmt_rel = torch.where(voiced[..., None] & fmt_valid,
                          fmt_amp - h1[..., None], 0.0)
    h1_a3 = torch.where(voiced & fmt_valid[..., 2], h1 - fmt_amp[..., 2], 0.0)

    lld = {
        "f0_semitone": f0_semitone, "voiced": voiced, "f0_hz": f0,
        "jitter": jitter, "loudness": loudness, "shimmer_db": shimmer,
        "hnr_db": hnr_db, "h1_h2": h1_h2, "h1_a3": h1_a3,
        "alpha_ratio": alpha_ratio, "hammarberg": hammarberg,
        "slope_0_500": slope_0_500, "slope_500_1500": slope_500_1500,
        "spectral_flux": flux, "mfcc": mfcc,
        "formant_freq": fmt_f, "formant_bw": fmt_bw, "formant_rel": fmt_rel,
        "formant_valid": fmt_valid,
        "jitter_valid": jitter_valid, "shimmer_valid": shimmer_valid,
        "frame_power": amp * amp,
    }
    if cfg.per_period_voice_quality:
        return lld, LldCarry(prev_mag=mag[..., -1, :])
    return lld, LldCarry(prev_mag=mag[..., -1, :],
                         prev_period=_frame_period(f0[..., -1:])[..., 0],
                         prev_voiced=voiced[..., -1], prev_amp=amp[..., -1])


def _frame_period(f0: torch.Tensor) -> torch.Tensor:
    """Period in seconds of each frame's F0, 0 where unvoiced."""
    return torch.where(f0 > 0, torch.div(scalar_like(1.0, f0),
                                         torch.clamp_min(f0, 1e-3)), 0.0)


# ---------------------------------------------------------------------------
# functionals -> 88-D vectors
# ---------------------------------------------------------------------------

def functionals_from_llds(lld: dict[str, torch.Tensor],
                          cfg: EgemapsConfig = EgemapsConfig(),
                          frame_mask: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The 88 functionals over an LLD matrix, optionally restricted to
    ``frame_mask`` (..., T), in eGeMAPSv02 order. Contours are stacked so
    smoothing, masked means, percentiles and segment statistics each run
    once over all of them."""
    raw_voiced = lld["voiced"]
    if frame_mask is not None:
        voiced = raw_voiced & frame_mask
        all_mask = frame_mask.expand(voiced.shape)
    else:
        voiced = raw_voiced
        all_mask = torch.ones_like(voiced)
    unvoiced = (~raw_voiced) & all_mask
    fp = cfg.hop_length / cfg.sample_rate
    shape = voiced.shape

    # sma3 within the offset window (voiced-only for the *nz* contours);
    # jitter and shimmer only within their measurable frames
    nz_within = raw_voiced & all_mask
    jit_mask = (lld["jitter_valid"] & all_mask).expand(shape)
    shim_mask = (lld["shimmer_valid"] & all_mask).expand(shape)
    fv = lld["formant_valid"].transpose(-1, -2)          # (..., 3, T)
    mfcc_t = lld["mfcc"].transpose(-1, -2)               # (..., 4, T)
    fmt = [lld[k].transpose(-1, -2)
           for k in ("formant_freq", "formant_bw", "formant_rel")]
    h1a3_mask = voiced & fv[..., 2, :]

    sm_x: list = []
    sm_w: list = []

    def sm(x, within):
        sm_x.append(x.expand(shape))
        sm_w.append(within.expand(shape))
        return len(sm_x) - 1

    i_f0 = sm(lld["f0_semitone"], nz_within)
    i_loud = sm(lld["loudness"], all_mask)
    i_jit = sm(lld["jitter"], jit_mask)
    i_shim = sm(lld["shimmer_db"], shim_mask)
    i_hnr = sm(lld["hnr_db"], nz_within)
    i_h1h2 = sm(lld["h1_h2"], nz_within)
    i_h1a3 = sm(lld["h1_a3"], nz_within)
    i_fmt = [[sm(arr[..., i, :], nz_within & fv[..., i, :]) for arr in fmt]
             for i in range(3)]
    i_spec = [sm(lld[k], all_mask)
              for k in ("alpha_ratio", "hammarberg", "slope_0_500",
                        "slope_500_1500", "spectral_flux")]
    i_mfcc = [sm(mfcc_t[..., k, :], all_mask) for k in range(4)]
    smoothed = _sma3(torch.stack(sm_x, -2), torch.stack(sm_w, -2))

    masks = torch.stack(
        [m.expand(shape)
         for m in (voiced, all_mask, unvoiced, jit_mask, shim_mask,
                   h1a3_mask, voiced & fv[..., 0, :], voiced & fv[..., 1, :],
                   voiced & fv[..., 2, :])], -2)
    MI_V, MI_ALL, MI_UNV, MI_JIT, MI_SHIM, MI_H1A3 = range(6)
    MI_FM = [6, 7, 8]

    red: list[tuple[int, int]] = []

    def r(row, mask_idx):
        red.append((row, mask_idx))
        return len(red) - 1

    r_jit = r(i_jit, MI_JIT)
    r_shim = r(i_shim, MI_SHIM)
    r_hnr = r(i_hnr, MI_V)
    r_h1h2 = r(i_h1h2, MI_V)
    r_h1a3 = r(i_h1a3, MI_H1A3)
    r_fmt = [[r(i_fmt[i][t], MI_FM[i]) for t in range(3)] for i in range(3)]
    r_vspec = [r(row, MI_V) for row in i_spec + i_mfcc]
    r_allspec = [r(row, MI_ALL) for row in [i_spec[4]] + i_mfcc]
    r_unv = [r(row, MI_UNV) for row in i_spec]

    dev = smoothed.device

    def take(x, ids):
        return x.index_select(-2, _index(tuple(ids), dev))

    rows = take(smoothed, [a for a, _ in red])
    rmasks = take(masks, [b for _, b in red])
    means = _masked_mean(rows, rmasks)
    stdns = _stddev_norm(rows, rmasks)

    # the two 10-functional contours (F0 voiced, loudness all frames)
    pf = take(smoothed, [i_f0, i_loud])
    pfm = torch.stack([voiced, all_mask], -2)
    p20, p50, p80 = _masked_percentiles(pf, pfm, (0.2, 0.5, 0.8))
    mr, sr_, mf_, sf = _slope_stats(pf, pfm, fp)
    stat_blocks = [_masked_mean(pf, pfm), _stddev_norm(pf, pfm), p20, p50,
                   p80, p80 - p20, mr, sr_, mf_, sf]

    # temporal (6) + equivalent sound level (1)
    duration = all_mask.sum(-1) * fp
    loud = smoothed[..., i_loud, :]
    l_prev = _shift_right(loud, loud[..., :1])
    l_next = _shift_left(loud, loud[..., -1:])
    thresh = _masked_mean(loud, all_mask)[..., None] * 1.1
    peaks = (loud > l_prev) & (loud >= l_next) & (loud > thresh) & all_mask
    maj = _majority3(raw_voiced)
    seg_masks = torch.stack([maj & all_mask, (~maj) & all_mask], -2)
    n_seg, mean_seg, std_seg = _segment_stats(seg_masks, fp)
    temporal = torch.stack(
        [peaks.sum(-1) / duration, n_seg[..., 0] / duration,
         mean_seg[..., 0], std_seg[..., 0], mean_seg[..., 1],
         std_seg[..., 1],
         10.0 * torch.log10(_masked_mean(lld["frame_power"], all_mask)
                            + 1e-12)], -1)

    # eGeMAPSv02 order from one permutation of
    # [10 stat blocks x (f0, loud)] [means] [stddevNorms] [temporal 7]
    pool = torch.cat(stat_blocks + [means, stdns, temporal], -1)
    o_mean, o_stdn = 2 * len(stat_blocks), 2 * len(stat_blocks) + len(red)
    o_temp = o_stdn + len(red)

    def ms(row):
        return [o_mean + row, o_stdn + row]

    perm: list[int] = [2 * b for b in range(10)]     # F0 (10)
    perm += ms(r_jit)                                 # jitter (2)
    perm += [2 * b + 1 for b in range(10)]            # loudness (10)
    perm += ms(r_shim)                                # shimmer (2)
    perm += ms(r_hnr) + ms(r_h1h2) + ms(r_h1a3)       # HNR, H1-H2, H1-A3
    for i in range(3):                                # formants (18)
        for t in range(3):
            perm += ms(r_fmt[i][t])
    for row in r_vspec:                               # voiced spectral (18)
        perm += ms(row)
    perm += [o_mean + row for row in r_unv]           # unvoiced amean (5)
    for row in r_allspec:                             # all-frame spectral
        perm += ms(row)
    perm += [o_temp + k for k in range(7)]            # temporal + level
    out = pool.index_select(-1, _index(tuple(perm), dev))
    assert out.shape[-1] == NUM_FEATURES, out.shape
    return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


def egemaps_functionals(audio: torch.Tensor,
                        cfg: EgemapsConfig = EgemapsConfig()) -> torch.Tensor:
    """The 88 functionals of ``audio (..., L)`` -> ``(..., 88)``."""
    return functionals_from_llds(compute_llds(audio, cfg), cfg)


#: LLD keys whose trailing axes are (T, C) rather than (T,)
_CHANNEL_KEYS = frozenset(
    {"mfcc", "formant_freq", "formant_bw", "formant_rel", "formant_valid"})


def functionals_multi_offset(lld: dict[str, torch.Tensor],
                             cfg: EgemapsConfig,
                             frame_masks: torch.Tensor) -> torch.Tensor:
    """Functionals under ``frame_masks`` (n_off, T) in one pass, offsets as
    a batch axis: ``(..., 88 * n_off)``, offset-major."""
    t = lld["voiced"].shape[-1]
    batch = lld["voiced"].shape[:-1]
    n_off = frame_masks.shape[-2]

    def expand(k, v):
        if k in _CHANNEL_KEYS:
            return v[..., None, :, :].expand(batch + (n_off,) + v.shape[-2:])
        return v[..., None, :].expand(batch + (n_off, t))

    lld_b = {k: expand(k, v) for k, v in lld.items()}
    mask = frame_masks.expand(batch + (n_off, t))
    out = functionals_from_llds(lld_b, cfg, frame_mask=mask)
    return out.reshape(batch + (n_off * NUM_FEATURES,))


def egemaps_concat_windows(audio: torch.Tensor,
                           cfg: EgemapsConfig = EgemapsConfig(),
                           offsets_sec: tuple[float, ...] = (0.0, 0.3, 0.6)
                           ) -> torch.Tensor:
    """Functionals over windows ending ``o`` seconds before the end of
    ``audio (..., L)`` for each offset ``o``: ``(..., 88 * len(offsets))``,
    offset-major. The LLDs are computed once; each offset is a frame mask."""
    lld = compute_llds(audio, cfg)
    t = lld["voiced"].shape[-1]
    fp = cfg.hop_length / cfg.sample_rate
    masks = offset_masks(t, tuple(t - int(round(off / fp))
                                  for off in offsets_sec), audio.device)
    return functionals_multi_offset(lld, cfg, masks)


_CALIBRATION_CACHE: dict = {}

