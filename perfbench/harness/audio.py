"""Speech-like test audio, made from a seed.

An utterance is a run of syllables and pauses. Each syllable is voiced: a
harmonic series on a gliding F0 contour, shaped by three formants of a
vowel drawn for the syllable, under a syllable envelope; pauses hold
breath noise. Every utterance has its own speaker (base F0 from 80 to 260
Hz, so the low-pitch path of the F0 tracker is taken too), speaking rate,
loudness and background noise, from a grid that is the same for every
seed (:func:`speakers`). The random choices are drawn with numpy
from the seed on the host; the synthesis runs in torch on ``device`` in a
few large operations (it is deterministic on one kind of device).

:func:`utterance_pool` gives ``n`` utterances of one length; a traffic
mix reads sessions or batch rows out of the pool at seeded offsets,
wrapping around, so that rows differ while every run of a cell has the
same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000
#: formant centres (Hz) of five vowels: a, e, i, o, u
VOWELS = np.array([[730, 1090, 2440], [530, 1840, 2480], [270, 2290, 3010],
                   [570, 840, 2410], [300, 870, 2240]], np.float64)
HARMONICS = 40


def speakers(n: int) -> np.ndarray:
    """``(n, 4)`` quantiles in (0, 1) of the pool's speakers: base F0,
    speaking rate, loudness and noise level. The same for every seed (a
    stratified grid, each column in its own fixed order), so that a pool's
    F0 range, voicing and loudness, and with them the F0 tracker's and
    K1's work, do not change with the seed; the seed orders the speakers
    and draws every syllable."""
    q = (np.arange(n) + 0.5) / n
    fixed = np.random.default_rng(0)
    return np.stack([q] + [q[fixed.permutation(n)] for _ in range(3)], 1)


def _plan(rng: np.random.Generator, n: int, sr: int,
          speaker: np.ndarray) -> dict:
    """The random choices of one utterance of ``n`` samples by the
    speaker of quantiles ``speaker`` (:func:`speakers`), as per-sample
    control arrays (host, float64)."""
    q_f0, q_rate, q_gain, q_noise = (float(x) for x in speaker)
    base_f0 = float(np.exp(np.log(80.0) + q_f0 * np.log(260.0 / 80.0)))
    rate = 3.0 + 3.0 * q_rate                    # syllables per second
    f0_ctl = np.zeros(n)
    env = np.zeros(n)
    formants = np.zeros((n, 3))
    pos = 0
    while pos < n:
        syl = int(sr * rng.uniform(0.6, 1.4) / rate)
        target = base_f0 * 2.0 ** rng.normal(0.0, 0.25)
        glide = 2.0 ** rng.normal(0.0, 0.12)
        end = min(n, pos + syl)
        m = end - pos
        t = np.linspace(0.0, 1.0, m, endpoint=False)
        f0_ctl[pos:end] = target * glide ** t
        env[pos:end] = np.sin(np.pi * t) ** 0.6 * rng.uniform(0.4, 1.0)
        formants[pos:end] = VOWELS[rng.integers(len(VOWELS))] * \
            rng.uniform(0.9, 1.1)
        pos = end
        if rng.random() < 0.35:                  # a pause
            gap = int(sr * rng.uniform(0.05, 0.6))
            f0_ctl[pos:pos + gap] = target
            formants[pos:pos + gap] = formants[end - 1]
            pos += gap
    return {"f0": f0_ctl, "env": env, "formants": formants,
            "gain": 0.9 * 10.0 ** ((-12.0 + 12.0 * q_gain) / 20.0),
            "noise": 10.0 ** ((-65.0 + 20.0 * q_noise) / 20.0),
            "phase": rng.uniform(0.0, 2 * np.pi),
            "seed": int(rng.integers(2 ** 62))}


def _smooth(x: np.ndarray, width: int) -> np.ndarray:
    """A moving average over ``width`` samples (edges held)."""
    pad = np.pad(x, ((width // 2, width - 1 - width // 2),)
                 + ((0, 0),) * (x.ndim - 1), mode="edge")
    c = np.cumsum(np.concatenate([np.zeros((1,) + x.shape[1:]), pad]), 0)
    return (c[width:] - c[:-width]) / width


def _synthesize(plan: dict, device) -> torch.Tensor:
    sr = SAMPLE_RATE
    f0 = torch.from_numpy(_smooth(plan["f0"], 320)).to(device)
    env = torch.from_numpy(_smooth(plan["env"], 160)).to(device)
    fmt = torch.from_numpy(_smooth(plan["formants"], 480)).to(device)
    phase = torch.cumsum(2 * math.pi * f0 / sr, 0) + plan["phase"]
    h = torch.arange(1, HARMONICS + 1, dtype=torch.float64, device=device)
    fh = f0[:, None] * h                                   # (n, H)
    widths = torch.tensor([90.0, 120.0, 180.0], dtype=torch.float64,
                          device=device)
    amp = torch.exp(-((fh[:, :, None] - fmt[:, None, :]) / widths) ** 2
                    ).sum(-1) + 0.02 / h
    amp = torch.where(fh < 7600.0, amp, torch.zeros((), dtype=amp.dtype,
                                                    device=device))
    voiced = (amp * torch.cos(phase[:, None] * h)).sum(-1)
    voiced = voiced / voiced.abs().max().clamp_min(1e-9)
    gen = torch.Generator(device=device).manual_seed(plan["seed"])
    noise = torch.randn(f0.shape, generator=gen, dtype=torch.float64,
                        device=device)
    x = plan["gain"] * env * voiced + plan["noise"] * noise
    return x.clamp(-1.0, 1.0).to(torch.float32)


def utterance_pool(n: int, seconds: float, seed: int, device="cpu"
                   ) -> torch.Tensor:
    """``(n, round(seconds * 16000))`` float32 utterances in [-1, 1] on
    ``device``, each with its own speaker, from ``seed``."""
    rng = np.random.default_rng(seed)
    length = int(round(seconds * SAMPLE_RATE))
    voices = speakers(n)[rng.permutation(n)]
    plans = [_plan(rng, length, SAMPLE_RATE, v) for v in voices]
    return torch.stack([_synthesize(p, device) for p in plans])


def to_int16(x: torch.Tensor) -> np.ndarray:
    """Float audio in [-1, 1] as int16 PCM on the host."""
    return np.round(x.clamp(-1.0, 32767 / 32768).cpu().numpy()
                    * 32768.0).astype(np.int16)
