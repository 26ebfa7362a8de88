"""Traffic is made from the seed alone: the same seed gives the same
audio, rows and picks; another seed gives others."""

import numpy as np
import torch

from perfbench.drivers.decode import Batches
from perfbench.drivers.serve import SessionAudio
from perfbench.harness import audio


def test_pool_is_deterministic_by_seed():
    a = audio.utterance_pool(3, 2.0, seed=2 ** 31 + 11)
    b = audio.utterance_pool(3, 2.0, seed=2 ** 31 + 11)
    c = audio.utterance_pool(3, 2.0, seed=2 ** 31 + 12)
    assert a.shape == (3, 32000) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0
    # each utterance its own speaker: no two rows alike
    assert all(not torch.allclose(a[i], a[j]) for i in range(3)
               for j in range(i))


def test_speakers_are_the_same_for_every_seed():
    """The pool's speakers form one stratified grid whatever the seed:
    each column holds every quantile once; the seed only orders them."""
    for n in (2, 9, 48):
        grid = audio.speakers(n)
        assert grid.shape == (n, 4)
        want = (np.arange(n) + 0.5) / n
        for col in grid.T:
            np.testing.assert_allclose(np.sort(col), want)
        np.testing.assert_array_equal(grid, audio.speakers(n))


def test_pool_is_speech_like():
    """Voiced stretches and pauses: the frame energy varies by more than
    20 dB within an utterance, and no utterance is silent."""
    x = audio.utterance_pool(4, 4.0, seed=7).numpy()
    frames = x[:, : 4 * 16000 // 400 * 400].reshape(4, -1, 400)
    db = 10 * np.log10((frames ** 2).mean(-1) + 1e-12)
    assert (db.max(1) - db.min(1) > 20).all()
    assert (db.max(1) > -50).all()


def test_session_hops_wrap_and_repeat():
    pool = audio.to_int16(audio.utterance_pool(2, 1.0, seed=3))
    s1 = SessionAudio(5, 533, pool, np.random.default_rng(9))
    s2 = SessionAudio(5, 533, pool, np.random.default_rng(9))
    for step in (0, 1, 29, 30, 31, 1000):
        h = s1.hops(step)
        assert h.shape == (5, 533) and h.dtype == np.int16
        assert np.array_equal(h, s2.hops(step))
        for s in range(5):
            idx = (s1.off[s] + step * 533 + np.arange(533)) % 16000
            assert np.array_equal(h[s], pool[s1.utt[s], idx])
    lanes = np.array([1, 3])
    assert np.array_equal(s1.hops(7, lanes), s1.hops(7)[lanes])


def test_decode_batches_repeat_by_seed():
    pool = audio.utterance_pool(3, 2.0, seed=5)
    a = Batches(pool, 4, 20000, np.random.default_rng(1))
    b = Batches(pool, 4, 20000, np.random.default_rng(1))
    # drawn in call order, whatever order they are asked for
    x3 = a(3)
    assert torch.equal(b(0), a(0)) and torch.equal(b(3), x3)
    utt, off = a.picks[3]
    for r in range(4):
        idx = (off[r] + np.arange(20000)) % 32000
        assert torch.equal(x3[r], pool[utt[r], idx])
