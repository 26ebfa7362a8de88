"""A whole run on the CPU at small sizes (the card check skipped) comes
out correct on the program as it is, and not correct with the timed path
broken underneath: a step that leaves its state as it was, half of the
batch left out (the mean of the rest in its place), an answer altered
where it is produced, every step of a stacked training call reading its
first batch; and in serving, a fault in K1, in K2 or in the
model's reading of the emotion vector fails the number that holds that
layer. Each fault is planted in the program's code."""

import dataclasses

import pytest
import torch

from perfbench.tests.helpers import run_small

SERVE = "serve_s2048_g8"
DECODE = "decode60_b8_stride1"
TRAIN = "train_b16_scan"


def _serve_kernel_fault(kind):
    """K1's lag sums mirrored, K2's roots turned by 0.05 rad (a formant
    moved by ~130 Hz), or the emotion vector's features moved one place
    where the model reads it (the state kept as it is; a scale alone
    would vanish in the emotion encoder's LayerNorm)."""
    if kind == "k1":
        from koemorph_tpu_torch.ops import f0
        real = f0.cycle_dsum
        return f0, "cycle_dsum", lambda *a, **kw: real(*a, **kw).flip(-1)
    if kind == "k2":
        from koemorph_tpu_torch.ops import egemaps
        real = egemaps.poly_roots
        turn = complex(torch.exp(torch.tensor(0.05j)))
        return egemaps, "poly_roots", lambda a: real(a) * turn
    from koemorph_tpu_torch.models import dual_stream_model
    cls = dual_stream_model.StreamingDualStreamModel
    real = cls.forward

    def forward(self, mel, detail, emotion_raw, *a, **kw):
        return real(self, mel, detail, emotion_raw.roll(1, -1), *a,
                    **kw)

    return cls, "forward", forward


def _serve_fault(kind):
    if kind in ("k1", "k2", "emotion"):
        return _serve_kernel_fault(kind)
    from koemorph_tpu_torch.runtime import multistream
    real = multistream.stream_step_
    calls = [0]

    def step(model, state, out, hops, cfg, refresh=()):
        calls[0] += 1
        if kind == "state":
            saved = dataclasses.replace(
                state, emotion_raw=state.emotion_raw.clone(),
                lld_ring={k: v.clone() for k, v in state.lld_ring.items()},
                lld_carry=type(state.lld_carry)(*(
                    None if c is None else c.clone()
                    for c in state.lld_carry)))
            prev = state.temporal.prev.clone()
            init = state.temporal.initialized.clone()
        y = real(model, state, out, hops, cfg, refresh)
        if kind == "state":
            out[0].copy_(state.audio_ring)
            out[1].copy_(state.mel_db)
            state.emotion_raw.copy_(saved.emotion_raw)
            for k, v in saved.lld_ring.items():
                state.lld_ring[k].copy_(v)
            for dst, src in zip(state.lld_carry, saved.lld_carry):
                if dst is not None:
                    dst.copy_(src)
            state.temporal.prev.copy_(prev)
            state.temporal.initialized.copy_(init)
        elif kind == "half":
            half = y.shape[0] // 2
            y = torch.cat([y[:half], y[:half].mean(0, keepdim=True).expand(
                y.shape[0] - half, -1)])
        elif kind == "answer" and calls[0] == 5:
            y = y.clone()
            y[1] = y[2]                    # one session's answer wrong
        return y

    return multistream, "stream_step_", step


def _decode_fault(kind):
    from koemorph_tpu_torch.parallel import batched_decode
    cls = batched_decode.BatchedSequentialDecoder
    real = cls._decode
    calls = [0]

    def decode(self, audio):
        calls[0] += 1
        y = real(self, audio)
        if kind == "half":
            half = y.shape[0] // 2
            y = torch.cat([y[:half], y[:half].mean(0, keepdim=True).expand(
                y.shape[0] - half, -1, -1)])
        elif kind == "answer":
            y = y.clone()
            y[1, 3] = y[0, 3]              # one frame's answer wrong
        return y

    return cls, "_decode", decode


def _train_fault(kind):
    from koemorph_tpu_torch.train import optim, trainer
    if kind == "state":
        return optim.Optimizer, "update", lambda self, *a, **kw: None
    if kind == "first":
        # every step of a stacked call reads the stack's first batch
        real_scan = trainer.Trainer._scan

        def scan(self, stacked, order):
            return real_scan(self, stacked, [order[0]] * len(order))

        return trainer.Trainer, "_scan", scan
    real = trainer.SequentialTrainer.loss_from

    def loss_from(self, pred, target, mask):
        half = pred.shape[0] // 2
        return real(self, pred[:half], target[:half],
                    None if mask is None else mask[:half])

    return trainer.SequentialTrainer, "loss_from", loss_from


FAULTS = {SERVE: _serve_fault, DECODE: _decode_fault, TRAIN: _train_fault}


@pytest.mark.parametrize("workload", [SERVE, DECODE, TRAIN])
def test_sound_run_is_correct(workload):
    line = run_small(workload)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("workload,kind", [
    (SERVE, "state"), (SERVE, "half"), (SERVE, "answer"),
    (DECODE, "half"), (DECODE, "answer"), (TRAIN, "state"), (TRAIN, "half"),
    (TRAIN, "first")])
def test_fault_is_not_correct(monkeypatch, workload, kind):
    target, name, fn = FAULTS[workload](kind)
    monkeypatch.setattr(target, name, fn)
    # long enough for several steps on a loaded CPU
    line = run_small(workload, seconds=4.0)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("kind,number", [
    ("k1", "serve_jitter_err"), ("k2", "serve_formant_share"),
    ("emotion", "serve_head_err")])
def test_serve_layer_fault_fails_its_number(monkeypatch, kind, number):
    """A fault in one layer of the refresh or the head fails the number
    that holds that layer."""
    target, name, fn = _serve_fault(kind)
    monkeypatch.setattr(target, name, fn)
    # long enough for a refresh of every checked lane
    line = run_small(SERVE, seconds=4.0)
    assert not line["correct"], line["compared"]
    c = line["compared"][number]
    assert c["value"] > c["limit"], line["compared"]
