"""backward_device_ms.train: median device ms per step of the slice's
backward stage (torch.autograd.grad), from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "train", ("backward",))
