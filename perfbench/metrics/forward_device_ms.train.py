"""forward_device_ms.train: median device ms per step of the slice's
forward stage (the rest of the model and the loss), from the stage
stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "train", ("forward",))
