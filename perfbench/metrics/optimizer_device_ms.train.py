"""optimizer_device_ms.train: median device ms per step of the slice's
optimizer stage (global norm and the update), from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "train", ("optimizer",))
