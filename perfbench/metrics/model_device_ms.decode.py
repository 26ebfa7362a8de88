"""model_device_ms.decode: median device ms per call of the slice's model
stage (window gather, attention, EMA), from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "decode", ("model",))
