"""emotion_device_ms.decode: median device ms per call of the slice's
emotion stage (LLDs with K1 and K2, the functionals), from the stage
stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "decode", ("emotion",))
