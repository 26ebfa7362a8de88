"""frontend_device_ms.decode: median device ms per call of the slice's
frontend stage (log-mel with K3, the reflected edge rows), from the
stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "decode", ("frontend",))
