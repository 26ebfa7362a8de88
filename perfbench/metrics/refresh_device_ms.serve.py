"""refresh_device_ms.serve: median device ms over the slice's refreshing
steps of their refresh stages (one per due cohort), from the stage
stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "serve", ("refresh",),
                                   only_with="refresh")
