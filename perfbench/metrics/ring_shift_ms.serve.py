"""ring_shift_ms.serve: median device ms per step of the slice's ring stage
(the audio ring's shift), from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "serve", ("ring",))
