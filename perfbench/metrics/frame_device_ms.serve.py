"""frame_device_ms.serve: median device ms per step of the slice's frame
path: the ingest, ring, mel and model stages, from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "serve",
                                   ("ingest", "ring", "mel", "model"))
