"""features_device_ms.train: median device ms per step of the slice's
features: the model's emotion and frontend stages (the eGeMAPS and the mel
frontend from the batch audio), from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "train", ("emotion", "frontend"))
