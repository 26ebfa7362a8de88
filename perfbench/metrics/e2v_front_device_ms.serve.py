"""e2v_front_device_ms.serve: median over the slice's refreshing steps of
the e2v_front stage (the encoder's conv ladder, feature projection and
positional convolution), from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "serve", ("e2v_front",),
                                   only_with="refresh")
