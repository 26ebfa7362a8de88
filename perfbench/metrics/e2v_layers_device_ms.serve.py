"""e2v_layers_device_ms.serve: median over the slice's refreshing steps of
the e2v_layers stage (the encoder's transformer layers and final
LayerNorm), from the stage stamps."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.median_stage_ms(rec, "serve", ("e2v_layers",),
                                   only_with="refresh")
