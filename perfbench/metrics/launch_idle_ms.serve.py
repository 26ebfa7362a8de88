"""launch_idle_ms.serve: device idle ms per step of the profiled slice
while the host was inside koemorph.serve.launch (the idle gaps split by
the innermost program span)."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.idle_per_span_ms(rec, "koemorph.serve.launch",
                                    "koemorph.serve.launch")
