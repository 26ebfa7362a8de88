"""launch_ms.serve: median host ms of the server's graph launch (the
program's span koemorph.serve.launch) over the window's steps outside
the profiled slice."""

from perfbench.harness import program


def read(rec: dict) -> float | None:
    return program.host_median_ms(rec, "koemorph.serve.launch",
                                  "koemorph.serve.step")
