"""mfu.train: the profiled slice's floating-point work, counted on the
reference, over its length at the float32 peak, percent."""

from perfbench.harness.readers import mfu


def read(rec: dict) -> float | None:
    return mfu(rec)
