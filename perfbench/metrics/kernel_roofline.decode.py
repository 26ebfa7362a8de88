"""kernel_roofline.decode: the hand-written kernels' summed roofline bound
over their summed device time in the profiled slice, percent."""

from perfbench.harness.readers import kernel_roofline


def read(rec: dict) -> float | None:
    return kernel_roofline(rec)
