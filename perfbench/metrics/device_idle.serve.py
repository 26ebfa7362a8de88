"""device_idle.serve: percent of the profiled slice with no device
activity."""

from perfbench.harness.readers import device_idle


def read(rec: dict) -> float | None:
    return device_idle(rec)
