"""step_ms_p95: the 95th percentile, over every step of the window, of
the time from a step being handed its audio to its blendshapes being in
host memory."""

from perfbench.harness.readers import percentile_ms


def read(rec: dict) -> float | None:
    return percentile_ms(rec.get("latency_s", ()), 95)
