"""refresh_step_ms.serve: median latency of the steps on which a cohort
refreshes, outside the profiled slice."""

from perfbench.harness.readers import median_ms


def read(rec: dict) -> float | None:
    return median_ms(t for t, r, s in zip(rec.get("latency_s", ()),
                                          rec.get("refresh", ()),
                                          rec.get("in_slice", ()))
                     if r and not s)
