"""dispatch_ms.serve: median host time inside MultiStreamInference.step
(audio copied in, replay launched), outside the profiled slice."""

from perfbench.harness.readers import median_ms


def read(rec: dict) -> float | None:
    return median_ms(d for d, s in zip(rec.get("dispatch_s", ()),
                                       rec.get("in_slice", ())) if not s)
