"""What the metric readers share: a median, a percentile over all samples,
and the traced slice's kernel roofline share, idle share and share of the
float32 peak. Each returns None where the record holds nothing to read."""

from __future__ import annotations

import sys

import numpy as np

from perfbench.harness import roofline


def median_ms(values) -> float | None:
    values = list(values)
    return float(np.median(values) * 1e3) if values else None


def percentile_ms(values, q: float) -> float | None:
    values = list(values)
    return float(np.percentile(values, q) * 1e3) if values else None


def kernel_roofline(rec: dict) -> float | None:
    """Percent: the kernels' summed bound over their summed device time in
    the slice."""
    tr, kb = rec.get("trace"), rec.get("kernel_bounds")
    if tr is None or not kb:
        return None
    bound = device_us = 0.0
    for name, e in kb.items():
        if not e["launches"]:
            continue
        count, us = tr.kernel_us(roofline.KERNEL_PATTERNS[name])
        if count != e["launches"] * roofline.KERNELS_PER_LAUNCH[name]:
            print(f"perfbench: the slice's trace shows {count} {name} "
                  f"kernels, its replays launched {e['launches']}",
                  file=sys.stderr)
            return None
        bound += e["bound_s"]
        device_us += us
    return 100.0 * bound / (device_us / 1e6) if device_us else None


def device_idle(rec: dict) -> float | None:
    """Percent of the traced window with no device activity."""
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.activities:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(rec: dict) -> float | None:
    """Percent: the slice's floating-point work over its window at the
    float32 peak."""
    tr, flops = rec.get("trace"), rec.get("slice_flops")
    if tr is None or not flops or tr.window_s <= 0:
        return None
    return 100.0 * flops / tr.window_s / roofline.PEAK_FP32_PER_S
