"""e2v_layers_fp32_share.serve: the e2v_layers stage's operations per
refreshing step of the slice, counted in closed form, over its stamped
time at the float32 peak, percent."""

from perfbench.harness.e2v_flops import fp32_share


def read(rec: dict) -> float | None:
    return fp32_share(rec, "e2v_layers")
