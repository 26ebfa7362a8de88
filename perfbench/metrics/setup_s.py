"""setup_s: seconds from the start of the process to the first timed
step (loading, weights, kernel builds, graph captures, traffic)."""


def read(rec: dict) -> float | None:
    return rec.get("setup_s")
