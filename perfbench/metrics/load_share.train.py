"""load_share.train: percent of the epochs' time spent collecting each
epoch's batches from the loader."""


def read(rec: dict) -> float | None:
    if "load_s" not in rec or not rec["window_s"]:
        return None
    return 100.0 * rec["load_s"] / rec["window_s"]
