"""decode_frames_per_s: blendshape rows of every completed call over the
window."""


def read(rec: dict) -> float | None:
    if "decode_rows" not in rec or not rec["window_s"]:
        return None
    return rec["decode_rows"] / rec["window_s"]
