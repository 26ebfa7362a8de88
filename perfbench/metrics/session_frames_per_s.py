"""session_frames_per_s: sessions x steps completed over the window."""


def read(rec: dict) -> float | None:
    if "session_frames" not in rec or not rec["window_s"]:
        return None
    return rec["session_frames"] / rec["window_s"]
