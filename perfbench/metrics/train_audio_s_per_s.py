"""train_audio_s_per_s: seconds of audio in the batches of every
completed step over the time of the epochs run, each epoch's load and
upload included."""


def read(rec: dict) -> float | None:
    if "audio_s" not in rec or not rec["window_s"]:
        return None
    return rec["audio_s"] / rec["window_s"]
