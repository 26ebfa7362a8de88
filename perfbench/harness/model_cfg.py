"""A configuration file's settings as the constructor arguments of the
program's classes and of the reference's (they take the same names)."""

from __future__ import annotations


def fps(config: dict) -> int:
    return int(config["target_fps"])


def hop(config: dict) -> int:
    return int(config["sample_rate"] / fps(config))


def stream_kwargs(config: dict) -> dict:
    """``StreamingConfig`` arguments."""
    emo, att, mel = (config["emotion_config"],
                     config["dual_stream_attention"], config["mel"])
    return dict(
        sample_rate=config["sample_rate"], target_fps=fps(config),
        window_frames=config["mel_sequence_length"], n_fft=mel["n_fft"],
        n_mels=mel["n_mels"], f_min=float(mel["f_min"]),
        f_max=float(mel["f_max"]), d_model=config["d_model"],
        num_heads=config["num_heads"],
        num_blendshapes=config["num_blendshapes"],
        emotion_backend=emo["backend"],
        use_concatenation=emo["use_concatenation"],
        emotion_context_s=float(emo["context_window"]),
        emotion_update_frames=max(1, round(emo["update_interval"]
                                           * fps(config))),
        use_learnable_weights=att["use_learnable_weights"],
        fusion_temperature=float(att["temperature"]),
        egemaps_per_period=config["assumed"]["egemaps_per_period"])


def sequential_kwargs(config: dict) -> dict:
    """``SequentialDualStreamModel`` arguments."""
    emo, att = config["emotion_config"], config["dual_stream_attention"]
    return dict(
        d_model=config["d_model"], num_heads=config["num_heads"],
        num_blendshapes=config["num_blendshapes"],
        sample_rate=config["sample_rate"], target_fps=fps(config),
        mel_sequence_length=config["mel_sequence_length"],
        emotion_backend=emo["backend"],
        use_concatenation=emo["use_concatenation"],
        egemaps_per_period=config["assumed"]["egemaps_per_period"],
        use_learnable_weights=att["use_learnable_weights"],
        fusion_temperature=float(att["temperature"]),
        dropout=float(att["dropout"]),
        smoothing_alpha_init=float(
            config["temporal_smoothing"]["initial_alpha"]),
        stride_frames=config["stride_frames"],
        decode_mode=config["decode_mode"])

