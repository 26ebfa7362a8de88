"""The floating-point work of the wav2vec2 encoder of the ``emotion2vec``
refresh, in closed form, by the program's stage (the ``serve`` track's
``e2v_front`` and ``e2v_layers``), and the stages' shares of the float32
peak.

Counted as ``torch.utils.flop_counter.FlopCounterMode`` counts the
reference (:mod:`perfbench.reference.wav2vec2`): 2 operations per
multiply-add of each convolution and matrix product (the positional
convolution over its padded output, an even kernel's extra column
included), none for the norms, activations, softmax and sums.

- ``e2v_front``: the 7 strided convolutions, the feature projection and
  the grouped positional convolution;
- ``e2v_layers``: per layer the q, k, v and output projections, the two
  attention products and the feed-forward's two products.
"""

from __future__ import annotations

from typing import Optional

from perfbench.harness import program, roofline

COUNTER = "koemorph.serve.encoder_frames"
STAGES = ("e2v_front", "e2v_layers")


def stage_flops(enc: dict, samples: int) -> dict:
    """``{stage: operations}`` of one lane encoding ``samples`` samples,
    for the encoder fields ``enc`` (a ``Wav2Vec2Config``'s)."""
    chans = [1] + list(enc["conv_dim"])
    length, conv = samples, 0
    for i, (k, s) in enumerate(zip(enc["conv_kernel"], enc["conv_stride"])):
        length = (length - k) // s + 1
        conv += 2 * length * chans[i + 1] * chans[i] * k
    t, d, ff = length, enc["hidden_size"], enc["intermediate_size"]
    k_pos = enc["num_conv_pos_embeddings"]
    pos_out = t + 2 * (k_pos // 2) - k_pos + 1
    pos = 2 * pos_out * d * (d // enc["num_conv_pos_embedding_groups"]) \
        * k_pos
    projection = 2 * t * chans[-1] * d
    layer = 4 * 2 * t * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * ff
    return {"e2v_front": float(conv + projection + pos),
            "e2v_layers": float(enc["num_hidden_layers"] * layer)}


def fp32_share(rec: dict, stage: str) -> Optional[float]:
    """Percent: ``stage``'s operations per refreshing step of the profiled
    slice (its lanes from the program's counter of encoder frames) over the
    stage's median stamped time there, at the float32 peak. None where the
    program counted or stamped nothing."""
    e2v = rec.get("e2v")
    if not e2v or not e2v["slice_encoder_frames"] \
            or not e2v["slice_refresh_steps"]:
        return None
    ms = program.median_stage_ms(rec, "serve", (stage,), only_with="refresh")
    if not ms:
        return None
    lanes = e2v["slice_encoder_frames"] / e2v["frames_per_lane"] \
        / e2v["slice_refresh_steps"]
    ops = lanes * e2v["stage_flops"][stage]
    return 100.0 * ops / (ms / 1e3) / roofline.PEAK_FP32_PER_S
