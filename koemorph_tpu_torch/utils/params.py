"""Flax parameter tree <-> PyTorch ``state_dict``.

The tree is the one ``SimplifiedDualStreamModel.init`` produces
(``{"dual_stream_attention": {...}, "emotion_projection": {...},
"smoothing_alpha": ()}``), given as numpy arrays. The state dict is that of
:class:`koemorph_tpu_torch.models.dual_stream_model.StreamingDualStreamModel`,
whose attention names follow the reference PyTorch module:

- a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in);
- a LayerNorm ``scale`` becomes ``weight``;
- ``in_proj_weight`` / ``in_proj_bias``, the learned queries, the stream
  weights and ``smoothing_alpha`` carry over unchanged;
- ``decoder_hidden`` / ``decoder_out`` are ``blendshape_decoder.0`` / ``.3``.

Both directions only transpose, so a round trip is bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_from_state_dict"]

_ATT = "dual_stream_attention"
_DENSE = {"mel_channel_encoder": "mel_channel_encoder",
          "emotion_encoder": "emotion_encoder",
          "mel_output_proj": "mel_output_proj",
          "emotion_output_proj": "emotion_output_proj",
          "decoder_hidden": "blendshape_decoder.0",
          "decoder_out": "blendshape_decoder.3"}
_NORMS = ("mel_norm", "emotion_norm")
_MHAS = ("mel_attention", "emotion_attention")
_PLAIN = ("mouth_queries", "expression_queries", "mel_weights",
          "emotion_weights")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """Flax tree of numpy arrays -> ``state_dict`` of float32 tensors."""
    sd: dict[str, torch.Tensor] = {}

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(p["bias"])

    att = params[_ATT]
    for flax_name, torch_name in _DENSE.items():
        dense(f"{_ATT}.{torch_name}", att[flax_name])
    for name in _NORMS:
        sd[f"{_ATT}.{name}.weight"] = _t(att[name]["scale"])
        sd[f"{_ATT}.{name}.bias"] = _t(att[name]["bias"])
    for name in _MHAS:
        sd[f"{_ATT}.{name}.in_proj_weight"] = _t(att[name]["in_proj_weight"])
        sd[f"{_ATT}.{name}.in_proj_bias"] = _t(att[name]["in_proj_bias"])
        dense(f"{_ATT}.{name}.out_proj", att[name]["out_proj"])
    for name in _PLAIN:
        if name in att:
            sd[f"{_ATT}.{name}"] = _t(att[name])
    dense("emotion_projection", params["emotion_projection"])
    sd["smoothing_alpha"] = _t(np.reshape(params["smoothing_alpha"], ()))
    return sd


def flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`state_dict_from_flax`: numpy float32 arrays."""
    def dense(prefix):
        return {"kernel": _n(sd[f"{prefix}.weight"]).T.copy(),
                "bias": _n(sd[f"{prefix}.bias"])}

    att: dict = {}
    for flax_name, torch_name in _DENSE.items():
        att[flax_name] = dense(f"{_ATT}.{torch_name}")
    for name in _NORMS:
        att[name] = {"scale": _n(sd[f"{_ATT}.{name}.weight"]),
                     "bias": _n(sd[f"{_ATT}.{name}.bias"])}
    for name in _MHAS:
        att[name] = {
            "in_proj_weight": _n(sd[f"{_ATT}.{name}.in_proj_weight"]),
            "in_proj_bias": _n(sd[f"{_ATT}.{name}.in_proj_bias"]),
            "out_proj": dense(f"{_ATT}.{name}.out_proj")}
    for name in _PLAIN:
        if f"{_ATT}.{name}" in sd:
            att[name] = _n(sd[f"{_ATT}.{name}"])
    return {_ATT: att,
            "emotion_projection": dense("emotion_projection"),
            "smoothing_alpha": _n(sd["smoothing_alpha"]).reshape(())}
