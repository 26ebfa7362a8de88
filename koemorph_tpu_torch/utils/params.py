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

The ``emotion2vec`` subtree (the in-model wav2vec2 encoder of that
backend) maps onto the encoder's HuggingFace names under ``emotion2vec.``:
``feature_extractor.conv_{i}`` / ``layer_norm_{i}`` become
``feature_extractor.conv_layers.{i}.conv`` / ``.layer_norm``,
``fp_layer_norm`` / ``fp_projection`` ``feature_projection.layer_norm`` /
``.projection``, ``pos_conv_embed.conv`` ``encoder.pos_conv_embed.conv``,
``layer_{i}`` ``encoder.layers.{i}`` (its dense layers under
``attention`` and ``feed_forward``), ``encoder_layer_norm``
``encoder.layer_norm``; a conv ``kernel`` (k, in/groups, out) becomes a
``weight`` (out, in/groups, k).

Both directions only transpose, so a round trip is bit-exact.

The optimizer state crosses the same way: :func:`optimizer_state_from_optax`
reads an optax state tree (``ScaleByAdamState`` or ``TraceState``, the
schedule's ``ScaleByScheduleState`` count, and ``MultiStepsState``'s
accumulators) into the state of
:class:`koemorph_tpu_torch.train.optim.Optimizer`, whose moments are named
as the state dict; :func:`optax_from_optimizer_state` fills an optax state
of the same optimizer with the port's. The optax trees are read by their
field names, so nothing here imports optax.

:func:`read_state_dict` reads the model state dict of a checkpoint
directory or a bare ``.pth`` file, and :func:`load_model_state` loads it
into a model after checking every name and shape, naming the first
parameter that does not fit.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_from_state_dict",
           "encoder_state_dict_from_flax",
           "optimizer_state_from_optax", "optax_from_optimizer_state",
           "read_state_dict", "load_model_state"]

#: the model's file in a checkpoint directory
STATE_FILE = "state.pth"

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


_E2V = "emotion2vec"
_E2V_FF = {"intermediate_dense": "feed_forward.intermediate_dense",
           "output_dense": "feed_forward.output_dense"}


def _e2v_names(tree_or_sd, from_flax: bool) -> tuple[int, int]:
    """(conv layers, transformer layers) of an emotion2vec subtree (Flax)
    or of the ``emotion2vec.`` keys of a state dict."""
    if from_flax:
        return (sum(k.startswith("conv_")
                    for k in tree_or_sd["feature_extractor"]),
                sum(k.startswith("layer_") and k[6:].isdigit()
                    for k in tree_or_sd))
    convs = {k.split(".")[3] for k in tree_or_sd
             if k.startswith(f"{_E2V}.feature_extractor.conv_layers.")}
    layers = {k.split(".")[3] for k in tree_or_sd
              if k.startswith(f"{_E2V}.encoder.layers.")}
    return len(convs), len(layers)


def _e2v_pairs(n_conv: int, n_layers: int):
    """(Flax path, state-dict prefix, kind) of every emotion2vec module:
    kind ``conv``, ``dense`` or ``norm``."""
    for i in range(n_conv):
        yield (("feature_extractor", f"conv_{i}"),
               f"feature_extractor.conv_layers.{i}.conv", "conv")
        yield (("feature_extractor", f"layer_norm_{i}"),
               f"feature_extractor.conv_layers.{i}.layer_norm", "norm")
    yield ("fp_layer_norm",), "feature_projection.layer_norm", "norm"
    yield ("fp_projection",), "feature_projection.projection", "dense"
    yield ("pos_conv_embed", "conv"), "encoder.pos_conv_embed.conv", "conv"
    for i in range(n_layers):
        base = f"encoder.layers.{i}"
        for name in ("layer_norm", "final_layer_norm"):
            yield (f"layer_{i}", name), f"{base}.{name}", "norm"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield ((f"layer_{i}", "attention", name),
                   f"{base}.attention.{name}", "dense")
        for name, torch_name in _E2V_FF.items():
            yield (f"layer_{i}", name), f"{base}.{torch_name}", "dense"
    yield ("encoder_layer_norm",), "encoder.layer_norm", "norm"


def _e2v_from_flax(tree: dict, sd: dict) -> None:
    for path, prefix, kind in _e2v_pairs(*_e2v_names(tree, True)):
        node = tree
        for k in path:
            node = node[k]
        key = f"{_E2V}.{prefix}"
        if kind == "norm":
            sd[f"{key}.weight"] = _t(node["scale"])
        elif kind == "conv":
            sd[f"{key}.weight"] = _t(np.transpose(node["kernel"], (2, 1, 0)))
        else:
            sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            sd[f"{key}.bias"] = _t(node["bias"])
    sd[f"{_E2V}.layer_fusion_weights"] = _t(tree["layer_fusion_weights"])


def encoder_state_dict_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax ``Wav2Vec2Encoder`` tree (with fusion) -> the state dict of
    :class:`koemorph_tpu_torch.features.wav2vec2.Wav2Vec2Encoder`."""
    sd: dict = {}
    _e2v_from_flax(tree, sd)
    return {k.removeprefix(f"{_E2V}."): v for k, v in sd.items()}


def _e2v_to_flax(sd: dict) -> dict:
    tree: dict = {}
    for path, prefix, kind in _e2v_pairs(*_e2v_names(sd, False)):
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        key = f"{_E2V}.{prefix}"
        w = _n(sd[f"{key}.weight"])
        if kind == "norm":
            node["scale"] = w
        elif kind == "conv":
            node["kernel"] = np.transpose(w, (2, 1, 0)).copy()
        else:
            node["kernel"] = w.T.copy()
        if f"{key}.bias" in sd:
            node["bias"] = _n(sd[f"{key}.bias"])
    tree["layer_fusion_weights"] = _n(sd[f"{_E2V}.layer_fusion_weights"])
    return tree


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
    if _E2V in params:
        _e2v_from_flax(params[_E2V], sd)
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
    tree = {_ATT: att,
            "emotion_projection": dense("emotion_projection"),
            "smoothing_alpha": _n(sd["smoothing_alpha"]).reshape(())}
    if f"{_E2V}.layer_fusion_weights" in sd:
        tree[_E2V] = _e2v_to_flax(sd)
    return tree


def _fields(node) -> tuple:
    return getattr(node, "_fields", ())


def _find(tree, fields: tuple) -> list:
    """Every namedtuple in ``tree`` (nested tuples, lists, namedtuples)
    whose fields are exactly ``fields``, in order."""
    if _fields(tree) == fields:
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [n for x in (tree if not _fields(tree)
                            else [getattr(tree, f) for f in _fields(tree)])
                for n in _find(x, fields)]
    return []


def _sd_like(tree: dict, params: dict, what: str) -> dict:
    sd = state_dict_from_flax(tree)
    if params is not None:
        want = state_dict_from_flax(params)
        for k, v in want.items():
            if k not in sd or tuple(sd[k].shape) != tuple(v.shape):
                raise ValueError(f"optax {what} does not match the "
                                 f"parameters at {k}")
    return sd


def optimizer_state_from_optax(opt_state, params: dict = None) -> dict:
    """An optax state tree of ``koemorph_tpu.train.optim.create_optimizer``
    (numpy leaves) -> the port's optimizer ``state_dict``. ``params`` (the
    Flax tree) checks the moments' names and shapes."""
    multi = _find(opt_state, ("mini_step", "gradient_step",
                              "inner_opt_state", "acc_grads", "skip_state"))
    inner = multi[0].inner_opt_state if multi else opt_state
    counts = [int(np.asarray(s.count)) for s in _find(inner, ("count",))]
    adam = _find(inner, ("count", "mu", "nu"))
    if len(counts) != 1:
        raise ValueError(f"optax state has {len(counts)} schedule counts, "
                         "expected 1")
    state: dict = {"count": counts[0], "mini_step": 0, "gradient_step": 0}
    if adam:
        (adam,) = adam
        if int(np.asarray(adam.count)) != counts[0]:
            raise ValueError("optax Adam and schedule counts differ: "
                             f"{int(np.asarray(adam.count))} vs "
                             f"{counts[0]}")
        state.update(name="adam", mu=_sd_like(adam.mu, params, "mu"),
                     nu=_sd_like(adam.nu, params, "nu"))
    else:
        traces = _find(inner, ("trace",))
        if len(traces) != 1:
            raise ValueError(f"optax state has {len(traces)} momentum "
                             "traces, expected 1")
        state.update(name="sgd", trace=_sd_like(traces[0].trace, params,
                                                  "trace"))
    if multi:
        m = multi[0]
        state.update(mini_step=int(np.asarray(m.mini_step)),
                     gradient_step=int(np.asarray(m.gradient_step)),
                     acc=_sd_like(m.acc_grads, params, "acc_grads"))
    return state


def optax_from_optimizer_state(state: dict, template):
    """Inverse of :func:`optimizer_state_from_optax`: ``template`` (an optax
    state of the same optimizer, e.g. its ``init``) with every field
    replaced by the port's ``state`` (numpy leaves)."""
    def count_like(old, value):
        return np.asarray(value, dtype=np.asarray(old).dtype)

    def fill(node):
        f = _fields(node)
        if f == ("mini_step", "gradient_step", "inner_opt_state",
                 "acc_grads", "skip_state"):
            return type(node)(
                mini_step=count_like(node.mini_step, state["mini_step"]),
                gradient_step=count_like(node.gradient_step,
                                         state["gradient_step"]),
                inner_opt_state=fill(node.inner_opt_state),
                acc_grads=flax_from_state_dict(state["acc"]),
                skip_state=node.skip_state)
        if f == ("count", "mu", "nu"):
            return type(node)(count=count_like(node.count, state["count"]),
                              mu=flax_from_state_dict(state["mu"]),
                              nu=flax_from_state_dict(state["nu"]))
        if f == ("count",):
            return type(node)(count=count_like(node.count, state["count"]))
        if f == ("trace",):
            return type(node)(trace=flax_from_state_dict(state["trace"]))
        if hasattr(node, "_fields"):     # any other namedtuple (EmptyState)
            return type(node)(**{k: fill(getattr(node, k)) for k in f})
        if isinstance(node, (tuple, list)):
            return type(node)(fill(x) for x in node)
        return node

    return fill(template)


def read_state_dict(path: Union[str, Path]) -> dict:
    """The model state dict of a checkpoint directory, or of a bare
    ``.pth`` file (a state dict, or a trainer checkpoint with
    ``model_state_dict``). Raises ``FileNotFoundError`` when neither
    exists."""
    path = Path(path)
    file = path / STATE_FILE if path.is_dir() else path
    if not file.is_file():
        raise FileNotFoundError(f"no checkpoint at {path} (expected a "
                                f"directory with {STATE_FILE} or a .pth "
                                "file)")
    blob = torch.load(file, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    if not isinstance(blob, dict):
        raise ValueError(f"{file} holds no state dict")
    return blob


def load_model_state(model: torch.nn.Module, sd: dict,
                     source: str = "checkpoint") -> None:
    """``model.load_state_dict(sd)`` after checking that the names are the
    model's and every shape matches: raises ``ValueError`` naming the
    first parameter that is missing, unexpected or of another shape (a
    wrong ``--d-model``, window or emotion backend)."""
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise ValueError(f"{source} lacks parameter {missing[0]!r} "
                         f"({len(missing)} missing)")
    extra = [k for k in sd if k not in want]
    if extra:
        raise ValueError(f"{source} has parameter {extra[0]!r} the model "
                         f"does not ({len(extra)} unexpected)")
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch at {k}: the model expects "
                f"{tuple(v.shape)}, the {source} has {tuple(sd[k].shape)} "
                "(check --d-model / --num-heads / --fps against the "
                "training config)")
    model.load_state_dict(sd)
