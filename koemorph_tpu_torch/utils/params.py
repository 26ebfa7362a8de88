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

The legacy family maps the same way. ``SimplifiedKoeMorphModel``'s tree
(``enc_0``, ``enc_1``, ``blendshape_queries``, ``attention``, ``dec_0``,
``dec_1``, ``dec_out``) keeps its names. ``KoeMorphModel``'s keeps
``audio_encoder`` (``{mel,emotion}_dense`` / ``_norm`` / ``_layer_{i}``),
``query_embeddings``, ``cross_attention_{i}``, ``attention_norm_{i}``,
``query_up_proj``, ``decoder`` and ``temporal_smoother/alpha`` or
``gaussian_weights``; Flax's auto-named submodules become torch's names:
in a transformer layer ``Dense_0`` / ``Dense_1`` / ``LayerNorm_0`` /
``LayerNorm_1`` are ``linear1`` / ``linear2`` / ``norm1`` / ``norm2``, in
the query embedding ``Dense_0`` / ``Dense_1`` are ``cond_hidden`` /
``cond_out``, and in ``MultiStreamAudioEncoder`` ``Dense_0``-``Dense_4``
are ``mel_out``, ``mel_hidden``, ``prosody_out``, ``prosody_hidden``,
``emotion_proj``, then ``fusion`` or the three gates, and ``LayerNorm_0``
is ``norm``. The model is picked from the tree's (or the state dict's)
top-level names, and a name no rule maps raises ``ValueError``.

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

from collections.abc import Mapping
from pathlib import Path
from typing import Union

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_from_state_dict",
           "encoder_state_dict_from_flax",
           "optimizer_state_from_optax", "optax_from_optimizer_state",
           "read_state_dict", "load_model_state", "read_model_state"]

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
_E2V = "emotion2vec"
_E2V_FF = {"intermediate_dense": "feed_forward.intermediate_dense",
           "output_dense": "feed_forward.output_dense"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


# ---------------------------------------------------------------------------
# module pairs: (Flax path, state-dict prefix, kind), paths dot-joined
# ---------------------------------------------------------------------------

def _count(keys, *formats: str) -> int:
    """How many consecutive ``i`` some key starts with one of ``formats``
    formatted with ``i`` (a Flax and a state-dict spelling)."""
    n = 0
    while any(k.startswith(f.format(n)) for f in formats for k in keys):
        n += 1
    return n


def _top(keys) -> set:
    return {k.split(".")[0] for k in keys}


def _e2v_pairs(keys, fp: str, tp: str):
    """The wav2vec2 encoder's modules (under ``fp`` / ``tp``)."""
    n_conv = _count(keys, f"{fp}feature_extractor.conv_{{}}.",
                    f"{tp}feature_extractor.conv_layers.{{}}.")
    n_layers = _count(keys, f"{fp}layer_{{}}.", f"{tp}encoder.layers.{{}}.")
    for i in range(n_conv):
        yield (f"{fp}feature_extractor.conv_{i}",
               f"{tp}feature_extractor.conv_layers.{i}.conv", "conv")
        yield (f"{fp}feature_extractor.layer_norm_{i}",
               f"{tp}feature_extractor.conv_layers.{i}.layer_norm", "norm")
    yield f"{fp}fp_layer_norm", f"{tp}feature_projection.layer_norm", "norm"
    yield f"{fp}fp_projection", f"{tp}feature_projection.projection", "dense"
    yield (f"{fp}pos_conv_embed.conv", f"{tp}encoder.pos_conv_embed.conv",
           "conv")
    for i in range(n_layers):
        f, t = f"{fp}layer_{i}", f"{tp}encoder.layers.{i}"
        for name in ("layer_norm", "final_layer_norm"):
            yield f"{f}.{name}", f"{t}.{name}", "norm"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            yield f"{f}.attention.{name}", f"{t}.attention.{name}", "dense"
        for name, torch_name in _E2V_FF.items():
            yield f"{f}.{name}", f"{t}.{torch_name}", "dense"
    yield f"{fp}encoder_layer_norm", f"{tp}encoder.layer_norm", "norm"
    yield f"{fp}layer_fusion_weights", f"{tp}layer_fusion_weights", "param"


def _dual_stream_pairs(keys):
    for flax_name, torch_name in _DENSE.items():
        yield f"{_ATT}.{flax_name}", f"{_ATT}.{torch_name}", "dense"
    for name in _NORMS:
        yield f"{_ATT}.{name}", f"{_ATT}.{name}", "norm"
    for name in _MHAS:
        yield f"{_ATT}.{name}", f"{_ATT}.{name}", "mha"
    for name in _PLAIN:
        yield f"{_ATT}.{name}", f"{_ATT}.{name}", "param"
    yield "emotion_projection", "emotion_projection", "dense"
    yield "smoothing_alpha", "smoothing_alpha", "scalar"
    yield from _e2v_pairs(keys, f"{_E2V}.", f"{_E2V}.")


def _simplified_pairs(keys):
    for name in ("enc_0", "enc_1", "dec_0", "dec_1", "dec_out"):
        yield name, name, "dense"
    yield "blendshape_queries", "blendshape_queries", "param"
    yield "attention", "attention", "mha"


def _transformer_layer_pairs(keys, p: str = ""):
    """``TransformerEncoderLayer``: Flax's auto-named submodules become
    ``nn.TransformerEncoderLayer``'s names."""
    yield f"{p}self_attn", f"{p}self_attn", "mha"
    yield f"{p}Dense_0", f"{p}linear1", "dense"
    yield f"{p}Dense_1", f"{p}linear2", "dense"
    yield f"{p}LayerNorm_0", f"{p}norm1", "norm"
    yield f"{p}LayerNorm_1", f"{p}norm2", "norm"


def _multistream_encoder_pairs(keys):
    """``MultiStreamAudioEncoder``: Flax names each stream's outer dense
    layer first (``Dense_0`` is the mel stream's output layer)."""
    for flax_name, torch_name in (("Dense_0", "mel_out"),
                                  ("Dense_1", "mel_hidden"),
                                  ("Dense_2", "prosody_out"),
                                  ("Dense_3", "prosody_hidden"),
                                  ("Dense_4", "emotion_proj")):
        yield flax_name, torch_name, "dense"
    if _top(keys) & {"Dense_6", "gate_mel"}:
        for i, name in enumerate(("gate_mel", "gate_prosody",
                                  "gate_emotion")):
            yield f"Dense_{5 + i}", name, "dense"
    else:
        yield "Dense_5", "fusion", "dense"
    for i in range(_count(keys, "layer_{}.", "layers.{}.")):
        for f, t, kind in _transformer_layer_pairs(keys):
            yield f"layer_{i}.{f}", f"layers.{i}.{t}", kind
    yield "LayerNorm_0", "norm", "norm"


def _dual_stream_encoder_pairs(keys, p: str = ""):
    n_layers = _count(keys, f"{p}mel_layer_{{}}.")
    for s in ("mel", "emotion"):
        yield f"{p}{s}_dense", f"{p}{s}_dense", "dense"
        yield f"{p}{s}_norm", f"{p}{s}_norm", "norm"
        for i in range(n_layers):
            yield from _transformer_layer_pairs(keys, f"{p}{s}_layer_{i}.")


def _query_embedding_pairs(keys, p: str = ""):
    yield (f"{p}query_embeddings", f"{p}query_embeddings", "param")
    yield f"{p}Dense_0", f"{p}cond_hidden", "dense"
    yield f"{p}Dense_1", f"{p}cond_out", "dense"


def _cross_attention_pairs(keys, p: str = ""):
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        yield f"{p}{name}", f"{p}{name}", "dense"


def _decoder_pairs(keys, p: str = ""):
    yield f"{p}input_proj", f"{p}input_proj", "dense"
    for i in range(_count(keys, f"{p}hidden_{{}}.")):
        yield f"{p}hidden_{i}", f"{p}hidden_{i}", "dense"
        yield f"{p}norm_{i}", f"{p}norm_{i}", "norm"
    yield f"{p}output_proj", f"{p}output_proj", "dense"


def _legacy_pairs(keys):
    yield from _dual_stream_encoder_pairs(keys, "audio_encoder.")
    yield from _query_embedding_pairs(keys, "query_embeddings.")
    for i in range(_count(keys, "cross_attention_{}.")):
        yield from _cross_attention_pairs(keys, f"cross_attention_{i}.")
        yield f"attention_norm_{i}", f"attention_norm_{i}", "norm"
    yield "query_up_proj", "query_up_proj", "dense"
    yield from _decoder_pairs(keys, "decoder.")
    yield from _smoother_pairs(keys, "temporal_smoother.")


def _smoother_pairs(keys, p: str = ""):
    yield f"{p}alpha", f"{p}alpha", "scalar"
    yield f"{p}gaussian_weights", f"{p}gaussian_weights", "param"


#: (a top-level name that marks the tree or state dict, its modules), one
#: per model
_KINDS = (
    ({_ATT}, _dual_stream_pairs),
    ({"blendshape_queries"}, _simplified_pairs),
    ({"audio_encoder"}, _legacy_pairs),
)


def _pairs(keys):
    top = _top(keys)
    for marks, pairs in _KINDS:
        if top & marks:
            return list(pairs(keys))
    raise ValueError(f"no known model has the parameters {sorted(top)}")


def _transpose(a):
    return np.swapaxes(np.asarray(a), 0, 1)


def _flip(a):
    return np.transpose(np.asarray(a), (2, 1, 0))


def _scalar(a):
    return np.reshape(np.asarray(a), ())


def _leaf_rules(pairs):
    """(Flax key, state-dict key, to torch, to Flax) of every leaf the
    module pairs name."""
    same = np.asarray
    for f, t, kind in pairs:
        if kind == "mha":
            yield f"{f}.in_proj_weight", f"{t}.in_proj_weight", same, same
            yield f"{f}.in_proj_bias", f"{t}.in_proj_bias", same, same
            f, t, kind = f"{f}.out_proj", f"{t}.out_proj", "dense"
        if kind in ("dense", "conv"):
            op = _transpose if kind == "dense" else _flip
            yield f"{f}.kernel", f"{t}.weight", op, op
            yield f"{f}.bias", f"{t}.bias", same, same
        elif kind == "norm":
            yield f"{f}.scale", f"{t}.weight", same, same
            yield f"{f}.bias", f"{t}.bias", same, same
        else:
            op = _scalar if kind == "scalar" else same
            yield f, t, op, op


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _convert(flat: dict, to_torch: bool, pairs=_pairs) -> dict:
    """``flat`` (Flax dot paths or state-dict keys) renamed by the rules of
    the module pairs ``pairs(flat)`` yields (by default its model's);
    raises ``ValueError`` naming a key no rule maps."""
    out, used = {}, set()
    for fk, tk, to_t, to_f in _leaf_rules(pairs(flat)):
        src, dst, op = (fk, tk, to_t) if to_torch else (tk, fk, to_f)
        if src in flat:
            value = flat[src] if to_torch else _n(flat[src])
            out[dst] = op(value)
            used.add(src)
    unmapped = [k for k in flat if k not in used]
    if unmapped:
        raise ValueError(f"parameter {unmapped[0]!r} has no counterpart "
                         f"({len(unmapped)} unmapped)")
    return out


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """Flax tree of numpy arrays -> ``state_dict`` of float32 tensors. The
    model is picked from the tree's top-level names; a name no rule maps
    raises ``ValueError``."""
    return _module_state_dict(params, _pairs)


def _module_state_dict(params: dict, pairs) -> dict[str, torch.Tensor]:
    """The tree of one module whose pairs ``pairs`` yields (e.g.
    ``_decoder_pairs``) -> its ``state_dict``."""
    return {k: _t(v) for k, v in
            _convert(_flatten(params), True, pairs).items()}


def flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`state_dict_from_flax`: numpy float32 arrays."""
    tree: dict = {}
    for key, value in _convert(dict(sd), False).items():
        *path, leaf = key.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.array(value, dtype=np.float32, order="C")
    return tree


def encoder_state_dict_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax ``Wav2Vec2Encoder`` tree (with fusion) -> the state dict of
    :class:`koemorph_tpu_torch.features.wav2vec2.Wav2Vec2Encoder`."""
    return _module_state_dict(tree, lambda keys: _e2v_pairs(keys, "", ""))


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


def read_model_state(path: Union[str, Path, None]) -> tuple[dict | None,
                                                            dict]:
    """The state dict of the checkpoint at ``path`` (``None`` without a
    path) and the dual-stream constructor keywords it fixes: its fusion
    mode, ``use_learnable_weights``, is trained (True) unless it stores no
    ``mel_weights`` (a fixed-fusion model); True for random weights."""
    sd = read_state_dict(path) if path else None
    return sd, {"use_learnable_weights":
                sd is None or "dual_stream_attention.mel_weights" in sd}
