"""Import the reference PyTorch repository's checkpoints.

A user of the reference repository has trained ``.pth`` files (a state
dict, or a trainer checkpoint with ``model_state_dict``) of its
``SimplifiedDualStreamModel`` / ``SequentialDualStreamModel``. The port's
parameter names are the reference's (``models/dual_stream.py``), so the
import is a filter over the names, the counterpart of
``koemorph_tpu.utils.torch_import``:

- ``dual_stream_attention.*`` and ``smoothing_alpha`` are taken; the
  checkpoint's other names (the reference's frontends) are ignored.
- ``emotion_projection`` does not exist in a reference checkpoint: the
  reference built its 264 -> 256 compression untrained inside the feature
  extractor. The model's initialized projection is kept (and should be
  fine-tuned).
- A fixed-fusion checkpoint carries the ``mel_weights`` / ``emotion_weights``
  masks as buffers; a ``use_learnable_weights=False`` model recomputes the
  same masks, so exactly that pair is dropped. Any other surplus or missing
  attention name, or another shape, raises ``ValueError``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Union

import torch

from koemorph_tpu_torch.utils.params import load_model_state, read_state_dict

logger = logging.getLogger(__name__)

__all__ = ["model_state_from_reference", "import_torch_checkpoint"]

PREFIX = "dual_stream_attention."
FUSION_WEIGHTS = {PREFIX + "mel_weights", PREFIX + "emotion_weights"}


def model_state_from_reference(sd: dict, model: torch.nn.Module
                               ) -> dict[str, torch.Tensor]:
    """``model``'s state dict with the attention and ``smoothing_alpha``
    of the reference state dict ``sd``; every other entry (the emotion
    projection) is the model's own."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    want = {k for k in state if k.startswith(PREFIX)}
    got = {k for k in sd if k.startswith(PREFIX)}
    if want - got:
        raise ValueError(
            "checkpoint missing attention parameters: "
            f"{sorted(k[len(PREFIX):] for k in want - got)} (a checkpoint "
            "without mel_weights/emotion_weights was trained with fixed "
            "fusion — build the model with use_learnable_weights=False)")
    surplus = got - want
    if surplus == FUSION_WEIGHTS:
        logger.info("dropping checkpoint fusion weights (target model uses "
                    "fixed fusion masks)")
    elif surplus:
        raise ValueError(
            "checkpoint has attention parameters the model does not "
            f"expect: {sorted(k[len(PREFIX):] for k in surplus)}")
    for k in sorted(want):
        if tuple(sd[k].shape) != tuple(state[k].shape):
            raise ValueError(
                f"shape mismatch at {k}: model expects "
                f"{tuple(state[k].shape)}, checkpoint has "
                f"{tuple(sd[k].shape)} — check --d-model / --num-heads / "
                "--mel-sequence-length against the training config")
        state[k] = sd[k].detach().to(state[k].dtype).clone()
    if "smoothing_alpha" in sd:
        state["smoothing_alpha"] = sd["smoothing_alpha"].detach().reshape(
            ()).to(state["smoothing_alpha"].dtype).clone()
    logger.info("mapped attention + smoothing_alpha from reference "
                "checkpoint; emotion_projection keeps initialization "
                "(untrained in the reference)")
    return state


def import_torch_checkpoint(pth_path: Union[str, Path],
                            model: torch.nn.Module,
                            out_dir: Union[str, Path]) -> str:
    """Convert a reference ``.pth`` into a port checkpoint directory that
    ``rt``, ``infer``, ``serve``, ``test_model`` and ``train --resume``
    load. ``model`` is configured to the checkpoint's architecture and
    holds its initialized weights; it ends up holding the imported ones."""
    from koemorph_tpu_torch.train.checkpoint import save_checkpoint

    state = model_state_from_reference(read_state_dict(pth_path), model)
    load_model_state(model, state, f"imported {pth_path}")
    save_checkpoint(Path(out_dir), state,
                    config={"imported_from": str(pth_path),
                            "source": "torch-reference"})
    return str(out_dir)
