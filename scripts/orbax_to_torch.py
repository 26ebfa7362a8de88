#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX trainer into the PyTorch port's.

    python scripts/orbax_to_torch.py <orbax_dir> <out_dir>

``<orbax_dir>`` is a directory ``koemorph_tpu.train.checkpoint`` wrote
(``state/``, optionally ``opt_state/``, and ``meta.json``), such as
``<work>/checkpoints/last``. ``<out_dir>`` gets the port's layout
(``koemorph_tpu_torch.train.checkpoint``): ``state.pth`` with the
parameters in the reference PyTorch names, ``meta.json`` as it was, and,
when the source has ``opt_state/``, ``opt_state.pth`` with the optimizer
state (Adam moments or momentum trace, the update count, gradient
accumulators). The optimizer's structure comes from the training config in
``meta.json``. Without ``opt_state/`` the port's resume fast-forwards the
schedule to ``global_step``.

This script imports JAX, orbax and the JAX package; the port does not.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def convert(src, dst) -> Path:
    """Write the port's checkpoint of orbax checkpoint ``src`` to
    ``dst``; returns ``dst``."""
    from koemorph_tpu.train.checkpoint import load_checkpoint, load_opt_state
    from koemorph_tpu.train.optim import create_optimizer
    from koemorph_tpu_torch.train.checkpoint import save_checkpoint
    from koemorph_tpu_torch.utils.params import (optimizer_state_from_optax,
                                                 state_dict_from_flax)

    src, dst = Path(src), Path(dst)
    params, meta = load_checkpoint(src)
    params = _numpy(params)
    config = meta.get("config", {}) or {}
    train_cfg = config.get("training", config)
    opt = None
    if (src / "opt_state").exists():
        template = create_optimizer(train_cfg, 1).init(params)
        opt_state = _numpy(load_opt_state(src, template))
        opt = {"optimizer": optimizer_state_from_optax(opt_state, params),
               "dropout_seed": int(train_cfg.get("seed", 42))}
    return save_checkpoint(
        dst, state_dict_from_flax(params), opt_state=opt,
        epoch=int(meta.get("epoch", 0)),
        global_step=int(meta.get("global_step", 0)),
        best_val_loss=float(meta.get("best_val_loss", float("inf"))),
        config=config)


def _numpy(tree):
    """Every array leaf of ``tree`` as numpy (namedtuples kept)."""
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("src", help="orbax checkpoint directory")
    p.add_argument("dst", help="output directory (the port's layout)")
    args = p.parse_args(argv)
    out = convert(args.src, args.dst)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
