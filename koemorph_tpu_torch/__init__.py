"""KoeMorph in PyTorch: streaming, offline decoding and training on an
NVIDIA GPU.

A port of :mod:`koemorph_tpu` (JAX) that stands on its own: it imports
``torch``, ``numpy`` and the standard library only. The per-frame
streaming step (incremental log-mel row, the eGeMAPS emotion refresh and
the dual-stream cross-attention decode) and the full-utterance sequential
decode (global log-mel, reflect-padded window edges, all windows in one
attention batch, the EMA across windows) run on ``cuda`` by default. The
fused STFT -> mel -> dB frontend and the two hot DSP reductions of the
eGeMAPS features are hand-written CUDA kernels
(:mod:`koemorph_tpu_torch.ops.cuda`), each with a plain PyTorch twin that
runs for tensors on the CPU.

Entry points:

- :func:`koemorph_tpu_torch.runtime.engine.build_streaming_model`
- :class:`koemorph_tpu_torch.runtime.streaming.StreamingInference`
- ``python -m koemorph_tpu_torch.rt --input x.wav ...``
- :class:`koemorph_tpu_torch.parallel.batched_decode.BatchedSequentialDecoder`
- ``python -m koemorph_tpu_torch.infer --input x.wav --output y.jsonl``
- ``python -m koemorph_tpu_torch.export_model --output exports`` (a
  ``torch.export`` program of the frame function,
  :mod:`koemorph_tpu_torch.export`)
- :class:`koemorph_tpu_torch.train.SequentialTrainer`
- ``python -m koemorph_tpu_torch.train --config <root.yaml> [k=v ...]``
- the legacy family: :class:`koemorph_tpu_torch.models.
  SimplifiedKoeMorphModel` and :class:`koemorph_tpu_torch.models.
  KoeMorphModel`, :class:`koemorph_tpu_torch.train.KoeMorphTrainer`,
  ``python -m koemorph_tpu_torch.rt_simplified --input x.wav ...`` and
  ``python -m koemorph_tpu_torch.test_model --data-dir d ...``
"""

__version__ = "0.1.0"

from koemorph_tpu_torch.blendshapes import (
    ARKIT_BLENDSHAPES,
    EXPRESSION_INDICES,
    MOUTH_BLENDSHAPES,
    MOUTH_INDICES,
    NUM_BLENDSHAPES,
)

__all__ = [
    "ARKIT_BLENDSHAPES",
    "MOUTH_BLENDSHAPES",
    "MOUTH_INDICES",
    "EXPRESSION_INDICES",
    "NUM_BLENDSHAPES",
    "__version__",
]
