"""KoeMorph in PyTorch: the single-session streaming step on an NVIDIA GPU.

A port of :mod:`koemorph_tpu` (JAX) that stands on its own: it imports
``torch``, ``numpy`` and the standard library only. The per-frame
streaming step (incremental log-mel row, the eGeMAPS emotion refresh and
the dual-stream cross-attention decode) runs on ``cuda`` by default; the
two hot DSP reductions of the refresh are hand-written CUDA kernels
(:mod:`koemorph_tpu_torch.ops.cuda`) with a plain PyTorch twin that runs
for tensors on the CPU.

Entry points:

- :func:`koemorph_tpu_torch.runtime.engine.build_streaming_model`
- :class:`koemorph_tpu_torch.runtime.streaming.StreamingInference`
- ``python -m koemorph_tpu_torch.rt --input x.wav ...``
"""

__version__ = "0.1.0"
