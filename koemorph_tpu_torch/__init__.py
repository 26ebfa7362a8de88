"""KoeMorph in PyTorch: streaming and offline decoding on an NVIDIA GPU.

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
"""

__version__ = "0.1.0"
