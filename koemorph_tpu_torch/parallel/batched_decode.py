"""Batched multi-utterance sequential decoding, on one GPU or over a mesh.

The counterpart of ``koemorph_tpu.parallel.batched_decode``: a batch of
equal-length utterances through
:class:`~koemorph_tpu_torch.models.dual_stream_model.SequentialDualStreamModel`,
with per-utterance window strides (:meth:`decode_scheduled`) and the
sequence-parallel decode's window split and EMA replay
(:meth:`decode_sequence_parallel`), which on one device is the plain decode
bit for bit.

Over a mesh (``mesh=`` or ``devices=``; one process drives every entry)
the decoder keeps one model replica and one decoder per entry
(:attr:`BatchedSequentialDecoder.entries`). A batch splits into one
contiguous block of utterances per entry, each decoded on its entry, and
the blocks are concatenated in order on the first entry's device: no
collectives, as in JAX. The sequence-parallel decode gives each entry one
contiguous chunk of the utterance's windows, decoded raw (before the EMA
smoothing); the raw rows are copied to the first entry, where the EMA
recurrence is replayed over the stitched sequence.

On the card every decode (:meth:`BatchedSequentialDecoder.__call__`,
:meth:`~BatchedSequentialDecoder.decode_scheduled`,
:meth:`~BatchedSequentialDecoder.decode_sequence_parallel`) is one CUDA
graph replay: a graph per method, input shape (for the window-start paths
also the window count) and model configuration, captured at the first
call of that key, reading static buffers that each call copies its audio
(and window starts) into. The decoder keeps the graphs of its
``max_graphs`` most recent keys: a graph pays for itself only on a shape
that repeats (fixed-length chunks or batches), and a first call of a new
one costs a warm-up run and a capture. ``__call__(...,
return_attention=True)`` runs eagerly.

In the span registry (:mod:`koemorph_tpu_torch.utils.spans`) a call is
the host spans ``koemorph.decode.h2d`` (the audio and its copy into the
static buffers), ``.launch`` and ``.out``, and one step of the ``decode``
track on the device: ``emotion`` (the LLDs with K1 and K2, the
functionals), ``frontend`` (the log-mel with K3 and the reflected edge
rows) and ``model`` (window gather, attention, EMA).
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Optional

import numpy as np
import torch

from koemorph_tpu_torch.device import DeviceLike, resolve_device
from koemorph_tpu_torch.models.dual_stream_model import (
    DECODE_STAGES, SequentialDualStreamModel, _ema_smooth)
from koemorph_tpu_torch.parallel.mesh import (Mesh, block_rows, make_mesh,
                                              replicate)
from koemorph_tpu_torch.runtime.graphs import StepGraphs
from koemorph_tpu_torch.utils import spans

logger = logging.getLogger(__name__)

__all__ = ["BatchedSequentialDecoder"]


class BatchedSequentialDecoder:
    """Decode batches of equal-length utterances::

        decoder = BatchedSequentialDecoder(model)
        out = decoder(audio_batch)          # (B, L) -> (B, T_out, 52)

    The model moves to ``device`` (``cuda`` unless the caller asks for
    another; raises when CUDA is absent) and runs in eval mode under
    ``torch.inference_mode``. On the card a call replays a CUDA graph of
    the decode; ``graphs=False`` runs it eagerly, and the CPU has no
    graphs (``graphs=True`` there raises ``ValueError``).

    ``mesh`` (or ``devices``, a list of entries for
    :func:`~koemorph_tpu_torch.parallel.make_mesh`) decodes over the
    mesh's entries, one decoder each (:attr:`entries`); a batch must divide
    over them.
    """

    #: graphs kept, one per key, the least recently used dropped
    max_graphs = 4

    def __init__(self, model: SequentialDualStreamModel,
                 device: DeviceLike = None, graphs: Optional[bool] = None,
                 mesh: Optional[Mesh] = None,
                 devices: Optional[list] = None):
        #: the decoder of each mesh entry (None without a mesh)
        self.entries: Optional[list[BatchedSequentialDecoder]] = None
        if mesh is None and devices is not None:
            mesh = make_mesh(devices=devices)
        self.mesh = mesh
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("one process drives every entry of a "
                                 "decode mesh; got a process group's mesh")
            if device is not None:
                raise ValueError("pass the mesh or a device, not both")
            self.entries = [
                BatchedSequentialDecoder(m, device=d, graphs=graphs)
                for m, d in zip(replicate(model.eval(), mesh),
                                mesh.devices)]
            self.device = self.entries[0].device
            self.model = self.entries[0].model
            return
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.step_graphs = StepGraphs(self.device, graphs,
                                      span="koemorph.decode")
        #: the static input buffers of each graph, by key, least recently
        #: used first
        self._static: dict = {}

    @property
    def num_devices(self) -> int:
        return 1 if self.entries is None else len(self.entries)

    def _blocks(self, audio_batch) -> list:
        """The entries' blocks of a batch (host or device), each on its
        entry's device; raises on a batch that does not divide."""
        audio = (audio_batch if isinstance(audio_batch, torch.Tensor)
                 else torch.from_numpy(np.array(audio_batch, np.float32)))
        n = len(self.entries)
        if audio.shape[0] % n:
            raise ValueError(f"batch {audio.shape[0]} not divisible by {n} "
                             "devices; pad upstream")
        return [e._audio(audio[block_rows(audio.shape[0], n, i)])
                for i, e in enumerate(self.entries)]

    def _stitch(self, parts: list) -> torch.Tensor:
        """The entries' outputs concatenated in order on the first
        entry's device."""
        return torch.cat([p.to(self.device, non_blocking=True)
                          for p in parts])

    def _audio(self, audio_batch) -> torch.Tensor:
        """A tensor on the decoder's device (numpy input is copied)."""
        if isinstance(audio_batch, torch.Tensor):
            return audio_batch.to(self.device, torch.float32)
        return torch.from_numpy(np.array(audio_batch, np.float32)).to(
            self.device)

    def _model_key(self) -> tuple:
        """The model options a decode graph depends on (the emotion
        frontend's configuration carries ``egemaps_per_period``)."""
        m = self.model
        return (m.stride_frames, m.decode_mode, m.window_chunk,
                m.exact_window_stft, m.window_edge, m.emotion_config,
                m.mel_frontend)

    def _graphed(self, key: tuple, inputs: tuple, body):
        """``body(*inputs)``: eagerly when graphs are off; else one replay
        of the graph of ``key`` (captured at its first call) over static
        buffers that ``inputs`` are copied into."""
        body = functools.partial(self._tracked, body)
        if not self.step_graphs.enabled:
            return self.step_graphs.run(key, functools.partial(body, *inputs))
        key = key + self._model_key()
        bufs = self._static.pop(key, None)
        if bufs is None:
            if len(self._static) >= self.max_graphs:
                old = next(iter(self._static))
                del self._static[old]
                self.step_graphs.drop(old)
            logger.info("capturing the decode's CUDA graph for %s", key[:3])
            bufs = tuple(t.clone() for t in inputs)
            fn = functools.partial(body, *bufs)
            self.step_graphs.capture(key, fn, fn)
        else:
            with spans.host("koemorph.decode.h2d"):
                for buf, t in zip(bufs, inputs):
                    buf.copy_(t)
        self._static[key] = bufs                 # the most recent, last
        return self.step_graphs.run(key, None)

    def _tracked(self, body, *args):
        """``body(*args)`` as one step of the registry's ``decode``
        track."""
        with spans.track("decode", self.device, DECODE_STAGES):
            return body(*args)

    def _decode(self, audio: torch.Tensor) -> torch.Tensor:
        return self.model(audio)["blendshapes"]

    @torch.inference_mode()
    def __call__(self, audio_batch, return_attention: bool = False):
        """``(B, L)`` audio -> ``(B, T_out, 52)`` blendshapes (on the
        device, not waited for; no later call writes them). With
        ``return_attention`` the model's dict (``blendshapes`` and the
        per-window ``mel_attention_weights`` / ``emotion_attention_weights``),
        computed eagerly."""
        if self.entries is not None:
            outs = [e(block, return_attention)
                    for e, block in zip(self.entries,
                                        self._blocks(audio_batch))]
            if return_attention:
                return {k: self._stitch([o[k] for o in outs])
                        for k in outs[0]}
            return self._stitch(outs)
        with spans.host("koemorph.decode.h2d"):
            audio = self._audio(audio_batch)
        if return_attention:
            out = self.model(audio, return_attention=True)
            return {k: out[k] for k in ("blendshapes",
                                        "mel_attention_weights",
                                        "emotion_attention_weights")}
        return self._graphed(("call", tuple(audio.shape)), (audio,),
                             self._decode)

    def _span(self, length: int) -> int:
        span = length // self.model.hop_length - self.model.window_frames
        if span < 0:
            raise ValueError(f"audio shorter than one "
                             f"{self.model.window_frames}-frame window")
        return span

    def _decode_at(self, audio: torch.Tensor,
                   starts: torch.Tensor) -> torch.Tensor:
        return self.model(audio, window_starts=starts)["blendshapes"]

    @torch.inference_mode()
    def decode_scheduled(self, audio_batch, strides
                         ) -> tuple[torch.Tensor, np.ndarray]:
        """Per-utterance window strides (an int or ``(B,)``): utterance
        ``i`` decodes windows at ``0, s_i, 2 s_i, ...``; every row is padded
        to the densest stride's window count with the final valid start.
        Returns ``(B, n_max, 52)`` blendshapes and the ``(B, n_max)``
        validity mask. One graph per (audio shape, ``n_max``)."""
        if self.entries is not None:
            blocks = self._blocks(audio_batch)
            bsz = sum(b.shape[0] for b in blocks)
        else:
            audio = self._audio(audio_batch)
            bsz = audio.shape[0]
        strides = np.broadcast_to(np.asarray(strides, np.int64),
                                  (bsz,)).astype(np.int64)
        if (strides < 1).any():
            raise ValueError("strides must be >= 1")
        length = (blocks[0] if self.entries is not None else audio).shape[1]
        span = self._span(length)
        n_per = span // strides + 1
        n_max = int(n_per.max())
        grid = np.arange(n_max)[None, :] * strides[:, None]
        starts = torch.from_numpy(np.minimum(grid, span))
        mask = np.arange(n_max)[None, :] < n_per[:, None]
        if self.entries is None:
            return self._scheduled(audio, starts, n_max), mask
        n = len(self.entries)
        return self._stitch([
            e._scheduled(block, starts[block_rows(bsz, n, i)], n_max)
            for i, (e, block) in enumerate(zip(self.entries, blocks))]), mask

    def _scheduled(self, audio: torch.Tensor, starts: torch.Tensor,
                   n_max: int) -> torch.Tensor:
        """The scheduled decode of ``audio`` at ``starts`` (host or device)
        on this decoder's device."""
        return self._graphed(("scheduled", tuple(audio.shape), n_max),
                             (audio, starts.to(self.device)), self._decode_at)

    def _decode_raw(self, tiled: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
        """Pre-smoothing windows ``(n_dev * per, 52)`` of ``tiled`` at
        ``starts``, in window order."""
        raw = self.model(tiled, window_starts=starts,
                         return_raw=True)["raw_blendshapes"]
        return raw.reshape(-1, raw.shape[-1])

    def _decode_sequence(self, tiled: torch.Tensor, starts: torch.Tensor,
                         n_out: int) -> torch.Tensor:
        raw_flat = self._decode_raw(tiled, starts)[:n_out]
        return _ema_smooth(raw_flat, self.model.alpha())

    @torch.inference_mode()
    def decode_sequence_parallel(self, audio) -> torch.Tensor:
        """ONE utterance ``(L,)`` -> ``(T_out, 52)``: the window sequence cut
        into one contiguous chunk per device, decoded raw, and the EMA
        replayed over the stitched sequence. On one device this is one
        chunk, equal to the plain decode. One graph per (L, T_out)."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 2 and audio.shape[0] == 1:
            audio = audio[0]
        if audio.ndim != 1:
            raise ValueError("decode_sequence_parallel takes ONE utterance "
                             "(L,); use __call__ for batches")
        n_dev = self.num_devices
        span = self._span(audio.shape[0])
        stride = int(self.model.stride_frames)
        n_out = span // stride + 1
        per = -(-n_out // n_dev)
        starts = np.minimum(np.arange(n_dev * per) * stride, span).reshape(
            n_dev, per)
        if self.entries is not None:
            raws = [e._graphed(("sequence_raw", audio.shape, per),
                               (e._audio(audio[None]),
                                torch.from_numpy(starts[i:i + 1]).to(
                                    e.device)),
                               e._decode_raw)
                    for i, e in enumerate(self.entries)]
            return _ema_smooth(self._stitch(raws)[:n_out], self.model.alpha())
        tiled = np.broadcast_to(audio, (n_dev, audio.shape[0]))
        return self._graphed(
            ("sequence_parallel", tiled.shape, n_out),
            (self._audio(tiled), torch.from_numpy(starts).to(self.device)),
            functools.partial(self._decode_sequence, n_out=n_out))

    def throughput_stats(self, audio_batch, iters: int = 10) -> dict:
        """Frames per second of ``__call__`` on this batch (host clock,
        each call waited for, after one warm-up call)."""
        audio = self._audio(audio_batch)
        out = self(audio)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self(audio)
        self._sync()
        dt = (time.perf_counter() - t0) / iters
        b, t_out = out.shape[0], out.shape[1]
        return {"batch": b, "frames_per_call": b * t_out,
                "latency_ms": dt * 1e3, "frames_per_s": b * t_out / dt,
                "frames_per_s_per_device": b * t_out / dt / self.num_devices,
                "devices": self.num_devices, "device": str(self.device)}

    def _sync(self) -> None:
        for e in self.entries or [self]:
            if e.device.type == "cuda":
                torch.cuda.synchronize(e.device)
