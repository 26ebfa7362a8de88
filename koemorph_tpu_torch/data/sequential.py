"""Sequential windowed datasets with stride schedules, on the host in
numpy: the counterpart of ``koemorph_tpu.data.sequential``, giving the same
batches bit for bit for the same files, seed and epoch.

Files are decoded once into host arrays; windows are index computations
(start frames), and the batcher gathers fixed-size ``(B, window_samples)``
slices, so every batch has one shape. Temporal order within a file is
kept, and each window carries a ``new_file`` flag for temporal-state
resets at file boundaries. Stride modes: dense, sparse, progressive and
mixed (:class:`StrideSchedule`).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np

from koemorph_tpu_torch.data.io import load_blendshapes_with_fps, resample_blendshapes
from koemorph_tpu_torch.data.wav import read_wav, resample_linear
from koemorph_tpu_torch.utils import spans

logger = logging.getLogger(__name__)
PathLike = Union[str, Path]


class SequentialKoeMorphDataset:
    """Overlapping fixed windows in temporal order per file."""

    def __init__(
        self,
        data_dir: PathLike,
        window_frames: int = 256,   # ~8.5 s at 30 fps
        stride_frames: int = 1,
        sample_rate: int = 16000,
        target_fps: int = 30,
        shuffle_files: bool = True,
        loop_dataset: bool = False,
        max_files: Optional[int] = None,
        seed: int = 0,
    ):
        self.data_dir = Path(data_dir)
        self.window_frames = window_frames
        self.stride_frames = stride_frames
        self.sample_rate = sample_rate
        self.target_fps = target_fps
        self.shuffle_files = shuffle_files
        self.loop_dataset = loop_dataset
        self.seed = seed

        self.hop_length = int(sample_rate / target_fps)  # 533 @ 30 fps
        self.window_samples = window_frames * self.hop_length
        self.stride_samples = stride_frames * self.hop_length

        self.file_pairs = self._find_file_pairs()
        if max_files:
            self.file_pairs = self.file_pairs[:max_files]
        if not self.file_pairs:
            raise ValueError(
                f"No valid audio/JSONL pairs found in {data_dir}")

        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._epoch = 0

    def _find_file_pairs(self) -> list[tuple[Path, Path]]:
        pairs = []
        for audio_path in sorted(self.data_dir.glob("**/*.wav")):
            jsonl_path = audio_path.with_suffix(".jsonl")
            if jsonl_path.exists():
                pairs.append((audio_path, jsonl_path))
        return pairs

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    # -- per-file loading (cached; decode once, window by index) ----------

    def _load_file(self, file_idx: int) -> tuple[np.ndarray, np.ndarray]:
        if file_idx in self._cache:
            return self._cache[file_idx]
        audio_path, jsonl_path = self.file_pairs[file_idx]
        audio, sr = read_wav(audio_path, mono=True)
        if sr != self.sample_rate:
            audio = resample_linear(audio, sr, self.sample_rate)
        blendshapes, source_fps = load_blendshapes_with_fps(jsonl_path)
        if abs(source_fps - self.target_fps) > 0.1:
            logger.info(
                "Resampling blendshapes %sfps -> %sfps for %s",
                source_fps, self.target_fps, audio_path.name)
            blendshapes = resample_blendshapes(blendshapes, source_fps,
                                               self.target_fps)
        # audio/blendshape alignment clamp
        # (reference sequential_dataset.py:169-179)
        expected_frames = len(audio) // self.hop_length
        if abs(len(blendshapes) - expected_frames) > 1:
            logger.warning(
                "Frame mismatch in %s: audio suggests %d frames, found %d "
                "blendshapes", audio_path.name, expected_frames,
                len(blendshapes))
        num_frames = min(len(blendshapes), expected_frames)
        audio = audio[: num_frames * self.hop_length]
        blendshapes = blendshapes[:num_frames]
        self._cache[file_idx] = (audio, blendshapes)
        return audio, blendshapes

    def windows_for_file(self, file_idx: int,
                         stride_frames: Optional[int] = None) -> np.ndarray:
        """Start-frame indices of all valid windows for one file."""
        stride = stride_frames or self.stride_frames
        _, blendshapes = self._load_file(file_idx)
        n = (len(blendshapes) - self.window_frames) // stride + 1
        if n <= 0:
            return np.empty((0,), dtype=np.int64)
        return np.arange(n, dtype=np.int64) * stride

    def get_window(self, file_idx: int, start_frame: int) -> dict:
        """Materialize one fixed-size window."""
        audio, blendshapes = self._load_file(file_idx)
        s = int(start_frame)
        a0 = s * self.hop_length
        return {
            "audio": audio[a0 : a0 + self.window_samples],
            "blendshapes": blendshapes[s : s + self.window_frames],
            "file_idx": file_idx,
            "window_idx": s // max(self.stride_frames, 1),
            "start_frame": s,
            "new_file": s == 0,   # first window of its file (state reset)
            "file_name": self.file_pairs[file_idx][0].stem,
        }

    def _stride_for_file(self, file_idx: int) -> Optional[int]:
        """Stride override hook (AdaptiveSequentialDataset schedules here);
        None = the dataset's fixed stride."""
        return None

    def __iter__(self) -> Iterator[dict]:
        while True:
            order = np.arange(len(self.file_pairs))
            if self.shuffle_files:
                rng = np.random.default_rng(self.seed + self._epoch)
                rng.shuffle(order)
            for file_idx in order:
                stride = self._stride_for_file(int(file_idx))
                try:
                    starts = self.windows_for_file(
                        int(file_idx), stride_frames=stride)
                except Exception as e:  # mirror lenient per-file recovery
                    logger.error("Error processing %s: %s",
                                 self.file_pairs[int(file_idx)][0], e)
                    continue
                for s in starts:
                    yield self.get_window(int(file_idx), int(s))
            if not self.loop_dataset:
                break
            self._epoch += 1

    def get_num_windows(self) -> int:
        total = 0
        for i in range(len(self.file_pairs)):
            try:
                total += len(self.windows_for_file(i))
            except Exception:
                pass
        return total


class StrideSchedule:
    """Stride scheduling for adaptive training
    (reference src/data/adaptive_sequential_dataset.py:111-267).

    Modes:
    - ``dense``: stride 1 every epoch.
    - ``sparse``: fixed ``sparse_stride``.
    - ``progressive``: stride decays linearly from ``sparse_stride`` to 1
      over ``progressive_epochs``.
    - ``mixed``: per-epoch random subset of files gets dense stride
      (``dense_ratio``), the rest sparse.
    """

    def __init__(
        self,
        mode: str = "progressive",
        sparse_stride: int = 16,
        progressive_epochs: int = 10,
        dense_ratio: float = 0.1,
        seed: int = 0,
    ):
        if mode not in ("dense", "sparse", "progressive", "mixed"):
            raise ValueError(f"Unknown stride mode: {mode}")
        self.mode = mode
        self.sparse_stride = sparse_stride
        self.progressive_epochs = progressive_epochs
        self.dense_ratio = dense_ratio
        self.seed = seed

    def stride_for(self, epoch: int, file_idx: int, num_files: int) -> int:
        if self.mode == "dense":
            return 1
        if self.mode == "sparse":
            return self.sparse_stride
        if self.mode == "progressive":
            frac = min(epoch / max(self.progressive_epochs - 1, 1), 1.0)
            stride = round(self.sparse_stride * (1 - frac) + 1 * frac)
            return max(1, int(stride))
        # mixed: deterministic per-epoch random dense subset
        rng = np.random.default_rng(self.seed + epoch)
        dense_files = rng.random(num_files) < self.dense_ratio
        return 1 if dense_files[file_idx] else self.sparse_stride


class AdaptiveSequentialDataset(SequentialKoeMorphDataset):
    """Sequential dataset with per-epoch stride scheduling."""

    def __init__(self, *args, schedule: Optional[StrideSchedule] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.schedule = schedule or StrideSchedule()

    def _stride_for_file(self, file_idx: int) -> Optional[int]:
        return self.schedule.stride_for(self._epoch, file_idx,
                                        len(self.file_pairs))


def sequential_collate(samples: list[dict]) -> dict[str, np.ndarray]:
    """Stack fixed-size windows into a static-shape batch with file metadata
    for boundary-aware temporal-state resets."""
    return {
        "audio": np.stack([s["audio"] for s in samples]).astype(np.float32),
        "blendshapes": np.stack(
            [s["blendshapes"] for s in samples]).astype(np.float32),
        "file_indices": np.asarray([s["file_idx"] for s in samples],
                                   np.int32),
        "window_indices": np.asarray([s["window_idx"] for s in samples],
                                     np.int32),
        "start_frames": np.asarray([s["start_frame"] for s in samples],
                                   np.int32),
        "new_file": np.asarray([s.get("new_file", False) for s in samples],
                               bool),
        "file_names": [s["file_name"] for s in samples],
    }



def prefetch_iterator(gen_fn, depth: int = 2):
    """Wrap a batch-generator factory with a background producer thread so
    host-side loading/collation overlaps device compute (the role of the
    reference's DataLoader workers, sequential_dataset.py:355-362).

    Producer exceptions are re-raised in the consumer — a mid-epoch loading
    failure must fail the epoch, not silently truncate it.

    In the span registry the consumer's wait for a batch is the host span
    ``koemorph.data.wait``."""

    def iterate():
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=depth)
        SENTINEL = object()

        def produce():
            try:
                for item in gen_fn():
                    q.put(item)
                q.put(SENTINEL)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            with spans.host("koemorph.data.wait"):
                item = q.get()
            if item is SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    return iterate


def create_sequential_dataloader(
    data_dir: PathLike,
    batch_size: int = 4,
    window_frames: int = 256,
    stride_frames: int = 128,
    drop_last: bool = True,
    **kwargs,
):
    """Batched iterator over sequential windows
    (reference src/data/sequential_dataset.py:324-364)."""
    dataset = SequentialKoeMorphDataset(
        data_dir=data_dir, window_frames=window_frames,
        stride_frames=stride_frames, **kwargs)
    return _batched_loader(dataset, batch_size, drop_last), dataset


def create_adaptive_dataloader(
    data_dir: PathLike,
    batch_size: int = 4,
    window_frames: int = 256,
    schedule: Optional[StrideSchedule] = None,
    drop_last: bool = True,
    **kwargs,
):
    """Batched iterator with stride scheduling
    (reference src/data/adaptive_sequential_dataset.py:308-348)."""
    dataset = AdaptiveSequentialDataset(
        data_dir=data_dir, window_frames=window_frames, schedule=schedule,
        **kwargs)
    return _batched_loader(dataset, batch_size, drop_last), dataset


class SequentialBatchSampler:
    """File-continuous window batching (reference
    sequential_dataset.py:247-321): batches never mix windows from
    different files — at a file boundary the partial batch is flushed
    (or dropped with ``drop_last``) so the trainer's temporal-state reset
    happens exactly once per file.

    Note a deliberate semantic difference: the reference sampler carries
    boundary partials over into the next file's batch (mixing files in
    one batch, which corrupts cross-window temporal state); we do not.
    With ``drop_last=True`` this discards up to ``batch_size - 1``
    windows *per file* rather than per epoch — with many short files,
    prefer ``drop_last=False`` (flush) to keep every window.
    """

    def __init__(self, dataset: SequentialKoeMorphDataset,
                 batch_size: int, drop_last: bool = True,
                 shuffle_sequences: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        # file order is shuffled by the dataset's own set_epoch; the flag
        # is kept for reference API compatibility
        self.shuffle_sequences = shuffle_sequences

    def __iter__(self) -> Iterator[dict]:
        batch: list[dict] = []
        current_file = None
        for sample in self.dataset:
            if current_file is not None and \
                    sample["file_idx"] != current_file and batch:
                # a partial batch at the file boundary (full batches were
                # already flushed below)
                if not self.drop_last:
                    yield sequential_collate(batch)
                batch = []
            current_file = sample["file_idx"]
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield sequential_collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield sequential_collate(batch)


def _batched_loader(dataset, batch_size: int, drop_last: bool):
    """Shared window batcher with background prefetch."""

    def iterate():
        batch: list[dict] = []
        for sample in dataset:
            batch.append(sample)
            if len(batch) == batch_size:
                yield sequential_collate(batch)
                batch = []
        if batch and not drop_last:
            yield sequential_collate(batch)

    return prefetch_iterator(iterate)
