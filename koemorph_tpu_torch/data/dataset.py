"""Per-file dataset, padding collate and datamodule of the legacy trainer,
on the host in numpy: the counterpart of ``koemorph_tpu.data.dataset``,
giving the same batches bit for bit for the same files, seed and epoch.

Samples pair ``*.jsonl`` blendshapes with the ``*.wav`` of the same
basename; a sample that fails to load becomes a dummy sample (1 s of
silence, 1 s of zero blendshapes) with a warning. Batches are padded to
their longest sample with boolean validity masks and produced on a
background thread (:class:`Prefetcher`).
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np

from koemorph_tpu_torch.data.io import ARKitDataLoader
from koemorph_tpu_torch.data.sequential import prefetch_iterator

__all__ = ["KoeMorphDataset", "collate_fn", "pad_to_multiple", "Prefetcher",
           "KoeMorphDataModule"]

PathLike = Union[str, Path]


class KoeMorphDataset:
    """Per-file samples of paired WAV + JSONL blendshapes, found by
    basename under ``data_dir`` (recursively, in sorted order)."""

    def __init__(self, data_dir: PathLike, sample_rate: int = 16000,
                 target_fps: float = 30.0, max_time_drift: float = 1.0,
                 max_samples: Optional[int] = None):
        self.data_dir = Path(data_dir)
        self.loader = ARKitDataLoader(sample_rate, target_fps, max_time_drift)
        self.sample_rate = sample_rate
        self.target_fps = target_fps
        self.file_pairs = self._find_pairs()
        if max_samples is not None:
            self.file_pairs = self.file_pairs[:max_samples]
        if not self.file_pairs:
            raise ValueError(f"No valid data pairs found in {self.data_dir}")

    def _find_pairs(self) -> list[tuple[Path, Path]]:
        pairs = []
        for jsonl_path in sorted(self.data_dir.glob("**/*.jsonl")):
            wav_path = jsonl_path.with_suffix(".wav")
            if wav_path.exists():
                pairs.append((jsonl_path, wav_path))
        return pairs

    def __len__(self) -> int:
        return len(self.file_pairs)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        jsonl_path, wav_path = self.file_pairs[idx]
        try:
            return self.loader.load_sample(jsonl_path, wav_path)
        except (ValueError, FileNotFoundError) as e:
            warnings.warn(f"Failed to load sample {idx} ({jsonl_path}): {e}; "
                          "substituting dummy sample")
            return {"wav": np.zeros(self.sample_rate, dtype=np.float32),
                    "arkit": np.zeros((int(self.target_fps), 52),
                                      dtype=np.float32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]


def collate_fn(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Pad variable-length samples to the longest and mark the valid parts:
    ``audio (B, L_max)``, ``audio_mask (B, L_max)``, ``arkit (B, T_max,
    52)``, ``arkit_mask (B, T_max)``."""
    if not samples:
        raise ValueError("Empty batch")
    b = len(samples)
    l_max = max(len(s["wav"]) for s in samples)
    t_max = max(len(s["arkit"]) for s in samples)
    audio = np.zeros((b, l_max), dtype=np.float32)
    audio_mask = np.zeros((b, l_max), dtype=bool)
    arkit = np.zeros((b, t_max, 52), dtype=np.float32)
    arkit_mask = np.zeros((b, t_max), dtype=bool)
    for i, s in enumerate(samples):
        nl, nt = len(s["wav"]), len(s["arkit"])
        audio[i, :nl] = s["wav"]
        audio_mask[i, :nl] = True
        arkit[i, :nt] = s["arkit"]
        arkit_mask[i, :nt] = True
    return {"audio": audio, "audio_mask": audio_mask,
            "arkit": arkit, "arkit_mask": arkit_mask}


def pad_to_multiple(batch: dict[str, np.ndarray],
                    audio_multiple: int = 533) -> dict[str, np.ndarray]:
    """Pad the audio axis (and its mask) to a multiple of
    ``audio_multiple``, which bounds the number of distinct shapes."""
    length = batch["audio"].shape[1]
    target = -(-length // audio_multiple) * audio_multiple
    if target == length:
        return batch
    pad = ((0, 0), (0, target - length))
    return dict(batch, audio=np.pad(batch["audio"], pad),
                audio_mask=np.pad(batch["audio_mask"], pad))


class Prefetcher:
    """Batches of a map-style dataset, collated on a background thread
    that keeps ``prefetch`` ready. With ``shuffle`` the order of epoch
    ``e`` is ``default_rng(seed + e)``'s permutation; ``drop_last`` drops
    a short last batch. A loading failure fails the epoch."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 collate=collate_fn):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.collate = collate
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        def produce():
            for idxs in batches:
                yield self.collate([self.dataset[int(i)] for i in idxs])

        yield from prefetch_iterator(produce, depth=self.prefetch)()


class KoeMorphDataModule:
    """Train, validation and test datasets and their loaders: training
    shuffled per epoch with the last short batch dropped; validation and
    test in order, every sample."""

    def __init__(self, train_data_dir: Optional[PathLike] = None,
                 val_data_dir: Optional[PathLike] = None,
                 test_data_dir: Optional[PathLike] = None,
                 batch_size: int = 16, sample_rate: int = 16000,
                 target_fps: float = 30.0, max_time_drift: float = 1.0,
                 prefetch: int = 2, seed: int = 0):
        self.train_data_dir = train_data_dir
        self.val_data_dir = val_data_dir
        self.test_data_dir = test_data_dir
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.target_fps = target_fps
        self.max_time_drift = max_time_drift
        self.prefetch = prefetch
        self.seed = seed
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None

    def setup(self) -> None:
        def make(d):
            return KoeMorphDataset(d, self.sample_rate, self.target_fps,
                                   self.max_time_drift) if d else None

        self.train_dataset = make(self.train_data_dir)
        self.val_dataset = make(self.val_data_dir)
        self.test_dataset = make(self.test_data_dir)

    def train_dataloader(self) -> Prefetcher:
        if self.train_dataset is None:
            raise RuntimeError("call setup() first")
        return Prefetcher(self.train_dataset, self.batch_size, shuffle=True,
                          drop_last=True, seed=self.seed,
                          prefetch=self.prefetch)

    def val_dataloader(self) -> Optional[Prefetcher]:
        if self.val_dataset is None:
            return None
        return Prefetcher(self.val_dataset, self.batch_size, shuffle=False,
                          drop_last=False, prefetch=self.prefetch)

    def test_dataloader(self) -> Optional[Prefetcher]:
        if self.test_dataset is None:
            return None
        return Prefetcher(self.test_dataset, self.batch_size, shuffle=False,
                          drop_last=False, prefetch=self.prefetch)
