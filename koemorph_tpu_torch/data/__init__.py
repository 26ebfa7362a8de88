"""Host-side data pipeline: WAV and JSONL I/O, datasets, windowing and
batching."""

from koemorph_tpu_torch.data.wav import read_wav, resample_linear, write_wav
from koemorph_tpu_torch.data.io import (
    ARKitDataLoader,
    detect_fps,
    load_blendshapes_with_fps,
    resample_blendshapes,
    validate_data_consistency,
)
from koemorph_tpu_torch.data.dataset import (
    KoeMorphDataModule,
    KoeMorphDataset,
    Prefetcher,
    collate_fn,
)
from koemorph_tpu_torch.data.sequential import (
    AdaptiveSequentialDataset,
    SequentialBatchSampler,
    SequentialKoeMorphDataset,
    StrideSchedule,
    create_adaptive_dataloader,
    create_sequential_dataloader,
    prefetch_iterator,
    sequential_collate,
)

__all__ = [
    "read_wav", "write_wav", "resample_linear",
    "ARKitDataLoader", "detect_fps", "load_blendshapes_with_fps",
    "resample_blendshapes", "validate_data_consistency",
    "KoeMorphDataset", "KoeMorphDataModule", "Prefetcher", "collate_fn",
    "SequentialKoeMorphDataset", "SequentialBatchSampler",
    "AdaptiveSequentialDataset",
    "StrideSchedule", "create_sequential_dataloader",
    "create_adaptive_dataloader", "sequential_collate", "prefetch_iterator",
]
