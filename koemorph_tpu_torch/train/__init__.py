"""Training: schedules and the optimizer, trainers, checkpoints."""

from koemorph_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 load_checkpoint,
                                                 load_opt_state,
                                                 save_checkpoint)
from koemorph_tpu_torch.train.optim import (Optimizer, create_lr_schedule,
                                            create_optimizer)
from koemorph_tpu_torch.train.trainer import (DualStreamTrainer,
                                              KoeMorphTrainer,
                                              SequentialTrainer, Trainer,
                                              loss_config_from,
                                              sequence_targets)

__all__ = [
    "create_lr_schedule", "create_optimizer", "Optimizer",
    "CheckpointManager", "save_checkpoint", "load_checkpoint",
    "load_opt_state",
    "Trainer", "KoeMorphTrainer", "DualStreamTrainer", "SequentialTrainer",
    "loss_config_from", "sequence_targets",
]
