"""Training of the port: the trainer, its optimizers and checkpoints in
``chore_tpu``'s format."""
from chore_tpu_torch.train.checkpoints import (
    checkpoint_name,
    find_checkpoint,
    load_checkpoint,
    save_checkpoint,
    update_val_min,
)
from chore_tpu_torch.train.trainer import MetricsLogger, Trainer, multistep_lr

__all__ = [
    "checkpoint_name",
    "find_checkpoint",
    "load_checkpoint",
    "save_checkpoint",
    "update_val_min",
    "MetricsLogger",
    "Trainer",
    "multistep_lr",
]
