from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "Trainer", "TrainerConfig"]
