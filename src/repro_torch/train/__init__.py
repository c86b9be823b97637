from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
