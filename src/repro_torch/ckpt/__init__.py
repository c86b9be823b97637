from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
