"""Step-atomic checkpoints (the port of `repro.checkpoint`)."""
from .checkpointing import CheckpointManager

__all__ = ["CheckpointManager"]
