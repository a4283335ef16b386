"""Checkpointing of the port (port of ``repro.checkpoint``): the atomic,
async, retention-bounded ``CheckpointManager`` over tensor trees."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
