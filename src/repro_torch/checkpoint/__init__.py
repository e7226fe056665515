"""Checkpoints of the port: :class:`CheckpointManager`, in the reference's
on-disk format."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
