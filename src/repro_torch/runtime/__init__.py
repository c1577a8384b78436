"""Runtime of the port: checkpointing. ``runtime/fault.py`` waits
(ROADMAP A10.4)."""

from repro_torch.runtime.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
