"""Runtime of the port: checkpointing. ``runtime/fault.py`` waits
(ROADMAP §A12)."""

from repro_torch.runtime.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
