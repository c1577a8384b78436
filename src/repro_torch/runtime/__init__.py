"""Runtime of the port: checkpointing, fault tolerance, stragglers,
elasticity."""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import (
    FaultTolerantRunner,
    StepFailure,
    StragglerBalancer,
    reshard_state,
)

__all__ = ["CheckpointManager", "FaultTolerantRunner", "StepFailure",
           "StragglerBalancer", "reshard_state"]
