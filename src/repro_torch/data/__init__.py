"""Deterministic synthetic data of the port: every feeder is a function of
(seed, step), built on the device it is given. ``lm_batch`` and
``dien_batch`` wait for their slices (ROADMAP §A12)."""

from repro_torch.data.pipeline import (
    DataCursor,
    gnn_full_batch,
    gnn_molecule_batch,
)

__all__ = ["DataCursor", "gnn_full_batch", "gnn_molecule_batch"]
