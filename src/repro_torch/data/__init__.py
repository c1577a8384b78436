"""Deterministic synthetic data of the port: every feeder is a function of
(seed, step), built on the device it is given."""

from repro_torch.data.pipeline import (
    DataCursor,
    dien_batch,
    gnn_full_batch,
    gnn_molecule_batch,
    gnn_sampled_batch,
    lm_batch,
    sample_subgraph,
    uniform_graph,
)

__all__ = ["DataCursor", "dien_batch", "gnn_full_batch", "gnn_molecule_batch",
           "gnn_sampled_batch", "lm_batch", "sample_subgraph",
           "uniform_graph"]
