"""Synthetic batch feeders for the GNN family (seed+step deterministic).

Counterpart of ``repro.data.pipeline``: the same keys, shapes, dtypes and
distributions, built directly on the given device from a
``torch.Generator`` seeded from ``(seed, step)``. The numbers differ from
``jax.random``'s for the same seed and step; tests that compare the two
packages hand the JAX package's batch across as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DataCursor:
    """Checkpointable pipeline position."""
    seed: int
    step: int

    def generator(self, device: str | torch.device = "cuda",
                  stream: int = 0) -> torch.Generator:
        """A generator on ``device`` seeded from ``(seed, step)`` alone;
        each ``stream`` number gives an independent sequence."""
        mixed = np.random.SeedSequence(
            [self.seed, self.step, stream]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(int(mixed))
        return gen


def _randint(gen, high: int, shape, low: int = 0):
    return torch.randint(low, high, shape, generator=gen, device=gen.device,
                         dtype=torch.int32)


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def gnn_full_batch(cursor: DataCursor, n_nodes: int, n_edges: int,
                   d_feat: int, d_out: int, task: str, d_edge: int = 4, *,
                   device: str | torch.device = "cuda"):
    """One random graph: x, src, dst, edge_feat, and labels (node_class)
    or targets."""
    gen = cursor.generator(device)
    batch = {
        "x": _randn(gen, (n_nodes, d_feat)),
        "src": _randint(gen, n_nodes, (n_edges,)),
        "dst": _randint(gen, n_nodes, (n_edges,)),
        "edge_feat": _randn(gen, (n_edges, d_edge)),
    }
    if task == "node_class":
        batch["labels"] = _randint(gen, d_out, (n_nodes,))
    else:
        batch["targets"] = _randn(gen, (n_nodes, d_out))
    return batch


def gnn_molecule_batch(cursor: DataCursor, n_graphs: int, nodes_per: int,
                       edges_per: int, d_feat: int, d_out: int,
                       d_edge: int = 4, *,
                       device: str | torch.device = "cuda"):
    """Batched small graphs: node-batch representation with graph ids."""
    gen = cursor.generator(device)
    n = n_graphs * nodes_per
    e = n_graphs * edges_per
    # edges stay within their graph
    base = (torch.arange(e, dtype=torch.int32, device=gen.device)
            // edges_per) * nodes_per
    src = base + _randint(gen, nodes_per, (e,))
    dst = base + _randint(gen, nodes_per, (e,))
    return {
        "x": _randn(gen, (n, d_feat)),
        "src": src,
        "dst": dst,
        "edge_feat": _randn(gen, (e, d_edge)),
        "graph_id": torch.arange(n, dtype=torch.int32,
                                 device=gen.device) // nodes_per,
        "graph_targets": _randn(gen, (n_graphs, d_out)),
    }
