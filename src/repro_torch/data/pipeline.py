"""Synthetic batch feeders for the LM, GNN and recsys families (seed+step
deterministic).

Counterpart of ``repro.data.pipeline``: the same keys, shapes, dtypes and
distributions, built directly on the given device from a
``torch.Generator`` seeded from ``(seed, step)``. The numbers differ from
``jax.random``'s for the same seed and step; tests that compare the two
packages hand the JAX package's batch across as numpy arrays.

Sampled training (``gnn_sampled_batch``) draws on the host: a uniform
random graph (``uniform_graph``; ``configs.gnn_family.shape_graph`` builds
it once per shape and seed), and per step the seeds and a
``NeighborSampler`` draw from numpy generators seeded from ``(seed,
step)``, so a step's subgraph is the reference sampler's for the same
graph and mixed seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph.sampler import NeighborSampler, SampledSubgraph

# Streams of the numpy generators, apart from the torch generators'
# streams 0 (a batch's tensors) and 1 (GraphCast's mesh).
GRAPH_STREAM, SEED_STREAM, SAMPLE_STREAM = 2, 3, 4


@dataclasses.dataclass
class DataCursor:
    """Checkpointable pipeline position."""
    seed: int
    step: int

    def seed_sequence(self, stream: int = 0) -> np.random.SeedSequence:
        """The ``SeedSequence`` of ``(seed, step, stream)``."""
        return np.random.SeedSequence([self.seed, self.step, stream])

    def mixed_seed(self, stream: int = 0) -> int:
        """One 64-bit seed mixed from ``(seed, step, stream)``."""
        return int(self.seed_sequence(stream).generate_state(1, np.uint64)[0])

    def generator(self, device: str | torch.device = "cuda",
                  stream: int = 0) -> torch.Generator:
        """A generator on ``device`` seeded from ``(seed, step)`` alone;
        each ``stream`` number gives an independent sequence."""
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(self.mixed_seed(stream))
        return gen


def _randint(gen, high: int, shape, low: int = 0):
    return torch.randint(low, high, shape, generator=gen, device=gen.device,
                         dtype=torch.int32)


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def lm_batch(cursor: DataCursor, batch: int, seq: int, vocab: int, *,
             device: str | torch.device = "cuda"):
    """Token/label pair: int32 tokens [batch, seq] uniform in ``[0,
    vocab)``; labels are the next-token shift, -1 (masked) in the last
    position."""
    gen = cursor.generator(device)
    toks = _randint(gen, vocab, (batch, seq))
    last = torch.full((batch, 1), -1, dtype=torch.int32, device=gen.device)
    return {"tokens": toks, "labels": torch.cat([toks[:, 1:], last], dim=1)}


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


def uniform_graph(n_nodes: int, n_edges: int, seed: int) -> NeighborSampler:
    """The in-neighbor CSR of ``n_edges`` edges whose int32 ends are drawn
    uniformly from ``[0, n_nodes)`` by a numpy generator seeded from
    ``DataCursor(seed, 0)``'s ``SeedSequence`` (``GRAPH_STREAM``)."""
    rng = np.random.default_rng(DataCursor(seed, 0).seed_sequence(GRAPH_STREAM))
    src = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    return NeighborSampler(src, dst, n_nodes)


def sample_subgraph(cursor: DataCursor, graph: NeighborSampler,
                    batch_nodes: int, fanouts: tuple[int, ...]
                    ) -> SampledSubgraph:
    """Step ``cursor``'s subgraph of ``graph``: ``batch_nodes`` distinct
    seeds drawn by a generator seeded with ``cursor.mixed_seed(SEED_STREAM)``,
    sampled by ``graph.reseeded(cursor.mixed_seed(SAMPLE_STREAM))``."""
    seeds = np.random.default_rng(cursor.mixed_seed(SEED_STREAM)).choice(
        graph.num_nodes, batch_nodes, replace=False).astype(np.int32)
    return graph.reseeded(cursor.mixed_seed(SAMPLE_STREAM)).sample(seeds,
                                                                  fanouts)


def gnn_sampled_batch(cursor: DataCursor, graph: NeighborSampler,
                      batch_nodes: int, fanouts: tuple[int, ...], d_out: int,
                      task: str, d_edge: int = 4, *,
                      device: str | torch.device = "cuda"):
    """One sampled-training batch: ``sample_subgraph``'s nodes, node_valid,
    src, dst (the sentinel ``n_local`` on invalid samples) and n_seeds on
    ``device``, random edge_feat, and labels (node_class) or targets of the
    seeds."""
    sub = sample_subgraph(cursor, graph, batch_nodes, fanouts)
    gen = cursor.generator(device)

    def put(a):
        return torch.from_numpy(a).to(gen.device)
    batch = {
        "nodes": put(sub.nodes), "node_valid": put(sub.node_valid),
        "src": put(sub.src), "dst": put(sub.dst),
        "edge_feat": _randn(gen, (sub.src.shape[0], d_edge)),
        "n_seeds": torch.tensor(sub.n_seeds, dtype=torch.int32,
                                device=gen.device),
    }
    if task == "node_class":
        batch["labels"] = _randint(gen, d_out, (batch_nodes,))
    else:
        batch["targets"] = _randn(gen, (batch_nodes, d_out))
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


def dien_batch(cursor: DataCursor, batch: int, seq: int, n_items: int,
               n_cats: int, *, device: str | torch.device = "cuda"):
    """Random behavior histories (all steps valid), targets and 0/1 labels."""
    gen = cursor.generator(device)
    return {
        "hist_items": _randint(gen, n_items, (batch, seq)),
        "hist_cats": _randint(gen, n_cats, (batch, seq)),
        "hist_mask": torch.ones((batch, seq), dtype=torch.bool,
                                device=gen.device),
        "target_item": _randint(gen, n_items, (batch,)),
        "target_cat": _randint(gen, n_cats, (batch,)),
        "label": _randint(gen, 2, (batch,)),
    }
