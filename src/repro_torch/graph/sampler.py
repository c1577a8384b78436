"""Fanout neighbor sampler (GraphSAGE-style) for sampled-training shapes.

Counterpart of ``repro.graph.sampler``, copied as host numpy: for the same
graph, construction seed and sequence of ``sample`` calls it draws the
same subgraphs bit for bit. ``minibatch_lg`` (232,965 nodes / 114M edges /
batch_nodes=1,024 / fanout 15-10) needs it: the sampler builds an
in-neighbor CSR once, then per batch samples a fixed fanout per hop with
replacement (padding with sentinel edges when a vertex's in-degree is 0),
producing **fixed-shape** subgraph arrays, so every step's tensors have one
shape. ``reseeded`` gives a sampler that shares the CSR and draws from a
new generator, so a feeder can seed each step's draws on its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Fixed-shape k-hop sampled subgraph (host arrays, copied to the device
    by the data feeder).

    Layout: ``nodes[0:n_seeds]`` are the seeds; each hop appends its sampled
    frontier. Edges point hop-(k+1) -> hop-k (message direction), expressed in
    *local* indices into ``nodes``. Padded edges have ``local_dst == n_local``.
    """

    nodes: np.ndarray       # int32 [n_local] global ids (padded with 0)
    node_valid: np.ndarray  # bool  [n_local]
    src: np.ndarray         # int32 [n_edges] local ids
    dst: np.ndarray         # int32 [n_edges] local ids (== n_local for padding)
    n_seeds: int

    @property
    def n_local(self) -> int:
        return int(self.nodes.shape[0])


class NeighborSampler:
    def __init__(self, src: np.ndarray, dst: np.ndarray, num_nodes: int, seed: int = 0):
        # in-neighbor CSR: for each v, the list of u with (u -> v)
        order = np.argsort(dst, kind="stable")
        self._nbr = src[order].astype(np.int32)
        counts = np.bincount(dst, minlength=num_nodes)
        self._offsets = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=self._offsets[1:])
        self._num_nodes = num_nodes
        self._rng = np.random.default_rng(seed)

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def reseeded(self, seed: int) -> NeighborSampler:
        """A sampler on the same CSR (shared, not copied) whose draws are
        those of a new ``NeighborSampler`` built with ``seed``."""
        other = object.__new__(NeighborSampler)
        other._nbr, other._offsets = self._nbr, self._offsets
        other._num_nodes = self._num_nodes
        other._rng = np.random.default_rng(seed)
        return other

    def _sample_one_hop(self, frontier: np.ndarray, fanout: int):
        """Sample ``fanout`` in-neighbors per frontier vertex (fixed shape)."""
        deg = self._offsets[frontier + 1] - self._offsets[frontier]
        # uniform with replacement; degree-0 vertices yield padded edges
        r = self._rng.integers(0, np.maximum(deg, 1)[:, None],
                               size=(frontier.shape[0], fanout))
        idx = self._offsets[frontier][:, None] + r
        nbrs = self._nbr[np.minimum(idx, self._nbr.shape[0] - 1)]
        valid = (deg > 0)[:, None] & np.ones_like(r, bool)
        return nbrs.astype(np.int32), valid

    def sample(self, seeds: np.ndarray, fanouts: tuple[int, ...]) -> SampledSubgraph:
        seeds = np.asarray(seeds, dtype=np.int32)
        nodes = [seeds]
        valids = [np.ones(seeds.shape[0], bool)]
        srcs, dsts = [], []
        frontier = seeds
        frontier_valid = np.ones(seeds.shape[0], bool)
        base = 0
        for fanout in fanouts:
            nbrs, valid = self._sample_one_hop(frontier, fanout)
            flat_nbrs = nbrs.reshape(-1)
            # a sample is valid only if its parent frontier slot was valid
            flat_valid = valid.reshape(-1) & np.repeat(frontier_valid, fanout)
            new_base = base + frontier.shape[0]
            # local edges: sampled neighbor (at new_base + i) -> frontier vertex (at base + i//fanout)
            e_src = new_base + np.arange(flat_nbrs.shape[0], dtype=np.int32)
            e_dst = base + (np.arange(flat_nbrs.shape[0], dtype=np.int32) // fanout)
            srcs.append(e_src)
            dsts.append(np.where(flat_valid, e_dst, np.int32(-1)))
            nodes.append(np.where(flat_valid, flat_nbrs, 0).astype(np.int32))
            valids.append(flat_valid)
            frontier = flat_nbrs  # fixed shape: sample next hop from all slots
            frontier_valid = flat_valid
            base = new_base
        nodes_arr = np.concatenate(nodes)
        valid_arr = np.concatenate(valids)
        n_local = nodes_arr.shape[0]
        src_arr = np.concatenate(srcs)
        dst_arr = np.concatenate(dsts)
        dst_arr = np.where(dst_arr < 0, n_local, dst_arr).astype(np.int32)
        return SampledSubgraph(
            nodes=nodes_arr, node_valid=valid_arr,
            src=src_arr.astype(np.int32), dst=dst_arr, n_seeds=seeds.shape[0],
        )


def subgraph_shapes(n_seeds: int, fanouts: tuple[int, ...]) -> tuple[int, int]:
    """(n_local_nodes, n_edges) for the fixed-shape sampled subgraph."""
    n_local, n_edges, frontier = n_seeds, 0, n_seeds
    for f in fanouts:
        n_edges += frontier * f
        frontier *= f
        n_local += frontier
    return n_local, n_edges
