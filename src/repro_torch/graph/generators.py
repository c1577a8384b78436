"""Evolving-graph generators (host-side, deterministic; numpy only, the
same arrays as ``repro.graph.generators`` from the same seeds).

The paper evaluates 50 snapshots, each separated by a batch of 75K edge
changes split evenly between additions and deletions. We reproduce that
protocol with R-MAT graphs sized to this container (DESIGN.md §7.4): an
:class:`EvolvingSequence` holds the initial edge set and, per transition,
the (additions, deletions) batches — from which core/ derives the
CommonGraph and Δ-batches.

The reference's ``np.unique``/``np.isin`` calls go through the sort-based
``unique_keys``/``isin_sorted`` (graph/edgeset.py), which return the same
arrays far faster under numpy 2.3.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.edgeset import (
    edge_keys,
    isin_sorted,
    keys_to_edges,
    merge_changes,
    unique_keys,
)


def rmat_edges(
    num_nodes: int,
    num_edges: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT power-law edge generator (Chakrabarti et al., SDM'04).

    ``num_nodes`` is rounded up to a power of two internally; emitted vertex
    ids are taken modulo ``num_nodes``. Duplicate edges and self-loops are
    removed, so the returned count may be slightly below ``num_edges``.
    """
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(num_nodes))))
    # Oversample: dedup + self-loop removal loses a few percent.
    n_draw = int(num_edges * 1.3) + 16
    src = np.zeros(n_draw, dtype=np.int64)
    dst = np.zeros(n_draw, dtype=np.int64)
    p_ab = a + b
    p_abc = a + b + c
    for _ in range(scale):
        r = rng.random(n_draw)
        right = r >= p_ab  # quadrant c or d -> src bit 1
        bottom = ((r >= a) & (r < p_ab)) | (r >= p_abc)  # b or d -> dst bit 1
        src = (src << 1) | right
        dst = (dst << 1) | bottom
    src %= num_nodes
    dst %= num_nodes
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = edge_keys(src, dst, num_nodes)
    keys = unique_keys(keys)
    rng.shuffle(keys)
    keys = keys[:num_edges]
    return keys_to_edges(keys, num_nodes)


def edge_weights(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deterministic per-edge weight in (0, 1], a pure function of the edge key.

    Weights must be stable across snapshots (an edge deleted and re-added
    keeps its weight), so they are hashed from the key, not drawn in sequence.
    """
    mult = np.uint64(0x9E3779B97F4A7C15)
    h = (keys.astype(np.uint64) * mult + np.uint64(seed)) >> np.uint64(1)
    u = (h % np.int64(1 << 24)).astype(np.float64) / float(1 << 24)
    return (u * (1.0 - 1e-3) + 1e-3).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class EvolvingSequence:
    """n snapshots over a fixed vertex set, as key-sets + change batches."""

    num_nodes: int
    snapshot_keys: tuple[np.ndarray, ...]       # sorted int64 keys per snapshot
    additions: tuple[np.ndarray, ...]           # keys added at transition i -> i+1
    deletions: tuple[np.ndarray, ...]           # keys deleted at transition i -> i+1
    weight_seed: int = 0

    @property
    def num_snapshots(self) -> int:
        return len(self.snapshot_keys)

    def weights_for(self, keys: np.ndarray) -> np.ndarray:
        return edge_weights(keys, self.weight_seed)


def make_evolving_sequence(
    num_nodes: int,
    num_edges: int,
    num_snapshots: int,
    batch_changes: int,
    seed: int = 0,
    weight_seed: int = 0,
) -> EvolvingSequence:
    """Paper protocol: per transition, batch_changes/2 adds + batch_changes/2 dels."""
    rng = np.random.default_rng(seed + 1)
    src, dst = rmat_edges(num_nodes, num_edges, seed=seed)
    keys = np.sort(edge_keys(src, dst, num_nodes))

    half = batch_changes // 2
    snaps = [keys]
    adds, dels = [], []
    current = keys
    for _ in range(num_snapshots - 1):
        # deletions: sample existing edges
        del_idx = rng.choice(current.shape[0], size=min(half, current.shape[0]),
                             replace=False)
        del_keys = np.sort(current[del_idx])
        # additions: sample fresh edges not currently present
        add_keys = np.empty(0, dtype=np.int64)
        while add_keys.shape[0] < half:
            s = rng.integers(0, num_nodes, size=2 * half)
            d = rng.integers(0, num_nodes, size=2 * half)
            ok = s != d
            cand = unique_keys(edge_keys(s[ok], d[ok], num_nodes))
            cand = cand[~isin_sorted(cand, current)]
            add_keys = unique_keys(np.concatenate([add_keys, cand]))
        add_keys = np.sort(rng.permutation(add_keys)[:half])
        nxt = merge_changes(current, add_keys, del_keys)
        snaps.append(nxt)
        adds.append(add_keys)
        dels.append(del_keys)
        current = nxt
    return EvolvingSequence(
        num_nodes=num_nodes,
        snapshot_keys=tuple(snaps),
        additions=tuple(adds),
        deletions=tuple(dels),
        weight_seed=weight_seed,
    )
