"""Frozen copies of the port's key helpers and edge weights (numpy, host).

``edge_weights``, ``keys_to_edges`` and ``unique_keys`` are copies of
``repro_torch.graph.generators.edge_weights`` and of the
``repro_torch.graph.edgeset`` helpers, kept here so that a change to the
program cannot change the weights or the edge lists the reference reads.
``bench/tests`` holds them equal to the port's functions bit for bit.
"""

from __future__ import annotations

import numpy as np


def unique_keys(keys: np.ndarray) -> np.ndarray:
    """Sorted distinct values of a 1-D integer array, by one sort."""
    s = np.sort(keys)
    if s.size > 1:
        s = s[np.concatenate(([True], s[1:] != s[:-1]))]
    return s


def keys_to_edges(keys: np.ndarray,
                  num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """The int32 ``(src, dst)`` of keys ``src * num_nodes + dst``."""
    src = (keys // num_nodes).astype(np.int32)
    dst = (keys % num_nodes).astype(np.int32)
    return src, dst


def edge_weights(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    """Per-edge weight in (0.001, 1], a pure function of the edge key.

    The modulus promotes uint64 by int64 to float64, as the original
    does; ``bench.inputs.draw.edge_weights`` repeats that on the card.
    """
    mult = np.uint64(0x9E3779B97F4A7C15)
    h = (keys.astype(np.uint64) * mult + np.uint64(seed)) >> np.uint64(1)
    u = (h % np.int64(1 << 24)).astype(np.float64) / float(1 << 24)
    return (u * (1.0 - 1e-3) + 1e-3).astype(np.float32)
