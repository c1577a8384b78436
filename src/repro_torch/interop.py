"""Carry data and state across from the JAX package as plain numpy arrays.

For the query engine data takes the place of weights: an evolving
sequence, an anchor query state or an edge block built by ``repro`` is
handed over as numpy arrays (``np.asarray`` of the JAX arrays) and rebuilt
here as the port's objects, so both packages compute on the same inputs.
GNN parameters cross the same way (``gnn_params_from_arrays``). Nothing
from ``repro`` is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.edgeset import EdgeBlock
from repro_torch.graph.engine import QueryState
from repro_torch.graph.generators import EvolvingSequence


def sequence_from_arrays(num_nodes: int, snapshot_keys, additions, deletions,
                         weight_seed: int = 0) -> EvolvingSequence:
    """An :class:`EvolvingSequence` from per-snapshot sorted int64 key
    arrays and per-transition addition/deletion key arrays."""
    def keys(arrays):
        return tuple(np.asarray(a, dtype=np.int64) for a in arrays)

    snaps, adds, dels = keys(snapshot_keys), keys(additions), keys(deletions)
    if len(adds) != len(snaps) - 1 or len(dels) != len(snaps) - 1:
        raise ValueError(f"{len(snaps)} snapshots need {len(snaps) - 1} "
                         f"change batches, got {len(adds)} additions and "
                         f"{len(dels)} deletions")
    return EvolvingSequence(num_nodes=int(num_nodes), snapshot_keys=snaps,
                            additions=adds, deletions=dels,
                            weight_seed=int(weight_seed))


def state_from_arrays(values, parent,
                      device: str | torch.device = "cuda") -> QueryState:
    """A :class:`QueryState` (float32 values, int32 parents) on ``device``;
    leading lane axes are kept."""
    return QueryState(
        torch.from_numpy(np.array(values, dtype=np.float32)).to(device),
        torch.from_numpy(np.array(parent, dtype=np.int32)).to(device))


def block_from_arrays(src, dst, w,
                      device: str | torch.device = "cuda") -> EdgeBlock:
    """An :class:`EdgeBlock` from already padded arrays (``[E]`` or stacked
    ``[lanes, E]``), copied as they are: no sorting or padding."""
    return EdgeBlock(torch.from_numpy(np.array(src, dtype=np.int32)).to(device),
                     torch.from_numpy(np.array(dst, dtype=np.int32)).to(device),
                     torch.from_numpy(np.array(w, dtype=np.float32)).to(device))


def gnn_params_from_arrays(tree, device: str | torch.device = "cuda"):
    """The port's GNN parameters from the JAX package's: a nested dict/list
    of arrays (``jax.tree.map(np.asarray, params)``) becomes the same tree
    of float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: gnn_params_from_arrays(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gnn_params_from_arrays(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
