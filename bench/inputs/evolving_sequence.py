"""Inputs of an evolving-sequence configuration, drawn on the device: an
R-MAT graph and its snapshot sequence by the protocol of
``repro_torch.graph.generators.make_evolving_sequence`` (per transition,
half the batch deletes a uniform sample of the present edges and half
adds uniform distinct edges absent from the current snapshot), with a
seeded ``torch.Generator`` in a few large calls instead of numpy on the
host (about 40 s at 2^24 edges). The keys are handed to the program as
host arrays, as the port's sequence holds them.

Configuration keys: ``num_nodes``, ``num_edges``, ``num_snapshots``,
``batch_changes``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.inputs import Inputs, on_device, read_only
from bench.inputs.draw import absent_keys, generator, rmat_keys
from bench.inputs.draw import edge_weights as device_weights
from bench.inputs.frozen import keys_to_edges, unique_keys


def evolving_keys(n: int, e: int, snapshots: int, changes: int,
                  gen: torch.Generator, device):
    """``(snapshot_keys, additions, deletions)``: lists of sorted int64
    key tensors on ``device``."""
    current = torch.sort(rmat_keys(n, e, gen, device)).values
    half = changes // 2
    snaps, adds, dels = [current], [], []
    for _ in range(snapshots - 1):
        gone = torch.randperm(current.numel(), generator=gen,
                              device=device)[:half]
        keep = torch.ones(current.numel(), dtype=torch.bool, device=device)
        keep[gone] = False
        added = absent_keys(n, half, current, gen, device)
        dels.append(torch.sort(current[gone]).values)
        adds.append(added)
        current = torch.sort(torch.cat([current[keep], added])).values
        snaps.append(current)
    return snaps, adds, dels


def common_graph_keys(snaps, dels) -> np.ndarray:
    """Keys in every snapshot: the first snapshot's keys that no
    transition deletes (additions only add absent keys, so a key deleted
    once is missing from the next snapshot)."""
    first = snaps[0]
    if not dels:
        return first
    gone = unique_keys(np.concatenate(dels))
    pos = np.searchsorted(first, gone)
    hit = pos < first.size
    pos, gone = pos[hit], gone[hit]
    keep = np.ones(first.size, dtype=bool)
    keep[pos[first[pos] == gone]] = False
    return first[keep]


def make(config: dict, seed: int, device) -> Inputs:
    n = int(config["num_nodes"])
    s = int(config["num_snapshots"])
    drawn = evolving_keys(n, int(config["num_edges"]), s,
                          int(config["batch_changes"]),
                          generator(seed, device), device)
    snaps, adds, dels = ([k.cpu().numpy() for k in part] for part in drawn)
    del drawn
    read_only(*snaps, *adds, *dels)
    cg = common_graph_keys(snaps, dels)
    delta_edges = sum(int(k.size) - int(cg.size) for k in snaps)
    min_bytes = 12 * (int(cg.size) + delta_edges) + 4 * n * s

    def snapshot_edges(i: int):
        # ``keys_to_edges`` and ``edge_weights`` on the run's device (the
        # weights bit for bit, ``draw.edge_weights``)
        keys = on_device(snaps[i], device)
        return [((keys // n).to(torch.int32), (keys % n).to(torch.int32),
                 device_weights(keys))]

    return Inputs(num_nodes=n, num_snapshots=s,
                  common_graph=keys_to_edges(cg, n),
                  min_query_bytes=min_bytes,
                  data=dict(snapshot_keys=snaps, additions=adds,
                            deletions=dels),
                  snapshot_edges=snapshot_edges)
