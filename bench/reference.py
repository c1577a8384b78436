"""The plain reference: a query's answer on one snapshot, worked out again
from that snapshot's own edge list.

Frontier Bellman-Ford for single-source shortest paths in plain PyTorch
(gathers and ``scatter_reduce_``), one sweep at a time until no vertex
improves. It imports nothing of the program. Every combine is one IEEE
addition in the stated precision and every reduce is a min, which is
exact, so the answer is the least fixpoint on that snapshot, the same
value for value as any correct evaluation order; the harness compares the
program's answers with it bit for bit.

``dtype`` below float32 (the control, bfloat16) rounds each weight and
each sum to that precision, in the program's place.
"""

from __future__ import annotations

import math

import torch

from bench.inputs import on_device


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def solve(parts, num_nodes: int, sources,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Shortest-path distances from each of ``sources`` over the edges
    ``parts`` (a list of ``(src, dst, w)`` tensors on one device, int32,
    int32, float32): float32 ``[len(sources), num_nodes]``, infinity
    where a source does not reach. The sources share each sweep's pass
    over the edges; each row is its own fixpoint."""
    dev = parts[0][0].device
    rows = torch.arange(len(sources), device=dev)
    at = torch.as_tensor(list(sources), dtype=torch.int64, device=dev)
    values = torch.full((len(sources), num_nodes), math.inf,
                        dtype=torch.float32, device=dev)
    values[rows, at] = 0.0
    frontier = torch.zeros(values.shape, dtype=torch.bool, device=dev)
    frontier[rows, at] = True
    weights = [_round(w, dtype) for _, _, w in parts]
    while True:
        new = values.clone()
        for (src, dst, _), w in zip(parts, weights):
            row, e = frontier[:, src].nonzero(as_tuple=True)
            if e.numel() == 0:
                continue
            cand = _round(values[row, src[e]] + w[e], dtype)
            new.view(-1).scatter_reduce_(
                0, row * num_nodes + dst[e].long(), cand, reduce="amin")
        frontier = new < values
        values = new
        if not bool(frontier.any()):
            return values


class Reference:
    """The reference over one run's inputs: each snapshot's own edge list
    (``Inputs.snapshot_edges``) placed on ``device``; a part shared with
    the previous snapshot (the same array) is placed once."""

    def __init__(self, inputs, device, dtype: torch.dtype = torch.float32):
        self.inputs = inputs
        self.device = device
        self.dtype = dtype
        self._placed: dict[int, tuple] = {}

    def answers(self, snapshot: int, sources):
        """The answers on ``snapshot`` from each of ``sources``, in order,
        worked out together."""
        host = self.inputs.snapshot_edges(snapshot)
        placed = {}
        for part in host:
            key = id(part[0])
            placed[key] = self._placed.get(key) or (part, tuple(
                on_device(a, self.device) for a in part))
        self._placed = placed
        parts = [placed[id(p[0])][1] for p in host]
        yield from solve(parts, self.inputs.num_nodes, sources, self.dtype)
