"""What decides ``correct``: a sample of the answers the timed path gave,
drawn from the seed, each compared with the plain reference bit for bit.

The sample keeps ``per_snapshot`` answers of every snapshot, each a
uniform draw (reservoir sampling) over the queries the run answered, so
the comparison covers every snapshot: the common graph's fixpoint, the
hop to each lane and the blocks the program derived for it. A kept
answer is copied to host memory (pinned, on a card) when it is drawn, so
the sample takes nothing of the card's memory; the comparison runs once
the window has closed and the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.reference import Reference

# The number compared, with its limit: an exact comparison.
LIMITS = {"value_mismatches": 0}


class Sample:
    """A seeded reservoir of ``per_snapshot`` answers per snapshot."""

    def __init__(self, seed: int, num_snapshots: int, per_snapshot: int,
                 num_nodes: int, device):
        self.rng = np.random.default_rng([seed, 2])
        self.per = per_snapshot
        self.snapshots = num_snapshots
        self.values = torch.empty(
            (num_snapshots * per_snapshot, num_nodes), dtype=torch.float32,
            pin_memory=torch.device(device).type == "cuda")
        self.sources: list = [None] * (num_snapshots * per_snapshot)
        self.offered = 0

    def offer(self, values, source: int) -> None:
        """Consider one query's answers, ``values[s]`` for snapshot ``s``."""
        k = self.offered
        self.offered += 1
        if k < self.per:
            picks = np.full(self.snapshots, k)
        else:
            picks = self.rng.integers(0, k + 1, size=self.snapshots)
        for s in np.flatnonzero(picks < self.per):
            slot = s * self.per + int(picks[s])
            self.values[slot].copy_(values[s])
            self.sources[slot] = int(source)


def compare(sample: Sample, inputs, device,
            dtype: torch.dtype = torch.float32) -> dict:
    """Each kept answer against the reference's (computed in ``dtype``):
    the vertices whose value differs bit for bit (``value_mismatches``),
    the answers that differ anywhere (``failed``) and the answers
    compared."""
    ref = Reference(inputs, device, dtype)
    mismatches = failed = compared = 0
    for s in range(sample.snapshots):
        slots = [j for j in range(s * sample.per, (s + 1) * sample.per)
                 if sample.sources[j] is not None]
        sources = [sample.sources[j] for j in slots]
        for slot, want in zip(slots, ref.answers(s, sources)):
            got = sample.values[slot].to(device)
            same = (got.view(torch.int32) == want.view(torch.int32))
            bad = int((~same).sum())
            mismatches += bad
            failed += bad > 0
            compared += 1
    return dict(value_mismatches=mismatches, failed=failed,
                compared=compared)
