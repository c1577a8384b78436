"""Stable-vertex analysis: seed incremental sweeps from the instability set
(PyTorch port of ``repro.graph.stability``).

A Δ edge ``(u, v, w)`` destabilizes ``v`` iff ``combine(values[u], w)``
strictly beats ``values[v]``. Unreached sources are inert for all five
semirings (``combine(identity, w) == identity`` never strictly beats
anything), so masking the seed sweep to reached sources changes no value,
parent or improved set — only the frontier-masked seed work drops. Every
incremental launch's frontier seeding routes through :func:`seed_state`.
"""

# The reference's graphlint rules G008/G010 sanction relax_sweep calls by
# the dotted name repro.graph.stability only; this module is its port, and
# its own rule set is queued in ROADMAP.md §A11.
# graphlint: disable-file=G008,G010

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.semiring import Semiring

SEED_MODES = ("instability", "delta")


class SeededState(NamedTuple):
    """The stability analysis' verdict on one Δ batch against one state.

    ``values``/``parent`` are the anchor state with the Δ edges' direct
    improvements applied; ``frontier`` is the instability seed set;
    ``seed_work`` is the frontier-masked edge work the seed sweep spent;
    ``unstable`` is ``sum(frontier)`` as int32 (per lane when batched).
    """

    values: torch.Tensor    # float32 [N] or [S, N]
    parent: torch.Tensor    # int32
    frontier: torch.Tensor  # bool — the instability seed set
    seed_work: torch.Tensor  # float32 scalar or [S]
    unstable: torch.Tensor  # int32 scalar or [S] — |frontier|


def seed_mask(semiring: Semiring, values: torch.Tensor) -> torch.Tensor:
    """Reached-vertex mask: the sources whose Δ edges can destabilize
    (every vertex not at ``semiring.identity``)."""
    return values != semiring.identity


def seed_state(
    semiring: Semiring,
    num_nodes: int,
    values: torch.Tensor,
    parent: torch.Tensor,
    seed_blocks,
    *,
    mode: str = "instability",
    track_parents: bool = True,
) -> SeededState:
    """Seed an incremental launch from the stable-vertex analysis.

    Relaxes ``seed_blocks`` (the Δ edges) against the anchor state once,
    with the seed frontier chosen by ``mode``: ``"instability"`` masks to
    :func:`seed_mask`, ``"delta"`` uses the all-on frontier. Both modes
    give identical values/parents/frontier and differ only in
    ``seed_work``. ``values``/``parent`` may carry a lane axis ``[S, N]``
    with stacked seed blocks.
    """
    if mode not in SEED_MODES:
        raise ValueError(
            f"unknown seed mode {mode!r}: expected one of {SEED_MODES}")
    from repro_torch.graph.engine import relax_sweep
    if mode == "instability":
        frontier = seed_mask(semiring, values)
    else:
        frontier = torch.ones_like(values, dtype=torch.bool)
    new_values, new_parent, improved, seed_work = relax_sweep(
        semiring, num_nodes, values, parent, frontier, tuple(seed_blocks),
        track_parents=track_parents)
    return SeededState(new_values, new_parent, improved, seed_work,
                       improved.sum(-1, dtype=torch.int32))


def stable_fraction_milli(unstable, num_nodes: int, lane_valid=None) -> int:
    """Aggregate per-lane instability counts into a stable fraction (‰).

    ``unstable`` is one int count per lane (a scalar, a tensor, or any
    sequence of ints); ``lane_valid`` masks out padding lanes. Returns
    ``round(1000 * stable_vertex_lanes / total_vertex_lanes)`` as an int,
    0 when no valid lanes exist.
    """
    if isinstance(unstable, torch.Tensor):
        unstable = unstable.cpu().numpy()
    if isinstance(lane_valid, torch.Tensor):
        lane_valid = lane_valid.cpu().numpy()
    counts = np.asarray(unstable, dtype=np.int64).reshape(-1)
    if lane_valid is not None:
        counts = counts[np.asarray(lane_valid, dtype=bool).reshape(-1)]
    total = int(counts.size) * int(num_nodes)
    if total == 0:
        return 0
    return round(1000 * (total - int(counts.sum())) / total)
