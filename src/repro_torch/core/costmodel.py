"""Measured-cost calibration for the Δ-volume planners (PyTorch port of
``repro.core.costmodel``; ``SweepCostModel`` is integer arithmetic copied
from the reference).

The campaign DP (core/window.py::optimal_campaigns) is an exact optimizer
over a *proxy* objective: raw added-edge counts, discounted by the
measured stable fraction (``stable_milli``). The proxy assumes a hop's
cost is proportional to its Δ volume with no per-launch price.
:class:`SweepCostModel` replaces it with an affine cost

    hop_cost(Δ)  =  per_edge_nanos · live(Δ)  +  per_sweep_nanos

fit from *measured* sweep timings (``evolve --calibrate``), where
``live(Δ) = Δ · (1000 − stable_milli) // 1000``. Both coefficients are
integers, so DP costs stay exact integer prices and "the calibrated plan
is never worse than the raw-count plan" holds as an exact comparison.

A sweep is timed on the host's clock, ``time.perf_counter_ns()`` around
one engine call that ends in :func:`host_sync`: the per-sweep price is
meant to include the launch and the host's convergence check, which
device-side events would leave out.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from repro_torch.graph.engine import host_sync, run_to_fixpoint


def _instability_volume(edges: int, stable_milli: int) -> int:
    """The planners' live-edge discount (see core/window.py)."""
    if not 0 <= stable_milli <= 1000:
        raise ValueError(f"stable_milli {stable_milli} outside [0, 1000]")
    return edges * (1000 - stable_milli) // 1000


@dataclasses.dataclass(frozen=True)
class SweepCostModel:
    """Affine measured cost of one incremental hop, in integer nanoseconds.

    ``per_edge_nanos`` is the marginal price of one live Δ edge through a
    frontier-masked sweep; ``per_sweep_nanos`` the fixed per-launch price
    (launch and convergence check); ``stable_milli`` the stable-vertex
    discount applied to hop volumes.
    """

    per_edge_nanos: int
    per_sweep_nanos: int
    stable_milli: int = 0

    def hop_cost(self, added_edges: int) -> int:
        """Price of an incremental hop streaming ``added_edges`` Δ edges."""
        live = _instability_volume(added_edges, self.stable_milli)
        return live * self.per_edge_nanos + self.per_sweep_nanos

    def anchor_cost(self, edges: int) -> int:
        """Price of a from-scratch anchor build over ``edges`` edges
        (undiscounted: a cold anchor has no stable incumbent state)."""
        return edges * self.per_edge_nanos + self.per_sweep_nanos

    @classmethod
    def fit(cls, samples: Sequence[tuple[int, int]], *,
            stable_milli: int = 0) -> "SweepCostModel":
        """Least-squares affine fit from ``(edges, nanos)`` measurements.

        Needs >= 2 samples at distinct edge scales for a full affine fit;
        with a degenerate spread it falls back to a pure per-edge model.
        Coefficients are rounded to integers, ``per_edge_nanos`` clamped to
        >= 1 so a hop's price always grows with its Δ volume.
        """
        if not samples:
            raise ValueError("SweepCostModel.fit needs at least one sample")
        xs = [float(e) for e, _ in samples]
        ys = [float(t) for _, t in samples]
        n = len(samples)
        mx = sum(xs) / n
        my = sum(ys) / n
        var = sum((x - mx) ** 2 for x in xs)
        if var == 0.0:
            per_edge = max(1, round(my / mx)) if mx else 1
            return cls(per_edge, 0, stable_milli)
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var
        per_edge = max(1, round(slope))
        per_sweep = max(0, round(my - slope * mx))
        return cls(per_edge, per_sweep, stable_milli)


def measure_sweep_nanos(view, semiring, source, *,
                        track_parents: bool = False,
                        fused_k: int | None = None,
                        repeats: int = 3) -> int:
    """Measured wall nanoseconds of ONE frontier-masked sweep over ``view``.

    Converges the query once (untimed), then times a warm all-on-frontier
    re-sweep capped at one iteration: a full pass over every edge that
    improves nothing, the per-sweep price the planners buy per unit of Δ
    volume. One untimed call first, then the best of ``repeats``, each
    ending in :func:`host_sync`.
    """
    base = run_to_fixpoint(view, semiring, source,
                           track_parents=track_parents, fused_k=fused_k)
    host_sync(base.values)

    def once() -> int:
        t0 = time.perf_counter_ns()
        res = run_to_fixpoint(view, semiring, source, 1, values=base.values,
                              parent=base.parent,
                              track_parents=track_parents, fused_k=fused_k)
        host_sync(res.values)
        return time.perf_counter_ns() - t0

    once()
    return min(once() for _ in range(repeats))


def calibrate(store, semiring, source, *, stable_milli: int = 0,
              track_parents: bool = False, fused_k: int | None = None,
              repeats: int = 3) -> SweepCostModel:
    """Fit a :class:`SweepCostModel` from two measured sweep scales.

    Times one sweep over the store's common graph T(0, last) and one over
    its first snapshot T(0, 0), two different edge scales on the views the
    executors launch. ``stable_milli`` (from a prior measured run, e.g. the
    warm-up stream in ``evolve --calibrate``) becomes the model's hop
    discount.
    """
    last = store.seq.num_snapshots - 1
    samples = []
    for (i, j) in [(0, last), (0, 0)]:
        edges = store.window_size(i, j)
        nanos = measure_sweep_nanos(
            store.common_graph_view(i, j), semiring, source,
            track_parents=track_parents, fused_k=fused_k, repeats=repeats)
        samples.append((edges, nanos))
    return SweepCostModel.fit(samples, stable_milli=stable_milli)
