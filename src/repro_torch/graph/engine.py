"""Frontier-masked edge-relaxation fixpoint engine (PyTorch port of
``repro.graph.engine``).

One *sweep* is a dense Bellman-Ford-style round over an edge view:

    cand[e]  = combine(values[src[e]], w[e])        (masked to the frontier)
    best[v]  = reduce(cand, dst)                    (min or max semiring)
    values'  = meet(values, best);  frontier' = strictly-improved vertices

``parent[v]`` tracks the smallest src among edges achieving the best — the
dependence edge the KickStarter trimming baseline (core/kickstarter.py)
consumes on deletions.

Every sweep runs through the fused relax kernel
(``kernels/edge_relax_multi``): on CUDA tensors the hand-written kernel,
on CPU tensors its plain version. State carries an explicit lane axis where
the reference vmaps: ``[S, N]`` values with shared blocks ``[E]`` and
stacked per-lane Δ blocks ``[S, E]``. A lane whose frontier empties, or
which reaches ``max_iters``, stops changing state and stops counting
iterations and work while the others run on — the reference's vmapped
``while_loop`` semantics. ``_fixpoint`` reads one host flag per chunk of
``fused_k`` sweeps; inside a chunk nothing syncs.

``edge_work`` is float32 and accumulated exactly as the reference does:
per-block counts summed in block order per sweep, sweeps summed within a
chunk, chunks added to the running total, seed work added last.
"""

# The reference's graphlint rules G008/G010 sanction relax_sweep and
# relax_sweep_fused calls by the dotted names repro.graph.engine and
# repro.graph.stability only; this module is their port, and its own rule
# set is queued in ROADMAP.md §A9.
# graphlint: disable-file=G008,G010

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graph.edgeset import EdgeBlock, EdgeView
from repro_torch.graph.semiring import Semiring
from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR
from repro_torch.kernels.edge_relax_multi.ops import relax_multi

INT_MAX = torch.iinfo(torch.int32).max
NO_PARENT = -1

Blocks = tuple[EdgeBlock, ...]


class FixpointResult(NamedTuple):
    """Final state of a fixpoint run plus its iteration/work accounting."""

    values: torch.Tensor      # float32 [N] (or [S, N] batched)
    parent: torch.Tensor      # int32 [N], -1 = none/source
    iterations: torch.Tensor  # int32 scalar (or [S]) — sweeps executed
    edge_work: torch.Tensor   # float32 scalar (or [S]) — frontier-masked relaxations
    # int32 scalar (per-lane when batched): |instability seed set| from the
    # stability analysis (graph/stability.py), None for from-scratch runs.
    unstable: torch.Tensor | None = None


class QueryState(NamedTuple):
    """A converged query state detached from its run statistics.

    The cross-launch unit of reuse: a ``(values, parent)`` pair that can be
    cached (SnapshotStore's anchor family), re-seeded into a later
    incremental launch, or broadcast into batched lanes via
    :func:`gather_lane_states`. :attr:`nbytes` is what the store's LRU
    charges for it.
    """

    values: torch.Tensor      # float32 [N]
    parent: torch.Tensor      # int32 [N]

    @property
    def nbytes(self) -> int:
        """Device footprint the store's LRU accounts for this state."""
        return sum(a.numel() * a.element_size() for a in self)


def extract_state(res: FixpointResult) -> QueryState:
    """Detach the reusable (values, parent) state from a fixpoint result."""
    return QueryState(res.values, res.parent)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)


def host_sync(x):
    """Wait until the device work producing ``x`` (a tensor or a tuple/list
    of them) has finished, returning ``x`` — THE sanctioned host-sync point
    for wall-clock timing (``torch.cuda.synchronize`` on each CUDA device
    involved; a no-op for CPU tensors)."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


def init_values(num_nodes: int, semiring: Semiring, source: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Fresh value vector: identity everywhere, source_value at source."""
    values = torch.full((num_nodes,), semiring.identity, dtype=torch.float32,
                        device=device)
    values[source] = semiring.source_value
    return values


def relax_sweep(
    semiring: Semiring,
    num_nodes: int,
    values: torch.Tensor,
    parent: torch.Tensor,
    frontier: torch.Tensor,
    blocks: Blocks,
    track_parents: bool = True,
):
    """One frontier-masked relaxation sweep over all blocks.

    ``values``/``parent``/``frontier`` are ``[N]`` or ``[S, N]``. The
    parent is the smallest src among active edges whose candidate equals
    the global best. The reference's ``gated`` block skip has no
    counterpart: the kernel skips inactive edges one by one, which a
    whole-block gate could only repeat. Returns (values, parent, improved,
    work).
    """
    values, parent, improved, _, work = relax_sweep_fused(
        semiring, num_nodes, values, parent, frontier, blocks, k=1,
        track_parents=track_parents)
    return values, parent, improved, work


def relax_sweep_fused(
    semiring: Semiring,
    num_nodes: int,
    values: torch.Tensor,
    parent: torch.Tensor,
    frontier: torch.Tensor,
    blocks: Blocks,
    k: int = 1,
    allowed: torch.Tensor | int | None = None,
    track_parents: bool = True,
):
    """Up to ``k`` frontier-masked sweeps as one fused chunk.

    A chunk runs sweeps until the frontier empties or ``min(k, allowed)``
    is reached (``allowed``: an int, or an int32 tensor with one entry per
    lane); nothing syncs with the host inside it. Runs the fused relax
    kernel (``kernels/edge_relax_multi``) on the state's device. Returns
    ``(values, parent, frontier, sweeps, work)``.
    """
    batched = values.dim() == 2
    if not batched:
        values, parent, frontier = (t.unsqueeze(0)
                                    for t in (values, parent, frontier))
    out = relax_multi(values, parent, frontier, [tuple(b) for b in blocks],
                      k if allowed is None else allowed,
                      op=KERNEL_OP_FOR[semiring.name], num_nodes=num_nodes,
                      k=k, track_parents=track_parents)
    if batched:
        return out
    return tuple(t[0] for t in out)


def _fixpoint(semiring: Semiring, num_nodes: int, max_iters: int,
              values, parent, frontier, blocks: Blocks,
              track_parents: bool = True, fused_k: int = 1) -> FixpointResult:
    """Run fused chunks until every lane's frontier is empty or has
    reached ``max_iters``; one host read per chunk decides whether to go
    on. Each chunk's cap ``min(fused_k, max_iters - it)`` never overruns
    ``max_iters``, so iterations and work equal the unfused loop's."""
    batched = values.dim() == 2
    if not batched:
        values, parent, frontier = (t.unsqueeze(0)
                                    for t in (values, parent, frontier))
    lanes = values.shape[0]
    it = torch.zeros(lanes, dtype=torch.int32, device=values.device)
    work = torch.zeros(lanes, dtype=torch.float32, device=values.device)
    live = frontier.any(1) & (it < max_iters)
    while bool(live.any()):
        cap = torch.clamp(max_iters - it, max=fused_k)
        values, parent, frontier, sweeps, dw = relax_sweep_fused(
            semiring, num_nodes, values, parent, frontier, blocks, k=fused_k,
            allowed=cap, track_parents=track_parents)
        # lanes that did not run add 0 sweeps and +0.0 work: unchanged
        it = it + sweeps
        work = work + dw
        live = frontier.any(1) & (it < max_iters)
    if batched:
        return FixpointResult(values, parent, it, work)
    return FixpointResult(values[0], parent[0], it[0], work[0])


def run_to_fixpoint(
    view: EdgeView,
    semiring: Semiring,
    source: int,
    max_iters: int = 10_000,
    values: torch.Tensor | None = None,
    parent: torch.Tensor | None = None,
    frontier: torch.Tensor | None = None,
    track_parents: bool = True,
    fused_k: int = 1,
) -> FixpointResult:
    """Run the query to fixpoint on ``view`` (from scratch or a warm state),
    on the view's device.

    ``fused_k`` > 1 makes the fixpoint consume fused chunks of up to that
    many sweeps per host check — a pure launch-shape knob, bit-identical
    results at any value.
    """
    n = view.num_nodes
    dev = view.device
    fresh = values is None
    if fresh:
        values = init_values(n, semiring, source, device=dev)
    if parent is None:
        parent = torch.full((n,), NO_PARENT, dtype=torch.int32, device=dev)
    if frontier is None:
        # Fresh start: only the source can seed improvements. Warm start with
        # an unknown perturbation: every vertex may need to re-propagate.
        if fresh:
            frontier = torch.zeros((n,), dtype=torch.bool, device=dev)
            frontier[source] = True
        else:
            frontier = torch.ones((n,), dtype=torch.bool, device=dev)
    return _fixpoint(semiring, n, max_iters, values, parent, frontier,
                     tuple(view.blocks), track_parents, fused_k)


def incremental_additions(
    view: EdgeView,
    added: EdgeView | EdgeBlock,
    semiring: Semiring,
    values: torch.Tensor,
    parent: torch.Tensor,
    max_iters: int = 10_000,
    track_parents: bool = True,
    seed: str = "instability",
    fused_k: int = 1,
) -> FixpointResult:
    """Addition-only incremental update (the cheap KickStarter direction).

    ``view`` must already include the added blocks; ``added`` is just the new
    edges. Seeds the frontier from the stable-vertex analysis
    (graph/stability.py); ``seed="delta"`` keeps full-Δ seeding (identical
    values/parents, more seed work).
    """
    from repro_torch.graph.stability import seed_state
    n = view.num_nodes
    add_blocks = (added,) if isinstance(added, EdgeBlock) else tuple(added.blocks)
    seeded = seed_state(semiring, n, values, parent, add_blocks,
                        mode=seed, track_parents=track_parents)
    res = _fixpoint(semiring, n, max_iters, seeded.values, seeded.parent,
                    seeded.frontier, tuple(view.blocks), track_parents,
                    fused_k)
    return FixpointResult(res.values, res.parent, res.iterations + 1,
                          res.edge_work + seeded.seed_work, seeded.unstable)


# ---------------------------------------------------------------------------
# Batched (snapshot-axis) execution: one lane per snapshot. Shared blocks
# broadcast; per-snapshot Δ blocks are stacked on axis 0.
# ---------------------------------------------------------------------------

def gather_lane_states(values: torch.Tensor, parent: torch.Tensor,
                       lane_to_parent) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather per-lane warm-start states for a batched launch.

    ``values``/``parent`` are the previous level's stacked states
    ``[P, N]``; ``lane_to_parent[l]`` names the parent lane whose state
    seeds lane ``l``. One device gather keeps the states on the device.
    """
    idx = torch.as_tensor(np.asarray(lane_to_parent, dtype=np.int64),
                          device=values.device)
    return values[idx], parent[idx]


def batched_incremental(semiring, num_nodes, max_iters,
                        values, parent, shared_blocks, delta_blocks,
                        track_parents=True, seed_blocks=None,
                        lane_valid=None, seed="instability", fused_k=1):
    """Incremental additions on every lane at once.

    values/parent: [S, N]; shared_blocks: tuple of EdgeBlock (broadcast);
    delta_blocks: tuple of EdgeBlock with leading S axis (stacked).
    ``seed_blocks`` (stacked like delta_blocks, default: all of them) are
    the blocks the frontier is seeded from. ``seed`` selects the seeding
    mode (graph/stability.py). ``lane_valid`` ([S] bool, default all
    valid) marks padding lanes; their ``iterations``/``edge_work``/
    ``unstable`` are zeroed.
    """
    from repro_torch.graph.stability import seed_state
    seeds = delta_blocks if seed_blocks is None else seed_blocks
    seeded = seed_state(semiring, num_nodes, values, parent, seeds,
                        mode=seed, track_parents=track_parents)
    res = _fixpoint(semiring, num_nodes, max_iters, seeded.values,
                    seeded.parent, seeded.frontier,
                    tuple(shared_blocks) + tuple(delta_blocks),
                    track_parents=track_parents, fused_k=fused_k)
    res = FixpointResult(res.values, res.parent, res.iterations + 1,
                         res.edge_work + seeded.seed_work, seeded.unstable)
    if lane_valid is None:
        return res
    return FixpointResult(
        res.values, res.parent,
        torch.where(lane_valid, res.iterations, 0),
        torch.where(lane_valid, res.edge_work, 0.0),
        torch.where(lane_valid, res.unstable, 0))


def incremental_additions_batched(
    num_nodes: int,
    semiring: Semiring,
    values: torch.Tensor,          # [S, N]
    parent: torch.Tensor,          # [S, N]
    shared_blocks: Blocks,         # broadcast to all snapshots
    delta_blocks: Blocks,          # each with leading [S] axis
    max_iters: int = 10_000,
    track_parents: bool = True,
    seed_blocks: Blocks | None = None,
    lane_valid: torch.Tensor | None = None,  # [S] bool; False = padding lane
    seed: str = "instability",
    fused_k: int = 1,
) -> FixpointResult:
    """Batched addition-only updates, one lane per Δ (see batched_incremental).

    Bit-identical per lane to :func:`incremental_additions`; ``fused_k``
    sets the sweeps-per-host-check chunk size, a pure launch-shape knob.
    """
    return batched_incremental(semiring, num_nodes, max_iters,
                               values, parent, tuple(shared_blocks),
                               tuple(delta_blocks), track_parents,
                               None if seed_blocks is None
                               else tuple(seed_blocks), lane_valid, seed,
                               fused_k)
