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
sweeps; inside a chunk nothing syncs. With ``fused_k=None`` (the default)
the engine sizes the chunks itself from the sweeps the fixpoint has run
(``_chunk_sweeps``); an integer ``fused_k`` fixes every chunk at that
many sweeps.

``edge_work`` is float32 and accumulated exactly as the reference does:
per-block counts summed in block order per sweep, then, with engine-sized
chunks, each sweep added to the running total in turn (the reference's
one-sweep loop); with a fixed ``fused_k``, sweeps summed within a chunk
and chunks added to the running total (the reference's fused loop). Seed
work is added last.
"""

# The reference's graphlint rules G008/G010 sanction relax_sweep and
# relax_sweep_fused calls by the dotted names repro.graph.engine and
# repro.graph.stability only, so they are off here; the port's own rules
# T008/T010 (repro_torch.analysis) hold this module's calls instead.
# graphlint: disable-file=G008,G010

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.graph.edgeset import EdgeBlock, EdgeView
from repro_torch.graph.semiring import Semiring
from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR
from repro_torch.kernels.edge_relax_multi.ops import relax_multi
from repro_torch.runtime import trace

INT_MAX = torch.iinfo(torch.int32).max
NO_PARENT = -1
# engine-sized chunks: the first chunk's sweeps, and the most a chunk
# takes; the lengths double in between (of first 2 or 4 and most 8, 16
# or 32, on an H100, 4 and 32 ran the benchmark's cells fastest or tied)
_FIRST_CHUNK = 4
_MOST_CHUNK = 32

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
    with trace.span("host.sync"):
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
    work: torch.Tensor | None = None,
):
    """Up to ``k`` frontier-masked sweeps as one fused chunk.

    A chunk runs sweeps until the frontier empties or ``min(k, allowed)``
    is reached (``allowed``: an int, or an int32 tensor with one entry per
    lane); nothing syncs with the host inside it. Runs the fused relax
    kernel (``kernels/edge_relax_multi``) on the state's device. Each
    sweep's work is added in turn to ``work`` (f32, one entry per lane;
    default zeros). Returns ``(values, parent, frontier, sweeps, work)``.
    """
    batched = values.dim() == 2
    if not batched:
        values, parent, frontier = (t.unsqueeze(0)
                                    for t in (values, parent, frontier))
        if work is not None:
            work = work.reshape(1)
    out = relax_multi(values, parent, frontier, [tuple(b) for b in blocks],
                      k if allowed is None else allowed,
                      op=KERNEL_OP_FOR[semiring.name], num_nodes=num_nodes,
                      k=k, track_parents=track_parents, work=work)
    if batched:
        return out
    return tuple(t[0] for t in out)


def _live_flags(lives: "list[torch.Tensor]") -> "list[bool]":
    """Whether each shard has a lane still running: ONE host read for all
    shards (a shard's flag is copied to the first shard's device first,
    a byte a shard in ``shard.copied_bytes``), so no shard's device
    waits for another's read."""
    if len(lives) == 1:
        return [bool(lives[0].any())]
    dev = lives[0].device
    trace.count("shard.copied_bytes", len(lives) - 1)
    return torch.stack([live.any().to(dev) for live in lives]).tolist()


def _chunk_sweeps(fused_k: int | None, launched: int, max_iters: int) -> int:
    """The next chunk's sweeps after ``launched`` in this fixpoint:
    ``fused_k``, or with ``None`` the engine's own length,
    ``_FIRST_CHUNK + launched`` (so each chunk doubles the last: 4, 8,
    16, 32, ...) up to ``_MOST_CHUNK``, and never past ``max_iters`` (a lane
    still running has run every sweep launched so far). A fixpoint of s
    sweeps then reads about log2(s) host flags, not s + 1."""
    if fused_k is not None:
        return fused_k
    return min(_FIRST_CHUNK + launched, _MOST_CHUNK, max_iters - launched)


def _fixpoint_shards(semiring: Semiring, num_nodes: int, max_iters: int,
                     shards, track_parents: bool = True,
                     fused_k: int | None = None) -> "list[FixpointResult]":
    """``_fixpoint`` over lane shards: ``shards`` is a sequence of
    ``(values, parent, frontier, blocks)``, each ``[S_d, N]`` with its
    blocks on its own device. Each round enqueues one fused chunk
    (``_chunk_sweeps``) on every shard that still has a running lane,
    then reads all shards' flags at once. A shard whose lanes have all
    stopped would run 0 sweeps and add +0.0 work, so it is skipped; every
    lane's values, parents, iterations and work equal an unsharded run's.

    Spans ``engine.fixpoint`` (the call), ``engine.launch`` (a round's
    enqueue, from one flag read to the next) and ``engine.flag_read``;
    while a recording is on, host counters ``engine.rounds`` (flag reads)
    and ``engine.launched_sweeps`` (each round's chunk length), in a
    call of more than one shard ``engine.shard_rounds`` (each round's
    shards, running or not) and ``engine.idle_shard_rounds`` (each
    round's shards skipped, all their lanes stopped while another shard
    ran) and, on the device,
    ``engine.sweeps`` (the call's most lane iterations),
    ``engine.active_edges`` (the chunks' work, summed over lanes) and
    ``engine.attempted_edges`` (each lane's real edges times its
    iterations)."""
    with trace.span("engine.fixpoint"):
        rec = trace.active()
        states = []
        for values, parent, frontier, blocks in shards:
            lanes = values.shape[0]
            it = torch.zeros(lanes, dtype=torch.int32, device=values.device)
            work = torch.zeros(lanes, dtype=torch.float32,
                               device=values.device)
            states.append([values, parent, frontier, it, work, tuple(blocks)])
        real = [_real_edges(s[5], num_nodes) for s in states] if rec \
            else None
        flags = _read_flags([s[2].any(1) & (s[3] < max_iters)
                             for s in states])
        launched = 0
        while any(flags):
            k = _chunk_sweeps(fused_k, launched, max_iters)
            with trace.span("engine.launch"):
                for state, running in zip(states, flags):
                    if not running:
                        continue
                    values, parent, frontier, it, work, blocks = state
                    cap = torch.clamp(max_iters - it, max=k)
                    # engine-sized chunks add each sweep to the lanes'
                    # totals in turn; a fixed fused_k sums a chunk first
                    total = work if fused_k is None else None
                    values, parent, frontier, sweeps, dw = relax_sweep_fused(
                        semiring, num_nodes, values, parent, frontier,
                        blocks, k=k, allowed=cap,
                        track_parents=track_parents, work=total)
                    # lanes that did not run add 0 sweeps and +0.0 work
                    state[:5] = (values, parent, frontier, it + sweeps,
                                 dw if total is not None else work + dw)
                lives = [s[2].any(1) & (s[3] < max_iters) for s in states]
            launched += k
            trace.count("engine.launched_sweeps", k)
            if len(flags) > 1:
                trace.count("engine.shard_rounds", len(flags))
                idle = len(flags) - sum(flags)
                if idle:
                    trace.count("engine.idle_shard_rounds", idle)
            flags = _read_flags(lives)
            del lives   # freed before the next round, as the peak expects
        if rec:
            dev = states[0][0].device
            most = [s[3].max() for s in states]
            if len(most) > 1:
                trace.count("shard.copied_bytes", 4 * (len(most) - 1))
            trace.add("engine.sweeps", most[0] if len(most) == 1 else
                      torch.stack([m.to(dev) for m in most]).max())
            for state, r in zip(states, real):
                trace.add("engine.active_edges", state[4])
                trace.add("engine.attempted_edges", r * state[3])
    return [FixpointResult(s[0], s[1], s[3], s[4]) for s in states]


def _read_flags(lives: "list[torch.Tensor]") -> "list[bool]":
    """``_live_flags`` in its span, counted as one round."""
    with trace.span("engine.flag_read"):
        flags = _live_flags(lives)
    trace.count("engine.rounds")
    return flags


# each block's real-edge count, reckoned once and kept while the block
# lives (blocks are never written after they are made, and the store and
# the cells reuse theirs query after query): ``dst`` -> (num_nodes, count)
_REAL_EDGES = WeakIdKeyDictionary()


def _real_edges(blocks: Blocks, num_nodes: int):
    """The real edges (``dst < num_nodes``) a sweep over ``blocks`` meets
    on each lane: the shared blocks' count plus, where stacked blocks
    are, each lane's row count (int64 on the blocks' device, a scalar or
    ``[S]``; never read on the host)."""
    counts = []
    for _, dst, _ in blocks:
        got = _REAL_EDGES.get(dst)
        if got is None or got[0] != num_nodes:
            got = _REAL_EDGES[dst] = (
                num_nodes, (dst < num_nodes).sum(-1, dtype=torch.int64))
        counts.append(got[1])
    return sum(counts[1:], counts[0]) if counts else 0


def _fixpoint(semiring: Semiring, num_nodes: int, max_iters: int,
              values, parent, frontier, blocks: Blocks,
              track_parents: bool = True,
              fused_k: int | None = None) -> FixpointResult:
    """Run fused chunks until every lane's frontier is empty or has
    reached ``max_iters``; one host read per chunk decides whether to go
    on. Each chunk's cap ``min(k, max_iters - it)`` never overruns
    ``max_iters``, so iterations and work equal the unfused loop's."""
    batched = values.dim() == 2
    if not batched:
        values, parent, frontier = (t.unsqueeze(0)
                                    for t in (values, parent, frontier))
    res, = _fixpoint_shards(semiring, num_nodes, max_iters,
                            [(values, parent, frontier, blocks)],
                            track_parents, fused_k)
    if batched:
        return res
    return FixpointResult(res.values[0], res.parent[0], res.iterations[0],
                          res.edge_work[0])


def run_to_fixpoint(
    view: EdgeView,
    semiring: Semiring,
    source: int,
    max_iters: int = 10_000,
    values: torch.Tensor | None = None,
    parent: torch.Tensor | None = None,
    frontier: torch.Tensor | None = None,
    track_parents: bool = True,
    fused_k: int | None = None,
) -> FixpointResult:
    """Run the query to fixpoint on ``view`` (from scratch or a warm state),
    on the view's device.

    ``fused_k`` sets the sweeps per host check: ``None`` lets the engine
    size its chunks, an integer fixes them — a pure launch-shape knob,
    bit-identical results at any value.
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
    fused_k: int | None = None,
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
    Span ``hop.lane_gather``.
    """
    with trace.span("hop.lane_gather"):
        idx = torch.as_tensor(np.asarray(lane_to_parent, dtype=np.int64),
                              device=values.device)
        return values[idx], parent[idx]


class LaneShard(NamedTuple):
    """One device's contiguous slice of a batched launch's lane axis
    (``core/trigrid.py`` ``_shard_snapshot_axis``): its state rows, its
    rows of every stacked Δ group, its lane mask and, once the executor
    has placed them, the launch's shared blocks on its device."""

    values: torch.Tensor          # [S_d, N] on the shard's device
    parent: torch.Tensor          # [S_d, N]
    delta_blocks: Blocks          # each [S_d, E]
    lane_valid: torch.Tensor      # [S_d] bool; False = padding lane
    shared_blocks: Blocks = ()    # broadcast blocks on the shard's device


class ShardedResult(NamedTuple):
    """A lane-sharded launch's results left where they were made: one
    :class:`FixpointResult` per shard (``[S_d, N]`` values and parents,
    ``[S_d]`` iterations, work and unstable counts) on that shard's
    device, shards in lane order. Nothing is gathered."""

    shards: "tuple[FixpointResult, ...]"

    def rows(self) -> "list[torch.Tensor]":
        """Every lane's ``[N]`` values, in lane order, each on its
        shard's device."""
        return [row for r in self.shards for row in r.values.unbind(0)]


def _resident_shards(semiring, num_nodes, max_iters, shards,
                     track_parents, seed, fused_k) -> ShardedResult:
    """Seed and run lane shards, each ``(values, parent, blocks,
    seed_blocks, lane_valid)`` on its own device, and leave each shard's
    result there: its iterations count the seed sweep, its work adds the
    seed's, and its padding lanes' (``lane_valid`` False) iterations,
    work and unstable counts are zeroed."""
    from repro_torch.graph.stability import seed_state
    with trace.span("engine.seed"):
        seeded = [seed_state(semiring, num_nodes, values, parent, seeds,
                             mode=seed, track_parents=track_parents)
                  for values, parent, _, seeds, _ in shards]
    runs = _fixpoint_shards(
        semiring, num_nodes, max_iters,
        [(sd.values, sd.parent, sd.frontier, blocks)
         for sd, (_, _, blocks, _, _) in zip(seeded, shards)],
        track_parents, fused_k)
    out = []
    for (*_, lane_valid), sd, run in zip(shards, seeded, runs):
        iterations = run.iterations + 1
        work = run.edge_work + sd.seed_work
        unstable = sd.unstable
        if lane_valid is not None:
            iterations = torch.where(lane_valid, iterations, 0)
            work = torch.where(lane_valid, work, 0.0)
            unstable = torch.where(lane_valid, unstable, 0)
        out.append(FixpointResult(run.values, run.parent, iterations, work,
                                  unstable))
    return ShardedResult(tuple(out))


def _incremental_shards(semiring, num_nodes, max_iters, shards,
                        track_parents, seed, fused_k) -> FixpointResult:
    """:func:`_resident_shards`, gathered in lane order onto the first
    shard's device."""
    parts = _resident_shards(semiring, num_nodes, max_iters, shards,
                             track_parents, seed, fused_k).shards
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].values.device
    with trace.span("shard.gather"):
        return FixpointResult(*(torch.cat([t.to(dev) for t in field])
                                for field in zip(*parts)))


def _lane_shards(shards: "Sequence[LaneShard]"):
    """:class:`LaneShard` s as the engine runs them: each relaxes its
    shared and Δ blocks and seeds from its last Δ group."""
    return [(s.values, s.parent,
             tuple(s.shared_blocks) + tuple(s.delta_blocks),
             (s.delta_blocks[-1],), s.lane_valid) for s in shards]


def batched_incremental(semiring, num_nodes, max_iters,
                        values, parent, shared_blocks, delta_blocks,
                        track_parents=True, seed_blocks=None,
                        lane_valid=None, seed="instability", fused_k=None):
    """Incremental additions on every lane at once.

    values/parent: [S, N]; shared_blocks: tuple of EdgeBlock (broadcast);
    delta_blocks: tuple of EdgeBlock with leading S axis (stacked).
    ``seed_blocks`` (stacked like delta_blocks, default: all of them) are
    the blocks the frontier is seeded from. ``seed`` selects the seeding
    mode (graph/stability.py). ``lane_valid`` ([S] bool, default all
    valid) marks padding lanes; their ``iterations``/``edge_work``/
    ``unstable`` are zeroed.
    """
    seeds = delta_blocks if seed_blocks is None else seed_blocks
    return _incremental_shards(
        semiring, num_nodes, max_iters,
        [(values, parent, tuple(shared_blocks) + tuple(delta_blocks),
          tuple(seeds), lane_valid)], track_parents, seed, fused_k)


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
    fused_k: int | None = None,
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


def incremental_additions_sharded(
    num_nodes: int,
    semiring: Semiring,
    shards: "Sequence[LaneShard]",
    max_iters: int = 10_000,
    track_parents: bool = True,
    seed: str = "instability",
    fused_k: int | None = None,
) -> FixpointResult:
    """:func:`incremental_additions_batched` with its lane axis split over
    devices: each :class:`LaneShard` relaxes its shared and Δ blocks and
    seeds its frontier from its last Δ group (the executors' hop Δ). Every
    shard is seeded, then each chunk runs on every shard before one host
    read of all shards' flags; the shards are gathered in lane order onto
    the first shard's device. Each lane equals the unsharded launch's bit
    for bit (values, parents, iterations, work, unstable): they are
    per-lane quantities, so the split cannot change them.
    """
    return _incremental_shards(semiring, num_nodes, max_iters,
                               _lane_shards(shards), track_parents, seed,
                               fused_k)


def incremental_additions_resident(
    num_nodes: int,
    semiring: Semiring,
    shards: "Sequence[LaneShard]",
    max_iters: int = 10_000,
    track_parents: bool = True,
    seed: str = "instability",
    fused_k: int | None = None,
) -> ShardedResult:
    """:func:`incremental_additions_sharded` without the gather: each
    shard's lanes are seeded and run on its device, as there, and stay
    there (a :class:`ShardedResult`). Each lane equals the gathered
    launch's lane bit for bit (values, parents, iterations, work,
    unstable); padding lanes' iterations, work and unstable counts are
    zeroed on their shard."""
    return _resident_shards(semiring, num_nodes, max_iters,
                            _lane_shards(shards), track_parents, seed,
                            fused_k)
