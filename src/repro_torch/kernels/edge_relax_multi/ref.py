"""Plain PyTorch version of the fused k-sweep relax kernel, with a lane axis.

Mirrors ``repro.kernels.edge_relax_multi.ref.relax_multi_ref`` applied to
every lane independently: up to ``min(k, allowed[lane])`` frontier-masked
sweeps with early exit on an empty frontier. A lane that stops keeps its
state and counts no more sweeps or work while the others run on. Each
sweep's work is the f32 sum, in block order, of each block's count of
active non-padding edges — the reference engine's grouping — and is
added to the lane's total one sweep at a time.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.edge_relax.ref import ops_for

INT_MAX = torch.iinfo(torch.int32).max


def lane_edges(blocks, lanes: int):
    """Concatenate ``blocks`` into per-lane edge arrays ``[lanes, E]``.

    Each block is ``(src, dst, w)`` of shape ``[E_b]`` (shared by every
    lane) or ``[lanes, E_b]`` (one row per lane). Returns ``(src, dst, w,
    block_id)`` with ``block_id`` ``[E]`` naming each column's block.
    """
    srcs, dsts, ws, ids = [], [], [], []
    for b, (src, dst, w) in enumerate(blocks):
        if src.dim() == 1:
            src, dst, w = (t.unsqueeze(0).expand(lanes, -1)
                           for t in (src, dst, w))
        srcs.append(src)
        dsts.append(dst)
        ws.append(w)
        ids.append(torch.full((src.shape[1],), b, dtype=torch.int64,
                              device=src.device))
    return (torch.cat(srcs, 1).long(), torch.cat(dsts, 1).long(),
            torch.cat(ws, 1), torch.cat(ids))


def _sweep(combine, is_min, ident, num_nodes, nblocks, values, parent,
           frontier, src, dst, w, block_id, track_parents):
    """One frontier-masked sweep on every lane: (values, parent, improved,
    work), work f32 [S] summed over blocks in block order."""
    lanes = values.shape[0]
    real = dst < num_nodes
    active = frontier.gather(1, src) & real
    cand = combine(values.gather(1, src), w)
    seg = torch.where(active, dst, num_nodes)      # inactive -> sentinel
    rows = torch.arange(lanes, device=values.device).unsqueeze(1)
    flat = (rows * (num_nodes + 1) + seg).reshape(-1)
    best = torch.full((lanes * (num_nodes + 1),), ident, dtype=torch.float32,
                      device=values.device)
    best.scatter_reduce_(0, flat, cand.reshape(-1),
                         reduce="amin" if is_min else "amax")
    best = best.view(lanes, num_nodes + 1)
    improved = (best[:, :num_nodes] < values) if is_min \
        else (best[:, :num_nodes] > values)
    new_values = (torch.minimum(values, best[:, :num_nodes]) if is_min
                  else torch.maximum(values, best[:, :num_nodes]))
    counts = torch.zeros(lanes, nblocks, dtype=torch.int64,
                         device=values.device)
    counts.scatter_add_(1, block_id.unsqueeze(0).expand(lanes, -1),
                        active.long())
    work = torch.zeros(lanes, dtype=torch.float32, device=values.device)
    for b in range(nblocks):
        work = work + counts[:, b].float()
    if not track_parents:
        return new_values, parent, improved, work
    is_win = active & (cand == best.gather(1, seg))
    winner = torch.full((lanes * (num_nodes + 1),), INT_MAX,
                        dtype=torch.int64, device=values.device)
    winner.scatter_reduce_(0, flat, torch.where(is_win, src, INT_MAX)
                           .reshape(-1), reduce="amin")
    winner = winner.view(lanes, num_nodes + 1)[:, :num_nodes].int()
    new_parent = torch.where(improved, winner, parent)
    return new_values, new_parent, improved, work


def relax_multi_ref(values, parent, frontier, blocks, allowed=None, *,
                    op: str, num_nodes: int, k: int,
                    track_parents: bool = True, work=None):
    """``min(k, allowed)`` sweeps per lane with early exit.

    values/parent/frontier ``[S, N]`` (f32/int32/bool); ``blocks`` as in
    :func:`lane_edges`; ``allowed`` an int or an int ``[S]`` tensor
    (default ``k``); ``work`` the lanes' f32 ``[S]`` totals each sweep
    adds to (default zeros). Returns new ``(values, parent, frontier,
    sweeps [S] int32, work [S] f32)``; the inputs are not modified.
    """
    combine, reduce_kind, ident = ops_for(op)
    is_min = reduce_kind == "min"
    lanes = values.shape[0]
    dev = values.device
    cap = torch.as_tensor(k if allowed is None else allowed,
                          dtype=torch.int32, device=dev)
    cap = torch.minimum(cap.expand(lanes), torch.tensor(k, dtype=torch.int32,
                                                        device=dev))
    src, dst, w, block_id = lane_edges(blocks, lanes)
    sweeps = torch.zeros(lanes, dtype=torch.int32, device=dev)
    work = (torch.zeros(lanes, dtype=torch.float32, device=dev)
            if work is None else work.clone())
    for s in range(k):
        run = (s < cap) & frontier.any(1)
        if not bool(run.any()):
            break
        vals, par, improved, dw = _sweep(
            combine, is_min, ident, num_nodes, len(blocks), values, parent,
            frontier, src, dst, w, block_id, track_parents)
        r = run.unsqueeze(1)
        values = torch.where(r, vals, values)
        parent = torch.where(r, par, parent)
        frontier = torch.where(r, improved, frontier)
        sweeps = sweeps + run.int()
        work = torch.where(run, work + dw, work)
    return values, parent, frontier, sweeps, work
