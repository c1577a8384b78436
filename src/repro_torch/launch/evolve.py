"""The paper's driver on the PyTorch port: evolving-graph queries over a
snapshot sequence (counterpart of ``repro.launch.evolve``).

Runs the five execution modes on an R-MAT evolving sequence and reports
the Table-1-style comparison:

    PYTHONPATH=src python -m repro_torch.launch.evolve --nodes 20000 \
        --edges 200000 --snapshots 10 --changes 10000 --alg sssp --verify

Modes: ks (KickStarter streaming baseline), dh (CommonGraph Direct-Hop),
dhb (batched Direct-Hop — snapshot-parallel), ws (Triangular-Grid
work-sharing, DP-optimal plan), wsb (level-synchronous batched TG
executor). ``--verify`` checks every mode against a from-scratch fixpoint
on every snapshot (rtol 1e-6), and checks each from-scratch result with one
unmasked sweep (the edge_relax kernel) that must improve no vertex.
``--device`` picks where the edge blocks
and query state live (default ``cuda``; the relax sweeps then run in the
port's CUDA kernels); ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    SnapshotStore,
    direct_hop_plan,
    optimal_plan,
    plan_added_edges,
    run_direct_hop,
    run_direct_hop_batched,
    run_kickstarter_stream,
    run_plan,
    run_plan_batched,
)
from repro_torch.graph import make_evolving_sequence, run_to_fixpoint
from repro_torch.graph.semiring import ALL_SEMIRINGS
from repro_torch.kernels import edge_relax
from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR

MODES = ("ks", "dh", "dhb", "ws", "wsb")


def main(argv=None) -> dict:
    """Run every mode; returns ``{"wall_s": {mode: seconds}, "results":
    {mode: [values per snapshot]}, "verified": bool}``."""
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=20_000)
    p.add_argument("--edges", type=int, default=200_000)
    p.add_argument("--snapshots", type=int, default=10)
    p.add_argument("--changes", type=int, default=10_000)
    p.add_argument("--alg", default="sssp", choices=list(ALL_SEMIRINGS))
    p.add_argument("--source", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="device for edge blocks and query state (default "
                        "cuda; cpu runs the plain PyTorch kernel versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.load_library()
        print(f"[evolve] kernels ready in {time.perf_counter() - t0:.2f}s "
              f"on {torch.cuda.get_device_name(device)}")

    sr = ALL_SEMIRINGS[args.alg]
    print(f"[evolve] generating {args.snapshots} snapshots of "
          f"~{args.edges} edges ({args.changes} changes each) ...")
    t0 = time.perf_counter()
    seq = make_evolving_sequence(args.nodes, args.edges, args.snapshots,
                                 args.changes, seed=args.seed)
    store = SnapshotStore(seq, device=device)
    print(f"[evolve] generated in {time.perf_counter() - t0:.2f}s")

    t0 = time.perf_counter()
    ks_res, ks_stats = run_kickstarter_stream(store, sr, args.source)
    t_ks = time.perf_counter() - t0
    print(f"[evolve] KickStarter streaming: {t_ks:.2f}s "
          f"(tainted/step: {[s.tainted for s in ks_stats[1:]]})")

    dh = run_direct_hop(store, sr, args.source)
    print(f"[evolve] Direct-Hop:            {dh.wall_s:.2f}s  "
          f"speedup {t_ks / dh.wall_s:.2f}x")

    dhb = run_direct_hop_batched(store, sr, args.source)
    print(f"[evolve] Direct-Hop (batched):  {dhb.wall_s:.2f}s  "
          f"speedup {t_ks / dhb.wall_s:.2f}x  (lanes {dhb.lane_layout})")

    t0 = time.perf_counter()
    plan = optimal_plan(store)
    t_plan = time.perf_counter() - t0
    ws = run_plan(store, plan, sr, args.source)
    print(f"[evolve] Work-Sharing (TG/DP):  {ws.wall_s:.2f}s  "
          f"speedup {t_ks / ws.wall_s:.2f}x  "
          f"(Δ-edges {ws.added_edges} vs DH "
          f"{plan_added_edges(store, direct_hop_plan(n=args.snapshots))}; "
          f"plan DP {t_plan:.2f}s)")

    wsb = run_plan_batched(store, plan, sr, args.source)
    print(f"[evolve] Work-Sharing (batched):{wsb.wall_s:.2f}s  "
          f"speedup {t_ks / wsb.wall_s:.2f}x  "
          f"({len(wsb.hop_stats)} level launches vs "
          f"{len(ws.hop_stats)} sequential hops)")

    results = {"ks": ks_res, "dh": dh.results, "dhb": dhb.results,
               "ws": [ws.results[i] for i in range(args.snapshots)],
               "wsb": [wsb.results[i] for i in range(args.snapshots)]}
    summary = {"wall_s": {"ks": t_ks, "dh": dh.wall_s, "dhb": dhb.wall_s,
                          "ws": ws.wall_s, "wsb": wsb.wall_s},
               "results": results, "verified": False}
    if args.verify:
        for i in range(args.snapshots):
            view = store.snapshot_view(i)
            ref = run_to_fixpoint(view, sr, args.source).values
            _check_fixpoint(sr, view, ref, f"from-scratch snap {i}")
            for label in MODES:
                np.testing.assert_allclose(
                    results[label][i].cpu().numpy(), ref.cpu().numpy(),
                    rtol=1e-6, err_msg=f"{label} snap {i}")
        summary["verified"] = True
        print("[evolve] verify: all modes match from-scratch on every "
              "snapshot, and every from-scratch result is a fixpoint")
    return summary


def _check_fixpoint(semiring, view, values, what: str) -> None:
    """Certificate independent of the frontier-masked engine: one unmasked
    sweep (the edge_relax kernel) over every edge of ``view`` must improve
    no vertex of a converged result."""
    src, dst, w = view.arrays()
    best = edge_relax(values, src, dst, w, op=KERNEL_OP_FOR[semiring.name],
                      num_nodes=view.num_nodes)
    bad = int(semiring.strictly_better(best, values).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} vertices improve under one more "
                             "unmasked sweep — not a fixpoint")


if __name__ == "__main__":
    main()
