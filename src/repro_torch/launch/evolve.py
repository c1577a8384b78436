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

``--window W`` also runs the sliding-window executors (core/window.py): a
width-W window slides over the sequence (stride ``--window-step``) and
every window is answered by an addition-only hop from the windows' common
super-window anchor. ``--window-batch`` runs the batched slide too, every
hop a lane of ONE stacked launch. ``--stream`` feeds the same windows
through the streaming-campaign scheduler (campaigns of
``--campaign-width C`` windows, or ``auto`` for the Δ-volume DP's
partition, whose modeled volumes are printed) and reports it against the
cold per-campaign baseline. ``--fused-k K`` runs every window and stream
launch with up to K sweeps per fused relax call; without it the engine
sizes its chunks (same results either way).
With ``--verify`` every window equals the from-scratch fixpoint of its
common graph (each checked by one unmasked sweep), the batched slide
equals the sequential one bit for bit, and the stream equals the cold
campaigns bit for bit.

``--shard`` splits the batched executors' lane axis (snapshots for
dhb/wsb, windows for the batched slide, the stream and the cold
campaigns) over a 1-D ``data`` mesh (launch/mesh.py ``mesh_led_by``):
every local card with the ``--device`` card first (the store's, where
results are gathered), a one-device mesh with ``--device cpu``. Each
launch's lanes bucket to a count the mesh divides, and a ``shard[...]``
line per executor reports the placement.

``--calibrate`` (with ``--stream``) fits a measured ``SweepCostModel``
(core/costmodel.py) from timed sweeps at two edge scales, prints its
per-edge and per-sweep prices, and hands it to the timed stream's
planner: with ``--campaign-width auto`` the DP then minimizes modeled
nanoseconds instead of discounted edge counts. ``--ingest`` builds the
store by replaying the generated sequence as an edge-event firehose
(core/ingest.py): every snapshot is born from a watermark cut, the cut
snapshots and Δ pairs are asserted bit-identical to the precomputed
sequence, and every mode runs over the cut-born store.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    EdgeLog,
    IngestMetrics,
    LiveSequence,
    SnapshotStore,
    Watermark,
    calibrate,
    direct_hop_plan,
    events_from_sequence,
    optimal_plan,
    plan_added_edges,
    replay_events,
    run_direct_hop,
    run_direct_hop_batched,
    run_kickstarter_stream,
    run_plan,
    run_plan_batched,
    run_window_slide,
    run_window_slide_batched,
    run_window_stream_batched,
    slide_windows,
)
from repro_torch.graph import EdgeView, make_evolving_sequence, run_to_fixpoint
from repro_torch.graph.semiring import ALL_SEMIRINGS
from repro_torch.kernels import edge_relax, relax_multi
from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR
from repro_torch.launch.mesh import mesh_led_by

MODES = ("ks", "dh", "dhb", "ws", "wsb")


def _campaign_width(arg: str):
    """argparse type for --campaign-width: a positive int or ``auto``."""
    if arg == "auto":
        return arg
    try:
        width = int(arg)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected a positive integer or 'auto', got {arg!r}") from None
    if width < 1:
        raise argparse.ArgumentTypeError(
            f"campaign width must be >= 1, got {width}")
    return width


def _ingest_store(seq, device) -> SnapshotStore:
    """Replay ``seq`` as a timestamped edge firehose and return the live
    store its watermark cuts materialize, asserted bit-identical to
    ``SnapshotStore(seq)``: snapshots and Δ pairs."""
    metrics = IngestMetrics()
    store = SnapshotStore(LiveSequence(seq.num_nodes,
                                       weight_seed=seq.weight_seed),
                          device=device)
    log = EdgeLog(seq.num_nodes, metrics=metrics)
    watermark = Watermark(log, store)
    t0 = time.perf_counter()
    cuts = replay_events(log, watermark, events_from_sequence(seq))
    wall = time.perf_counter() - t0
    live = store.seq
    for i in range(seq.num_snapshots):
        assert np.array_equal(live.snapshot_keys[i],
                              seq.snapshot_keys[i]), f"cut {i} diverged"
    for t in range(seq.num_snapshots - 1):
        assert np.array_equal(live.additions[t], seq.additions[t]) \
            and np.array_equal(live.deletions[t], seq.deletions[t]), \
            f"Δ pair {t} diverged"
    print(f"[evolve] ingest: replayed {metrics.events} events -> "
          f"{len(cuts)} cuts in {wall:.2f}s "
          f"(+{metrics.applied_additions}/-{metrics.applied_deletions} "
          f"applied, common-shrinkage {metrics.common_shrinkage}); "
          f"snapshots bit-identical to the precomputed sequence")
    return store


def _shard_report(mesh, label: str,
                  lane_layout: "list[tuple[int, int]]") -> None:
    """Per-launch lane placement, from the (lanes, bucket) pairs the batched
    executor recorded for what it actually launched: every lane axis buckets
    to a pow2 count divisible by the data axis, so each launch shards — the
    padding overhead is the price of never running replicated."""
    extent = mesh.shape["data"]
    if not lane_layout:
        print(f"[evolve]   shard[{label}]: no batched launches "
              "(single-snapshot leaf plan)")
        return
    lanes = [c for c, _ in lane_layout]
    buckets = [b for _, b in lane_layout]
    pad = sum(buckets) / sum(lanes) - 1
    print(f"[evolve]   shard[{label}]: lanes {lanes} -> buckets "
          f"{buckets} over {extent} devices "
          f"({[b // extent for b in buckets]} lanes/device, "
          f"padding overhead {pad:.0%})")


def _launch_counts() -> dict:
    """The relax kernels' launch counters (they count CUDA launches only)."""
    return {"edge_relax": edge_relax.launches,
            "edge_relax_multi": relax_multi.launches}


def main(argv=None) -> dict:
    """Run every mode; returns ``{"wall_s": {mode: seconds}, "results":
    {mode: [values per snapshot]}, "verified": bool, "lane_layout":
    {"dhb"/"wsb": (lanes, bucket) per launch}}``, and with ``--window``
    also ``"windows"`` (see :func:`_run_windows`)."""
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
    p.add_argument("--shard", action="store_true",
                   help="shard the batched executors' lane axis (snapshots, "
                        "or windows with --window-batch/--stream) over a 1-D "
                        "data mesh of every local card, the --device "
                        "card first (one device with --device cpu)")
    p.add_argument("--window", type=int, default=None, metavar="W",
                   help="also run the sliding-window executor: slide a "
                        "width-W window over the sequence, answering every "
                        "window by an addition-only hop from the shared "
                        "super-window anchor (core/window.py)")
    p.add_argument("--window-step", type=int, default=1, metavar="S",
                   help="slide stride for --window (default 1)")
    p.add_argument("--window-batch", action="store_true",
                   help="with --window: also run the batched slide, every "
                        "window hop one lane of a single stacked launch")
    p.add_argument("--stream", action="store_true",
                   help="with --window: run the streaming-campaign "
                        "scheduler too, the slide windows consumed as "
                        "campaigns with incremental anchor maintenance")
    p.add_argument("--campaign-width", type=_campaign_width, default=4,
                   metavar="C",
                   help="windows per streaming campaign for --stream "
                        "(default 4), or 'auto' to let the Δ-volume DP "
                        "(core/window.py optimal_campaigns) choose")
    p.add_argument("--fused-k", type=int, default=None, metavar="K",
                   help="fused-chunk size for the sliding-window/stream "
                        "launches: up to K frontier-masked sweeps per relax "
                        "call (same results at any K; default: the engine "
                        "sizes its chunks)")
    p.add_argument("--ingest", action="store_true",
                   help="build the store by replaying the sequence as an "
                        "edge-event firehose (core/ingest.py): snapshots "
                        "are born from watermark cuts, asserted "
                        "bit-identical, and serve every mode below")
    p.add_argument("--calibrate", action="store_true",
                   help="with --stream: fit a measured SweepCostModel "
                        "(core/costmodel.py) from timed sweeps, print it, "
                        "and hand it to the timed stream's campaign planner "
                        "(campaign-width 'auto' prices in modeled ns)")
    args = p.parse_args(argv)
    if args.window_batch and args.window is None:
        p.error("--window-batch requires --window W")
    if args.stream and args.window is None:
        p.error("--stream requires --window W")
    if args.calibrate and not args.stream:
        p.error("--calibrate requires --stream")
    if args.fused_k is not None and args.fused_k < 1:
        p.error(f"--fused-k must be >= 1, got {args.fused_k}")
    device = torch.device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.load_library()
        print(f"[evolve] kernels ready in {time.perf_counter() - t0:.2f}s "
              f"on {torch.cuda.get_device_name(device)}")
    mesh = mesh_led_by(device) if args.shard else None

    sr = ALL_SEMIRINGS[args.alg]
    print(f"[evolve] generating {args.snapshots} snapshots of "
          f"~{args.edges} edges ({args.changes} changes each) ...")
    t0 = time.perf_counter()
    seq = make_evolving_sequence(args.nodes, args.edges, args.snapshots,
                                 args.changes, seed=args.seed)
    print(f"[evolve] generated in {time.perf_counter() - t0:.2f}s")
    store = (_ingest_store(seq, device) if args.ingest
             else SnapshotStore(seq, device=device))

    t0 = time.perf_counter()
    ks_res, ks_stats = run_kickstarter_stream(store, sr, args.source)
    t_ks = time.perf_counter() - t0
    print(f"[evolve] KickStarter streaming: {t_ks:.2f}s "
          f"(tainted/step: {[s.tainted for s in ks_stats[1:]]})")

    dh = run_direct_hop(store, sr, args.source)
    print(f"[evolve] Direct-Hop:            {dh.wall_s:.2f}s  "
          f"speedup {t_ks / dh.wall_s:.2f}x")

    dhb = run_direct_hop_batched(store, sr, args.source, mesh=mesh)
    print(f"[evolve] Direct-Hop (batched):  {dhb.wall_s:.2f}s  "
          f"speedup {t_ks / dhb.wall_s:.2f}x  (lanes {dhb.lane_layout})")
    if mesh is not None:
        _shard_report(mesh, "dhb", dhb.lane_layout)

    t0 = time.perf_counter()
    plan = optimal_plan(store)
    t_plan = time.perf_counter() - t0
    ws = run_plan(store, plan, sr, args.source)
    print(f"[evolve] Work-Sharing (TG/DP):  {ws.wall_s:.2f}s  "
          f"speedup {t_ks / ws.wall_s:.2f}x  "
          f"(Δ-edges {ws.added_edges} vs DH "
          f"{plan_added_edges(store, direct_hop_plan(n=args.snapshots))}; "
          f"plan DP {t_plan:.2f}s)")

    wsb = run_plan_batched(store, plan, sr, args.source, mesh=mesh)
    print(f"[evolve] Work-Sharing (batched):{wsb.wall_s:.2f}s  "
          f"speedup {t_ks / wsb.wall_s:.2f}x  "
          f"({len(wsb.hop_stats)} level launches vs "
          f"{len(ws.hop_stats)} sequential hops)")
    if mesh is not None:
        _shard_report(mesh, "wsb", wsb.lane_layout)

    results = {"ks": ks_res, "dh": dh.results, "dhb": dhb.results,
               "ws": [ws.results[i] for i in range(args.snapshots)],
               "wsb": [wsb.results[i] for i in range(args.snapshots)]}
    summary = {"wall_s": {"ks": t_ks, "dh": dh.wall_s, "dhb": dhb.wall_s,
                          "ws": ws.wall_s, "wsb": wsb.wall_s},
               "results": results, "verified": False,
               "lane_layout": {"dhb": dhb.lane_layout,
                               "wsb": wsb.lane_layout}}
    if args.window is not None:
        summary["windows"] = _run_windows(store, sr, args, mesh)
    if args.verify:
        for i in range(args.snapshots):
            view = store.snapshot_view(i)
            ref = run_to_fixpoint(view, sr, args.source).values
            _check_fixpoint(sr, view, ref, f"from-scratch snap {i}")
            for label in MODES:
                np.testing.assert_allclose(
                    results[label][i].cpu().numpy(), ref.cpu().numpy(),
                    rtol=1e-6, err_msg=f"{label} snap {i}")
        print("[evolve] verify: all modes match from-scratch on every "
              "snapshot, and every from-scratch result is a fixpoint")
        if args.window is not None:
            _verify_windows(store, sr, args.source, summary["windows"])
        summary["verified"] = True
    return summary


def _run_windows(store, sr, args, mesh) -> dict:
    """The window section: a sequential slide, with ``--window-batch`` a
    batched slide, with ``--stream`` a warm-up stream, the timed stream
    (its planner hinted with the warm-up's stable fraction) and the cold
    per-campaign baseline (with ``--calibrate``, planned under the fitted
    cost model); every batched run on ``mesh`` when given. Returns the
    runs (``slide``, ``batch``, ``stream``, ``cold``; None where not
    run), the ``cost_model``, their wall seconds
    (``wall_s``) and the relax kernels' launches made here and in the
    window verify (``launches``)."""
    before = _launch_counts()
    windows = slide_windows(args.snapshots, args.window,
                            step=args.window_step)
    sl = run_window_slide(store, sr, args.source, args.window,
                          step=args.window_step, fused_k=args.fused_k)
    print(f"[evolve] Window slide (seq):   {sl.wall_s:.2f}s  "
          f"({len(windows)} windows of width {args.window}, "
          f"anchor T{sl.anchor}, Δ-edges {sl.added_edges})")
    out = {"windows": windows, "slide": sl, "batch": None, "stream": None,
           "cold": None, "cost_model": None, "wall_s": {"slide": sl.wall_s}}
    if args.window_batch:
        slb = run_window_slide_batched(store, sr, args.source, args.window,
                                       step=args.window_step, mesh=mesh,
                                       fused_k=args.fused_k)
        print(f"[evolve] Window slide (batch): {slb.wall_s:.2f}s  "
              f"speedup {sl.wall_s / slb.wall_s:.2f}x  "
              f"(1 stacked launch vs {len(sl.hop_stats)} hops)")
        if mesh is not None:
            _shard_report(mesh, "windows", slb.lane_layout)
        out["batch"], out["wall_s"]["batch"] = slb, slb.wall_s
    if args.stream:
        # Warm-up: builds the blocks both paths touch; the anchor states
        # are then dropped so the timed stream pays its real 1 rebuild +
        # hops and the cold baseline free-rides on nothing.
        warm = run_window_stream_batched(store, sr, args.source, args.window,
                                         step=args.window_step,
                                         campaign_width=args.campaign_width,
                                         mesh=mesh, fused_k=args.fused_k)
        store.release(("AS",))
        cost_model = None
        if args.calibrate:
            # measured prices on the store and launch options the timed
            # run uses, hops discounted by the warm-up's stable fraction
            cost_model = calibrate(store, sr, args.source,
                                   stable_milli=warm.stable_milli,
                                   fused_k=args.fused_k)
            print(f"[evolve] calibrated sweep cost: "
                  f"{cost_model.per_edge_nanos}ns/edge + "
                  f"{cost_model.per_sweep_nanos}ns/sweep "
                  f"(hops discounted {cost_model.stable_milli}‰ stable)")
        stm = run_window_stream_batched(store, sr, args.source, args.window,
                                        step=args.window_step,
                                        campaign_width=args.campaign_width,
                                        stable_milli=warm.stable_milli,
                                        mesh=mesh, cost_model=cost_model,
                                        fused_k=args.fused_k)
        # the cold baseline rebuilds its anchor per campaign
        t0 = time.perf_counter()
        cold = [run_window_slide_batched(store, sr, args.source, windows=c,
                                         anchor=a, mesh=mesh,
                                         fused_k=args.fused_k)
                for c, a in zip(stm.campaigns, stm.anchors)]
        t_cold = time.perf_counter() - t0
        shape = (f"widths {[len(c) for c in stm.campaigns]}"
                 if args.campaign_width == "auto"
                 else f"of <={args.campaign_width}")
        print(f"[evolve] Window stream:        {stm.wall_s:.2f}s  "
              f"vs cold campaigns {t_cold:.2f}s  "
              f"({len(stm.campaigns)} campaigns "
              f"{shape}: {stm.anchor_rebuilds} rebuilds "
              f"+ {stm.anchor_hops} anchor hops + {stm.anchor_hits} hits "
              f"vs {len(cold)} rebuilds; anchor-Δ "
              f"{stm.anchor_delta_edges} edges; "
              f"stable {stm.stable_milli}‰)")
        if stm.plan is not None:
            unit = ("modeled ns" if stm.plan.cost_model is not None
                    else "modeled Δ-edges")
            pricing = ("calibrated SweepCostModel"
                       if stm.plan.cost_model is not None
                       else f"{stm.plan.stable_milli}‰ stable")
            print(f"[evolve]   campaign plan (auto, lane_budget "
                  f"{stm.plan.lane_budget}): "
                  f"slide {stm.plan.slide_edges} + anchor "
                  f"{stm.plan.anchor_edges} + pad "
                  f"{stm.plan.padding_edges} = {stm.plan.total_edges} "
                  f"{unit} (priced at {pricing})")
        if mesh is not None:
            _shard_report(mesh, "stream", stm.lane_layout)
        out["stream"], out["cold"] = stm, cold
        out["cost_model"] = cost_model
        out["wall_s"].update(stream=stm.wall_s, cold=t_cold)
    after = _launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in after}
    return out


def _verify_windows(store, sr, source: int, win: dict) -> None:
    """Every window equals the from-scratch fixpoint of its common graph
    (rtol 1e-6), itself checked by one unmasked sweep; the batched slide
    equals the sequential one and the stream the cold campaigns, bit for
    bit. Adds the launches it makes to ``win["launches"]``."""
    before = _launch_counts()
    sl, slb, stm = win["slide"], win["batch"], win["stream"]
    for wnd in win["windows"]:
        view = EdgeView((store.window_block(*wnd),), store.num_nodes)
        ref = run_to_fixpoint(view, sr, source).values
        _check_fixpoint(sr, view, ref, f"from-scratch window {wnd}")
        np.testing.assert_allclose(sl.results[wnd].cpu().numpy(),
                                   ref.cpu().numpy(), rtol=1e-6,
                                   err_msg=f"window slide {wnd}")
        if slb is not None:
            np.testing.assert_array_equal(
                slb.results[wnd].cpu().numpy(), sl.results[wnd].cpu().numpy(),
                err_msg=f"batched window slide {wnd}")
    if stm is not None:
        for cold_run, campaign in zip(win["cold"], stm.campaigns):
            for wnd in campaign:
                np.testing.assert_array_equal(
                    stm.results[wnd].cpu().numpy(),
                    cold_run.results[wnd].cpu().numpy(),
                    err_msg=f"stream vs cold campaign {wnd}")
    after = _launch_counts()
    for k in after:
        win["launches"][k] += after[k] - before[k]
    print("[evolve] verify: window slide exact on every window"
          + (" (batched bit-identical)" if slb is not None else "")
          + (" (stream bit-identical to cold campaigns)"
             if stm is not None else ""))


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
