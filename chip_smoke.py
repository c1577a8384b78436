"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero (nothing is caught):

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print the build seconds and the
   card's name and power limit;
2. relax kernels vs plain, on the card, on the blocks the main path gives
   them: a ``SnapshotStore`` of the main path's sequence (2^22 vertices,
   2^24 edges, 8 snapshots, 75,000 changes), its snapshot block (ks, and
   the ``--verify`` sweep), its common-graph block plus one snapshot's Δ
   block (dh, ws) and plus the stacked Δ of all 8 snapshots (dhb, wsb's
   first level). All five semirings, k in {1, 4}, parents tracked and not,
   lanes in {1, 8}, each call with an ``allowed`` cap on one lane and an
   early-exit lane; every output must equal the plain version bit for bit.
   Prints kernel, plain and library times, the bytes bound and the sector
   floor per shape (``relax_bytes``); then replays the main path's own
   sweeps call by call (``main_path_sweeps``: the dh and dhb incremental
   fixpoints, the ks from-scratch fixpoint), each call bit for bit against
   the plain version and timed, with its active edges, bound and floor;
   the replay also covers the window path: the batched slide's launch
   (5 width-4 windows on 8 lanes, 3 of them masked) and the stream's
   anchor hop T(0, 7) -> T(2, 7);
3. main path at full size: the port's evolve driver, all five modes, sssp,
   and the window section (``--window 4 --window-batch --stream
   --campaign-width 2``: sequential and batched slides, a stream of 3
   campaigns, the cold campaigns), ``--verify`` (every mode equals
   from-scratch on every snapshot, each from-scratch result is a
   fixpoint, every window equals its from-scratch fixpoint, the batched
   slide the sequential one and the stream the cold campaigns bit for
   bit), with the launch counters set to 0 just before and read just
   after; the window section's own launches are counted by evolve;
4. the other four semirings through all five modes and the window
   section (width 3, ``--campaign-width auto``, ``--fused-k 4``) with
   ``--verify`` at 2^18 vertices and 2^20 edges;
5. segment_reduce vs plain, on the card, bit for bit (sums included), on
   every index array and width that phase 6's runs give it: gcn-cora/
   ogb_products by dst and by src at D in {1, 16, 47} (degrees, messages,
   gather backwards), pna/molecule by dst (D = 1 and 75, sum/min/max), by
   src (75) and by graph id (1), meshgraphnet/full_graph_sm by dst, src
   and clamped dst (128), graphcast/full_graph_sm's g2m, mesh and m2g
   edge sets by dst and by src (512); and sum, min and max on a 2^24-edge
   random message stream and on a 2^24-edge Zipf stream (the evolve
   path's R-MAT degree skew, D = 16). -0.0 and ±inf entries everywhere;
   empty segments and sentinel ids where the arrays have them. Prints per
   case the kernel's ms (back-to-back calls, events; the host's time per
   call where that is longer) as a multiple of its bytes bound, plain ms,
   the library's ms (``index_add_``, ``scatter_reduce_``) with its
   output's fill inside the timing and into a filled output, and for
   D <= 8 the sector floor (each gathered row counted as a 32-byte
   sector);
6. GNN training on the card (``launch.train.SHAPE_RUNS`` through
   ``shape_run`` and ``train_step``), the counters set to 0 just before and
   read just after: gcn-cora at its full width on ogb_products (2,449,408
   nodes, 61,859,328 edges), pna on molecule, meshgraphnet and graphcast
   on full_graph_sm; each loss must be finite and decrease, with
   segment_reduce launched in every run. Then pna, meshgraphnet and
   graphcast run again on the CPU (plain versions) from host copies of the
   card's initial weights and batch, and must agree step by step within
   ``FIRST_LOSS_TOL``/``STEP_LOSS_TOL``. TF32 is off (``allow_tf32 =
   False`` for matmul and cuDNN);
7. the train CLI (``repro_torch.launch.train --arch <a> --steps 5``) for
   the four architectures, each at its ``SHAPE_RUNS`` learning rate; then
   the CLI's meshgraphnet and graphcast set-up at the reference's default
   lr 1e-3, on the card and on the CPU from the card's weights, agreeing
   step by step whether or not the loss falls;
8. embedding_bag vs plain, on the card, bit for bit: the bags DIEN's
   main path gives it (one per history row of serve_p99's 512 rows,
   serve_bulk's 262,144, the retrieval user and phase 10's 16,384
   training rows, on the 2^23-row item table and the 10^4-row category
   table, the mask as weights, in the contiguous layout whose perm the
   kernel skips), one bag of 5,000 lookups, 4,096 bags of 1-3 lookups at
   D = 8, and a generic case (unsorted bags, random weights, -0.0/±inf
   entries, empty bags, the sentinel bag and bags past it); then
   segment_reduce on the training backward's index arrays (by item and
   category id, D = 18; timed as in phase 5). Prints per case the
   kernel's ms (back-to-back calls, events), device µs (calls queued
   behind a sleep) and the wrapper's host µs per call, plain ms,
   ``F.embedding_bag``'s ms and device µs, the bytes bound and the sector
   floor (each row counted as the 32-byte sectors it touches);
9. DIEN serving at full width (``dien_forward`` at serve_p99 and
   serve_bulk, ``dien_score_candidates`` at retrieval_cand: 1 user x
   1,000,448 candidates in chunks), the embedding_bag count set to 0 just
   before each and read just after: ms per call, rows or candidates per
   second, peak memory; retrieval must equal the forward's margin for the
   same candidates (``RETRIEVAL_TOL``), and the serve_p99 logits the CPU's
   from host copies of the weights and batch (``LOGIT_TOL``);
10. DIEN training at full width (``launch.train.dien_run`` at
    ``launch.train.DIEN_TRAIN_BATCH`` rows, 5 steps), counters set to 0
    just before and read just after: finite, falling loss, both
    embedding_bag and segment_reduce launched; 3 steps at 256 rows on the
    card and on the CPU from the same weights must agree; then the train
    CLI (``--arch dien --steps 5``);
11. the ``{"kernels": [...]}`` line, the card line, and last
    ``{"ok": true, "device": {...}}``.

Without a GPU, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import math
import pathlib
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
L2_BYTES = 50 * 10**6  # H100 L2 cache
NODES, EDGES, SNAPSHOTS, CHANGES = 1 << 22, 1 << 24, 8, 75_000
# phase 3's window section: width-4 windows, streamed in campaigns of 2
WINDOW, CAMPAIGN_WIDTH = 4, 2
OTHER_NODES, OTHER_EDGES = 1 << 18, 1 << 20
STREAM_SEGMENTS, STREAM_EDGES = 1 << 20, 1 << 24
# Phase 5's skewed stream: STREAM_EDGES ids into STREAM_SEGMENTS segments
# drawn from a Zipf law over ranks (weight r^-0.65). The exponent gives the
# degree skew of the evolve path's R-MAT graphs (a, b, c = 0.57, 0.19,
# 0.19): at 2^18 vertices and 2^22 edges the port's ``rmat_edges`` puts
# 1.8% of the edges on its 10 largest in-degrees, ranks at 0.65 put 1.9%.
ZIPF_EXPONENT = 0.65
# training steps of each phase-6 run (``launch.train.SHAPE_RUNS``)
GNN_STEPS = {"gcn-cora": 4, "pna": 5, "meshgraphnet": 5, "graphcast": 5}
# Card vs CPU from the same weights and batch (phases 6 and 7): the first
# step's loss is a forward at equal weights, whose matmuls round in another
# order, so within 1e-5 relative, and its gradient norm within 1e-4 (the
# CPU parity tests' tolerances); later losses within 2e-2 relative. Adam's
# steps amplify rounding: on the CPU, scaling every weight by 1 + 1e-7 or
# 1 + 1e-6 noise moved these 5-step losses by up to 4.8e-3 (pna/molecule)
# and 1.9e-3 (the CLI's meshgraphnet at lr 1e-3).
FIRST_LOSS_TOL, FIRST_GNORM_TOL, STEP_LOSS_TOL = 1e-5, 1e-4, 2e-2
# DIEN (phases 9-10): the card's logits against the CPU's from the same
# weights within 1e-5 of the largest |logit| (matmuls and the GRU's 100
# steps round in another order); retrieval scores against the forward's
# margins for the same candidates within 1e-4 of the largest margin (the
# reference's own retrieval check, tests/test_models.py); training
# replays at ``FIRST_LOSS_TOL``/``STEP_LOSS_TOL``.
LOGIT_TOL, RETRIEVAL_TOL = 1e-5, 1e-4


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events, after
    one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> float:
    import torch
    got, want = got.double(), want.double()
    diff = torch.where(got == want, torch.zeros_like(got), (got - want).abs())
    return float(diff.max()) if diff.numel() else 0.0


def same_bits(what: str, got, want) -> float:
    """Raise unless ``got`` equals ``want`` bit for bit; returns the max
    absolute difference (0.0)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
             f"{tuple(want.shape)}/{want.dtype}")
    if got.dtype == torch.float32:
        equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        equal = torch.equal(got, want)
    err = max_abs_err(got, want)
    if not equal:
        n_bad = int((got != want).sum())
        fail(f"{what}: kernel and plain version differ at {n_bad} entries "
             f"(max abs err {err})")
    return err


def mixed_state(sr, n, lanes, rng, device):
    """Mid-run query states: values a mix of reached and identity, random
    parents, ~40% frontier; lane 0's frontier is empty and lane 1's holds
    only vertices without out-edges (it exits after one sweep)."""
    import numpy as np
    import torch
    if sr.name == "viterbi":
        vals = rng.random((lanes, n)).astype(np.float32)
        vals[rng.random((lanes, n)) < 0.01] = np.float32(1e-36)  # underflow
    else:
        vals = (rng.random((lanes, n)) * 4 + 0.5).astype(np.float32)
    vals[rng.random((lanes, n)) < 0.3] = np.float32(sr.identity)
    vals[:, 0] = np.float32(sr.source_value)
    parent = rng.integers(-1, n, (lanes, n)).astype(np.int32)
    frontier = rng.random((lanes, n)) < 0.4
    return (torch.from_numpy(vals).to(device),
            torch.from_numpy(parent).to(device),
            torch.from_numpy(frontier).to(device))


def relax_work(blocks, frontier, n: int):
    """(edge slots, active edges, active pairs) of one relax_multi sweep
    from ``frontier`` [S, N]: the src entries it must read (a stacked
    block's for every lane), the non-padding edges whose src is on some
    lane's frontier (whose dst and w it must read), and the (edge, lane)
    pairs whose src is on that lane's frontier (its candidates)."""
    edges = active = pairs = 0
    for src, dst, _ in blocks:
        real = dst < n
        if src.dim() == 1:
            on = frontier[:, src.long()] & real
            active += int(on.any(0).sum())
        else:
            on = frontier.gather(1, src.long()) & real
            active += int(on.sum())
        edges += src.numel()
        pairs += int(on.sum())
        del on
    return edges, active, pairs


def relax_bytes(blocks, frontier, track: bool, n: int):
    """(bound bytes, sector-floor bytes, active pairs) of one relax_multi
    sweep.

    Bound: src of every edge slot, dst and w of the active edges only (an
    edge whose src is on no frontier needs nothing more), and the lane
    states (values, frontier, parents when tracked) read once and written
    once. Sector floor: the bound plus, where the lanes' state is larger
    than the L2, a 32-byte sector for each candidate's random value
    gather."""
    edges, active, pairs = relax_work(blocks, frontier, n)
    state = frontier.shape[0] * n * (4 + 1 + (4 if track else 0))
    nbytes = 4 * edges + 8 * active + 2 * state
    return nbytes, nbytes + (32 * pairs if state > L2_BYTES else 0), pairs


def relax_timing(fn, reps: int) -> dict:
    """Phase 2's timing of one relax call: ms of back-to-back calls."""
    return dict(ms=cuda_ms(fn, reps))


def main_path_sweeps(store, sr, call=None):
    """Replay the relax_multi calls of three of the main path's fixpoints,
    one call of k = 1 at a time, until every lane's frontier is empty:

    * ``dh``: Direct-Hop's hop to snapshot 1 (phase 2's dh shape): the
      seed sweep on its Δ block from the anchor state (the from-scratch
      fixpoint on the common graph, parents not tracked) with the reached
      vertices as frontier, then sweeps over the common graph plus the Δ;
    * ``dhb``: the same for every snapshot at once, one lane each
      (``lane_bucket`` lanes), over the stacked Δ;
    * ``slide``: the batched window slide's launch (phase 3's width-4
      windows, ``lane_bucket`` lanes, the padding lanes masked): the
      seed sweep on the stacked slide Δ from the anchor state, then
      sweeps over the common graph plus the stacked Δ;
    * ``anchor_hop``: the stream's hop from the first campaign's anchor
      (the common graph) to the second's, T(2, last), one lane;
    * ``ks``: KickStarter's from-scratch fixpoint: a fresh state (source 0)
      on snapshot 0's block, parents tracked.

    ``call(case, args, kwargs)`` makes each call (default: ``relax_multi``
    itself) and returns its outputs. Returns per case the final values,
    parent and frontier, the iterations and f32 work accumulated as the
    engine accumulates them (``_fixpoint``, then the seed's +1 and work),
    and the number of calls.
    """
    import torch
    from repro_torch.core import slide_windows
    from repro_torch.graph.edgeset import lane_bucket
    from repro_torch.graph.engine import init_values, run_to_fixpoint
    from repro_torch.kernels import relax_multi
    from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR

    if call is None:
        def call(case, args, kw):
            return relax_multi(*args, **kw)
    n = store.num_nodes
    dev = store.device
    snaps = store.seq.num_snapshots
    window = (0, snaps - 1)
    cg = store.common_graph_view(*window)
    hops = [(window, (i, i)) for i in range(snaps)]
    stacked = store.delta_stack(hops, num_lanes=lane_bucket(snaps))
    windows = slide_windows(snaps, min(WINDOW, snaps))
    slide = store.slide_stack(windows, window,
                              num_lanes=lane_bucket(len(windows)))
    seeded = {"dh": (1, store.delta_block(*hops[1])),
              "dhb": (stacked.src.shape[0], stacked),
              "slide": (slide.src.shape[0], slide),
              "anchor_hop": (1, store.delta_block(
                  window, (min(CAMPAIGN_WIDTH, snaps - 1), snaps - 1)))}

    def fixpoint(case, values, parent, frontier, blocks, track):
        kw = dict(op=KERNEL_OP_FOR[sr.name], num_nodes=n, k=1,
                  track_parents=track)
        it = torch.zeros(values.shape[0], dtype=torch.int32, device=dev)
        work = torch.zeros(values.shape[0], dtype=torch.float32, device=dev)
        calls = 0
        while bool(frontier.any()):
            values, parent, frontier, sweeps, dw = call(
                case, (values, parent, frontier, blocks, 1), kw)
            it, work, calls = it + sweeps, work + dw, calls + 1
        return dict(values=values, parent=parent, frontier=frontier,
                    iterations=it, work=work, calls=calls)

    out = {}
    anchor = run_to_fixpoint(cg, sr, 0, track_parents=False)
    for case, (lanes, delta) in seeded.items():
        values = anchor.values.expand(lanes, n).contiguous()
        parent = anchor.parent.expand(lanes, n).contiguous()
        kw = dict(op=KERNEL_OP_FOR[sr.name], num_nodes=n, k=1,
                  track_parents=False)
        values, parent, frontier, _, seed_work = call(
            case, (values, parent, values != sr.identity, [tuple(delta)], 1),
            kw)
        res = fixpoint(case, values, parent, frontier,
                       [tuple(b) for b in cg.blocks] + [tuple(delta)], False)
        res["iterations"] = res["iterations"] + 1
        res["work"] = res["work"] + seed_work
        res["calls"] += 1
        out[case] = res
    values = init_values(n, sr, 0, device=dev)[None]
    parent = torch.full((1, n), -1, dtype=torch.int32, device=dev)
    frontier = torch.zeros((1, n), dtype=torch.bool, device=dev)
    frontier[0, 0] = True
    out["ks"] = fixpoint("ks", values, parent, frontier,
                         [tuple(b) for b in store.snapshot_view(0).blocks],
                         True)
    return out


def check_windows(tag: str, win: dict, n: int) -> None:
    """fail() unless every window result of evolve's window section
    (``summary["windows"]``) is a CUDA [n] tensor without NaN and the
    section launched relax_multi."""
    import torch
    runs = [win["slide"], win["batch"], win["stream"], *(win["cold"] or [])]
    for run in filter(None, runs):
        for wnd, vals in run.results.items():
            if vals.shape != (n,) or vals.device.type != "cuda":
                fail(f"{tag} window {wnd}: result {tuple(vals.shape)} on "
                     f"{vals.device}")
            if bool(torch.isnan(vals).any()):
                fail(f"{tag} window {wnd}: NaN in result")
    if win["launches"]["edge_relax_multi"] <= 0:
        fail(f"{tag}: the window section never launched relax_multi")


def kernel_phase(device, timing=relax_timing):
    """Phase 2: both kernels against their plain versions on the card, on
    the blocks a store of the main path's sequence gives them."""
    import numpy as np
    import torch
    from repro_torch.core import SnapshotStore
    from repro_torch.graph import ALL_SEMIRINGS, make_evolving_sequence
    from repro_torch.graph.edgeset import lane_bucket
    from repro_torch.kernels import edge_relax, relax_multi
    from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR, edge_relax_ref
    from repro_torch.kernels.edge_relax_multi.ref import relax_multi_ref

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    seq = make_evolving_sequence(NODES, EDGES, SNAPSHOTS, CHANGES, seed=0)
    store = SnapshotStore(seq, device=device)
    n = seq.num_nodes
    window = (0, SNAPSHOTS - 1)
    hops = [(window, (i, i)) for i in range(SNAPSHOTS)]
    snap = store.snapshot_view(0).blocks[0]
    cg = store.common_graph_view(*window).blocks[0]
    deltas = {1: store.delta_block(*hops[1]),
              SNAPSHOTS: store.delta_stack(
                  hops, num_lanes=lane_bucket(SNAPSHOTS))}
    stacked = deltas[SNAPSHOTS]
    lanes_full = stacked.src.shape[0]

    def out_degree(src, dst):
        keep = dst < n
        return torch.bincount(src[keep].long(), minlength=n)

    # vertices with no out-edge in the common graph nor in Δ lane 1
    sink = (out_degree(cg.src, cg.dst)
            + out_degree(stacked.src[1], stacked.dst[1])) == 0
    if not bool(sink.any()):
        fail("no vertex without out-edges for the early-exit lane")
    print(f"[chip_smoke] phase 2: {n} vertices; snapshot block "
          f"{snap.n_padded} edges, common-graph block {cg.n_padded}, Δ "
          f"block {deltas[1].n_padded}, stacked Δ {lanes_full} x "
          f"{stacked.n_padded} (inputs {time.perf_counter() - t0:.1f}s)",
          flush=True)

    # edge_relax on the snapshot block (--verify's sweep): every semiring,
    # bit-exact; timed on sssp
    err = 0.0
    for name in sorted(ALL_SEMIRINGS):
        sr = ALL_SEMIRINGS[name]
        vals = mixed_state(sr, n, 1, rng, device)[0][0]
        op = KERNEL_OP_FOR[name]
        got = edge_relax(vals, snap.src, snap.dst, snap.w, op=op,
                         num_nodes=n)
        want = edge_relax_ref(vals, snap.src, snap.dst, snap.w, op=op,
                              num_nodes=n)
        err = max(err, same_bits(f"edge_relax[{name}]", got, want))
    vals = mixed_state(ALL_SEMIRINGS["sssp"], n, 1, rng, device)[0][0]
    args = (vals, snap.src, snap.dst, snap.w)
    kw = dict(op="min_plus", num_nodes=n)
    dst_long = snap.dst.long()
    cand = vals[snap.src.long()] + snap.w
    out = torch.full((n + 1,), float("inf"), device=device)
    er = timing(lambda: edge_relax(*args, **kw), 20)
    er_plain = cuda_ms(lambda: edge_relax_ref(*args, **kw), 5)
    er_lib = cuda_ms(lambda: out.scatter_reduce_(0, dst_long, cand, "amin"),
                     20)
    # values (16.8 MB) fit the L2: the sector floor is the bound
    er_bytes = 12 * snap.n_padded + 4 * n + 4 * n
    edge_relax_row = dict(
        name="edge_relax", route="cuda",
        source="src/repro_torch/kernels/csrc/relax.cu",
        replaces="src/repro/kernels/edge_relax/edge_relax.py:93",
        max_abs_err=err, **er, plain_ms=er_plain,
        bound_ms=er_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        sector_floor_ms=er_bytes / HBM_BYTES_PER_S * 1e3,
        library_ms=er_lib, bit_exact=True)
    print(f"[chip_smoke] edge_relax: 5 semirings bit-exact; kernel "
          f"{er['ms']:.3f} ms, plain {er_plain:.3f} ms, scatter_reduce_ "
          f"{er_lib:.3f} ms, bound {edge_relax_row['bound_ms']:.3f} ms",
          flush=True)

    # relax_multi on the common graph plus Δ: semirings x k x parents x
    # lanes, with an allowed cap, an empty lane and an early-exit lane
    err, cases = 0.0, 0
    for name in sorted(ALL_SEMIRINGS):
        sr = ALL_SEMIRINGS[name]
        op = KERNEL_OP_FOR[name]
        for lanes in (1, lanes_full):
            values, parent, frontier = mixed_state(sr, n, lanes, rng, device)
            if lanes > 1:
                frontier[0] = False
                frontier[1] = sink
            blocks = [tuple(cg), tuple(deltas[lanes])]
            for k in (1, 4):
                allowed = torch.full((lanes,), k, dtype=torch.int32,
                                     device=device)
                if k > 1:
                    allowed[-1] = 2               # a capped lane
                elif lanes > 1:
                    allowed[-1] = 0               # a lane allowed nothing
                for track in (True, False):
                    kw = dict(op=op, num_nodes=n, k=k, track_parents=track)
                    got = relax_multi(values, parent, frontier, blocks,
                                      allowed, **kw)
                    want = relax_multi_ref(values, parent, frontier, blocks,
                                           allowed, **kw)
                    tag = f"relax_multi[{name},lanes={lanes},k={k},track={track}]"
                    for part, g, r in zip(
                            ("values", "parent", "frontier", "sweeps",
                             "work"), got, want):
                        err = max(err, same_bits(f"{tag} {part}", g, r))
                    if lanes > 1 and int(got[3][1]) != 1:
                        fail(f"{tag}: early-exit lane ran {int(got[3][1])} "
                             "sweeps")
                    cases += 1
    print(f"[chip_smoke] relax_multi: {cases} cases bit-exact (values, "
          "parent, frontier, sweeps, work)", flush=True)

    # timed at k=1, sssp, on each main-path shape
    sr = ALL_SEMIRINGS["sssp"]
    shapes = {"ks": (1, (snap,), True), "dh": (1, (cg, deltas[1]), False),
              "dhb": (lanes_full, (cg, stacked), False)}
    timed = {}
    for label, (lanes, blks, track) in shapes.items():
        values, parent, frontier = mixed_state(sr, n, lanes, rng, device)
        blocks = [tuple(b) for b in blks]
        kw = dict(op="min_plus", num_nodes=n, k=1, track_parents=track)
        t = timing(lambda: relax_multi(values, parent, frontier, blocks,
                                       None, **kw), 10)
        plain = cuda_ms(lambda: relax_multi_ref(values, parent, frontier,
                                                blocks, None, **kw), 3)
        nbytes, floor, pairs = relax_bytes(blocks, frontier, track, n)
        timed[label] = dict(t, plain_ms=plain,
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                            sector_floor_ms=floor / HBM_BYTES_PER_S * 1e3,
                            lanes=lanes, track_parents=track,
                            active_edges=pairs)
        print(f"[chip_smoke] relax_multi timed ({label} shape: sssp, k=1, "
              f"lanes={lanes}, track_parents={track}, {pairs} active "
              f"edges): kernel {t['ms']:.3f} ms, plain {plain:.3f} ms, bound "
              f"{timed[label]['bound_ms']:.3f} ms, sector floor "
              f"{timed[label]['sector_floor_ms']:.3f} ms", flush=True)

    # the main path's own sweeps, replayed call by call: each held bit for
    # bit against the plain version, timed, with its active edges
    main_path = {}

    def held_call(case, args, kw):
        got = relax_multi(*args, **kw)
        want = relax_multi_ref(*args, **kw)
        calls = main_path.setdefault(case, [])
        tag = f"relax_multi[main path {case}, call {len(calls)}]"
        for part, g, r in zip(("values", "parent", "frontier", "sweeps",
                               "work"), got, want):
            same_bits(f"{tag} {part}", g, r)
        del want
        t = timing(lambda: relax_multi(*args, **kw), 5)
        _, _, frontier, blocks, _ = args
        nbytes, floor, pairs = relax_bytes(blocks, frontier,
                                           kw["track_parents"], n)
        calls.append(dict(t, active_edges=pairs,
                          frontier=int(frontier.sum()),
                          bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                          sector_floor_ms=floor / HBM_BYTES_PER_S * 1e3))
        return got

    t0 = time.perf_counter()
    replay = main_path_sweeps(store, sr, held_call)
    replayed = {}
    for case, calls in main_path.items():
        keys = sorted({key for c in calls for key in c})
        sums = {key: sum(c.get(key, 0) for c in calls) for key in keys}
        replayed[case] = dict(sums, calls=len(calls), per_call=calls,
                              sweeps=int(replay[case]["iterations"].max()))
        print(f"[chip_smoke] relax_multi main path {case}: {len(calls)} "
              f"calls bit-exact, kernel {sums['ms']:.3f} ms in all, bound "
              f"{sums['bound_ms']:.3f} ms, sector floor "
              f"{sums['sector_floor_ms']:.3f} ms; active edges per call "
              f"{[c['active_edges'] for c in calls]}", flush=True)
    print(f"[chip_smoke] relax_multi main-path replay in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    dh = timed["dh"]
    relax_multi_row = dict(
        name="edge_relax_multi", route="cuda",
        source="src/repro_torch/kernels/csrc/relax.cu",
        replaces="src/repro/kernels/edge_relax_multi/edge_relax_multi.py:131",
        max_abs_err=err, ms=dh["ms"], plain_ms=dh["plain_ms"],
        bound_ms=dh["bound_ms"], bound_by="bytes",
        sector_floor_ms=dh["sector_floor_ms"], library_ms=None,
        bit_exact=True, shapes=timed, main_path=replayed)
    return edge_relax_row, relax_multi_row


def special_messages(e: int, d: int, seed: int, device):
    """A random [e, d] float32 message stream on the card with -0.0, +0.0,
    +inf and -inf entries at about 0.1% of the places each."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = torch.randn((e, d), generator=gen, device=device)
    flat = data.view(-1)
    for value in (-0.0, 0.0, float("inf"), float("-inf")):
        idx = torch.randint(0, e * d, (max(e * d // 1000, 1),),
                            generator=gen, device=device)
        flat[idx] = value
    return data


def segment_bytes(layout, d: int) -> int:
    """Bytes a segment_reduce call must move: the in-range edges' rows and
    perm entries, the offsets, and the [N, D] output (the kernel reads no
    seg id: perm and offsets carry them)."""
    n = layout.num_segments
    kept = int(layout.offsets[-1])
    return 4 * kept * d + 4 * kept + 4 * (n + 1) + 4 * n * d


def sector_floor_bytes(layout, d: int) -> int:
    """``segment_bytes`` with each gathered row of fewer than 32 bytes
    counted as the 32-byte sector a random read of it costs (D <= 8)."""
    kept = int(layout.offsets[-1])
    return segment_bytes(layout, d) + kept * (32 - 4 * d)


def zipf_ids(e: int, n: int, seed: int, device):
    """``e`` int32 ids into ``n`` segments: ranks drawn with weight
    ``r^-ZIPF_EXPONENT``, mapped to ids by a seeded permutation."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    weight = torch.arange(1, n + 1, dtype=torch.float64,
                          device=device).pow(-ZIPF_EXPONENT)
    cdf = torch.cumsum(weight, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(e, generator=gen, dtype=torch.float64, device=device)
    rank = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    ids = torch.randperm(n, generator=gen, device=device)[rank]
    return ids.to(torch.int32)


def library_ms(reduce: str, lay, data):
    """Times of the one PyTorch call computing the same reduction
    (``index_add_`` for sum, ``scatter_reduce_`` for min/max) on the
    layout's clamped ids (dropped ids into an extra row): with its output's
    fill (``torch.full``) inside the timing, the same function as the
    kernel; and into an output filled once outside it."""
    import torch
    n, d = lay.num_segments, data.shape[1]
    fill = {"sum": 0.0, "min": math.inf, "max": -math.inf}[reduce]
    if reduce == "sum":
        def call(out):
            return out.index_add_(0, lay.seg, data)
    else:
        index = lay.seg.long()[:, None].expand(-1, d)
        how = "amin" if reduce == "min" else "amax"

        def call(out):
            return out.scatter_reduce_(0, index, data, how)
    out = torch.full((n + 1, d), fill, device=data.device)
    prefilled = cuda_ms(lambda: call(out), 10)
    del out
    return cuda_ms(lambda: call(torch.full((n + 1, d), fill,
                                           device=data.device)), 10), prefilled


def segment_case(tag, data, ids, lay, reduce, plain_reps=3):
    """One segment_reduce case: bit for bit against the plain version,
    then the kernel's, plain and library times, the bytes bound (and for
    D <= 8 the sector floor). The kernel's calls after the first reuse the
    tiles it kept in ``lay``. Returns (timed dict, max abs err)."""
    from repro_torch.kernels import segment_reduce
    from repro_torch.kernels.segment_reduce import segment_reduce_ref
    n, d = lay.num_segments, data.shape[1]
    kw = dict(num_segments=n, reduce=reduce, layout=lay)
    err = same_bits(tag, segment_reduce(data, ids, **kw),
                    segment_reduce_ref(data, ids, **kw))
    ms = cuda_ms(lambda: segment_reduce(data, ids, **kw), 10)
    plain = cuda_ms(lambda: segment_reduce_ref(data, ids, **kw), plain_reps)
    lib, lib_prefilled = library_ms(reduce, lay, data)
    bound = segment_bytes(lay, d) / HBM_BYTES_PER_S * 1e3
    timed = dict(ms=ms, plain_ms=plain, library_ms=lib,
                 library_prefilled_ms=lib_prefilled, bound_ms=bound,
                 edges=ids.shape[0], segments=n)
    floor = ""
    if d <= 8:
        timed["sector_floor_ms"] = (sector_floor_bytes(lay, d)
                                    / HBM_BYTES_PER_S * 1e3)
        floor = f", sector floor {timed['sector_floor_ms']:.3f} ms"
    timed["empty_segments"] = int((lay.offsets.diff() == 0).sum())
    timed["dropped_ids"] = ids.shape[0] - int(lay.offsets[-1])
    print(f"[chip_smoke] {tag} bit-exact ({timed['empty_segments']} empty "
          f"segments, {timed['dropped_ids']} dropped ids): kernel {ms:.3f} "
          f"ms ({ms / bound:.2f}x its bound), plain {plain:.3f} ms, library "
          f"{lib:.3f} ms with its fill ({lib_prefilled:.3f} ms into a filled "
          f"output), bound {bound:.3f} ms{floor}", flush=True)
    return timed, err


def segment_phase(device, case=segment_case):
    """Phase 5: segment_reduce against its plain version on the card, bit
    for bit, at every (index array, width, reduce) the GNN runs of phase 6
    give it, and on the 2^24-edge streams; each case run by ``case``
    (``segment_case``'s arguments and result)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import _arch_shape_cfg, shape_batch
    from repro_torch.data import DataCursor
    from repro_torch.kernels.segment_reduce import segment_layout

    def batch_of(arch, shape_id):
        cfg = _arch_shape_cfg(get_arch(arch)[0], shape_id)
        return shape_batch(cfg, shape_id, DataCursor(0, 0), device)

    t0 = time.perf_counter()
    big = batch_of("gcn-cora", "ogb_products")
    mol = batch_of("pna", "molecule")
    sm = batch_of("meshgraphnet", "full_graph_sm")
    gc = batch_of("graphcast", "full_graph_sm")
    n_big, n_mol, n_sm = big["x"].shape[0], mol["x"].shape[0], sm["x"].shape[0]
    n_mesh, n_grid = gc["mesh_valid"].shape[0], gc["x"].shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    stream = torch.randint(-16, STREAM_SEGMENTS + 16, (STREAM_EDGES,),
                           generator=gen, device=device, dtype=torch.int32)
    stream[stream == 1] = 0                        # an empty segment
    # label: (ids, segments), the main path's own index arrays: messages
    # and degrees by dst, gather backwards by src and by the clamped dst
    # (meshgraphnet's receivers; graphcast's mesh_dst has no sentinel, so
    # its clamped copy equals it), pooling by graph id, graphcast's three
    # edge sets (g2m_dst with the sentinel n_mesh, m2g_dst with n_grid)
    index_sets = {
        "ogb_dst": (big["dst"], n_big), "ogb_src": (big["src"], n_big),
        "molecule_dst": (mol["dst"], n_mol),
        "molecule_src": (mol["src"], n_mol),
        "molecule_graph": (mol["graph_id"], mol["graph_targets"].shape[0]),
        "sm_dst": (sm["dst"], n_sm), "sm_src": (sm["src"], n_sm),
        "sm_dst_clamped": (torch.clamp(sm["dst"], max=n_sm - 1), n_sm),
        "g2m_dst": (gc["g2m_dst"], n_mesh), "g2m_src": (gc["g2m_src"], n_grid),
        "mesh_dst": (gc["mesh_dst"], n_mesh),
        "mesh_src": (gc["mesh_src"], n_mesh),
        "m2g_dst": (gc["m2g_dst"], n_grid), "m2g_src": (gc["m2g_src"], n_mesh),
        "stream": (stream, STREAM_SEGMENTS),
        "zipf": (zipf_ids(STREAM_EDGES, STREAM_SEGMENTS, 6, device),
                 STREAM_SEGMENTS),
    }
    # the sets that must hold an empty segment (the shapes' padded nodes,
    # the stream's emptied segment 1)
    with_empty = ("ogb_dst", "ogb_src", "molecule_dst", "sm_dst", "stream")
    cases = (("ogb_dst", 1, ("sum",)), ("ogb_dst", 16, ("sum",)),
             ("ogb_dst", 47, ("sum",)), ("ogb_src", 1, ("sum",)),
             ("ogb_src", 16, ("sum",)), ("ogb_src", 47, ("sum",)),
             ("molecule_dst", 1, ("sum",)),
             ("molecule_dst", 75, ("sum", "min", "max")),
             ("molecule_src", 75, ("sum",)), ("molecule_graph", 1, ("sum",)),
             ("sm_dst", 128, ("sum",)), ("sm_src", 128, ("sum",)),
             ("sm_dst_clamped", 128, ("sum",)),
             ("g2m_dst", 512, ("sum",)), ("g2m_src", 512, ("sum",)),
             ("mesh_dst", 512, ("sum",)), ("mesh_src", 512, ("sum",)),
             ("m2g_dst", 512, ("sum",)), ("m2g_src", 512, ("sum",)),
             ("stream", 75, ("sum", "min", "max")),
             ("zipf", 16, ("sum", "min", "max")))
    layouts = {k: segment_layout(ids, n) for k, (ids, n) in index_sets.items()}
    zipf_counts = layouts["zipf"].offsets.diff()
    torch.cuda.synchronize()
    print(f"[chip_smoke] phase 5: ogb_products {n_big} nodes, "
          f"{big['dst'].shape[0]} edges; molecule {mol['dst'].shape[0]} "
          f"edges; full_graph_sm {sm['dst'].shape[0]} edges, graphcast mesh "
          f"{n_mesh} nodes, {gc['mesh_dst'].shape[0]} edges; stream and "
          f"Zipf stream {STREAM_EDGES} edges into {STREAM_SEGMENTS} segments, "
          f"the Zipf stream's largest segment "
          f"{int(zipf_counts.max())} edges (inputs and layouts "
          f"{time.perf_counter() - t0:.1f}s)", flush=True)
    del big, mol, sm, gc

    err, timed = 0.0, {}
    for label, d, reduces in cases:
        ids, n = index_sets[label]
        lay = layouts[label]
        if label in with_empty and not bool((lay.offsets.diff() == 0).any()):
            fail(f"segment_reduce[{label}]: no empty segment")
        data = special_messages(ids.shape[0], d, seed=d, device=device)
        for reduce in reduces:
            tag = f"segment_reduce[{label},D={d},{reduce}]"
            # the Zipf stream's hubs make the plain version's loop long
            timed[f"{label}/D={d}/{reduce}"], case_err = case(
                tag, data, ids, lay, reduce,
                plain_reps=1 if label == "zipf" else 3)
            err = max(err, case_err)
        del data
        torch.cuda.empty_cache()
    head = timed["ogb_dst/D=47/sum"]
    return dict(
        name="segment_reduce", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce/segment_reduce.py:47",
        max_abs_err=err, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by="bytes",
        library_ms=head["library_ms"], bit_exact=True, shapes=timed)


def to_cpu(params, batch):
    """Host copies of a run's parameters and batch."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu(), params), {k: v.cpu()
                                                 for k, v in batch.items()}


def run_steps(loss_fn, params, batch, steps: int, lr: float):
    """Losses and gradient norms of ``steps`` train steps from fresh AdamW
    state (on the CPU these run the kernels' plain versions)."""
    from repro_torch.launch.train import train_step
    from repro_torch.optim import adamw_init
    opt = adamw_init(params)
    losses, gnorms = [], []
    for _ in range(steps):
        params, opt, loss, gnorm = train_step(loss_fn, params, opt, batch,
                                              lr=lr)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return losses, gnorms


def card_agrees_with_cpu(tag, card, cpu) -> float:
    """Fail unless the card's (losses, gradient norms) agree with the CPU's
    from the same weights (tolerances at ``FIRST_LOSS_TOL``); returns the
    largest relative loss difference."""
    (losses, gnorms), (cpu_losses, cpu_gnorms) = card, cpu

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    if rel(gnorms[0], cpu_gnorms[0]) > FIRST_GNORM_TOL:
        fail(f"{tag}: first gradient norm {gnorms[0]} on the card, "
             f"{cpu_gnorms[0]} on the CPU")
    worst = 0.0
    for i, (a, b) in enumerate(zip(losses, cpu_losses)):
        worst = max(worst, rel(a, b))
        if rel(a, b) > (FIRST_LOSS_TOL if i == 0 else STEP_LOSS_TOL):
            fail(f"{tag}: step {i + 1} loss {a} on the card, {b} on the CPU "
                 f"(card {losses}, CPU {cpu_losses})")
    return worst


def gnn_phase(device):
    """Phase 6: the GNN family's training path on the card, counters set to
    0 just before and read just after; then each run but gcn-cora's (62M
    edges, too large for the host) replayed on the CPU from host copies of
    its initial weights and batch. Returns (launches, per-run table)."""
    import torch
    from repro_torch.kernels import segment_reduce
    from repro_torch.launch.train import SHAPE_RUNS, shape_run, train_step

    runs, replays = {}, []
    segment_reduce.launches = 0
    for arch, shape_id, lr in SHAPE_RUNS:
        t0 = time.perf_counter()
        cfg, batch, params, opt, loss_fn = shape_run(arch, shape_id, device)
        steps = GNN_STEPS[arch]
        tag = f"{arch}/{shape_id}"
        if arch != "gcn-cora":
            replays.append((tag, loss_fn, to_cpu(params, batch), steps, lr))
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        before = segment_reduce.launches
        losses, gnorms, step_s = [], [], []
        for _ in range(steps):
            t1 = time.perf_counter()
            params, opt, loss, gnorm = train_step(loss_fn, params, opt, batch,
                                                  lr=lr)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        launched = segment_reduce.launches - before
        if not all(map(math.isfinite, losses + gnorms)):
            fail(f"{tag}: loss or gradient norm not finite: {losses} {gnorms}")
        if not losses[-1] < losses[0]:
            fail(f"{tag}: loss did not decrease: {losses}")
        if launched <= 0:
            fail(f"{tag}: segment_reduce was never launched")
        peak = torch.cuda.max_memory_allocated() / 2**30
        warm = step_s[1:]
        runs[tag] = dict(
            nodes=batch["x"].shape[0], steps=steps, lr=lr,
            losses=losses, gnorms=gnorms, first_step_ms=step_s[0] * 1e3,
            ms_per_step=sum(warm) / len(warm) * 1e3, peak_gib=peak,
            segment_reduce_launches=launched, setup_s=setup)
        print(f"[chip_smoke] phase 6: {tag} (layers {cfg.n_layers}, d "
              f"{cfg.d_hidden}, lr {lr:g}) {steps} steps, losses "
              f"{[round(x, 5) for x in losses]}; first step "
              f"{step_s[0] * 1e3:.1f} ms, then {runs[tag]['ms_per_step']:.1f} "
              f"ms/step; peak device memory {peak:.2f} GiB; {launched} "
              f"segment_reduce launches; set-up {setup:.1f}s", flush=True)
        del batch, params, opt
        torch.cuda.empty_cache()
    launches = segment_reduce.launches
    for tag, loss_fn, (params, batch), steps, lr in replays:
        t0 = time.perf_counter()
        cpu = run_steps(loss_fn, params, batch, steps, lr)
        card = (runs[tag]["losses"], runs[tag]["gnorms"])
        worst = card_agrees_with_cpu(tag, card, cpu)
        runs[tag].update(cpu_losses=cpu[0], cpu_rel_diff=worst)
        print(f"[chip_smoke] phase 6: {tag} on the CPU from the card's "
              f"weights: losses {[round(x, 5) for x in cpu[0]]}, largest "
              f"relative difference {worst:.2e} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return launches, runs


def default_lr_witness(device):
    """Phase 7, second part: the train CLI's meshgraphnet and graphcast at
    the reference's default lr 1e-3, where a 5-step loss need not fall: the
    CLI's own set-up (seed 0) on the card, and on the CPU from host copies
    of the card's weights and batch, must agree step by step."""
    import torch
    from repro_torch.data import DataCursor
    from repro_torch.launch import train
    out = {}
    for arch in ("meshgraphnet", "graphcast"):
        _, _, params_init, loss_fn, data_fn = train.build(arch, False, 8, 128,
                                                          device)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params, batch = params_init(gen), data_fn(DataCursor(0, 0))
        host = to_cpu(params, batch)
        card = run_steps(loss_fn, params, batch, 5, 1e-3)
        cpu = run_steps(loss_fn, *host, 5, 1e-3)
        worst = card_agrees_with_cpu(f"train CLI {arch} at lr 1e-3", card,
                                     cpu)
        out[arch] = dict(card_losses=card[0], cpu_losses=cpu[0],
                         rel_diff=worst)
        print(f"[chip_smoke] phase 7: train CLI {arch} at lr 1e-3: card "
              f"losses {[round(x, 5) for x in card[0]]}, CPU from the card's "
              f"weights {[round(x, 5) for x in cpu[0]]} (largest relative "
              f"difference {worst:.2e})", flush=True)
    return out


def bag_bytes(layout, d: int) -> int:
    """Bytes an embedding_bag call must move: each in-range lookup's id,
    weight and 4 D-byte row (and its perm entry, unless the layout's perm
    is the identity, which the kernel does not read), the offsets, and the
    [n_bags, D] output (the kernel reads no bag id: perm and offsets carry
    them)."""
    n = layout.num_segments
    kept = int(layout.offsets[-1])
    per = 8 + (0 if layout.identity_perm else 4)
    return kept * (per + 4 * d) + 4 * (n + 1) + 4 * n * d


def bag_sector_bytes(layout, ids, d: int) -> int:
    """``bag_bytes`` with each in-range lookup's row counted as the 32-byte
    sectors a random read of it touches (a 72-byte row at D = 18 touches
    3): what the card moves at the least when no row is found in a cache."""
    import torch
    kept = int(layout.offsets[-1])
    if layout.identity_perm:
        rows = ids[:kept].long()
    else:
        rows = ids.index_select(0, layout.perm[:kept]).long()
    first = rows * (4 * d)
    sectors = int(torch.sum((first + 4 * d - 1) // 32 - first // 32 + 1))
    return bag_bytes(layout, d) + 32 * sectors - kept * 4 * d


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs queued behind a 25 ms
    sleep on the card, after one warm-up run: the host enqueues every run
    before the card reaches them, so the time between the events is the
    card's own."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of ``fn``, its runs queued behind a 25 ms
    sleep on the card so that the host never waits for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    per_call = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return per_call


def bag_case(tag, table, ids, w, lay, library=None):
    """One embedding_bag case: bit for bit against the plain version, then
    the kernel's ms (back-to-back calls, events), device µs (calls queued
    behind a sleep), the wrapper's host µs per call, the plain version's
    ms, the bytes bound and the sector floor; and, where ``library`` (one
    ``F.embedding_bag`` call on the same bags) is given, its ms and device
    µs, after checking it computes the same function within 1e-5 of the
    largest output. Returns (timed dict, max abs err)."""
    from repro_torch.kernels import embedding_bag
    from repro_torch.kernels.embedding_bag import embedding_bag_ref
    n_bags = lay.num_segments
    kw = dict(n_bags=n_bags, layout=lay)

    def kernel():
        return embedding_bag(table, ids, lay.seg, w, **kw)
    want = embedding_bag_ref(table, ids, lay.seg, w, **kw)
    err = same_bits(f"embedding_bag[{tag}]", kernel(), want)
    lib = lib_us = None
    if library is not None:
        scale = max(float(want.abs().max()), 1e-30)
        if float((library() - want).abs().max()) > 1e-5 * scale:
            fail(f"embedding_bag[{tag}]: F.embedding_bag computes another "
                 "function")
        lib = cuda_ms(library, 100)
        lib_us = device_ms(library, 20) * 1e3
    del want
    counts = lay.offsets[1:] - lay.offsets[:-1]
    d = table.shape[1]
    timed = dict(
        ms=cuda_ms(kernel, 100), device_us=device_ms(kernel, 20) * 1e3,
        host_us=host_us(kernel, 20),
        plain_ms=cuda_ms(lambda: embedding_bag_ref(table, ids, lay.seg, w,
                                                   **kw), 3),
        library_ms=lib, library_device_us=lib_us,
        bound_ms=bag_bytes(lay, d) / HBM_BYTES_PER_S * 1e3,
        sector_floor_ms=bag_sector_bytes(lay, ids, d) / HBM_BYTES_PER_S * 1e3,
        lookups=ids.shape[0], bags=n_bags, table_rows=table.shape[0],
        width=d, perm_read=not lay.identity_perm,
        empty_bags=int((counts == 0).sum()),
        dropped_lookups=ids.shape[0] - int(lay.offsets[-1]))
    lib_txt = (f"{lib:.3f} ms ({lib_us:.1f} us on the device)"
               if lib is not None else "none")
    print(f"[chip_smoke] embedding_bag[{tag}] bit-exact "
          f"({timed['empty_bags']} empty bags, {timed['dropped_lookups']} "
          f"dropped lookups): kernel {timed['ms']:.3f} ms, "
          f"{timed['device_us']:.1f} us on the device, host "
          f"{timed['host_us']:.1f} us per call; plain "
          f"{timed['plain_ms']:.3f} ms, F.embedding_bag {lib_txt}, bound "
          f"{timed['bound_ms']:.4f} ms, sector floor "
          f"{timed['sector_floor_ms']:.4f} ms", flush=True)
    return timed, err


def bag_phase(device, case=bag_case):
    """Phase 8: embedding_bag against its plain version on the card, bit
    for bit, on the bags DIEN's serving and training give it (item and
    category tables, the mask as weights, the contiguous layout), one long
    bag, many short bags at D = 8, and a generic case; each case run and
    timed by ``case``. Returns (embedding_bag row, the training batch)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_family import shape_batch
    from repro_torch.data import DataCursor
    from repro_torch.kernels.segment_reduce import (
        contiguous_layout,
        segment_layout,
    )
    from repro_torch.launch.train import DIEN_TRAIN_BATCH

    cfg = get_arch("dien")[0]
    d = cfg.embed_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    tables = {"item": torch.randn((cfg.n_items, d), generator=gen,
                                  device=device) * 0.02,
              "cat": torch.randn((cfg.n_cats, d), generator=gen,
                                 device=device) * 0.02}
    err, timed = 0.0, {}

    def run_case(tag, table, ids, w, lay, library=None):
        nonlocal err
        timed[tag], e = case(tag, table, ids, w, lay, library)
        err = max(err, e)

    def bags_2d(ids2d, table, w):
        """F.embedding_bag on [B, S] ids: one bag per row."""
        ids2d, w2d = ids2d.long(), w.view(ids2d.shape)
        return lambda: F.embedding_bag(ids2d, table, mode="sum",
                                       per_sample_weights=w2d)

    # the path's bags: one per history row and table, the mask as weights
    path = (("serve_p99", None), ("serve_bulk", None),
            ("retrieval_cand", None), ("train_batch", DIEN_TRAIN_BATCH))
    train_batch = None
    for shape_id, rows in path:
        batch = shape_batch(cfg, shape_id, DataCursor(0, 0), device, rows)
        b, s = batch["hist_items"].shape
        lay = contiguous_layout(b, s, device)
        w = batch["hist_mask"].reshape(-1).float()
        for name, key in (("item", "hist_items"), ("cat", "hist_cats")):
            run_case(f"{shape_id}/{name}", tables[name],
                     batch[key].reshape(-1), w, lay,
                     bags_2d(batch[key], tables[name], w))
        if shape_id == "train_batch":
            train_batch = batch
        else:
            del batch
        torch.cuda.empty_cache()

    # one long bag on the item table; 4,096 bags of 1-3 lookups at D = 8
    ids = torch.randint(0, cfg.n_items, (5000,), generator=gen,
                        device=device, dtype=torch.int32)
    w = torch.randn(5000, generator=gen, device=device)
    run_case("long_bag/item", tables["item"], ids, w,
             contiguous_layout(1, 5000, device),
             bags_2d(ids[None], tables["item"], w))
    n_bags = 4096
    sizes = torch.randint(1, 4, (n_bags,), generator=gen, device=device)
    bags = torch.repeat_interleave(
        torch.arange(n_bags, dtype=torch.int32, device=device), sizes)
    table = torch.randn((1 << 20, 8), generator=gen, device=device)
    ids = torch.randint(0, 1 << 20, bags.shape, generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.randn(bags.shape, generator=gen, device=device)
    lay = segment_layout(bags, n_bags)
    ids_l, offsets_l = ids.long(), lay.offsets.long()
    run_case("short_bags/D=8", table, ids, w, lay,
             lambda: F.embedding_bag(ids_l, table, offsets_l, mode="sum",
                                     per_sample_weights=w,
                                     include_last_offset=True))

    # generic: unsorted bags, random weights, -0.0/±inf entries, empty
    # bags, the sentinel bag and bags past it
    n_bags, lookups = 1 << 16, 1 << 22
    table = special_messages(1 << 20, d, seed=18, device=device) * 0.02
    ids = torch.randint(0, 1 << 20, (lookups,), generator=gen, device=device,
                        dtype=torch.int32)
    bags = torch.randint(0, n_bags + 16, (lookups,), generator=gen,
                         device=device, dtype=torch.int32)
    bags[bags == 1] = 0                            # an empty bag
    w = special_messages(lookups, 1, seed=19, device=device)[:, 0].contiguous()
    run_case("generic", table, ids, w, segment_layout(bags, n_bags))
    if timed["generic"]["empty_bags"] == 0 or \
            timed["generic"]["dropped_lookups"] == 0:
        fail("embedding_bag[generic]: no empty bag or no dropped lookup")
    del table, ids, bags, w

    head = timed["serve_bulk/item"]
    row = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/embedding_bag.py:46",
        max_abs_err=err, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by="bytes",
        library_ms=head["library_ms"], bit_exact=True, shapes=timed)
    return row, train_batch


def dien_segment_cases(device, batch, case=segment_case):
    """segment_reduce on DIEN training's backward for the training
    ``batch``: the gathered rows' gradients summed by item and category id
    (the history lookups and the bags' table gradient share the history's
    arrays), and the targets'; each case run by ``case``. Returns the timed
    cases."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.segment_reduce import segment_layout
    cfg = get_arch("dien")[0]
    d = cfg.embed_dim
    seg_timed = {}
    for label, n in (("hist_items", cfg.n_items), ("hist_cats", cfg.n_cats),
                     ("target_item", cfg.n_items),
                     ("target_cat", cfg.n_cats)):
        ids = batch[label].reshape(-1)
        lay = segment_layout(ids, n)
        data = special_messages(ids.shape[0], d, seed=d, device=device)
        timed, err = case(f"segment_reduce[dien {label},D={d},sum]", data,
                          ids, lay, "sum")
        seg_timed[f"dien_{label}/D={d}/sum"] = dict(timed, max_abs_err=err)
        del data
        torch.cuda.empty_cache()
    return seg_timed


def timed_calls(fn, reps: int):
    """(result of a cold call, its ms, mean ms of ``reps`` warm calls), each
    call ended by a synchronize."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    cold = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return out, cold, (time.perf_counter() - t0) * 1e3 / reps


def serve_phase(device):
    """Phase 9: DIEN serving at full width on the card, the embedding_bag
    count set to 0 just before each shape's calls and read just after:
    ``dien_forward`` at serve_p99 and serve_bulk, ``dien_score_candidates``
    at retrieval_cand (each output's SHA-256 recorded, so two trees'
    outputs can be compared bit for bit). Then retrieval against the
    forward's margins for the same candidates, and the card's serve_p99
    logits against the CPU's from host copies of the weights and batch.
    Returns (launches, per-shape
    table)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_family import shape_batch
    from repro_torch.data import DataCursor
    from repro_torch.kernels import embedding_bag
    from repro_torch.models import dien
    from repro_torch.tree import tree_map

    cfg = get_arch("dien")[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = dien.init_dien_params(gen, cfg)
    runs, launches = {}, 0

    def forward(batch):
        return dien.dien_forward(cfg, params, batch)[0]

    with torch.no_grad():
        for shape_id, reps in (("serve_p99", 5), ("serve_bulk", 2),
                               ("retrieval_cand", 2)):
            batch = shape_batch(cfg, shape_id, DataCursor(0, 0), device)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            retrieval = shape_id == "retrieval_cand"
            embedding_bag.launches = 0
            out, cold, warm = timed_calls(
                (lambda b=batch: dien.dien_score_candidates(cfg, params, b))
                if retrieval else (lambda b=batch: forward(b)), reps)
            launched = embedding_bag.launches
            launches += launched
            rows = batch["cand_items" if retrieval else "hist_items"].shape[0]
            want = (rows,) if retrieval else (rows, 2)
            if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
                fail(f"DIEN {shape_id}: output {tuple(out.shape)}, finite "
                     f"{bool(torch.isfinite(out).all())}")
            if launched <= 0:
                fail(f"DIEN {shape_id}: embedding_bag was never launched")
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs[shape_id] = dict(rows=rows, reps=reps, cold_ms=cold,
                                  ms_per_call=warm,
                                  rows_per_s=rows / warm * 1e3,
                                  peak_gib=peak,
                                  embedding_bag_launches=launched,
                                  out_sha256=hashlib.sha256(
                                      out.cpu().numpy().tobytes()).hexdigest())
            unit = "candidates" if retrieval else "rows"
            print(f"[chip_smoke] phase 9: DIEN {shape_id} ({rows} {unit}): "
                  f"cold {cold:.1f} ms, warm {warm:.1f} ms/call "
                  f"({rows / warm * 1e3:.0f} {unit}/s); peak device memory "
                  f"{peak:.2f} GiB; {launched} embedding_bag launches",
                  flush=True)
            if retrieval:
                scores, user = out, batch
            elif shape_id == "serve_p99":
                p99_batch, p99_logits = batch, out
            del batch, out
            torch.cuda.empty_cache()

        # retrieval == the forward's margin for the same candidate, at
        # candidates across every chunk boundary
        c = scores.shape[0]
        chunk = dien.CANDIDATE_CHUNK
        edges = {0, c - 1} | {i for k in range(1, -(-c // chunk))
                              for i in (k * chunk - 1, k * chunk)}
        spread = torch.linspace(0, c - 1, 512 - len(edges)).long().tolist()
        picks = torch.tensor(sorted(edges) + spread, device=device)
        same = {k: user[k].expand(picks.shape[0], -1)
                for k in ("hist_items", "hist_cats", "hist_mask")}
        same.update(target_item=user["cand_items"][picks],
                    target_cat=user["cand_cats"][picks])
        logits = forward(same)
        margin = logits[:, 1] - logits[:, 0]
        diff = float((scores[picks] - margin).abs().max())
        scale = float(margin.abs().max())
        if diff > RETRIEVAL_TOL * scale:
            fail(f"retrieval vs forward margin: max diff {diff} at scale "
                 f"{scale}")
        runs["retrieval_cand"]["vs_forward_rel"] = diff / scale
        print(f"[chip_smoke] phase 9: retrieval equals the forward's margin "
              f"at {picks.shape[0]} candidates across {c // chunk} chunk "
              f"boundaries (max diff {diff / scale:.2e} of the largest)",
              flush=True)

    # the card's serve_p99 logits against the CPU's from the same weights
    t0 = time.perf_counter()
    host_params = tree_map(lambda t: t.cpu(), params)
    host_batch = {k: v.cpu() for k, v in p99_batch.items()}
    del params
    torch.cuda.empty_cache()
    with torch.no_grad():
        cpu_logits = dien.dien_forward(cfg, host_params, host_batch)[0]
    diff = float((p99_logits.cpu() - cpu_logits).abs().max())
    scale = float(cpu_logits.abs().max())
    if diff > LOGIT_TOL * scale:
        fail(f"serve_p99 logits: card and CPU differ by {diff} at scale "
             f"{scale}")
    runs["serve_p99"]["card_vs_cpu_rel"] = diff / scale
    print(f"[chip_smoke] phase 9: serve_p99 logits on the CPU from the "
          f"card's weights agree within {diff / scale:.2e} of the largest "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return launches, runs


def dien_train_phase(device):
    """Phase 10: DIEN training at full width on the card (``dien_run`` at
    ``DIEN_TRAIN_BATCH`` rows, 5 steps on the fixed batch, lr 1e-3), the
    counts set to 0 just before and read just after; the loss must be
    finite and fall, with both embedding_bag and segment_reduce launched.
    Then 3 steps at a 256-row cut of the batch from the same initial
    weights, on the card and on the CPU from host copies, must agree.
    Returns (embedding_bag launches, segment_reduce launches, table)."""
    import torch
    from repro_torch.kernels import embedding_bag, segment_reduce
    from repro_torch.launch.train import DIEN_TRAIN_BATCH, dien_run, train_step
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg, batch, params, opt, loss_fn = dien_run("train_batch", device)
    small = {k: v[:256] for k, v in batch.items()}
    host = to_cpu(params, small)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    embedding_bag.launches = 0
    segment_reduce.launches = 0
    losses, gnorms, step_s = [], [], []
    for _ in range(5):
        t1 = time.perf_counter()
        params, opt, loss, gnorm = train_step(loss_fn, params, opt, batch,
                                              lr=1e-3)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    bag_launches = embedding_bag.launches
    seg_launches = segment_reduce.launches
    if not all(map(math.isfinite, losses + gnorms)):
        fail(f"DIEN train_batch: loss or gradient norm not finite: {losses} "
             f"{gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"DIEN train_batch: loss did not decrease: {losses}")
    if bag_launches <= 0 or seg_launches <= 0:
        fail(f"DIEN train_batch: launches embedding_bag {bag_launches}, "
             f"segment_reduce {seg_launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    warm = step_s[1:]
    run = dict(batch=DIEN_TRAIN_BATCH, steps=5, lr=1e-3, losses=losses,
               gnorms=gnorms, first_step_ms=step_s[0] * 1e3,
               ms_per_step=sum(warm) / len(warm) * 1e3, peak_gib=peak,
               embedding_bag_launches=bag_launches,
               segment_reduce_launches=seg_launches, setup_s=setup)
    print(f"[chip_smoke] phase 10: DIEN train_batch cut to "
          f"{DIEN_TRAIN_BATCH} rows, 5 steps, losses "
          f"{[round(x, 5) for x in losses]}; first step "
          f"{step_s[0] * 1e3:.1f} ms, then {run['ms_per_step']:.1f} ms/step; "
          f"peak device memory {peak:.2f} GiB; {bag_launches} embedding_bag "
          f"and {seg_launches} segment_reduce launches; set-up {setup:.1f}s",
          flush=True)
    del params, opt, batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    card = run_steps(loss_fn, tree_map(lambda t: t.to(device), host[0]),
                     {k: v.to(device) for k, v in host[1].items()}, 3, 1e-3)
    cpu = run_steps(loss_fn, *host, 3, 1e-3)
    worst = card_agrees_with_cpu("DIEN 256-row replay", card, cpu)
    run.update(replay_card_losses=card[0], replay_cpu_losses=cpu[0],
               replay_card_gnorms=card[1], replay_cpu_gnorms=cpu[1],
               replay_rel_diff=worst)
    print(f"[chip_smoke] phase 10: 3 steps at 256 rows, card losses "
          f"{card[0]}, gradient norms {card[1]}; CPU from the card's weights "
          f"{cpu[0]}, {cpu[1]} (largest relative loss difference "
          f"{worst:.2e}; {time.perf_counter() - t0:.1f}s)", flush=True)
    return bag_launches, seg_launches, run


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    src_dir = pathlib.Path(__file__).resolve().parent / "src"
    if not (src_dir / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{src_dir}/repro_torch not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(src_dir))
    from repro_torch.kernels import (
        _build,
        edge_relax,
        embedding_bag,
        relax_multi,
        segment_reduce,
    )
    from repro_torch.launch import evolve, train

    device = torch.device("cuda", 0)
    # 1. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[chip_smoke] phase 1: built {lib.name} in "
          f"{time.perf_counter() - t0:.1f}s; card: {card_line()}", flush=True)

    # 2. kernels vs plain
    t0 = time.perf_counter()
    edge_relax_row, relax_multi_row = kernel_phase(device)
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 2 done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 3. main path, counters zeroed just before and read just after
    argv = ["--nodes", str(NODES), "--edges", str(EDGES), "--snapshots",
            str(SNAPSHOTS), "--changes", str(CHANGES), "--alg", "sssp",
            "--verify", "--device", "cuda", "--window", str(WINDOW),
            "--window-batch", "--stream", "--campaign-width",
            str(CAMPAIGN_WIDTH)]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    edge_relax.launches = 0
    relax_multi.launches = 0
    summary = evolve.main(argv)
    launches = {"edge_relax": edge_relax.launches,
                "edge_relax_multi": relax_multi.launches}
    wall = time.perf_counter() - t0
    if not summary["verified"]:
        fail("main path did not verify")
    for mode, per_snap in summary["results"].items():
        for i, vals in enumerate(per_snap):
            if vals.shape != (NODES,) or vals.device.type != "cuda":
                fail(f"{mode} snap {i}: result {tuple(vals.shape)} on "
                     f"{vals.device}")
            if bool(torch.isnan(vals).any()):
                fail(f"{mode} snap {i}: NaN in result")
    for name, count in launches.items():
        if count <= 0:
            fail(f"main path never launched the {name} kernel")
    win = summary["windows"]
    check_windows("phase 3", win, NODES)
    walls = {m: round(s, 3) for m, s in summary["wall_s"].items()}
    print(f"[chip_smoke] phase 3: main path {argv} verified in {wall:.1f}s; "
          f"per-mode wall s {walls}; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    stm = win["stream"]
    windows_row = dict(
        wall_s=win["wall_s"], launches=win["launches"],
        anchors=stm.anchors, anchor_events=stm.anchor_events,
        added_edges={"slide": win["slide"].added_edges,
                     "stream": stm.added_edges,
                     "anchor_hops": stm.anchor_delta_edges},
        stable_milli={"slide": win["slide"].stable_milli,
                      "batch": win["batch"].stable_milli,
                      "stream": stm.stable_milli})
    window_walls = {k: round(v, 3) for k, v in win["wall_s"].items()}
    print(f"[chip_smoke] phase 3 windows: {len(win['windows'])} of width "
          f"{WINDOW}, wall s {window_walls}; stream "
          f"{len(stm.campaigns)} campaigns anchored at {stm.anchors}: "
          f"{stm.anchor_rebuilds} rebuilds + {stm.anchor_hops} hops + "
          f"{stm.anchor_hits} hits; Δ-edges {windows_row['added_edges']}; "
          f"stable ‰ {windows_row['stable_milli']}; window-section "
          f"launches {win['launches']}", flush=True)
    del summary, win, stm
    torch.cuda.empty_cache()

    # 4. the other four semirings at a smaller size
    t0 = time.perf_counter()
    for alg in ("bfs", "sswp", "ssnp", "viterbi"):
        other = evolve.main(["--nodes", str(OTHER_NODES), "--edges",
                             str(OTHER_EDGES), "--snapshots", str(SNAPSHOTS),
                             "--changes", str(CHANGES), "--alg", alg,
                             "--verify", "--device", "cuda", "--window", "3",
                             "--window-batch", "--stream",
                             "--campaign-width", "auto", "--fused-k", "4"])
        if not other["verified"]:
            fail(f"{alg} did not verify")
        check_windows(f"phase 4 {alg}", other["windows"], OTHER_NODES)
        if other["windows"]["stream"].plan is None:
            fail(f"phase 4 {alg}: the stream made no campaign plan")
    print(f"[chip_smoke] phase 4: bfs/sswp/ssnp/viterbi verified at "
          f"{OTHER_NODES} vertices, {OTHER_EDGES} edges, windows of width 3 "
          f"(auto campaigns, fused k 4), in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    del other

    # 5. segment_reduce vs plain
    t0 = time.perf_counter()
    segment_row = segment_phase(device)
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 5 done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 6. the GNN training path, counters zeroed just before and read after
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    segment_row["launches"], segment_row["gnn_runs"] = gnn_phase(device)
    print(f"[chip_smoke] phase 6: {segment_row['launches']} segment_reduce "
          f"launches over {len(train.SHAPE_RUNS)} training runs; done in "
          f"{time.perf_counter() - t0:.1f}s (TF32 off)", flush=True)

    # 7. the train CLI, then the witness at the reference's default lr
    t0 = time.perf_counter()
    for arch, _, lr in train.SHAPE_RUNS:
        losses = train.main(["--arch", arch, "--steps", "5", "--lr", str(lr),
                             "--device", "cuda"])
        if not losses[-1] < losses[0]:
            fail(f"train CLI {arch}: loss did not decrease")
    segment_row["default_lr_witness"] = default_lr_witness(device)
    print(f"[chip_smoke] phase 7: train CLI for {len(train.SHAPE_RUNS)} "
          f"archs and the lr 1e-3 witness in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # 8. embedding_bag vs plain (and segment_reduce on DIEN's backward)
    t0 = time.perf_counter()
    bag_row, train_batch = bag_phase(device)
    segment_row["shapes"].update(dien_segment_cases(device, train_batch))
    del train_batch
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 8 done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 9. DIEN serving, the count zeroed before each shape and read after
    t0 = time.perf_counter()
    bag_row["launches"], bag_row["dien_serving"] = serve_phase(device)
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 9: {bag_row['launches']} embedding_bag "
          f"launches over 3 serving shapes; done in "
          f"{time.perf_counter() - t0:.1f}s (TF32 off)", flush=True)

    # 10. DIEN training, counters zeroed before and read after; the CLI
    t0 = time.perf_counter()
    bag_n, seg_n, bag_row["dien_training"] = dien_train_phase(device)
    torch.cuda.empty_cache()
    embedding_bag.launches = 0
    segment_reduce.launches = 0
    losses = train.main(["--arch", "dien", "--steps", "5", "--device",
                         "cuda"])
    if not losses[-1] < losses[0]:
        fail("train CLI dien: loss did not decrease")
    if embedding_bag.launches <= 0 or segment_reduce.launches <= 0:
        fail("train CLI dien: a kernel was never launched")
    bag_row["launches"] += bag_n + embedding_bag.launches
    segment_row["dien_launches"] = seg_n + segment_reduce.launches
    segment_row["launches"] += segment_row["dien_launches"]
    print(f"[chip_smoke] phase 10: train CLI dien (batch 8) losses "
          f"{[round(x, 5) for x in losses]}; done in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # 11. records
    edge_relax_row["launches"] = launches["edge_relax"]
    relax_multi_row["launches"] = launches["edge_relax_multi"]
    relax_multi_row["windows"] = windows_row
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [edge_relax_row, relax_multi_row,
                                  segment_row, bag_row]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
