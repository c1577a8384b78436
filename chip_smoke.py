"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero (nothing is caught):

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print the build seconds and the
   card's name and power limit;
1b. lint: the port's graphlint (``repro_torch.analysis``, rules
   T001-T010) over the checkout's ``src/repro_torch``; any finding fails.
   Prints the rules run, the files checked and the seconds;
2. relax kernels vs plain, on the card, on the blocks the main path gives
   them: a ``SnapshotStore`` of the main path's sequence (2^22 vertices,
   2^24 edges, 8 snapshots, 75,000 changes), its snapshot block (ks, and
   the ``--verify`` sweep), its common-graph block plus one snapshot's Δ
   block (dh, ws) and plus the stacked Δ of all 8 snapshots (dhb, wsb's
   first level). All five semirings, k in {1, 4, 32}, parents tracked and
   not, lanes in {1, 8}, each call with an ``allowed`` cap on one lane and
   an early-exit lane; k = 32 starts from running work totals and runs
   past every lane's fixpoint; every output must equal the plain version
   bit for bit. Prints kernel, plain and library times, the bytes bound
   and the sector floor per shape (``relax_bytes``); then replays the main
   path's own calls in the engine's chunks (``main_path_sweeps``: the dh
   and dhb incremental fixpoints, the ks from-scratch fixpoint), each call
   bit for bit against the plain version, as one call and as one round a
   call (``round_by_round``), and timed, with its rounds, active edges and
   the bound and floor of every round it ran;
   the replay also covers the window path: the batched slide's launch
   (5 width-4 windows on 8 lanes, 3 of them masked) and the stream's
   anchor hop T(0, 7) -> T(2, 7);
3. main path at full size: the port's evolve driver, all five modes, sssp,
   and the window section (``--window 4 --window-batch --stream
   --campaign-width 2``: sequential and batched slides, a stream of 3
   campaigns, the cold campaigns), ``--shard`` (the batched executors'
   lanes over a mesh of every local card; prints the ``shard[...]``
   lines), ``--verify`` (every mode equals
   from-scratch on every snapshot, each from-scratch result is a
   fixpoint, every window equals its from-scratch fixpoint, the batched
   slide the sequential one and the stream the cold campaigns bit for
   bit), with the launch counters set to 0 just before and read just
   after; the window section's own launches are counted by evolve;
3b. the query service at the main path's full size (``serve --service
   --clients 6 --seed 0``: a seeded open-loop load of window queries,
   sssp and bfs from two sources, packed into masked relax_multi launches),
   the counts set to 0 just before and read just after: every query
   completes, every client's window equals a solo stream of its spec and
   a from-scratch fixpoint of its window (each certified by one unmasked
   edge_relax sweep) bit for bit, the service rebuilds strictly fewer
   anchors than the solo streams when clients share a query key, and a
   launch packs lanes of several clients; prints the counts, the turn
   wall, queries/s and p50/p99. Then ``calibrate`` (sssp, fused k 4) on
   the same store, counted as its own path: over ``slide_windows(8, 4)``
   the calibrated plan must cost no more than the raw-count plan priced
   under the same model;
3c. lane sharding on phase 2's store, the counts set to 0 just before and
   read just after: on a mesh naming the card four times (and on every
   local card where there are two or more), ``run_direct_hop_batched``,
   ``run_plan_batched`` on the optimal plan, the batched slide of 5
   width-4 windows (bucket 8) and the ``campaign_width="auto"`` stream,
   each run unmeshed (cold), meshed and unmeshed again (warm): every
   meshed run equals the unmeshed one bit for bit (values, per-launch
   work and sweeps, stable fraction; the stream's plan is the planner's at
   the mesh's extent) with every launch bucketed to ``lane_bucket(lanes,
   extent)``; the engine's sharded launch of the 8 dhb lanes equals the
   unsharded one lane for lane (values, parents, iterations, edge_work,
   unstable); phase 3b's load at 2^18/2^20 through the service, meshed
   against unmeshed (every count, every launch record but its bucket,
   every result). Prints per executor the walls, relax launches,
   set-algebra seconds and the split, replica and gather seconds;
3d. the paper's engine at production scale (``configs/commongraph.py``):
   ``window_32x`` (32 snapshots, 2^20 vertices, 2^24 common-graph edges,
   2^18 Δ edges each) and ``window_64x`` (64, 2^23, 2^26, 2^20), each at
   its full published size, the counts set to 0 just before each shape's
   first evolve step and read after its checks: generation (on the host,
   in a spawned process started after phase 1, beside phases 2-3c) and
   start-state seconds, the cell's step (SSSP, ``track_parents=False``,
   ``max_iters`` 64) cold and warm with its relax_multi launches and
   device ms, the peak device memory beside its reckoning, per-lane
   iterations and edge_work. Every valid lane is certified a fixpoint by
   one unmasked ``edge_relax`` sweep over the common graph and one over
   its Δ row; a lane stopped by ``max_iters`` short of its fixpoint fails
   the phase; padding lanes report 0 iterations and 0.0 work; lanes 0,
   s // 2 and s - 1 equal their from-scratch fixpoints, and the cell on a
   mesh naming the card four times (and on every card where there are
   two or more) equals the unmeshed step, bit for bit; then relax_multi
   at the cell's seed and sweep shapes against its plain version (4
   lanes at a time), timed beside its bytes bound;
4. the other four semirings through all five modes and the window
   section (width 3, ``--campaign-width auto`` priced by ``--calibrate``,
   ``--fused-k 4``) with ``--verify`` at 2^18 vertices and 2^20 edges,
   then sssp the same way without ``--calibrate`` (the plan priced by raw
   counts);
4b. ingestion at 2^18/2^20, counts set to 0 just before and read just
   after: ``evolve --ingest --calibrate`` (bfs, the window section,
   ``--verify``: snapshots born from watermark cuts, bit-identical to the
   sequence), then a live replay with spill backpressure whose cuts feed a
   ``WindowStream`` and a ``QueryService`` client through
   ``LiveWindowFeed``s: snapshots and Δ pairs bit-identical to the
   sequence, live window results equal to the precomputed store's bit for
   bit, and ``Watermark.compact`` strictly shrinks the stored edges.
   Ingestion stays at this size: every event is one Python object on the
   host, as in the reference;
5. segment_reduce vs plain, on the card, bit for bit (sums included), on
   every index array and width that phase 6's runs give it: gcn-cora/
   ogb_products by dst and by src at D in {1, 16, 47} (degrees, messages,
   gather backwards), pna/molecule by dst (D = 1 and 75, sum/min/max), by
   src (75) and by graph id (1), meshgraphnet/full_graph_sm by dst, src
   and clamped dst (128), graphcast/full_graph_sm's g2m, mesh and m2g
   edge sets by dst and by src (512); and sum, min and max on a 2^24-edge
   random message stream and on a 2^24-edge Zipf stream (the evolve
   path's R-MAT degree skew, D = 16). Then minibatch_lg's sampled batch
   (``shape_graph``: 232,965 nodes, 114,615,892 edges, built once, in
   the process that builds phase 3d's edges, and shared with phase 6; its
   set-up seconds printed): one training step of
   each minibatch_lg run with every segment_reduce call recorded, and each
   recorded (index array, width, reduce) held as a case: the sampled
   ``nodes`` into the 233,472-row feature table (the table gradient, D =
   602 and graphcast's 227, mostly empty segments), the sampled dst, src
   and clamped dst at every width the runs give (sum, min, max), graphcast's
   mesh edge sets. -0.0 and ±inf entries everywhere;
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
   on full_graph_sm, and all four on minibatch_lg (1,024 seeds, fanout
   15-10: 169,984 sampled nodes, 168,960 edges, features gathered from a
   233,472 x 602 table, graphcast's 233,472 x 227 with a 42,496-node
   mesh); each loss must be finite and decrease (a minibatch_lg run on its
   step-0 subgraph), with segment_reduce launched in every run. A
   minibatch_lg run then takes ``SAMPLED_STEPS`` steps that each sample a
   fresh subgraph (host sampling, batch and step ms each) and two more
   under ``torch.profiler`` (device-busy ms per step). Then the runs but
   ``NOT_REPLAYED``'s run again on the CPU (plain versions) from host
   copies of the card's initial weights and batch, and must agree step by
   step within ``FIRST_LOSS_TOL``/``STEP_LOSS_TOL``. TF32 is off
   (``allow_tf32 = False`` for matmul and cuDNN);
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
11. LM serving at published widths (``LM_RUNS``): each config's seeded
    bfloat16 weights (qwen3-moe-30b-a3b all 48 layers, llama3.2-3b all 28,
    stablelm-1.6b all 24; nemotron-4-340b 2 of 96 and
    llama4-maverick-400b-a17b one (dense, MoE) pair: ``LM_DEPTH``) serve a
    ``LM_BATCH`` x ``LM_PROMPT`` prefill and greedy decode to
    ``LM_DECODE_STEPS`` tokens (``launch.serve.serve_lm``), the
    segment_reduce count set to 0 just before and read just after: init s,
    prefill and decode ms and tokens/s, peak GiB, greedy tokens, one
    segment_reduce launch per MoE layer and step; every logit finite; then
    the device-busy ms of one prefill and one decode step
    (``torch.profiler``) and their share of the walls. The
    MoE configs' combine calls of the prefill and of one decode step are
    recorded (``record_segment_calls``) and each held bit for bit against
    its plain version, timed beside ``index_add_`` and its bytes bound; the
    dense configs' first decode logits equal ``lm_forward``'s within
    ``LM_DECODE_ULPS``; stablelm's prefill with
    ``allow_bf16_reduced_precision_reduction`` flipped; then qwen3 in
    float32 at 2 layers, card against CPU within ``LM_CPU_TOL``, flipped
    expert choices printed with their margins;
12. LM training at published widths (``LM_TRAIN_RUNS``, through
    ``launch.train.lm_run`` and ``train_step``): bfloat16 weights, AdamW
    with float32 state, 4 x 4,096 tokens of ``lm_batch``'s step-0 batch
    (train_4k's sequence, its batch cut from 256), each layer recomputed
    in the backward; stablelm-1.6b at all 24 layers, qwen3-moe-30b-a3b at
    2 of 48. The segment_reduce count set to 0 just before
    ``LM_TRAIN_STEPS`` steps and read just after: the loss must fall, one
    launch a step for the embedding's gradient and two per MoE layer (the
    combine, the dispatch's gradient); ms/step,
    tokens/s, peak GiB beside its reckoning, device-busy ms by kernel kind
    (``torch.profiler``). Every segment_reduce call of one step, forward
    and backward, held bit for bit against its plain version, timed
    beside ``index_add_`` and its bytes bound; two runs of a step give
    bit-identical gradients and parameters; then qwen3 in float32 at 2
    layers, one step on the card against the CPU (loss, gradient norm,
    every gradient and updated parameter; flipped expert choices printed
    with their margins), and the train CLI (``--arch stablelm-1.6b
    --reduced --steps 5``);
13. the dry run and the model cells, the kernels' counts set to 0 just
    before and read just after: (a) ``launch.dryrun.main(["--all",
    "--both-meshes", "--commongraph", "--json", ...])`` must return 0 with
    84 records (40 cells x 2 production meshes, 2 CommonGraph shapes x 2),
    its seconds and its largest one-device peak and per-device arguments
    printed; (b) gcn-cora/full_graph_sm, pna/molecule and dien/serve_p99
    built by ``configs.make_cell`` on ``make_local_mesh()`` and run on the
    card from seeded arguments of their meta arguments' shapes: each
    output equal to ``launch.train.train_step``'s or phase 9's serve
    call's bit for bit, each step's peak within 5% or 64 MiB of the meta
    trace's, and phase 12's stablelm step traced on meta against phase
    12's measured peak to the same bound; (c) a fault drill, gcn-cora/
    full_graph_sm trained 8 steps through ``FaultTolerantRunner`` with
    checkpoints every 2 steps and failures at steps 3 and 6, equal to a
    run without failures bit for bit, then 5 rounds of
    ``ef_compress_update`` card against CPU bit for bit;
14. the ``{"kernels": [...]}`` line, the card line, and last
    ``{"ok": true, "device": {...}}``.

Without a GPU, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import math
import multiprocessing
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
# phase 3b's service load (``serve.generate_load``, seed 0) and phase 4b's
# spill bound (``benchmarks/ingest.py``'s)
SERVICE_CLIENTS = 6
INGEST_MAX_PENDING = 1024
STREAM_SEGMENTS, STREAM_EDGES = 1 << 20, 1 << 24
# Phase 5's skewed stream: STREAM_EDGES ids into STREAM_SEGMENTS segments
# drawn from a Zipf law over ranks (weight r^-0.65). The exponent gives the
# degree skew of the evolve path's R-MAT graphs (a, b, c = 0.57, 0.19,
# 0.19): at 2^18 vertices and 2^22 edges the port's ``rmat_edges`` puts
# 1.8% of the edges on its 10 largest in-degrees, ranks at 0.65 put 1.9%.
ZIPF_EXPONENT = 0.65
# training steps of each phase-6 run (``launch.train.SHAPE_RUNS``) on its
# step-0 batch, by (architecture, shape); a minibatch_lg run then takes
# SAMPLED_STEPS steps on fresh subgraphs (steps 1, 2, ...) and two more
# under the profiler
GNN_STEPS = {("gcn-cora", "ogb_products"): 4, ("pna", "molecule"): 5,
             ("meshgraphnet", "full_graph_sm"): 5,
             ("graphcast", "full_graph_sm"): 5,
             ("gcn-cora", "minibatch_lg"): 5, ("pna", "minibatch_lg"): 5,
             ("meshgraphnet", "minibatch_lg"): 5,
             ("graphcast", "minibatch_lg"): 5}
SAMPLED_STEPS = 5
# phase-6 runs not replayed on the CPU, and why
NOT_REPLAYED = {
    ("gcn-cora", "ogb_products"): "62M edges, too large for the host",
    ("meshgraphnet", "minibatch_lg"): "15 blocks of width 128 over 168,960 "
    "edges: minutes of host time; its full_graph_sm run is replayed",
    ("graphcast", "minibatch_lg"): "16 layers of width 512 over 169,984 "
    "mesh and 168,960 grid edges: minutes of host time; its full_graph_sm "
    "run is replayed"}
# Card vs CPU from the same weights and batch (phases 6 and 7): the first
# step's loss is a forward at equal weights, whose matmuls round in another
# order, so within 1e-5 relative, and its gradient norm within 1e-4 (the
# CPU parity tests' tolerances); later losses within 2e-2 relative. Adam's
# steps amplify rounding: on the CPU, scaling every weight by 1 + 1e-7 or
# 1 + 1e-6 noise moved these 5-step losses by up to 4.8e-3 (pna/molecule)
# and 1.9e-3 (the CLI's meshgraphnet at lr 1e-3).
FIRST_LOSS_TOL, FIRST_GNORM_TOL, STEP_LOSS_TOL = 1e-5, 1e-4, 2e-2
# pna on minibatch_lg: its gradient norm is more sensitive than that. Its
# last hop's nodes have no in-edge and take PNA's attenuation scaler
# (delta / 1e-6) times the std aggregator's sqrt(1e-5); nodes aggregating
# them cancel in m2 - mean^2. On the CPU, one more rounding of each weight
# (a relative change of at most 2^-24) moved the first gradient norm by
# 2.1e-4, and card and CPU differed by 5.0e-4 (H100, 700 W); so its first
# gradient norm is held within 10x the former. Its losses keep the
# tolerances above.
GNORM_TOL = {("pna", "minibatch_lg"): 2e-3}
# DIEN (phases 9-10): the card's logits against the CPU's from the same
# weights within 1e-5 of the largest |logit| (matmuls and the GRU's 100
# steps round in another order); retrieval scores against the forward's
# margins for the same candidates within 1e-4 of the largest margin (the
# reference's own retrieval check, tests/test_models.py); training
# replays at ``FIRST_LOSS_TOL``/``STEP_LOSS_TOL``.
LOGIT_TOL, RETRIEVAL_TOL = 1e-5, 1e-4
# phase 11: LM serving, every config at its published widths: a LM_BATCH x
# LM_PROMPT prefill (prefill_32k's 32 x 32,768 cut: one layer's float32
# [B, H, S, S] scores there would not fit the card), then greedy decode to
# LM_DECODE_STEPS tokens a row (the serve CLI's --decode-steps: the first
# from the prefill). Depth is cut where the weights would not fit: nemotron
# to 2 of 96 layers (3.45 B parameters a layer), llama4 to one (dense, MoE)
# pair of its 24.
LM_RUNS = ("qwen3-moe-30b-a3b", "llama3.2-3b", "stablelm-1.6b",
           "nemotron-4-340b", "llama4-maverick-400b-a17b")
LM_DEPTH = {"nemotron-4-340b": 2, "llama4-maverick-400b-a17b": 2}
LM_BATCH, LM_PROMPT, LM_DECODE_STEPS = 8, 2048, 16
# The dense configs' decode logits at position LM_PROMPT against
# lm_forward's over the prompt and the first greedy token: within this many
# bfloat16 ulps of the largest |logit| (a bfloat16 model; the two paths'
# products differ in shape, so their float32 sums can round to the other
# side of a bfloat16 tie, and such a difference spreads through the later
# layers). qwen3 in float32 on the card against the CPU (2 layers, full
# width): every logit within LM_CPU_TOL of the largest, as LOGIT_TOL.
LM_DECODE_ULPS = 16
LM_CPU_TOL = 1e-4
# phase 12: LM training at published widths (``launch.train.lm_run``):
# bfloat16 weights, AdamW with float32 state, train_4k's 4,096-token
# sequences with its 256-row batch cut to ``launch.train.LM_TRAIN_BATCH``
# (4: 16,384 tokens a step, phase 11's count), on the step-0 batch of
# ``lm_batch`` (the reference CLI memorizes one), ``LM_TRAIN_STEPS`` steps
# at ``LM_TRAIN_LR`` (the deep GNNs' rate); stablelm at all 24 layers,
# qwen3 at 2 of 48 (at 48 its weights alone are 61 GB, m and v 244 GB).
# Its card-vs-CPU step holds gradients within LM_CPU_TOL.
LM_TRAIN_RUNS = (("stablelm-1.6b", None), ("qwen3-moe-30b-a3b", 2))
LM_TRAIN_STEPS, LM_TRAIN_LR = 3, 1e-4
# phase 3d: the CommonGraph cell's shapes (configs/commongraph.py), each at
# its full published size, and the cell's max_iters (the reference's 64)
COMMONGRAPH_SHAPES_RUN = ("window_32x", "window_64x")
CELL_MAX_ITERS = 64


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
    """Largest |got - want|, counting equal entries and NaN against NaN as
    0 (a sum of +inf and -inf is NaN on both sides)."""
    import torch
    got, want = got.double(), want.double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
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


def relax_bytes(blocks, frontier, track: bool, n: int, lanes=None):
    """(bound bytes, sector-floor bytes, active pairs) of one relax_multi
    sweep.

    Bound: src of every edge slot, dst and w of the active edges only (an
    edge whose src is on no frontier needs nothing more), and the states
    of ``lanes`` lanes (default: every lane of ``frontier``; values,
    frontier, parents when tracked) read once and written once. Sector
    floor: the bound plus, where those states are larger than the L2, a
    32-byte sector for each candidate's random value gather."""
    edges, active, pairs = relax_work(blocks, frontier, n)
    lanes = frontier.shape[0] if lanes is None else lanes
    state = lanes * n * (4 + 1 + (4 if track else 0))
    nbytes = 4 * edges + 8 * active + 2 * state
    return nbytes, nbytes + (32 * pairs if state > L2_BYTES else 0), pairs


def round_by_round(args, kw, n: int):
    """One relax_multi call (``args``, ``kw``) made again by the plain
    version one round at a time (k = 1, each round's work added to the
    lanes' running totals, the lanes that do not run masked). Returns its
    outputs, which must equal the call's bit for bit, and over the rounds
    in which some lane ran: the sums of ``relax_bytes`` (bound, sector
    floor, active pairs) and the number of rounds. Round 0 reads and
    writes every lane's state, a later round only the running lanes'."""
    import torch
    from repro_torch.kernels.edge_relax_multi.ref import relax_multi_ref
    values, parent, frontier, blocks, allowed = args
    k, track, work = kw["k"], kw["track_parents"], kw.get("work")
    lanes, dev = values.shape[0], values.device
    cap = (allowed if isinstance(allowed, torch.Tensor)
           else torch.full((lanes,), k if allowed is None else allowed,
                           dtype=torch.int32, device=dev))
    sweeps = torch.zeros(lanes, dtype=torch.int32, device=dev)
    nbytes = floor = pairs = rounds = 0
    for r in range(k):
        run = frontier.any(1) & (r < cap)
        if not bool(run.any()):
            break
        b, f, p = relax_bytes(blocks, frontier & run[:, None], track, n,
                              lanes=None if r == 0 else int(run.sum()))
        nbytes, floor, pairs, rounds = (nbytes + b, floor + f, pairs + p,
                                        rounds + 1)
        values, parent, frontier, ran, work = relax_multi_ref(
            values, parent, frontier, blocks, run.to(torch.int32),
            op=kw["op"], num_nodes=n, k=1, track_parents=track, work=work)
        sweeps = sweeps + ran
    if work is None:
        work = torch.zeros(lanes, dtype=torch.float32, device=dev)
    return (values, parent, frontier, sweeps, work), (nbytes, floor, pairs,
                                                     rounds)


def relax_timing(fn, reps: int) -> dict:
    """Phase 2's timing of one relax call: ms of back-to-back calls."""
    return dict(ms=cuda_ms(fn, reps))


def main_path_sweeps(store, sr, call=None):
    """Replay the relax_multi calls of the main path's fixpoints as the
    engine makes them: after the seed sweep, chunks of the engine's own
    lengths (``_chunk_sweeps``: 4, 8, 16, 32, 32, ...), each lane allowed
    ``min(k, max_iters - iterations)`` rounds and its running work passed
    in, until every lane's frontier is empty:

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
    from repro_torch.graph.engine import (
        _chunk_sweeps,
        init_values,
        run_to_fixpoint,
    )
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

    max_iters = 10_000   # the engine's default

    def fixpoint(case, values, parent, frontier, blocks, track):
        it = torch.zeros(values.shape[0], dtype=torch.int32, device=dev)
        work = torch.zeros(values.shape[0], dtype=torch.float32, device=dev)
        launched = calls = 0
        while bool((frontier.any(1) & (it < max_iters)).any()):
            k = _chunk_sweeps(None, launched, max_iters)
            kw = dict(op=KERNEL_OP_FOR[sr.name], num_nodes=n, k=k,
                      track_parents=track, work=work)
            values, parent, frontier, sweeps, work = call(
                case, (values, parent, frontier, blocks,
                       torch.clamp(max_iters - it, max=k)), kw)
            it, launched, calls = it + sweeps, launched + k, calls + 1
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


def kernel_phase(device, timing=relax_timing, keep=None):
    """Phase 2: both kernels against their plain versions on the card, on
    the blocks a store of the main path's sequence gives them; the store
    goes into ``keep["store"]`` when a dict is given (phase 3c's)."""
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
    if keep is not None:
        keep["store"] = store
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
    # lanes, with an allowed cap, an empty lane and an early-exit lane; the
    # engine's longest chunk (k = 32) starts 16 sweeps before the slowest
    # lane's fixpoint, from the lanes' state and running work there (plus
    # 2^24 - 3), and runs past every fixpoint, so its last rounds are dead
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
            for k in (1, 4, 32):
                allowed = torch.full((lanes,), k, dtype=torch.int32,
                                     device=device)
                if lanes > 1:                     # a lane allowed nothing
                    allowed[-1] = 0 if k == 1 else 2  # or a capped lane
                elif k == 4:
                    allowed[-1] = 2
                state, work = (values, parent, frontier), None
                if k == 32:
                    kw = dict(op=op, num_nodes=n, track_parents=True)
                    full = relax_multi_ref(*state, blocks, k=10_000, **kw)
                    ahead = max(int(full[3].max()) - 16, 1)
                    *state, _, work = relax_multi_ref(*state, blocks,
                                                      k=ahead, **kw)
                    work = work + (2**24 - 3)
                    del full
                for track in (True, False):
                    kw = dict(op=op, num_nodes=n, k=k, track_parents=track,
                              work=work)
                    got = relax_multi(*state, blocks, allowed, **kw)
                    want = relax_multi_ref(*state, blocks, allowed, **kw)
                    tag = f"relax_multi[{name},lanes={lanes},k={k},track={track}]"
                    for part, g, r in zip(
                            ("values", "parent", "frontier", "sweeps",
                             "work"), got, want):
                        err = max(err, same_bits(f"{tag} {part}", g, r))
                    if lanes > 1 and k < 32 and int(got[3][1]) != 1:
                        fail(f"{tag}: early-exit lane ran {int(got[3][1])} "
                             "sweeps")
                    free = allowed == k
                    if k == 32 and (bool(got[2][free].any())
                                    or int(got[3].max()) >= k):
                        fail(f"{tag}: a lane ran to the chunk's end, "
                             f"sweeps {got[3].tolist()}")
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

    # the main path's own calls, replayed in the engine's chunks: each held
    # bit for bit against the plain version, as one call and one round a
    # call, timed, with its rounds, active edges and every round's bytes
    main_path = {}

    def held_call(case, args, kw):
        got = relax_multi(*args, **kw)
        want = relax_multi_ref(*args, **kw)
        rounds, (nbytes, floor, pairs, ran) = round_by_round(args, kw, n)
        calls = main_path.setdefault(case, [])
        tag = f"relax_multi[main path {case}, call {len(calls)}, k={kw['k']}]"
        for part, g, r, o in zip(("values", "parent", "frontier", "sweeps",
                                  "work"), got, want, rounds):
            same_bits(f"{tag} {part}", g, r)
            same_bits(f"{tag} {part} vs one round a call", g, o)
        del want, rounds
        t = timing(lambda: relax_multi(*args, **kw), 5)
        calls.append(dict(t, k=kw["k"], rounds=ran, active_edges=pairs,
                          frontier=int(args[2].sum()),
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
              f"{sums['sector_floor_ms']:.3f} ms; (k, rounds run) per call "
              f"{[(c['k'], c['rounds']) for c in calls]}, active edges per "
              f"call {[c['active_edges'] for c in calls]}", flush=True)
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


def segment_case(tag, data, ids, lay, reduce, plain_reps=3, quiet=False):
    """One segment_reduce case: bit for bit against the plain version,
    then the kernel's, plain and library times, the bytes bound (and for
    D <= 8 the sector floor), printed unless ``quiet``. The kernel's calls
    after the first reuse the tiles it kept in ``lay``. ``plain_reps`` 0
    times the plain version's checking call alone. Returns (timed dict,
    max abs err)."""
    import torch
    from repro_torch.kernels import segment_reduce
    from repro_torch.kernels.segment_reduce import segment_reduce_ref
    n, d = lay.num_segments, data.shape[1]
    kw = dict(num_segments=n, reduce=reduce, layout=lay)
    got = segment_reduce(data, ids, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = segment_reduce_ref(data, ids, **kw)
    end.record()
    end.synchronize()
    err = same_bits(tag, got, want)
    del got, want
    ms = cuda_ms(lambda: segment_reduce(data, ids, **kw), 10)
    plain = (cuda_ms(lambda: segment_reduce_ref(data, ids, **kw), plain_reps)
             if plain_reps else start.elapsed_time(end))
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
    if quiet:
        return timed, err
    print(f"[chip_smoke] {tag} bit-exact ({timed['empty_segments']} empty "
          f"segments, {timed['dropped_ids']} dropped ids): kernel {ms:.3f} "
          f"ms ({ms / bound:.2f}x its bound), plain {plain:.3f} ms, library "
          f"{lib:.3f} ms with its fill ({lib_prefilled:.3f} ms into a filled "
          f"output), bound {bound:.3f} ms{floor}", flush=True)
    return timed, err


def record_segment_calls(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every segment_reduce kernel call
    recorded: returns (its result, [(layout, width, reduce)] in call
    order)."""
    from repro_torch.kernels.segment_reduce import ops
    calls, launch = [], ops._launch

    def recorded(rows, layout, reduce):
        calls.append((layout, rows.shape[1], reduce))
        return launch(rows, layout, reduce)
    ops._launch = recorded
    try:
        return fn(*args, **kwargs), calls
    finally:
        ops._launch = launch


def sampled_index_sets(device, sampler):
    """Phase 5's sampled cases, enumerated from the runs: one training step
    of each minibatch run of ``SHAPE_RUNS`` on the card, its subgraph
    sampled from ``sampler``, with its segment_reduce calls recorded. Each recorded index array is named by
    the batch array it is (``nodes``, ``dst``, ``src``, a ``_clamped``
    copy, graphcast's edge sets); the runs sample one subgraph, so an
    array a later run meets again is the same case. Returns ({label: (ids,
    segments)}, [(label, width, reduces)], recorded calls)."""
    import torch
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.launch.train import SHAPE_RUNS, shape_run, train_step

    def dropped(ids, n):   # a layout's seg: ids outside [0, n) set to n
        return torch.where((ids >= 0) & (ids < n), ids, n)

    index_sets, widths, n_calls = {}, {}, 0
    for arch, shape_id, lr in SHAPE_RUNS:
        if GNN_SHAPES[shape_id]["kind"] != "minibatch":
            continue
        _, batch, params, opt, loss_fn, _ = shape_run(arch, shape_id, device,
                                                      graph=sampler)
        _, calls = record_segment_calls(train_step, loss_fn, params, opt,
                                        batch, lr=lr)
        n_calls += len(calls)
        named = {k: v for k, v in batch.items()
                 if k == "nodes" or k.endswith(("src", "dst"))}
        for layout, d, reduce in calls:
            n, seg = layout.num_segments, layout.seg
            label = next((k for k, (ids, m) in index_sets.items()
                          if m == n and ids.shape == seg.shape
                          and torch.equal(ids, seg)), None)
            if label is None:
                label = next(
                    (k + suffix for k, v in named.items()
                     for suffix, ids in (("", v),
                                         ("_clamped", v.clamp(max=n - 1)))
                     if v.shape == seg.shape
                     and torch.equal(dropped(ids, n), seg)), None)
                if label is None:
                    fail(f"phase 5: {arch}/{shape_id} reduced by an index "
                         f"array of {seg.shape[0]} ids into {n} segments "
                         f"that is no array of its batch")
                label = f"{shape_id}/{label}"
                if label in index_sets:   # the name of another array
                    label = f"{label}/{arch}"
                index_sets[label] = (seg.clone(), n)
            widths.setdefault((label, d), set()).add(reduce)
        del batch, params, opt, calls
        torch.cuda.empty_cache()
    order = ("sum", "min", "max")
    cases = [(label, d, tuple(r for r in order if r in reduces))
             for (label, d), reduces in widths.items()]
    return index_sets, cases, n_calls


def segment_phase(device, graph, case=segment_case):
    """Phase 5: segment_reduce against its plain version on the card, bit
    for bit, at every (index array, width, reduce) the GNN runs of phase 6
    give it (the minibatch runs' enumerated by ``sampled_index_sets`` on
    ``graph``, ``host_graph``'s graph and seconds), and on the 2^24-edge
    streams; each case run by ``case`` (``segment_case``'s arguments and
    result)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import _arch_shape_cfg, shape_batch
    from repro_torch.data import DataCursor
    from repro_torch.kernels.segment_reduce import segment_layout

    def batch_of(arch, shape_id):
        cfg = _arch_shape_cfg(get_arch(arch)[0], shape_id)
        return shape_batch(cfg, shape_id, DataCursor(0, 0), device)

    sampler, graph_s = graph
    print(f"[chip_smoke] phase 5: minibatch_lg's shared graph (232,965 "
          f"nodes, 114,615,892 edges, its in-neighbor CSR) built on the host "
          f"in {graph_s:.1f}s", flush=True)
    t0 = time.perf_counter()
    sampled_sets, sampled_cases, n_calls = sampled_index_sets(device,
                                                              sampler)
    print(f"[chip_smoke] phase 5: one training step of each minibatch_lg run "
          f"made {n_calls} segment_reduce calls: {len(sampled_cases)} cases "
          f"on {len(sampled_sets)} index arrays "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
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
        **sampled_sets,
    }
    # the sets that must hold an empty segment (the shapes' padded nodes,
    # the stream's emptied segment 1, the feature table's unsampled rows)
    with_empty = ("ogb_dst", "ogb_src", "molecule_dst", "sm_dst", "stream",
                  "minibatch_lg/nodes")
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
             ("zipf", 16, ("sum", "min", "max")), *sampled_cases)
    if "minibatch_lg/nodes" not in sampled_sets:
        fail("phase 5: no minibatch_lg run gathered the feature table")
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
            # (3.7-8.8 s a call on an H100 80GB HBM3 at 700 W): its
            # checking call is its timing
            timed[f"{label}/D={d}/{reduce}"], case_err = case(
                tag, data, ids, lay, reduce,
                plain_reps=0 if label == "zipf" else 3)
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
        library_ms=head["library_ms"], bit_exact=True, shapes=timed,
        sampled_graph_setup_s=graph_s)


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


def card_agrees_with_cpu(tag, card, cpu, gnorm_tol=FIRST_GNORM_TOL) -> float:
    """Fail unless the card's (losses, gradient norms) agree with the CPU's
    from the same weights (tolerances at ``FIRST_LOSS_TOL``; the first
    gradient norm within ``gnorm_tol``); returns the largest relative loss
    difference."""
    (losses, gnorms), (cpu_losses, cpu_gnorms) = card, cpu

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    if rel(gnorms[0], cpu_gnorms[0]) > gnorm_tol:
        fail(f"{tag}: first gradient norm {gnorms[0]} on the card, "
             f"{cpu_gnorms[0]} on the CPU")
    worst = 0.0
    for i, (a, b) in enumerate(zip(losses, cpu_losses)):
        worst = max(worst, rel(a, b))
        if rel(a, b) > (FIRST_LOSS_TOL if i == 0 else STEP_LOSS_TOL):
            fail(f"{tag}: step {i + 1} loss {a} on the card, {b} on the CPU "
                 f"(card {losses}, CPU {cpu_losses})")
    return worst


def profiled_device_ms(fn, reps: int) -> float:
    """Device-busy ms per call of ``fn``: the summed time of the CUDA
    kernels of ``reps`` calls traced by ``torch.profiler`` (one stream, so
    none overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(evt.self_device_time_total for evt in prof.key_averages()
             if evt.device_type == DeviceType.CUDA)
    if us <= 0:
        fail("torch.profiler saw no device time")
    return us / 1e3 / reps


def sampled_steps(shape_id, graph, batch_at, loss_fn, params, opt, lr):
    """``SAMPLED_STEPS`` training steps of a minibatch run from ``params``
    and ``opt``, each on a fresh subgraph (steps 1, 2, ...), then two more
    traced by the profiler. Per step: the host's sampling ms
    (``sample_subgraph`` alone), the batch's ms (sampling, the copy to the
    card and the padding, synchronised), the training step's ms and their
    sum; the profiled steps' device-busy ms; every loss."""
    import torch
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.data import DataCursor, sample_subgraph
    from repro_torch.launch.train import train_step
    sh = GNN_SHAPES[shape_id]
    sample_ms, batch_ms, step_ms, losses = [], [], [], []

    def step(batch):
        nonlocal params, opt
        params, opt, loss, _ = train_step(loss_fn, params, opt, batch, lr=lr)
        return float(loss)
    for s in range(1, SAMPLED_STEPS + 1):
        t0 = time.perf_counter()
        sample_subgraph(DataCursor(0, s), graph, sh["batch_nodes"],
                        sh["fanout"])
        t1 = time.perf_counter()
        batch = batch_at(s)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.append(step(batch))
        t3 = time.perf_counter()
        sample_ms.append((t1 - t0) * 1e3)
        batch_ms.append((t2 - t1) * 1e3)
        step_ms.append((t3 - t2) * 1e3)
    traced = iter(range(SAMPLED_STEPS + 1, SAMPLED_STEPS + 3))
    device = profiled_device_ms(
        lambda: losses.append(step(batch_at(next(traced)))), 2)
    if not all(map(math.isfinite, losses)):
        fail(f"{shape_id}: a fresh subgraph's loss is not finite: {losses}")

    def mean(xs):
        return sum(xs) / len(xs)
    return dict(sample_ms=mean(sample_ms), batch_ms=mean(batch_ms),
                train_step_ms=mean(step_ms),
                fresh_ms_per_step=mean(batch_ms) + mean(step_ms),
                device_ms_per_step=device, fresh_losses=losses)


def gnn_phase(device, graph):
    """Phase 6: the GNN family's training path on the card, counters set to
    0 just before and read just after, the minibatch runs sampling
    ``graph`` (``host_graph``'s graph and seconds); then each run but those
    of ``NOT_REPLAYED`` replayed on the CPU from host copies of its initial
    weights and batch. Returns (launches, per-run table)."""
    import torch
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.kernels import segment_reduce
    from repro_torch.launch.train import SHAPE_RUNS, shape_run, train_step

    sampler, graph_setup_s = graph
    runs, replays = {}, []
    segment_reduce.launches = 0
    for arch, shape_id, lr in SHAPE_RUNS:
        t0 = time.perf_counter()
        sampled = GNN_SHAPES[shape_id]["kind"] == "minibatch"
        cfg, batch, params, opt, loss_fn, batch_at = shape_run(
            arch, shape_id, device, graph=sampler if sampled else None)
        steps = GNN_STEPS[(arch, shape_id)]
        tag = f"{arch}/{shape_id}"
        if (arch, shape_id) not in NOT_REPLAYED:
            replays.append((tag, loss_fn, to_cpu(params, batch), steps, lr,
                            GNORM_TOL.get((arch, shape_id), FIRST_GNORM_TOL)))
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
        if not all(map(math.isfinite, losses + gnorms)):
            fail(f"{tag}: loss or gradient norm not finite: {losses} {gnorms}")
        if not losses[-1] < losses[0]:
            fail(f"{tag}: loss did not decrease: {losses}")
        warm = step_s[1:]
        nodes = batch["nodes" if sampled else "x"].shape[0]
        runs[tag] = dict(
            nodes=nodes, steps=steps, lr=lr,
            losses=losses, gnorms=gnorms, first_step_ms=step_s[0] * 1e3,
            ms_per_step=sum(warm) / len(warm) * 1e3, setup_s=setup)
        fresh = ""
        if sampled:
            timed = sampled_steps(shape_id, sampler, batch_at, loss_fn,
                                  params, opt, lr)
            runs[tag].update(timed, edges=batch["src" if arch != "graphcast"
                                                else "g2m_src"].shape[0],
                             graph_setup_s=graph_setup_s)
            fresh = (f"; {SAMPLED_STEPS} steps on fresh subgraphs: "
                     f"{timed['fresh_ms_per_step']:.1f} ms/step (host sampling "
                     f"{timed['sample_ms']:.1f} ms, batch with its copy "
                     f"{timed['batch_ms']:.1f} ms, train step "
                     f"{timed['train_step_ms']:.1f} ms), device-busy "
                     f"{timed['device_ms_per_step']:.1f} ms/step "
                     f"(profiled); the shared graph's set-up "
                     f"{graph_setup_s:.1f}s")
        launched = segment_reduce.launches - before
        if launched <= 0:
            fail(f"{tag}: segment_reduce was never launched")
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[tag].update(peak_gib=peak, segment_reduce_launches=launched)
        print(f"[chip_smoke] phase 6: {tag} ({nodes} nodes, layers "
              f"{cfg.n_layers}, d {cfg.d_hidden}, lr {lr:g}) {steps} steps, "
              f"losses {[round(x, 5) for x in losses]}; first step "
              f"{step_s[0] * 1e3:.1f} ms, then {runs[tag]['ms_per_step']:.1f} "
              f"ms/step{fresh}; peak device memory {peak:.2f} GiB; "
              f"{launched} segment_reduce launches; set-up {setup:.1f}s",
              flush=True)
        del batch, params, opt
        torch.cuda.empty_cache()
    launches = segment_reduce.launches
    for (arch, shape_id), why in NOT_REPLAYED.items():
        print(f"[chip_smoke] phase 6: {arch}/{shape_id} not replayed on the "
              f"CPU: {why}", flush=True)
    for tag, loss_fn, (params, batch), steps, lr, gnorm_tol in replays:
        t0 = time.perf_counter()
        cpu = run_steps(loss_fn, params, batch, steps, lr)
        card = (runs[tag]["losses"], runs[tag]["gnorms"])
        worst = card_agrees_with_cpu(tag, card, cpu, gnorm_tol)
        gnorm_diff = abs(card[1][0] - cpu[1][0]) / abs(cpu[1][0])
        runs[tag].update(cpu_losses=cpu[0], cpu_rel_diff=worst,
                         cpu_first_gnorm_rel_diff=gnorm_diff)
        print(f"[chip_smoke] phase 6: {tag} on the CPU from the card's "
              f"weights: losses {[round(x, 5) for x in cpu[0]]}, largest "
              f"relative difference {worst:.2e}, first gradient norm's "
              f"{gnorm_diff:.2e} ({time.perf_counter() - t0:.1f}s)",
              flush=True)
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


def lm_cut(arch: str):
    """The config of ``arch`` that phase 11 serves: its published widths,
    its depth cut to ``LM_DEPTH`` layers where the weights would not fit."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)[0]
    depth = LM_DEPTH.get(arch)
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


def lm_combine_cases(tag, calls, device, case=segment_case, phase="11"):
    """segment_reduce at every recorded (layout, width, reduce) of an MoE
    combine (or of another LM call site), bit for bit against its plain
    version and timed by ``case`` (one seeded [E, D] message stream per
    shape, its -0.0 and ±inf entries included). Returns a summary: calls,
    rows, segments, width, the kernel's, plain, library and bound ms
    (median and largest over the calls), and the largest error."""
    import statistics
    import torch
    rows = {}
    timed = []
    for lay, d, reduce in calls:
        e = lay.seg.shape[0]
        if (e, d) not in rows:
            rows.clear()
            torch.cuda.empty_cache()
            rows[(e, d)] = special_messages(e, d, seed=d, device=device)
        t, err = case(f"segment_reduce[{tag},E={e},D={d},{reduce}]",
                      rows[(e, d)], lay.seg, lay, reduce, quiet=True)
        timed.append(dict(t, max_abs_err=err))
    rows.clear()
    torch.cuda.empty_cache()
    out = dict(calls=len(timed), edges=timed[0]["edges"],
               segments=timed[0]["segments"], width=calls[0][1],
               empty_slots_max=max(t["dropped_ids"] for t in timed),
               max_abs_err=max(t["max_abs_err"] for t in timed))
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [t[key] for t in timed]
        out[key] = statistics.median(vals)
        out[key + "_max"] = max(vals)
    print(f"[chip_smoke] phase {phase}: {tag}: {out['calls']} segment_reduce "
          f"calls ({out['edges']} rows into {out['segments']} segments, D = "
          f"{out['width']}, up to {out['empty_slots_max']} rows dropped) "
          f"bit-exact; "
          f"kernel {out['ms']:.3f} ms median ({out['ms_max']:.3f} largest), "
          f"plain {out['plain_ms']:.3f}, library {out['library_ms']:.3f} with "
          f"its fill, bound {out['bound_ms']:.5f}", flush=True)
    return out


def lm_logit_ulps(got, want) -> float:
    """max |got - want| in bfloat16 ulps of the largest |want|."""
    scale = float(want.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    return float((got - want).abs().max()) / ulp


def lm_serve_case(device, arch: str, case=segment_case) -> dict:
    """One config of phase 11: seeded weights at published width (the
    depth of ``lm_cut``), a short warm-up serve, then ``serve_lm`` at
    ``LM_BATCH`` x ``LM_PROMPT`` and ``LM_DECODE_STEPS`` with the
    segment_reduce count set to 0 just before and read just after. MoE
    configs: every combine call of the prefill and of one decode step held
    against its plain version (``lm_combine_cases``); dense configs: the
    first decode step's logits against ``lm_forward``'s last position over
    the prompt and the first greedy token, within ``LM_DECODE_ULPS``."""
    import torch
    from repro_torch.data import DataCursor
    from repro_torch.kernels import segment_reduce
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer
    from repro_torch.models.common import matmul_f32

    cfg = lm_cut(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_lm_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2**30
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=DataCursor(0, 0).generator(device),
                           device=device, dtype=torch.int32)
    serve_lm(cfg, params, tokens[:1, :64], 2)            # warm-up
    segment_reduce.launches = 0
    res = serve_lm(cfg, params, tokens, LM_DECODE_STEPS)
    launches = segment_reduce.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    logits = [res["prefill_logits"], *res["decode_logits"]]
    for i, lg in enumerate(logits):
        if tuple(lg.shape) != (LM_BATCH, cfg.vocab) or lg.dtype != \
                torch.float32 or not bool(torch.isfinite(lg).all()):
            fail(f"{arch}: logits {i} {tuple(lg.shape)} {lg.dtype}, finite "
                 f"{bool(torch.isfinite(lg).all())}")
    n_moe = cfg.layer_kinds().count("moe")
    if launches != n_moe * LM_DECODE_STEPS:
        fail(f"{arch}: {launches} segment_reduce launches, not one per MoE "
             f"layer ({n_moe}) per step ({LM_DECODE_STEPS})")
    steps = LM_DECODE_STEPS - 1
    prefill_dev, decode_dev = lm_device_ms(cfg, params, tokens,
                                           res["tokens"][:, :1])
    row = dict(arch=arch, layers=cfg.n_layers, params=cfg.param_count(),
               weights_gib=weights_gib, init_s=init_s, batch=LM_BATCH,
               prompt=LM_PROMPT, decode_steps=steps,
               prefill_ms=res["prefill_s"] * 1e3,
               prefill_tokens_per_s=LM_BATCH * LM_PROMPT / res["prefill_s"],
               decode_ms_per_step=res["decode_s"] / steps * 1e3,
               decode_tokens_per_s=LM_BATCH * steps / res["decode_s"],
               prefill_device_ms=prefill_dev, decode_device_ms=decode_dev,
               prefill_device_share=prefill_dev / (res["prefill_s"] * 1e3),
               decode_device_share=decode_dev * steps / (res["decode_s"]
                                                         * 1e3),
               peak_gib=peak, segment_reduce_launches=launches,
               greedy_tokens=res["tokens"].tolist())
    first = res["tokens"][:, :1]
    del res, logits
    torch.cuda.empty_cache()
    if n_moe:
        t1 = time.perf_counter()
        with torch.no_grad():
            (_, cache), prefill_calls = record_segment_calls(
                transformer.lm_prefill, cfg, params, tokens)
            full = transformer.init_kv_cache(cfg, LM_BATCH, LM_PROMPT + 1,
                                             dtype=cache["k"].dtype,
                                             device=device)
            for key in ("k", "v"):
                full[key][:, :, :LM_PROMPT] = cache[key]
            del cache
            _, decode_calls = record_segment_calls(
                transformer.lm_decode_step, cfg, params, full, first,
                LM_PROMPT)
            del full
        row["combine_prefill"] = lm_combine_cases(f"{arch} prefill",
                                                  prefill_calls, device, case)
        row["combine_decode"] = lm_combine_cases(f"{arch} decode",
                                                 decode_calls, device, case)
        row["combine_check_s"] = time.perf_counter() - t1
    else:
        dec_cache = transformer.init_kv_cache(cfg, LM_BATCH, LM_PROMPT + 1,
                                              device=device)
        _, pc = transformer.lm_prefill(cfg, params, tokens)
        for key in ("k", "v"):
            dec_cache[key][:, :, :LM_PROMPT] = pc[key]
        del pc
        got, _ = transformer.lm_decode_step(cfg, params, dec_cache, first,
                                            LM_PROMPT)
        del dec_cache
        torch.cuda.empty_cache()
        x = transformer.lm_forward(cfg, params, torch.cat([tokens, first], 1))
        want = matmul_f32(x[:, -1], params["lm_head"])
        del x
        ulps = lm_logit_ulps(got, want)
        same_argmax = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
        if ulps > LM_DECODE_ULPS:
            fail(f"{arch}: decode's logits at position {LM_PROMPT} differ "
                 f"from the forward's by {ulps:.2f} bfloat16 ulps of the "
                 f"largest |logit| (limit {LM_DECODE_ULPS})")
        row.update(decode_vs_forward_ulps=ulps,
                   decode_vs_forward_same_argmax=same_argmax)
        if arch == "stablelm-1.6b":
            row["bf16_reduced_precision_reduction"] = lm_reduction_flag(
                cfg, params, tokens)
    del params, tokens
    torch.cuda.empty_cache()
    check = (f"decode vs forward {row['decode_vs_forward_ulps']:.2f} bf16 "
             f"ulps of the largest |logit|" if not n_moe else
             f"{row['combine_prefill']['calls']} + "
             f"{row['combine_decode']['calls']} combine calls bit-exact")
    print(f"[chip_smoke] phase 11: {arch} ({cfg.n_layers} layers, "
          f"{row['params'] / 1e9:.2f} B params, {weights_gib:.1f} GiB): init "
          f"{init_s:.1f}s; prefill {LM_BATCH}x{LM_PROMPT} "
          f"{row['prefill_ms']:.1f} ms ({row['prefill_tokens_per_s']:.0f} "
          f"tokens/s); decode {row['decode_ms_per_step']:.2f} ms/step "
          f"({row['decode_tokens_per_s']:.0f} tokens/s); device-busy "
          f"{prefill_dev:.1f} ms a prefill "
          f"({row['prefill_device_share']:.0%}), {decode_dev:.2f} ms a decode "
          f"step ({row['decode_device_share']:.0%}); peak {peak:.2f} GiB; "
          f"{launches} segment_reduce launches; {check}; greedy tokens of "
          f"row 0 {row['greedy_tokens'][0]}", flush=True)
    return row


def lm_device_ms(cfg, params, tokens, first):
    """Device-busy ms (``profiled_device_ms``) of one prefill of ``tokens``
    and of one decode step at position ``LM_PROMPT`` fed ``first``, after
    the timed serving run (its counts already read)."""
    import torch
    from repro_torch.models import transformer
    prefill = profiled_device_ms(
        lambda: transformer.lm_prefill(cfg, params, tokens), 1)
    _, pc = transformer.lm_prefill(cfg, params, tokens)
    cache = transformer.init_kv_cache(cfg, LM_BATCH, LM_PROMPT + 1,
                                      dtype=pc["k"].dtype, device=tokens.device)
    for key in ("k", "v"):
        cache[key][:, :, :LM_PROMPT] = pc[key]
    del pc
    decode = profiled_device_ms(lambda: transformer.lm_decode_step(
        cfg, params, cache, first, LM_PROMPT), 3)
    del cache
    torch.cuda.empty_cache()
    return prefill, decode


def lm_reduction_flag(cfg, params, tokens) -> dict:
    """Whether ``allow_bf16_reduced_precision_reduction`` moves the card's
    results: stablelm's prefill logits with the flag as PyTorch sets it and
    flipped, compared bit for bit (the port's bfloat16 products all return
    float32 through ``out_dtype``)."""
    import torch
    from repro_torch.models import transformer
    flags = torch.backends.cuda.matmul
    default = flags.allow_bf16_reduced_precision_reduction
    try:
        got = {}
        for value in (default, not default):
            flags.allow_bf16_reduced_precision_reduction = value
            got[value] = transformer.lm_prefill(cfg, params, tokens)[0]
    finally:
        flags.allow_bf16_reduced_precision_reduction = default
    diff = float((got[True] - got[False]).abs().max())
    out = dict(default=default, bit_equal=bool(torch.equal(got[True],
                                                           got[False])),
               max_abs_diff=diff)
    print(f"[chip_smoke] phase 11: allow_bf16_reduced_precision_reduction "
          f"(default {default}) on vs off: stablelm prefill logits "
          f"{'bit-equal' if out['bit_equal'] else f'differ by {diff}'}",
          flush=True)
    return out


def lm_card_vs_cpu(device) -> dict:
    """qwen3-moe-30b-a3b at full width, 2 layers, float32: a 2 x 64
    prefill and 4 greedy decode steps on the card (``serve_lm``), then the
    same weights and tokens (the card's greedy tokens fed back) on the CPU;
    every logit within ``LM_CPU_TOL`` of the largest |logit|. Every expert
    choice is recorded on both sides; a flip is printed with its
    probability margin."""
    import dataclasses
    import torch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(lm_cut("qwen3-moe-30b-a3b"), n_layers=2,
                              param_dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    params = transformer.init_lm_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           device=device, dtype=torch.int32)
    route, routes = transformer._route, []

    def recorded(cfg_, lp, xg):
        top_p, top_i = route(cfg_, lp, xg)
        probs = torch.softmax(transformer.matmul_f32(
            xg.reshape(-1, xg.shape[-1]).float(), lp["router"].float()), -1)
        ranked = torch.sort(probs, -1, descending=True).values
        margin = ranked[:, cfg_.top_k - 1] - ranked[:, cfg_.top_k]
        routes.append((top_i.reshape(-1, cfg_.top_k).cpu(), margin.cpu()))
        return top_p, top_i
    transformer._route = recorded
    try:
        card = serve_lm(cfg, params, tokens, 5)
        n_card = len(routes)
        host = tree_map(lambda t: t.cpu(), params)
        del params
        torch.cuda.empty_cache()
        greedy = card["tokens"].cpu()
        logits, cache = transformer.lm_prefill(cfg, host, tokens.cpu())
        cpu = [logits]
        full = transformer.init_kv_cache(cfg, 2, 64 + 5, dtype=torch.float32,
                                         device="cpu")
        for key in ("k", "v"):
            full[key][:, :, :64] = cache[key]
        for i in range(4):
            logits, full = transformer.lm_decode_step(
                cfg, host, full, greedy[:, i:i + 1], 64 + i)
            cpu.append(logits)
    finally:
        transformer._route = route
    flips = []
    for (ci, cm), (hi, _) in zip(routes[:n_card], routes[n_card:]):
        bad = (ci != hi).any(-1).nonzero().flatten().tolist()
        flips += [(t, ci[t].tolist(), hi[t].tolist(), float(cm[t]))
                  for t in bad]
    if flips:
        print(f"[chip_smoke] phase 11: expert choices that flipped between "
              f"card and CPU (token, card, CPU, card's k-th minus (k+1)-th "
              f"probability): {flips}", flush=True)
    worst = 0.0
    for i, (c, h) in enumerate(zip([card["prefill_logits"],
                                    *card["decode_logits"]], cpu)):
        rel = float((c.cpu() - h).abs().max()) / float(h.abs().max())
        worst = max(worst, rel)
        if rel > LM_CPU_TOL:
            fail(f"qwen3 float32 card vs CPU: logits {i} differ by {rel:.2e} "
                 f"of the largest (limit {LM_CPU_TOL}); {len(flips)} expert "
                 f"choices flipped")
    min_margin = min(float(m.min()) for _, m in routes)
    out = dict(rel_diff=worst, flips=len(flips), min_margin=min_margin,
               seconds=time.perf_counter() - t0)
    print(f"[chip_smoke] phase 11: qwen3-moe-30b-a3b float32, 2 layers at "
          f"full width: card and CPU logits (prefill 2x64, 4 decode steps) "
          f"agree within {worst:.2e} of the largest; {len(flips)} expert "
          f"choices flipped, smallest top-k margin {min_margin:.2e} "
          f"({out['seconds']:.1f}s)", flush=True)
    return out


def lm_phase(device, case=segment_case) -> dict:
    """Phase 11: LM serving at published widths (``LM_RUNS``, depths cut
    by ``LM_DEPTH``), each config through ``lm_serve_case``, then the card
    against the CPU (``lm_card_vs_cpu``). TF32 off. Returns the table and
    the segment_reduce launches of the serving runs."""
    import gc
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 11: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB held before the LM runs", flush=True)
    runs = {arch: lm_serve_case(device, arch, case) for arch in LM_RUNS}
    card_vs_cpu = lm_card_vs_cpu(device)
    return dict(runs=runs, card_vs_cpu=card_vs_cpu,
                launches=sum(r["segment_reduce_launches"]
                             for r in runs.values()))


def lm_train_reckoned_bytes(cfg, batch: int, seq: int) -> dict:
    """Device bytes phase 12's training step should peak at, for an
    unchunked attention: the state (bfloat16 weights and their gradients,
    float32 ``m`` and ``v``: 12 bytes a parameter), each layer's
    checkpointed input, and the larger of two backward peaks: one layer's
    recomputed attention (the saved float32 probabilities, their bfloat16
    copy, and their gradient in float32 and bfloat16: 12 bytes per
    [B, H, S, S] entry) and the loss's (the float32 logits and their
    gradient: 8 bytes per [B x S, V] entry)."""
    tokens = batch * seq
    out = dict(state=12 * cfg.param_count(),
               checkpoints=2 * cfg.n_layers * tokens * cfg.d_model,
               attention=12 * batch * cfg.n_heads * seq * seq,
               loss=8 * tokens * cfg.vocab)
    out["peak"] = (out["state"] + out["checkpoints"]
                   + max(out["attention"], out["loss"]))
    return out


def lm_train_segment_roles(cfg, calls) -> dict:
    """A training step's recorded segment_reduce calls by role, in the
    order a step makes them: each MoE layer's combine in the forward, then
    in the backward each MoE layer's dispatch gradient (the recomputation
    stops before the combine: the combine's backward keeps nothing), and
    last the embedding's gradient (into the vocabulary)."""
    n_moe = cfg.layer_kinds().count("moe")
    roles = {"combine": calls[:n_moe],
             "dispatch gradient": calls[n_moe:2 * n_moe],
             "embedding gradient": calls[2 * n_moe:]}
    return {role: c for role, c in roles.items() if c}


def lm_train_case(device, arch: str, depth, case=segment_case) -> dict:
    """One config of phase 12 (``launch.train.lm_run``: published widths,
    ``depth`` layers where given, seeded bfloat16 weights, the step-0
    batch): ``LM_TRAIN_STEPS`` train steps at ``LM_TRAIN_LR`` with the
    segment_reduce count set to 0 just before and read just after: ms per
    step, tokens/s, peak GiB against ``lm_train_reckoned_bytes``, a
    falling loss, one launch per step for the embedding's gradient and two
    per MoE layer (the combine, the dispatch's gradient). Then the step's
    loss and gradients twice, the first with
    its segment_reduce calls recorded (each held bit for bit against its
    plain version by ``case``), the second traced by the profiler
    (device-busy ms by kind): the two bit-identical, and so the
    parameters AdamW makes of each."""
    import torch
    from repro_torch.kernels import segment_reduce
    from repro_torch.launch import train
    from repro_torch.optim import adamw_update
    from repro_torch.tree import tree_leaves
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "scripts"))
    from torch_gnn_profile import trace

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, batch, params, opt, loss_fn = train.lm_run(arch, device, 0,
                                                    n_layers=depth)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b, s = batch["tokens"].shape
    reckoned = lm_train_reckoned_bytes(cfg, b, s)
    losses, step_ms = [], []
    segment_reduce.launches = 0
    for _ in range(LM_TRAIN_STEPS):
        t1 = time.perf_counter()
        params, opt, loss, gnorm = train.train_step(
            loss_fn, params, opt, batch, lr=LM_TRAIN_LR)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = segment_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"phase 12 {arch}: losses {losses} at lr {LM_TRAIN_LR} are not "
             f"finite and falling")
    n_moe = cfg.layer_kinds().count("moe")
    if launches != LM_TRAIN_STEPS * (1 + 2 * n_moe):
        fail(f"phase 12 {arch}: {launches} segment_reduce launches in "
             f"{LM_TRAIN_STEPS} steps, not 1 + 2 x {n_moe} a step")
    ms = sum(step_ms[1:]) / len(step_ms[1:])

    (loss_a, grads_a), calls = record_segment_calls(
        train.loss_and_grads, loss_fn, params, batch)
    run_b = []
    prof = trace(lambda: run_b.append(train.loss_and_grads(loss_fn, params,
                                                           batch)), 0, 1)
    loss_b, grads_b = run_b.pop()
    if not torch.equal(loss_a, loss_b):
        fail(f"phase 12 {arch}: two runs' losses {loss_a} and {loss_b}")
    for ga, gb in zip(tree_leaves(grads_a), tree_leaves(grads_b)):
        same_bits(f"phase 12 {arch} gradients of two runs", ga, gb)
    new_a = adamw_update(grads_a, opt, params, lr=LM_TRAIN_LR,
                         weight_decay=0.0)[0]
    del grads_a
    new_b = adamw_update(grads_b, opt, params, lr=LM_TRAIN_LR,
                         weight_decay=0.0)[0]
    del grads_b
    for pa, pb in zip(tree_leaves(new_a), tree_leaves(new_b)):
        same_bits(f"phase 12 {arch} parameters of two runs", pa, pb)
    del new_a, new_b, params, opt, batch
    torch.cuda.empty_cache()

    if len(calls) != 1 + 2 * n_moe or calls[-1][0].num_segments != cfg.vocab:
        fail(f"phase 12 {arch}: {len(calls)} recorded segment_reduce calls, "
             f"not 1 + 2 x {n_moe} ending with the embedding's gradient")
    roles = lm_train_segment_roles(cfg, calls)
    cases = {role: lm_combine_cases(f"{arch} {role}", role_calls, device,
                                    case, phase="12")
             for role, role_calls in roles.items()}
    del calls, roles
    torch.cuda.empty_cache()
    row = dict(arch=arch, layers=cfg.n_layers, params=cfg.param_count(),
               init_s=init_s, batch=b, seq=s, lr=LM_TRAIN_LR, losses=losses,
               step_ms=step_ms, ms_per_step=ms,
               tokens_per_s=b * s / ms * 1e3, peak_gib=peak / 2**30,
               reckoned_gib={k: v / 2**30 for k, v in reckoned.items()},
               segment_reduce_launches=launches, recompute=True,
               device_ms_per_step=prof["device_ms_per_step"],
               device_share=prof["device_ms_per_step"] / ms,
               device_ms_by_kind=prof["by_kind_ms"], segment_cases=cases,
               deterministic=True)
    kinds = ", ".join(f"{k} {v:.1f}" for k, v in prof["by_kind_ms"].items())
    print(f"[chip_smoke] phase 12: {arch} ({cfg.n_layers} layers, "
          f"{row['params'] / 1e9:.3f} B params, bfloat16, recompute on): "
          f"init {init_s:.1f}s; {b}x{s} tokens a step, losses "
          f"{[round(x, 5) for x in losses]} at lr {LM_TRAIN_LR}; "
          f"{ms:.1f} ms/step (first {step_ms[0]:.1f}), "
          f"{row['tokens_per_s']:.0f} tokens/s; peak {row['peak_gib']:.2f} "
          f"GiB (reckoned {row['reckoned_gib']['peak']:.2f}: state "
          f"{row['reckoned_gib']['state']:.2f}, checkpoints "
          f"{row['reckoned_gib']['checkpoints']:.2f}, attention "
          f"{row['reckoned_gib']['attention']:.2f}, loss "
          f"{row['reckoned_gib']['loss']:.2f}); device-busy "
          f"{row['device_ms_per_step']:.1f} ms a step "
          f"({row['device_share']:.0%}; by kind: {kinds}); {launches} "
          f"segment_reduce launches; two runs' gradients and parameters "
          f"bit-identical", flush=True)
    return row


def lm_train_card_vs_cpu(device) -> dict:
    """qwen3-moe-30b-a3b at full width, 2 layers, float32: one training
    step (``loss_and_grads``, then AdamW at ``LM_TRAIN_LR``) on a 2 x 64
    ``lm_batch`` on the card and on the CPU from the same weights and
    batch: the loss within ``FIRST_LOSS_TOL``, the gradient norm within
    ``FIRST_GNORM_TOL``, every gradient within ``LM_CPU_TOL`` of its
    leaf's largest magnitude, and every updated parameter within 1e-2 x
    lr of the CPU's, but where the two gradients' signs differ or the
    gradient is within ``LM_CPU_TOL`` of 0 (Adam's first step is about lr
    times the gradient's sign, so such an element may step either way).
    Every expert choice is recorded on both sides; a flip is printed with
    its probability margin."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import DataCursor, lm_batch
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b")[0], n_layers=2,
                              param_dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    params = transformer.init_lm_params(gen, cfg)
    batch = lm_batch(DataCursor(1, 0), 2, 64, cfg.vocab, device=device)

    def loss_fn(p, b):
        return transformer.lm_loss(cfg, p, b["tokens"], b["labels"])
    route, routes = transformer._route, {"cpu": [], "cuda": []}

    def recorded(cfg_, lp, xg):
        top_p, top_i = route(cfg_, lp, xg)
        with torch.no_grad():
            probs = torch.softmax(transformer.matmul_f32(
                xg.reshape(-1, xg.shape[-1]), lp["router"]), -1)
            ranked = torch.sort(probs, -1, descending=True).values
            margin = ranked[:, cfg_.top_k - 1] - ranked[:, cfg_.top_k]
        routes[xg.device.type].append((top_i.reshape(-1, cfg_.top_k).cpu(),
                                       margin.cpu()))
        return top_p, top_i

    def step(prm, b):
        t1 = time.perf_counter()
        loss, grads = loss_and_grads(loss_fn, prm, b)
        new, _, gnorm = adamw_update(grads, adamw_init(prm), prm,
                                     lr=LM_TRAIN_LR, weight_decay=0.0)
        return (float(loss), float(gnorm), grads, new,
                time.perf_counter() - t1)
    transformer._route = recorded
    try:
        card = step(params, batch)
        host = tree_map(lambda t: t.cpu(), params)
        del params
        torch.cuda.empty_cache()
        cpu = step(host, {k: v.cpu() for k, v in batch.items()})
        del host
    finally:
        transformer._route = route
    cpu_s = cpu[4]
    flips = []
    for (ci, cm), (hi, _) in zip(routes["cuda"], routes["cpu"]):
        bad = (ci != hi).any(-1).nonzero().flatten().tolist()
        flips += [(t, ci[t].tolist(), hi[t].tolist(), float(cm[t]))
                  for t in bad]
    if flips:
        print(f"[chip_smoke] phase 12: expert choices that flipped between "
              f"card and CPU (token, card, CPU, card's k-th minus (k+1)-th "
              f"probability): {flips}", flush=True)

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    (card_loss, card_gnorm), (cpu_loss, cpu_gnorm) = card[:2], cpu[:2]
    if rel(card_loss, cpu_loss) > FIRST_LOSS_TOL or \
            rel(card_gnorm, cpu_gnorm) > FIRST_GNORM_TOL:
        fail(f"phase 12 qwen3 float32 card vs CPU: loss {card_loss} / "
             f"{cpu_loss}, gradient norm {card_gnorm} / {cpu_gnorm}; "
             f"{len(flips)} expert choices flipped")
    worst, sign_steps = 0.0, 0
    # compared on the card, a leaf at a time
    for gc, gh, pc, ph in zip(tree_leaves(card[2]), tree_leaves(cpu[2]),
                              tree_leaves(card[3]), tree_leaves(cpu[3])):
        gh, ph = gh.to(device), ph.to(device)
        top = float(gh.abs().max())
        err = float((gc - gh).abs().max()) / max(top, 1e-30)
        worst = max(worst, err)
        if err > LM_CPU_TOL:
            fail(f"phase 12 qwen3 float32 card vs CPU: a gradient leaf "
                 f"{tuple(gh.shape)} differs by {err:.2e} of its largest "
                 f"(limit {LM_CPU_TOL}); {len(flips)} expert choices flipped")
        off = (pc - ph).abs() > 1e-2 * LM_TRAIN_LR
        sign = (gc.sign() != gh.sign()) | (gh.abs() <= LM_CPU_TOL * top)
        n_off = int((off & ~sign).sum())
        if n_off:
            fail(f"phase 12 qwen3 float32 card vs CPU: {n_off} updated "
                 f"parameters of a leaf {tuple(gh.shape)} differ by more "
                 f"than 1e-2 x lr where the gradients agree")
        sign_steps += int(off.sum())
    del card, cpu
    torch.cuda.empty_cache()
    out = dict(loss=card_loss, cpu_loss=cpu_loss, gnorm=card_gnorm,
               cpu_gnorm=cpu_gnorm, grad_rel_diff=worst,
               sign_steps=sign_steps, flips=len(flips),
               min_margin=min(float(m.min()) for _, m in routes["cuda"]),
               cpu_step_s=cpu_s, seconds=time.perf_counter() - t0)
    print(f"[chip_smoke] phase 12: qwen3-moe-30b-a3b float32, 2 layers at "
          f"full width, one step on 2x64 tokens: card and CPU losses "
          f"{card_loss:.7f} / {cpu_loss:.7f}, gradient norms "
          f"{card_gnorm:.6f} / {cpu_gnorm:.6f}, gradients within "
          f"{worst:.2e} of each leaf's "
          f"largest; {sign_steps} updated parameters stepped otherwise "
          f"(gradients of another sign or within {LM_CPU_TOL} of 0); "
          f"{len(flips)} expert choices flipped, smallest top-k margin "
          f"{out['min_margin']:.2e} ({out['seconds']:.1f}s, the CPU's step "
          f"{cpu_s:.1f}s)", flush=True)
    return out


def lm_train_phase(device, case=segment_case) -> dict:
    """Phase 12: LM training at published widths (``LM_TRAIN_RUNS``) through
    ``lm_train_case``, the card against the CPU
    (``lm_train_card_vs_cpu``), then the train CLI (``--arch stablelm-1.6b
    --reduced --steps 5``, its count set to 0 just before and read just
    after). TF32 off. Returns the table and the segment_reduce launches of
    the training runs and the CLI."""
    import gc
    import torch
    from repro_torch.kernels import segment_reduce
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    runs = {arch: lm_train_case(device, arch, depth, case)
            for arch, depth in LM_TRAIN_RUNS}
    card_vs_cpu = lm_train_card_vs_cpu(device)
    segment_reduce.launches = 0
    losses = train.main(["--arch", "stablelm-1.6b", "--reduced", "--steps",
                         "5", "--device", "cuda"])
    cli_launches = segment_reduce.launches
    if not losses[-1] < losses[0] or cli_launches != 5:
        fail(f"phase 12: train CLI stablelm-1.6b --reduced: losses {losses},"
             f" {cli_launches} segment_reduce launches (one a step)")
    print(f"[chip_smoke] phase 12: train CLI stablelm-1.6b --reduced losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    return dict(runs=runs, card_vs_cpu=card_vs_cpu, cli_losses=losses,
                launches=sum(r["segment_reduce_launches"]
                             for r in runs.values()) + cli_launches)


# phase 13: the dry run's records (40 cells x 2 meshes + 2 CommonGraph
# shapes x 2 meshes), the cells run on the card against their entry points
# and peaks, and the fault drill's schedule (tests/test_torch_runtime.py)
DRYRUN_RECORDS = 84
DRYRUN_CARD_CELLS = (("gcn-cora", "full_graph_sm"), ("pna", "molecule"),
                     ("dien", "serve_p99"))
PEAK_REL_TOL, PEAK_ABS_TOL = 0.05, 64 * 2**20
# a phase-13b cell's arguments and its step's temporaries, each apart
PART_ABS_TOL = 2**20
DRILL = dict(ckpt_every=2, fail_at={3, 6}, n_steps=8)
DRILL_REPLAYED = [2, 3, 6]
COMPRESS_ROUNDS = 5


def bytes_agree(what: str, measured: int, traced: int,
                abs_tol: int = PEAK_ABS_TOL) -> None:
    """Fail unless ``measured`` lies within ``PEAK_REL_TOL`` of ``traced``
    or ``abs_tol``, whichever is larger."""
    bound = max(PEAK_REL_TOL * traced, abs_tol)
    if abs(measured - traced) > bound:
        fail(f"{what}: measured {measured:,} bytes, traced {traced:,}: more "
             f"than {bound:,.0f} apart")


def dryrun_summary() -> dict:
    """13a: ``launch.dryrun.main(["--all", "--both-meshes",
    "--commongraph", "--json", ...])``, its per-cell lines kept out of the
    log: it must return 0 with ``DRYRUN_RECORDS`` records. Returns the
    seconds and the largest one-device peak and per-device arguments."""
    import contextlib
    import io
    import tempfile
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "dryrun.json"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as lines:
            rc = dryrun.main(["--all", "--both-meshes", "--commongraph",
                              "--json", str(path)])
        seconds = time.perf_counter() - t0
        got = json.loads(path.read_text())
    records = got["records"]
    if rc != 0 or got["failures"] or len(records) != DRYRUN_RECORDS:
        fail(f"phase 13a: dry run returned {rc} with {len(records)} records "
             f"and failures {got['failures']}; its last lines: "
             f"{lines.getvalue()[-2000:]}")
    peak = max(records, key=lambda r: r["one_device"]["peak_bytes"])
    held = max(records, key=lambda r: r["mem_per_device"]["argument_bytes"])
    out = dict(seconds=seconds, records=len(records),
               largest_one_device_peak=dict(
                   cell=peak["cell"], mesh=peak["mesh"],
                   bytes=peak["one_device"]["peak_bytes"]),
               largest_argument_bytes=dict(
                   cell=held["cell"], mesh=held["mesh"],
                   bytes=held["mem_per_device"]["argument_bytes"]))
    print(f"[chip_smoke] phase 13a: dry run --all --both-meshes "
          f"--commongraph: {len(records)} records in {seconds:.1f}s; largest "
          f"one-device peak {peak['cell']} "
          f"{peak['one_device']['peak_bytes'] / 2**40:.2f} TiB; largest "
          f"per-device arguments {held['cell']} on {held['mesh']} "
          f"{held['mem_per_device']['argument_bytes'] / 2**30:.2f} GiB",
          flush=True)
    return out


def card_cell_args(arch: str, shape: str, device):
    """The concrete arguments of a phase-13b cell on ``device``, from the
    seeded init and ``shape_batch`` functions, and the existing entry
    point's output on them: ``launch.train.train_step`` (lr 1e-3, no
    decay) for a GNN, phase 9's DIEN serve call for dien."""
    import torch
    from repro_torch.configs import get_arch, recsys_family
    from repro_torch.data import DataCursor
    from repro_torch.launch import train
    from repro_torch.models import dien
    if arch == "dien":
        cfg = get_arch("dien")[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = dien.init_dien_params(gen, cfg)
        batch = recsys_family.shape_batch(cfg, shape, DataCursor(0, 0),
                                          device)

        def entry():
            with torch.no_grad():
                return dien.dien_forward(cfg, params, batch)[0]
        return (params, batch), entry
    _, batch, params, opt, loss_fn, _ = train.shape_run(arch, shape, device, 0)

    def entry():
        p, o, loss, gnorm = train.train_step(loss_fn, params, opt, batch,
                                             lr=1e-3)
        return p, o, {"loss": loss, "grad_norm": gnorm}
    return (params, opt, batch), entry


def dryrun_card_phase(device, lm_train_row) -> dict:
    """13b: ``DRYRUN_CARD_CELLS`` built by ``configs.make_cell`` on
    ``make_local_mesh()`` and run on the card from concrete arguments of
    their meta arguments' shapes and dtypes: each output equals the
    existing entry point's bit for bit. The bytes the arguments take on the
    card (the allocator's count across ``card_cell_args``) and the step's
    temporaries (its peak above what was live before it) each lie within
    ``PEAK_REL_TOL`` or ``PART_ABS_TOL`` of the meta trace's
    ``one_device.argument_bytes`` and ``temp_bytes``. Then phase 12's
    stablelm step traced on meta against phase 12's measured peak, within
    ``PEAK_REL_TOL`` or ``PEAK_ABS_TOL``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch, make_cell
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.meta_trace import trace_step
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves
    mesh = make_local_mesh([device])
    cells = {}
    for arch, shape in DRYRUN_CARD_CELLS:
        cell = make_cell(arch, shape, mesh)
        _, trace = trace_step(cell.fn, cell.args)
        one = trace["one_device"]
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        args, entry = card_cell_args(arch, shape, device)
        torch.cuda.synchronize()
        arg_bytes = torch.cuda.memory_allocated() - held
        got = [(tuple(t.shape), t.dtype) for t in tree_leaves(args)]
        if got != [(tuple(t.shape), t.dtype) for t in tree_leaves(cell.args)]:
            fail(f"phase 13b {cell.name}: concrete arguments differ from "
                 f"the cell's")
        torch.cuda.reset_peak_memory_stats()
        out = cell.fn(*args)
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - held - arg_bytes
        bytes_agree(f"phase 13b {cell.name} arguments", arg_bytes,
                    one["argument_bytes"], PART_ABS_TOL)
        bytes_agree(f"phase 13b {cell.name} step temporaries", temp,
                    one["temp_bytes"], PART_ABS_TOL)
        want = entry()
        for a, b in zip(tree_leaves(out), tree_leaves(want), strict=True):
            same_bits(f"phase 13b {cell.name} cell vs entry point", a, b)
        cells[cell.name] = dict(measured_arguments=arg_bytes,
                                traced_arguments=one["argument_bytes"],
                                measured_temp=temp,
                                traced_temp=one["temp_bytes"],
                                measured_peak=arg_bytes + temp,
                                traced_peak=one["peak_bytes"],
                                flops=trace["flops"],
                                bytes_accessed=trace["bytes_accessed"])
        del args, out, want, entry
        torch.cuda.empty_cache()

    # phase 12's stablelm step, traced on meta
    arch = "stablelm-1.6b"
    depth = dict(LM_TRAIN_RUNS)[arch]
    cfg = get_arch(arch)[0]
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    params = init_lm_params(None, cfg, device="meta")
    tokens = torch.empty((train.LM_TRAIN_BATCH, train.LM_TRAIN_SEQ),
                         dtype=torch.int32, device="meta")

    def loss_fn(p, b):
        return lm_loss(cfg, p, b["tokens"], b["labels"])

    def step(p, o, b):
        return train.train_step(loss_fn, p, o, b, lr=LM_TRAIN_LR)
    _, trace = trace_step(step, (params, adamw_init(params),
                                 {"tokens": tokens,
                                  "labels": torch.empty_like(tokens)}))
    run12 = lm_train_row["runs"][arch]
    measured = int(run12["peak_gib"] * 2**30)
    traced = trace["one_device"]["peak_bytes"]
    bytes_agree(f"phase 13b {arch} (phase 12's step) peak", measured, traced)
    cells[f"{arch} phase 12 step"] = dict(
        measured_peak=measured, traced_peak=traced,
        reckoned_peak=int(run12["reckoned_gib"]["peak"] * 2**30))
    parts = "; ".join(
        f"{name} {c['measured_arguments'] / 2**20:.3f} / "
        f"{c['traced_arguments'] / 2**20:.3f} + "
        f"{c['measured_temp'] / 2**20:.3f} / {c['traced_temp'] / 2**20:.3f}"
        for name, c in cells.items() if "phase 12" not in name)
    names = ", ".join(n for n in cells if "phase 12" not in n)
    print(f"[chip_smoke] phase 13b: {names} on the card equal their entry "
          f"points bit for bit; arguments + step temporaries, measured / "
          f"traced MiB: {parts}; {arch} ({cfg.n_layers} layers, "
          f"{train.LM_TRAIN_BATCH}x{train.LM_TRAIN_SEQ} tokens) step: "
          f"measured in phase 12 {measured / 2**30:.2f} GiB, traced on meta "
          f"{traced / 2**30:.2f} GiB (in {trace['trace_s']:.1f}s), reckoned "
          f"{run12['reckoned_gib']['peak']:.2f} GiB "
          f"(lm_train_reckoned_bytes)", flush=True)
    return cells


def fault_phase(device) -> dict:
    """13c: gcn-cora/full_graph_sm trained ``DRILL["n_steps"]`` steps (the
    batch of each step from its (seed, step) cursor) through
    ``FaultTolerantRunner`` with checkpoints every ``DRILL["ckpt_every"]``
    steps and failures at ``DRILL["fail_at"]``: the final parameters and
    AdamW state equal a run without failures bit for bit, and the replayed
    steps are ``DRILL_REPLAYED``. Then ``COMPRESS_ROUNDS`` rounds of
    ``ef_compress_update`` over one step's gradients on the card, each
    round's gradients and residuals equal to the CPU's bit for bit."""
    import tempfile
    from repro_torch.launch import train
    from repro_torch.optim import ef_compress_update, init_residuals
    from repro_torch.runtime import CheckpointManager, FaultTolerantRunner
    from repro_torch.tree import tree_leaves, tree_map
    _, batch, params, opt, loss_fn, batch_at = train.shape_run(
        "gcn-cora", "full_graph_sm", device, 0)

    def step_fn(state, step):
        p, o, _, _ = train.train_step(loss_fn, state["params"], state["opt"],
                                      batch_at(step), lr=1e-3)
        return {"params": p, "opt": o}
    t0 = time.perf_counter()
    straight = {"params": params, "opt": opt}
    for step in range(DRILL["n_steps"]):
        straight = step_fn(straight, step)
    with tempfile.TemporaryDirectory() as tmp:
        runner = FaultTolerantRunner(CheckpointManager(tmp, device=device),
                                     ckpt_every=DRILL["ckpt_every"])
        got, replayed = runner.run({"params": params, "opt": opt}, step_fn,
                                   DRILL["n_steps"],
                                   fail_at=DRILL["fail_at"])
    if replayed != DRILL_REPLAYED:
        fail(f"phase 13c: replayed {replayed}, not {DRILL_REPLAYED}")
    for a, b in zip(tree_leaves(got), tree_leaves(straight), strict=True):
        same_bits("phase 13c drill vs a run without failures", a, b)
    drill_s = time.perf_counter() - t0

    _, grads = train.loss_and_grads(loss_fn, params, batch)
    host = tree_map(lambda t: t.cpu(), grads)
    res_card, res_host = init_residuals(grads), init_residuals(host)
    for r in range(COMPRESS_ROUNDS):
        comp_card, res_card = ef_compress_update(grads, res_card)
        comp_host, res_host = ef_compress_update(host, res_host)
        for a, b in zip(tree_leaves((comp_card, res_card)),
                        tree_leaves((comp_host, res_host)), strict=True):
            same_bits(f"phase 13c compression round {r}", a.cpu(), b)
    print(f"[chip_smoke] phase 13c: gcn-cora/full_graph_sm "
          f"{DRILL['n_steps']} steps, checkpoints every "
          f"{DRILL['ckpt_every']}, failures at {sorted(DRILL['fail_at'])}: "
          f"replayed {replayed}, parameters and AdamW state equal a run "
          f"without failures bit for bit ({drill_s:.1f}s); "
          f"{COMPRESS_ROUNDS} rounds of ef_compress_update card vs CPU bit "
          f"for bit", flush=True)
    return dict(replayed=replayed, drill_s=drill_s,
                compress_rounds=COMPRESS_ROUNDS)


def same_runs(what: str, got, want, keys) -> None:
    """fail() unless two executor runs agree: per-launch work and sweeps,
    stable fraction (where the run records one), and the result of every
    key bit for bit, on the same device."""
    if [(h.edge_work, h.sweeps) for h in got.hop_stats] != \
            [(h.edge_work, h.sweeps) for h in want.hop_stats]:
        fail(f"{what}: per-launch work and sweeps differ")
    stable = [getattr(run, "stable_milli", None) for run in (got, want)]
    if stable[0] != stable[1]:
        fail(f"{what}: stable ‰ {stable[0]} vs {stable[1]}")
    for key in keys:
        if got.results[key].device != want.results[key].device:
            fail(f"{what} {key}: result on {got.results[key].device}")
        same_bits(f"{what} {key}", got.results[key], want.results[key])


def span_s(spans: dict, name: str) -> float:
    """Total seconds of the span ``name`` in ``trace.totals()["spans"]``
    (``repro_torch.runtime.trace``); 0.0 where it never ran."""
    return spans.get(name, {}).get("total_s", 0.0)


def shard_phase(store, device) -> dict:
    """Phase 3c: lane sharding on phase 2's full-size store, the relax
    counts set to 0 just before and read just after. Per mesh (the card
    named four times; every local card where there are two or more) the
    batched executors run unmeshed (cold), meshed, and unmeshed again
    (warm), each meshed run bit for bit against the unmeshed one with
    every launch bucketed to ``lane_bucket(lanes, extent)``; the engine's
    sharded launch of the dhb lanes lane for lane (values, parents,
    iterations, edge_work, unstable); then phase 3b's load at 2^18/2^20
    through the service, meshed against unmeshed."""
    import torch
    from repro_torch.core import (
        SnapshotStore,
        optimal_campaigns,
        optimal_plan,
        run_direct_hop_batched,
        run_plan_batched,
        run_window_slide_batched,
        run_window_stream_batched,
        slide_windows,
    )
    from repro_torch.core.trigrid import _shard_snapshot_axis
    from repro_torch.graph import ALL_SEMIRINGS, make_evolving_sequence
    from repro_torch.graph.edgeset import lane_bucket
    from repro_torch.graph.engine import (
        gather_lane_states,
        incremental_additions_batched,
        incremental_additions_sharded,
        run_to_fixpoint,
    )
    from repro_torch.kernels import edge_relax, relax_multi
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_snapshot_mesh
    from repro_torch.runtime import trace

    meshes = {"4 x cuda:0": make_snapshot_mesh([device] * 4)}
    if torch.cuda.device_count() >= 2:
        meshes[f"{torch.cuda.device_count()} cards"] = make_snapshot_mesh()
    sr = ALL_SEMIRINGS["sssp"]
    snaps = store.seq.num_snapshots
    windows = slide_windows(snaps, WINDOW)
    edge_relax.launches = 0
    relax_multi.launches = 0
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    plan = optimal_plan(store)
    plan_s = time.perf_counter() - t0

    def stream(mesh):
        store.release(("AS",))
        return run_window_stream_batched(store, sr, 0, WINDOW,
                                         campaign_width="auto",
                                         track_parents=True, mesh=mesh)

    executors = {
        "dhb": lambda mesh: run_direct_hop_batched(
            store, sr, 0, track_parents=True, mesh=mesh),
        "wsb": lambda mesh: run_plan_batched(
            store, plan, sr, 0, track_parents=True, mesh=mesh),
        "slide": lambda mesh: run_window_slide_batched(
            store, sr, 0, windows=windows, track_parents=True, mesh=mesh),
        "stream": stream,
    }

    def timed_run(fn, mesh):
        # the set algebra each run does is the store.delta_keys span (the
        # stacks' set differences, window intersections inside)
        trace.reset()
        before = relax_multi.launches
        t = time.perf_counter()
        with trace.recording():
            run = fn(mesh)
        wall = time.perf_counter() - t
        spans = trace.totals()["spans"]
        return run, dict(wall_s=wall, launches=relax_multi.launches - before,
                         set_algebra_s=span_s(spans, "store.delta_keys"),
                         split_s=span_s(spans, "shard.split"),
                         replicas_s=span_s(spans, "shard.replicas"),
                         gather_s=span_s(spans, "shard.gather"))

    rows = {}
    for label, mesh in meshes.items():
        extent = mesh.shape["data"]
        for name, fn in executors.items():
            plain, cold = timed_run(fn, None)
            got, meshed = timed_run(fn, mesh)
            again, warm = timed_run(fn, None)
            what = f"phase 3c {name} on {label}"
            if got.lane_layout != [(lanes, lane_bucket(lanes, extent))
                                   for lanes, _ in got.lane_layout]:
                fail(f"{what}: lane layout {got.lane_layout}")
            if meshed["launches"] <= 0:
                fail(f"{what}: never launched relax_multi")
            # dhb's results are a list per snapshot, the others' a dict
            keys = (list(plain.results) if isinstance(plain.results, dict)
                    else list(range(len(plain.results))))
            if len(got.results) != len(keys) or (
                    isinstance(got.results, dict)
                    and list(got.results) != keys):
                fail(f"{what}: results for other keys than {keys}")
            if name == "stream":
                want = optimal_campaigns(store, windows, data_extent=extent)
                if got.campaigns != want.campaigns:
                    fail(f"{what}: campaigns {got.campaigns} != the "
                         f"planner's {want.campaigns} at extent {extent}")
                for key in keys:
                    same_bits(f"{what} {key}", got.results[key],
                              plain.results[key])
            else:
                same_runs(what, got, plain, keys)
            same_runs(f"{what} (warm unmeshed)", again, plain, keys)
            rows[f"{name} on {label}"] = dict(
                lane_layout=got.lane_layout,
                unmeshed_lane_layout=plain.lane_layout, unmeshed_cold=cold,
                meshed=meshed, unmeshed_warm=warm)
            print(f"[chip_smoke] phase 3c {name} on {label}: lanes "
                  f"{got.lane_layout} (unmeshed {plain.lane_layout}) bit "
                  f"for bit; wall s unmeshed cold {cold['wall_s']:.3f} / "
                  f"meshed {meshed['wall_s']:.3f} / unmeshed warm "
                  f"{warm['wall_s']:.3f}; relax_multi launches "
                  f"{cold['launches']} / {meshed['launches']} / "
                  f"{warm['launches']}; set algebra s "
                  f"{cold['set_algebra_s']:.3f} / "
                  f"{meshed['set_algebra_s']:.3f} / "
                  f"{warm['set_algebra_s']:.3f}; meshed split "
                  f"{meshed['split_s']:.6f} s, replicas "
                  f"{meshed['replicas_s']:.6f} s, gather "
                  f"{meshed['gather_s']:.6f} s (host)", flush=True)
        store.release(("AS",))

    # the engine alone on the dhb lanes: lane for lane, parents tracked
    mesh = meshes["4 x cuda:0"]
    window = (0, snaps - 1)
    apex = store.common_graph_view(*window)
    base = run_to_fixpoint(apex, sr, 0, track_parents=True)
    bucket = lane_bucket(snaps, mesh.shape["data"])
    stacked = store.delta_stack([(window, (i, i)) for i in range(snaps)],
                                num_lanes=bucket)
    values, parent = gather_lane_states(base.values[None], base.parent[None],
                                        [0] * bucket)
    lane_valid = torch.arange(bucket, device=device) < snaps
    want = incremental_additions_batched(
        store.num_nodes, sr, values, parent, shared_blocks=apex.blocks,
        delta_blocks=(stacked,), seed_blocks=(stacked,),
        lane_valid=lane_valid, track_parents=True)
    shards = [s._replace(shared_blocks=apex.blocks)
              for s in _shard_snapshot_axis(mesh, values, parent,
                                            (stacked,), lane_valid)]
    got = incremental_additions_sharded(store.num_nodes, sr, shards,
                                        track_parents=True)
    for field in want._fields:
        same_bits(f"phase 3c engine {field}", getattr(got, field),
                  getattr(want, field))
    gather_ms = cuda_ms(lambda: (torch.cat([s.values for s in shards]),
                                 torch.cat([s.parent for s in shards])), 10)
    print(f"[chip_smoke] phase 3c engine: {bucket} dhb lanes in "
          f"{len(shards)} shards equal the unsharded launch lane for lane "
          f"(values, parents, iterations, edge_work, unstable); gathering "
          f"values and parents of {bucket} x {store.num_nodes} takes "
          f"{gather_ms:.3f} ms on the card", flush=True)

    # the query service at phase 4's size, meshed against unmeshed
    seq = make_evolving_sequence(OTHER_NODES, OTHER_EDGES, SNAPSHOTS,
                                 CHANGES, seed=0)
    specs, schedule = serve.generate_load(SNAPSHOTS,
                                          num_clients=SERVICE_CLIENTS, seed=0)
    service = {}
    for label, m in [("unmeshed", None)] + list(meshes.items()):
        svc_store = SnapshotStore(seq, device=device)
        before = relax_multi.launches
        t = time.perf_counter()
        svc, clients = serve.run_service_load(svc_store, specs, schedule,
                                              mesh=m)
        service[label] = (svc, clients, time.perf_counter() - t,
                          relax_multi.launches - before)
    plain, plain_clients, plain_wall, plain_n = service.pop("unmeshed")
    pm = plain.metrics()
    service_row = {"unmeshed": dict(wall_s=plain_wall, launches=plain_n,
                                    turn_wall_s=pm.wall_s)}
    for label, (svc, clients, wall, n_launch) in service.items():
        m = svc.metrics()
        extent = meshes[label].shape["data"]
        for field in ("admitted", "completed", "turns", "launches", "lanes",
                      "anchor_rebuilds", "anchor_hops", "anchor_hits",
                      "edge_work", "seeded_vertex_lanes",
                      "unstable_vertex_lanes"):
            if getattr(m, field) != getattr(pm, field):
                fail(f"phase 3c service on {label}: {field} "
                     f"{getattr(m, field)} vs {getattr(pm, field)}")
        for rec, prec in zip(svc.launch_log, plain.launch_log):
            if (rec.group, rec.anchor, rec.windows, rec.clients,
                    rec.anchor_events, rec.edge_work, rec.iterations) != \
                    (prec.group, prec.anchor, prec.windows, prec.clients,
                     prec.anchor_events, prec.edge_work, prec.iterations) \
                    or rec.bucket != lane_bucket(rec.lanes, extent):
                fail(f"phase 3c service on {label}: launch record {rec} vs "
                     f"{prec}")
        for got_c, want_c in zip(clients, plain_clients):
            if list(got_c.results) != list(want_c.results):
                fail(f"phase 3c service on {label}: {got_c.name}'s windows")
            for wnd, vals in want_c.results.items():
                same_bits(f"phase 3c service on {label} {got_c.name} {wnd}",
                          got_c.results[wnd], vals)
        service_row[label] = dict(wall_s=wall, launches=n_launch,
                                  turn_wall_s=m.wall_s,
                                  buckets=[r.bucket for r in svc.launch_log])
        print(f"[chip_smoke] phase 3c service on {label}: {m.completed} "
              f"queries in {m.launches} launches (buckets "
              f"{service_row[label]['buckets']}) equal the unmeshed load bit "
              f"for bit; wall s {wall:.3f} vs unmeshed {plain_wall:.3f}; "
              f"relax_multi launches {n_launch} vs {plain_n}", flush=True)
    launches = {"edge_relax": edge_relax.launches,
                "edge_relax_multi": relax_multi.launches}
    return dict(launches=launches, plan_s=plan_s, executors=rows,
                gather_ms=gather_ms, service=service_row,
                wall_s=time.perf_counter() - t_phase)


def relax_device_ms(fn):
    """Run ``fn`` with CUDA events around every ``engine.relax_multi`` call
    (on the call's device and stream); returns ``(result, wall s, device
    ms per device, calls)``."""
    import torch
    from repro_torch.graph import engine
    events = []
    inner = engine.relax_multi

    def timed(values, *args, **kw):
        with torch.cuda.device(values.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(values, *args, **kw)
            end.record()
        events.append((str(values.device), start, end))
        return out

    engine.relax_multi = timed
    try:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    finally:
        engine.relax_multi = inner
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    per_device = {}
    for dev, start, end in events:
        per_device[dev] = per_device.get(dev, 0.0) + start.elapsed_time(end)
    return out, wall, per_device, len(events)


def commongraph_reckoned_bytes(shape: dict, bucket: int) -> int:
    """Device bytes phase 3d's unmeshed step should hold at its peak: the
    inputs (lane state [bucket, n] values and parents, the common graph
    and the stacked Δ, 12 bytes an edge), a fixpoint chunk's old and new
    values and frontiers, relax_multi's best words (4 bytes a lane and
    vertex without parents) and its lane bits (a word per 32 lanes and
    vertex)."""
    n = shape["n_nodes"]
    cells = bucket * n
    edges = 12 * (shape["cg_edges"] + bucket * shape["delta_edges"])
    return (8 * cells + edges + 2 * (4 + 1) * cells + 4 * cells
            + 4 * n * -(-bucket // 32))


def plain_by_lanes(args, kw, per: int = 4):
    """``relax_multi_ref`` on ``per`` lanes at a time (lanes are
    independent; the plain version's [lanes, E] temporaries of a 64-lane
    launch over 2^26 edges do not fit on a card), concatenated."""
    import torch
    from repro_torch.kernels.edge_relax_multi.ref import relax_multi_ref
    values, parent, frontier, blocks, allowed = args
    parts = []
    for lo in range(0, values.shape[0], per):
        rows = slice(lo, lo + per)
        sub = [b if b[0].dim() == 1 else tuple(a[rows] for a in b)
               for b in blocks]
        parts.append(relax_multi_ref(values[rows], parent[rows],
                                     frontier[rows], sub, allowed, **kw))
    return tuple(torch.cat(p) for p in zip(*parts))


def commongraph_kernel_check(inputs, n: int) -> dict:
    """Both relax kernels at the cell's shapes against their plain
    versions, bit for bit, each timed with its bytes bound: relax_multi's
    seed sweep (the Δ block, frontier = the reached vertices) and first
    fixpoint sweep (the common graph and the Δ from the seeded frontier),
    and the certificate's edge_relax sweep over the common graph (beside
    ``scatter_reduce_`` on precomputed candidates)."""
    import torch
    from repro_torch.configs.commongraph import SEMIRING
    from repro_torch.graph.stability import seed_mask
    from repro_torch.kernels import edge_relax, relax_multi
    from repro_torch.kernels.edge_relax.ref import edge_relax_ref
    kw = dict(op="min_plus", num_nodes=n, k=1, track_parents=False)
    seed_args = (inputs.values, inputs.parent,
                 seed_mask(SEMIRING, inputs.values), [tuple(inputs.delta)], 1)
    seeded = relax_multi(*seed_args, **kw)
    sweep_args = (seeded[0], seeded[1], seeded[2],
                  [tuple(inputs.cg), tuple(inputs.delta)], 1)
    out = {}
    for label, args in (("seed", seed_args), ("sweep", sweep_args)):
        got = relax_multi(*args, **kw)
        t = time.perf_counter()
        want = plain_by_lanes(args, kw)
        plain_s = time.perf_counter() - t
        for part, g, r in zip(("values", "parent", "frontier", "sweeps",
                               "work"), got, want):
            same_bits(f"phase 3d relax_multi {label} {part}", g, r)
        del got, want
        ms = cuda_ms(lambda: relax_multi(*args, **kw), 5)
        nbytes, floor, pairs = relax_bytes(args[3], args[2], False, n)
        out[label] = dict(ms=ms, plain_ms=plain_s * 1e3,
                          bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                          sector_floor_ms=floor / HBM_BYTES_PER_S * 1e3,
                          active_edges=pairs,
                          frontier=int(args[2].sum()))
    args = (inputs.values[0], *inputs.cg)
    kw = dict(op="min_plus", num_nodes=n)
    same_bits("phase 3d edge_relax certificate", edge_relax(*args, **kw),
              edge_relax_ref(*args, **kw))
    vals, src, dst, w = args
    dst_long, cand = dst.long(), vals[src.long()] + w
    best = torch.full((n + 1,), float("inf"), device=vals.device)
    # values (4n bytes) stay in the L2 at these shapes: the sector floor
    # is the bound
    nbytes = 12 * src.numel() + 8 * n
    out["certificate"] = dict(
        ms=cuda_ms(lambda: edge_relax(*args, **kw), 10),
        plain_ms=cuda_ms(lambda: edge_relax_ref(*args, **kw), 3),
        library_ms=cuda_ms(lambda: best.scatter_reduce_(0, dst_long, cand,
                                                        "amin"), 10),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, edges=src.numel())
    return out


def host_worker() -> None:
    """Start of ``main``'s spawned process for host inputs: two threads,
    so that it takes few of the cores the phases beside it run on."""
    import torch
    torch.set_num_threads(2)


def commongraph_host_edges(shape_id: str):
    """Phase 3d's input: ``shape_id``'s edges (``commongraph_edges``, seed
    0, one device) as numpy arrays, and the seconds their generation took.
    Numpy on the host (84-110 s for window_64x), no card: ``main`` runs it
    in a spawned process beside phases 2-3c."""
    from repro_torch.configs.commongraph import commongraph_edges
    t0 = time.perf_counter()
    cg, delta, lane_valid = commongraph_edges(shape_id, 1, seed=0)
    arrays = ([t.numpy() for t in cg], [t.numpy() for t in delta],
              lane_valid.numpy())
    return arrays, time.perf_counter() - t0


def host_graph(shape_id: str):
    """Phases 5 and 6's input: ``shape_id``'s host graph
    (``configs.gnn_family.shape_graph``, seed 0) and the seconds it took,
    numpy (32-38 s for minibatch_lg), built in ``main``'s spawned process
    as phase 3d's edges are."""
    from repro_torch.configs.gnn_family import shape_graph
    t0 = time.perf_counter()
    graph = shape_graph(shape_id, 0)
    return graph, time.perf_counter() - t0


def commongraph_phase(device, host_edges, shapes=COMMONGRAPH_SHAPES_RUN,
                      extra_meshes=None) -> dict:
    """Phase 3d: the paper's engine at production scale
    (``configs/commongraph.py``), each shape at its full published size,
    the relax counts set to 0 just before the first evolve step and read
    after the phase's checks. Per shape: generation and start-state
    seconds, the cell's step cold and warm (wall ms, relax_multi launches
    and device ms), peak device memory beside its reckoning, per-lane
    iterations and edge_work; the gates: every valid lane certified a
    fixpoint by one unmasked ``edge_relax`` sweep per block, no lane
    stopped by ``max_iters``, padding lanes at 0 iterations and 0.0 work,
    lanes 0, s // 2 and s - 1 equal to their from-scratch fixpoints, and
    the cell on a mesh naming the card four times (and on every card where
    there are two or more, and on ``extra_meshes``) equal to the unmeshed
    step bit for bit; then relax_multi at the cell's launch shapes against
    its plain version. ``host_edges``: {shape: ``commongraph_host_edges``
    of it}."""
    import statistics
    import torch
    from repro_torch.configs.commongraph import (
        COMMONGRAPH_SHAPES,
        SEMIRING,
        SOURCE,
        commongraph_inputs,
        lane_view,
        make_commongraph_cell,
    )
    from repro_torch.graph.edgeset import EdgeBlock
    from repro_torch.graph.engine import host_sync, run_to_fixpoint
    from repro_torch.kernels import edge_relax, relax_multi
    from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR
    from repro_torch.launch.mesh import make_snapshot_mesh
    from repro_torch.runtime import trace

    meshes = {"4 x cuda:0": make_snapshot_mesh([device] * 4)}
    if torch.cuda.device_count() >= 2:
        meshes[f"{torch.cuda.device_count()} cards"] = make_snapshot_mesh()
    meshes.update(extra_meshes or {})
    launches = {"edge_relax": 0, "edge_relax_multi": 0}
    rows = {}
    for shape_id in shapes:
        sh = COMMONGRAPH_SHAPES[shape_id]
        s, n = sh["n_snapshots"], sh["n_nodes"]
        tag = f"phase 3d {shape_id}"
        (cg, delta, lane_valid), gen_s = host_edges[shape_id]
        edges = (EdgeBlock(*map(torch.from_numpy, cg)),
                 EdgeBlock(*map(torch.from_numpy, delta)),
                 torch.from_numpy(lane_valid))
        t0 = time.perf_counter()
        inputs = host_sync(commongraph_inputs(shape_id, 1, 0, device, edges))
        start_s = time.perf_counter() - t0
        del edges
        cell = make_commongraph_cell(shape_id, max_iters=CELL_MAX_ITERS)
        sb = cell.meta["lane_bucket"]
        leaves = [inputs.values, inputs.parent, *inputs.cg, *inputs.delta,
                  inputs.lane_valid]
        metas = [cell.args[0], cell.args[1], *cell.args[2], *cell.args[3],
                 cell.args[4]]
        for got, want in zip(leaves, metas):
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f"{tag}: input {tuple(got.shape)}/{got.dtype} vs the "
                     f"cell's {tuple(want.shape)}/{want.dtype}")
        print(f"[chip_smoke] {tag}: {s} snapshots (bucket {sb}), {n} "
              f"vertices, {sh['cg_edges']} common-graph edges, "
              f"{sh['delta_edges']} Δ edges per lane; generated in "
              f"{gen_s:.1f}s (host), uploaded and start state (SSSP "
              f"fixpoint of the common graph) in {start_s:.1f}s", flush=True)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        edge_relax.launches = 0
        relax_multi.launches = 0
        t0 = time.perf_counter()
        out = host_sync(cell.fn(*inputs))
        cold_ms = (time.perf_counter() - t0) * 1e3
        step_launches = relax_multi.launches
        if step_launches <= 0:
            fail(f"{tag}: the evolve step never launched relax_multi")
        warm, warm_s, warm_dev, warm_calls = relax_device_ms(
            lambda: host_sync(cell.fn(*inputs)))
        peak = torch.cuda.max_memory_allocated()
        for i, part in ((0, "values"), (2, "iterations"), (3, "edge_work")):
            same_bits(f"{tag} warm {part} vs cold", warm[i], out[i])
        del warm
        values, _, iters, work = out
        it, wk = iters.cpu(), work.cpu()
        if it[s:].any() or wk[s:].any():
            fail(f"{tag}: padding lanes report iterations {it[s:].tolist()}"
                 f", work {wk[s:].tolist()}")
        sweeps = it[:s] - 1
        capped = [lane for lane in range(s)
                  if int(sweeps[lane]) >= CELL_MAX_ITERS]

        # the certificate: one unmasked sweep per block improves nothing
        op = KERNEL_OP_FOR[SEMIRING.name]
        bad = torch.zeros(s, dtype=torch.int64, device=device)
        for lane in range(s):
            for src, dst, w in lane_view(inputs, lane).blocks:
                best = edge_relax(values[lane], src, dst, w, op=op,
                                  num_nodes=n)
                bad[lane] += SEMIRING.strictly_better(best,
                                                      values[lane]).sum()
        bad = bad.tolist()
        if edge_relax.launches < 2 * s:
            fail(f"{tag}: the certificate launched edge_relax "
                 f"{edge_relax.launches} times for {s} lanes")
        unconverged = [lane for lane in range(s) if bad[lane]]
        if any(lane in capped for lane in unconverged):
            fail(f"{tag}: lanes {[x for x in unconverged if x in capped]} "
                 f"reached max_iters = {CELL_MAX_ITERS} without converging "
                 f"(iterations "
                 f"{[int(it[x]) for x in capped]}): the reference's config "
                 "stops them short of the fixpoint")
        if unconverged:
            fail(f"{tag}: lanes {unconverged} are not fixpoints "
                 f"({[bad[x] for x in unconverged]} vertices improve)")
        for lane in sorted({0, s // 2, s - 1}):
            scratch = run_to_fixpoint(lane_view(inputs, lane), SEMIRING,
                                      SOURCE, track_parents=False)
            same_bits(f"{tag} lane {lane} vs from scratch", values[lane],
                      scratch.values)
            del scratch

        per_lane_it = [int(x) for x in it[:s]]
        per_lane_work = [float(x) for x in wk[:s]]
        row = dict(
            snapshots=s, lane_bucket=sb, generation_s=gen_s,
            start_state_s=start_s, cold_ms=cold_ms, warm_ms=warm_s * 1e3,
            step_launches=step_launches, warm_relax_calls=warm_calls,
            warm_relax_device_ms=sum(warm_dev.values()),
            peak_gib=peak / 2**30, held_before_gib=held / 2**30,
            reckoned_gib=commongraph_reckoned_bytes(sh, sb) / 2**30,
            iterations_max=max(per_lane_it),
            iterations_median=statistics.median(per_lane_it),
            iterations=per_lane_it, edge_work=per_lane_work,
            certified_lanes=s, capped_lanes=capped)
        print(f"[chip_smoke] {tag}: evolve step cold {cold_ms:.1f} ms, warm "
              f"{warm_s * 1e3:.1f} ms; relax_multi {step_launches} launches "
              f"per step, warm {row['warm_relax_device_ms']:.3f} device ms in "
              f"{warm_calls} calls; peak {row['peak_gib']:.2f} GiB "
              f"(inputs held {row['held_before_gib']:.2f}; reckoned "
              f"{row['reckoned_gib']:.2f}); iterations per lane max "
              f"{row['iterations_max']}, median "
              f"{row['iterations_median']}; edge_work per lane max "
              f"{max(per_lane_work):.0f}, median "
              f"{statistics.median(per_lane_work):.0f}; all {s} lanes "
              f"certified, lanes {sorted({0, s // 2, s - 1})} equal from "
              f"scratch, {sb - s} padding lanes inert; card "
              f"{card_line()}", flush=True)

        # the cell on meshes, bit for bit against the unmeshed step
        row["meshes"] = {}
        for label, mesh in meshes.items():
            mcell = make_commongraph_cell(shape_id, mesh, CELL_MAX_ITERS)
            if mcell.meta["lane_bucket"] != sb:
                fail(f"{tag} on {label}: bucket {mcell.meta['lane_bucket']}"
                     f" vs {sb}")
            trace.reset()
            before = relax_multi.launches
            t0 = time.perf_counter()
            with trace.recording():
                got = host_sync(mcell.fn(*inputs))
            m_cold = (time.perf_counter() - t0) * 1e3
            m_launches = relax_multi.launches - before
            spans = trace.totals()["spans"]
            host_s = {part: span_s(spans, f"shard.{part}")
                      for part in ("split", "replicas", "gather")}
            for i, part in enumerate(("values", "parent", "iterations",
                                      "edge_work")):
                if got[i].device != out[i].device:
                    fail(f"{tag} on {label}: {part} on {got[i].device}")
                same_bits(f"{tag} on {label} {part}", got[i], out[i])
            del got
            got, m_warm, m_dev, m_calls = relax_device_ms(
                lambda: host_sync(mcell.fn(*inputs)))
            del got
            row["meshes"][label] = dict(
                cold_ms=m_cold, warm_ms=m_warm * 1e3, launches=m_launches,
                warm_relax_calls=m_calls, warm_relax_device_ms=m_dev,
                lanes_per_device=mcell.meta["lanes_per_device"],
                host_s=host_s)
            print(f"[chip_smoke] {tag} on {label}: "
                  f"{mcell.meta['lanes_per_device']} lanes per shard, "
                  f"values, parents, iterations and edge_work equal the "
                  f"unmeshed step bit for bit; cold {m_cold:.1f} ms, warm "
                  f"{m_warm * 1e3:.1f} ms; relax_multi {m_launches} launches"
                  f", warm device ms per card "
                  f"{ {d: round(v, 3) for d, v in m_dev.items()} } in "
                  f"{m_calls} calls; host split {host_s['split']:.6f} s, "
                  f"replicas {host_s['replicas']:.6f} s, gather "
                  f"{host_s['gather']:.6f} s", flush=True)
        launches["edge_relax"] += edge_relax.launches
        launches["edge_relax_multi"] += relax_multi.launches
        del out, values

        # relax_multi at the cell's launch shapes against its plain version
        row["kernel"] = commongraph_kernel_check(inputs, n)
        cert = row["kernel"].pop("certificate")
        row["edge_relax"] = cert
        print(f"[chip_smoke] {tag} edge_relax certificate shape "
              f"({cert['edges']} edges): bit-exact; kernel {cert['ms']:.3f} "
              f"ms, plain {cert['plain_ms']:.3f} ms, scatter_reduce_ "
              f"{cert['library_ms']:.3f} ms, bound {cert['bound_ms']:.3f} ms",
              flush=True)
        for label, k in row["kernel"].items():
            print(f"[chip_smoke] {tag} relax_multi {label} shape ({sb} "
                  f"lanes, {k['frontier']} frontier entries, "
                  f"{k['active_edges']} active edges): bit-exact; kernel "
                  f"{k['ms']:.3f} ms, plain {k['plain_ms']:.1f} ms (4 lanes "
                  f"at a time), bound {k['bound_ms']:.3f} ms, sector floor "
                  f"{k['sector_floor_ms']:.3f} ms", flush=True)
        rows[shape_id] = row
        del inputs
        torch.cuda.empty_cache()
    return dict(launches=launches, shapes=rows)


def service_phase() -> dict:
    """Phase 3b: the query service at full width (``serve --service``,
    ``SERVICE_CLIENTS`` clients over the main path's sequence), the relax
    counts set to 0 just before and read just after; then its checks (solo
    streams, from-scratch fixpoints with their one-sweep certificates,
    rebuilds, packing) and the calibrated planner on the same store."""
    from repro_torch.core import (
        calibrate,
        campaign_volume,
        optimal_campaigns,
        run_window_stream_batched,
        slide_windows,
    )
    from repro_torch.graph import EdgeView, run_to_fixpoint
    from repro_torch.graph.semiring import ALL_SEMIRINGS
    from repro_torch.kernels import edge_relax, relax_multi
    from repro_torch.launch import evolve, serve

    argv = ["--service", "--nodes", str(NODES), "--edges", str(EDGES),
            "--snaps", str(SNAPSHOTS), "--changes", str(CHANGES),
            "--clients", str(SERVICE_CLIENTS), "--seed", "0", "--device",
            "cuda"]
    edge_relax.launches = 0
    relax_multi.launches = 0
    t0 = time.perf_counter()
    service = serve.main(argv)
    wall = time.perf_counter() - t0
    launches = {"edge_relax": edge_relax.launches,
                "edge_relax_multi": relax_multi.launches}
    m = service.metrics()
    store = service.store
    if m.completed != m.admitted or not m.admitted:
        fail(f"phase 3b: {m.completed} of {m.admitted} queries completed")
    if launches["edge_relax_multi"] <= 0:
        fail("phase 3b: the service never launched relax_multi")
    packed = sum(len(set(r.clients)) > 1 for r in service.launch_log)
    if not packed:
        fail("phase 3b: no launch packed lanes of more than one client")
    counts = dict(
        admitted=m.admitted, completed=m.completed, turns=m.turns,
        launches=m.launches, lanes=m.lanes, padded_lanes=m.padded_lanes,
        occupancy_milli=round(1000 * m.lanes / m.launches),
        rebuilds=m.anchor_rebuilds, hops=m.anchor_hops, hits=m.anchor_hits,
        stable_milli=m.stable_fraction_milli, multi_client_launches=packed)
    timing = dict(wall_s=wall, turn_wall_s=m.wall_s,
                  queries_per_s=m.queries_per_sec,
                  p50_ms=m.latency_us(50) / 1e3,
                  p99_ms=m.latency_us(99) / 1e3)
    print(f"[chip_smoke] phase 3b: serve {argv} in {wall:.1f}s (sequence "
          f"and store included); counts {counts}; turn wall "
          f"{m.wall_s:.3f}s, {m.queries_per_sec:.2f} queries/s, p50 "
          f"{timing['p50_ms']:.1f} ms, p99 {timing['p99_ms']:.1f} ms; "
          f"launches {launches}", flush=True)

    # every client's windows against a solo stream of its spec (cold
    # anchors, the service's pins released first)
    t0 = time.perf_counter()
    specs, _ = serve.generate_load(SNAPSHOTS, num_clients=SERVICE_CLIENTS,
                                   seed=0)
    clients = {c.name: c for c in service.clients}
    for client in list(service.clients):
        service.unregister(client)
    solo_rebuilds = 0
    for spec in specs:
        client = clients[spec["name"]]
        store.release(("AS",))
        solo = run_window_stream_batched(
            store, ALL_SEMIRINGS[spec["alg"]], spec["source"],
            windows=spec["windows"], campaign_width=spec["campaign_width"])
        solo_rebuilds += solo.anchor_rebuilds
        if list(solo.results) != list(client.results):
            fail(f"phase 3b {spec['name']}: windows {list(client.results)} "
                 f"!= solo {list(solo.results)}")
        for wnd, vals in solo.results.items():
            same_bits(f"phase 3b {spec['name']} {wnd} vs solo",
                      client.results[wnd], vals)
    keys = [(s["alg"], s["source"]) for s in specs]
    shared = len(set(keys)) < len(keys)
    if shared and not m.anchor_rebuilds < solo_rebuilds:
        fail(f"phase 3b: {m.anchor_rebuilds} rebuilds, not fewer than the "
             f"solo streams' {solo_rebuilds}, with a query key shared")
    if not shared:
        print("[chip_smoke] phase 3b: the seeded plan shares no query key; "
              "rebuilds not compared", flush=True)
    # and a from-scratch fixpoint per distinct (semiring, source, window),
    # each certified by one unmasked edge_relax sweep
    checked = {}
    for spec in specs:
        sr = ALL_SEMIRINGS[spec["alg"]]
        for wnd in spec["windows"]:
            key = (spec["alg"], spec["source"], wnd)
            if key not in checked:
                view = EdgeView((store.window_block(*wnd),), store.num_nodes)
                ref = run_to_fixpoint(view, sr, spec["source"]).values
                evolve._check_fixpoint(sr, view, ref,
                                       f"phase 3b from-scratch {key}")
                checked[key] = ref
            same_bits(f"phase 3b {spec['name']} {wnd} vs from-scratch",
                      clients[spec["name"]].results[wnd], checked[key])
    print(f"[chip_smoke] phase 3b: every window equals its solo stream "
          f"and a from-scratch fixpoint ({len(checked)} distinct, each a "
          f"certified fixpoint) bit for bit; rebuilds {m.anchor_rebuilds} "
          f"vs solo {solo_rebuilds}; {packed} launches packed several "
          f"clients; checks in {time.perf_counter() - t0:.1f}s", flush=True)
    del clients, checked

    # the calibrated planner on the same store, counted as a path of its own
    sr = ALL_SEMIRINGS["sssp"]
    store.release(("AS",))
    edge_relax.launches = 0
    relax_multi.launches = 0
    t0 = time.perf_counter()
    model = calibrate(store, sr, 0, stable_milli=m.stable_fraction_milli,
                      fused_k=4)
    cal_wall = time.perf_counter() - t0
    cal_launches = {"edge_relax": edge_relax.launches,
                    "edge_relax_multi": relax_multi.launches}
    if cal_launches["edge_relax_multi"] <= 0:
        fail("phase 3b: calibrate never launched relax_multi")
    windows = slide_windows(SNAPSHOTS, 4)
    raw = optimal_campaigns(store, windows)
    raw_priced = campaign_volume(store, raw.campaigns,
                                 cost_model=model).total_edges
    cal = optimal_campaigns(store, windows, cost_model=model)
    if not cal.total_edges <= raw_priced:
        fail(f"phase 3b: calibrated plan {cal.total_edges} ns costs more "
             f"than the raw-count plan {raw_priced} ns")
    calibration = dict(per_edge_nanos=model.per_edge_nanos,
                       per_sweep_nanos=model.per_sweep_nanos,
                       stable_milli=model.stable_milli, wall_s=cal_wall,
                       launches=cal_launches, raw_widths=raw.widths,
                       calibrated_widths=cal.widths, raw_priced_ns=raw_priced,
                       calibrated_ns=cal.total_edges)
    print(f"[chip_smoke] phase 3b: calibrated {model.per_edge_nanos} "
          f"ns/edge + {model.per_sweep_nanos} ns/sweep (stable "
          f"{model.stable_milli}‰) in {cal_wall:.1f}s, launches "
          f"{cal_launches}; slide_windows({SNAPSHOTS}, 4): calibrated "
          f"plan {cal.widths} {cal.total_edges} ns <= raw-count plan "
          f"{raw.widths} {raw_priced} ns", flush=True)
    return dict(counts=counts, timing=timing, launches=launches,
                solo_rebuilds=solo_rebuilds, calibration=calibration)


def ingest_phase(device) -> dict:
    """Phase 4b: ingestion at 2^18/2^20, the relax counts set to 0 just
    before and read just after: ``evolve --ingest --calibrate`` (bfs, the
    window section, auto campaigns, fused k 4, ``--verify``), then a live
    leg shaped like ``benchmarks/ingest.py``: a spill-policy replay whose
    cuts feed a ``WindowStream`` and a ``QueryService`` client through
    ``LiveWindowFeed``s, then ``Watermark.compact``."""
    import numpy as np
    from repro_torch.core import (
        EdgeLog,
        IngestMetrics,
        LiveSequence,
        LiveWindowFeed,
        QueryService,
        SnapshotStore,
        Watermark,
        WindowStream,
        events_from_sequence,
        replay_events,
        run_window_slide_batched,
        run_window_stream_batched,
    )
    from repro_torch.graph import make_evolving_sequence
    from repro_torch.graph.semiring import ALL_SEMIRINGS
    from repro_torch.kernels import edge_relax, relax_multi
    from repro_torch.launch import evolve

    edge_relax.launches = 0
    relax_multi.launches = 0
    t0 = time.perf_counter()
    other = evolve.main(["--nodes", str(OTHER_NODES), "--edges",
                         str(OTHER_EDGES), "--snapshots", str(SNAPSHOTS),
                         "--changes", str(CHANGES), "--alg", "bfs",
                         "--ingest", "--verify", "--device", "cuda",
                         "--window", "3", "--window-batch", "--stream",
                         "--campaign-width", "auto", "--calibrate",
                         "--fused-k", "4"])
    if not other["verified"]:
        fail("phase 4b: evolve --ingest did not verify")
    check_windows("phase 4b", other["windows"], OTHER_NODES)
    if other["windows"]["stream"].plan.cost_model is None:
        fail("phase 4b: the stream's plan was not priced by the cost model")
    evolve_wall = time.perf_counter() - t0
    del other

    # the live leg: replay with spill backpressure, serving every cut
    sr = ALL_SEMIRINGS["sssp"]
    seq = make_evolving_sequence(OTHER_NODES, OTHER_EDGES, SNAPSHOTS,
                                 CHANGES, seed=0)
    events = events_from_sequence(seq)
    metrics = IngestMetrics()
    store = SnapshotStore(LiveSequence(seq.num_nodes,
                                       weight_seed=seq.weight_seed),
                          device=device)
    log = EdgeLog(seq.num_nodes, max_pending_events=INGEST_MAX_PENDING,
                  policy="spill", metrics=metrics)
    watermark = Watermark(log, store)
    stream = WindowStream(2, name="live-stream",
                          feed=LiveWindowFeed(store, width=3,
                                              name="live-stream"))
    service = QueryService(store)
    client = service.register(sr, 0, campaign_width=2, name="live-client",
                              feed=LiveWindowFeed(store, width=3,
                                                  name="live-client"))
    live = {}

    def on_cut(_idx):
        live.update(run_window_stream_batched(store, sr, 0,
                                              stream=stream).results)
        service.turn()

    t0 = time.perf_counter()
    cuts = replay_events(log, watermark, events, on_cut=on_cut)
    service.drain()
    replay_wall = time.perf_counter() - t0
    launches = {"edge_relax": edge_relax.launches,
                "edge_relax_multi": relax_multi.launches}
    if launches["edge_relax_multi"] <= 0:
        fail("phase 4b: ingestion's queries never launched relax_multi")
    for i in range(SNAPSHOTS):
        if not np.array_equal(store.seq.snapshot_keys[i],
                              seq.snapshot_keys[i]):
            fail(f"phase 4b: live snapshot {i} differs from the sequence")
    for t in range(SNAPSHOTS - 1):
        if not (np.array_equal(store.seq.additions[t], seq.additions[t])
                and np.array_equal(store.seq.deletions[t],
                                   seq.deletions[t])):
            fail(f"phase 4b: live Δ pair {t} differs from the sequence")
    ref = run_window_slide_batched(SnapshotStore(seq, device=device), sr, 0,
                                   3)
    if set(live) != set(ref.results) or set(client.results) != set(live):
        fail(f"phase 4b: live windows {sorted(live)} / "
             f"{sorted(client.results)} != {sorted(ref.results)}")
    for wnd, vals in ref.results.items():
        same_bits(f"phase 4b live stream {wnd}", live[wnd], vals)
        same_bits(f"phase 4b live service {wnd}", client.results[wnd], vals)
    service.unregister(client)
    before = store.stored_edges
    stats = watermark.compact()
    after = store.stored_edges
    if not (stats.retired > 0 and after < before):
        fail(f"phase 4b: compaction retired {stats.retired} snapshots, "
             f"stored edges {before} -> {after}")
    store.window_keys(store.first_live, SNAPSHOTS - 1)
    row = dict(events=metrics.events, spilled=metrics.spilled,
               cuts=len(cuts), applied_additions=metrics.applied_additions,
               applied_deletions=metrics.applied_deletions,
               common_shrinkage=metrics.common_shrinkage,
               windows_served=len(live), retired=stats.retired,
               freed_edges=stats.freed_edges, stored_edges=[before, after],
               evolve_wall_s=evolve_wall, replay_wall_s=replay_wall,
               launches=launches)
    print(f"[chip_smoke] phase 4b: evolve --ingest --calibrate (bfs) "
          f"verified in {evolve_wall:.1f}s; live replay of {len(events)} "
          f"events (spill at {INGEST_MAX_PENDING}: {metrics.spilled} "
          f"spilled) -> {len(cuts)} cuts in {replay_wall:.1f}s with "
          f"{len(live)} windows served live to a stream and a service "
          f"client, bit-identical to the precomputed store; compaction "
          f"retired {stats.retired} snapshots, stored edges {before} -> "
          f"{after}; launches {launches}", flush=True)
    return row


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
    # phase 3d's edges and phases 5-6's graph, numpy on the host only,
    # built in a spawned process from here on, beside phases 2-3c
    generator = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=host_worker)
    edges_made = {shape_id: generator.submit(commongraph_host_edges, shape_id)
                  for shape_id in COMMONGRAPH_SHAPES_RUN}
    graph_made = generator.submit(host_graph, "minibatch_lg")
    print("[chip_smoke] phase 1: phase 3d's edges and phases 5-6's graph "
          "are being built on the host in a spawned process", flush=True)

    # 1b. the port's graphlint over the checkout's src/repro_torch, beside
    # the spawned host work
    t0 = time.perf_counter()
    from repro_torch.analysis import Linter
    linter = Linter(root=src_dir.parent)
    findings = linter.lint([src_dir / "repro_torch"])
    if findings:
        fail("phase 1b: graphlint findings in src/repro_torch:\n"
             + "\n".join(f.render() for f in findings))
    print(f"[chip_smoke] phase 1b: graphlint rules "
          f"{','.join(r.id for r in linter.rules)} over "
          f"{linter.files_checked} files of src/repro_torch: 0 findings in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # 2. kernels vs plain
    t0 = time.perf_counter()
    keep = {}
    edge_relax_row, relax_multi_row = kernel_phase(device, keep=keep)
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 2 done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 3. main path, counters zeroed just before and read just after
    argv = ["--nodes", str(NODES), "--edges", str(EDGES), "--snapshots",
            str(SNAPSHOTS), "--changes", str(CHANGES), "--alg", "sssp",
            "--verify", "--device", "cuda", "--shard", "--window",
            str(WINDOW), "--window-batch", "--stream", "--campaign-width",
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

    # 3b. the query service and the calibrated planner, at full width
    t0 = time.perf_counter()
    service_row = service_phase()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 3b done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 3c. lane sharding on phase 2's store, counters zeroed before and read
    # after
    t0 = time.perf_counter()
    shard_row = shard_phase(keep.pop("store"), device)
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 3c: launches {shard_row['launches']}; done "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    # 3d. the CommonGraph cell at production scale, counters zeroed before
    # each shape's first step and read after its checks
    t0 = time.perf_counter()
    commongraph_row = commongraph_phase(
        device, {shape_id: made.result() for shape_id, made in
                 edges_made.items()})
    del edges_made
    print(f"[chip_smoke] phase 3d: launches {commongraph_row['launches']}; "
          f"done in {time.perf_counter() - t0:.1f}s", flush=True)

    # 4. the other four semirings at a smaller size, their auto campaigns
    # priced by the calibrated model; then sssp's priced by raw counts,
    # the plan a user gets without --calibrate
    t0 = time.perf_counter()
    for alg, calibrated in (("bfs", True), ("sswp", True), ("ssnp", True),
                            ("viterbi", True), ("sssp", False)):
        other = evolve.main(["--nodes", str(OTHER_NODES), "--edges",
                             str(OTHER_EDGES), "--snapshots", str(SNAPSHOTS),
                             "--changes", str(CHANGES), "--alg", alg,
                             "--verify", "--device", "cuda", "--window", "3",
                             "--window-batch", "--stream",
                             "--campaign-width", "auto", "--fused-k", "4"]
                            + (["--calibrate"] if calibrated else []))
        if not other["verified"]:
            fail(f"{alg} did not verify")
        check_windows(f"phase 4 {alg}", other["windows"], OTHER_NODES)
        plan = other["windows"]["stream"].plan
        if plan is None or (plan.cost_model is not None) != calibrated:
            fail(f"phase 4 {alg}: the stream made no "
                 f"{'calibrated' if calibrated else 'raw-count'} plan")
    print(f"[chip_smoke] phase 4: bfs/sswp/ssnp/viterbi (auto campaigns "
          f"priced by the calibrated model) and sssp (priced by raw counts) "
          f"verified at {OTHER_NODES} vertices, {OTHER_EDGES} edges, windows "
          f"of width 3, fused k 4, in {time.perf_counter() - t0:.1f}s",
          flush=True)
    del other

    # 4b. ingestion: evolve --ingest, then a live replay and compaction
    t0 = time.perf_counter()
    ingest_row = ingest_phase(device)
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 4b done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 5. segment_reduce vs plain
    t0 = time.perf_counter()
    graph = graph_made.result()
    generator.shutdown()
    segment_row = segment_phase(device, graph)
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 5 done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # 6. the GNN training path, counters zeroed just before and read after
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    segment_row["launches"], segment_row["gnn_runs"] = gnn_phase(device,
                                                                 graph)
    del graph
    gnn_launches = segment_row["launches"]
    print(f"[chip_smoke] phase 6: {segment_row['launches']} segment_reduce "
          f"launches over {len(train.SHAPE_RUNS)} training runs; done in "
          f"{time.perf_counter() - t0:.1f}s (TF32 off)", flush=True)

    # 7. the train CLI, then the witness at the reference's default lr
    t0 = time.perf_counter()
    # the CLI trains a small full graph: at the full-graph runs' rates
    cli_lrs = {arch: lr for arch, shape_id, lr in train.SHAPE_RUNS
               if shape_id != "minibatch_lg"}
    for arch, lr in cli_lrs.items():
        losses = train.main(["--arch", arch, "--steps", "5", "--lr", str(lr),
                             "--device", "cuda"])
        if not losses[-1] < losses[0]:
            fail(f"train CLI {arch}: loss did not decrease")
    segment_row["default_lr_witness"] = default_lr_witness(device)
    print(f"[chip_smoke] phase 7: train CLI for {len(cli_lrs)} "
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

    # 11. LM serving, the segment_reduce count zeroed before each config's
    # serving run and read after
    t0 = time.perf_counter()
    lm_row = lm_phase(device)
    segment_row["launches"] += lm_row["launches"]
    segment_row["lm_serving"] = lm_row
    segment_row["launches_by_phase"] = {
        "6 gnn": gnn_launches, "10 dien": segment_row["dien_launches"],
        "11 lm": lm_row["launches"]}
    print(f"[chip_smoke] phase 11: {lm_row['launches']} segment_reduce "
          f"launches over {len(LM_RUNS)} LM configs; done in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # 12. LM training, the segment_reduce count zeroed before each run's
    # steps and before the CLI and read after each
    t0 = time.perf_counter()
    lm_train_row = lm_train_phase(device)
    segment_row["launches"] += lm_train_row["launches"]
    segment_row["lm_training"] = lm_train_row
    segment_row["launches_by_phase"]["12 lm training"] = \
        lm_train_row["launches"]
    print(f"[chip_smoke] phase 12: {lm_train_row['launches']} segment_reduce "
          f"launches over {len(LM_TRAIN_RUNS)} LM training runs and the "
          f"train CLI; done in {time.perf_counter() - t0:.1f}s", flush=True)

    # 13. the dry run; its cells on the card; the fault drill and
    # compression; the kernels' counts zeroed before and read after
    t0 = time.perf_counter()
    segment_reduce.launches = 0
    embedding_bag.launches = 0
    dryrun_row = dict(summary=dryrun_summary(),
                      card=dryrun_card_phase(device, lm_train_row),
                      fault=fault_phase(device))
    dryrun_row["launches"] = dict(segment_reduce=segment_reduce.launches,
                                  embedding_bag=embedding_bag.launches)
    if min(dryrun_row["launches"].values()) <= 0:
        fail(f"phase 13: kernel launches {dryrun_row['launches']}")
    segment_row["launches"] += segment_reduce.launches
    segment_row["launches_by_phase"]["13 dry run"] = segment_reduce.launches
    bag_row["launches"] += embedding_bag.launches
    bag_row["dryrun_launches"] = embedding_bag.launches
    segment_row["dryrun"] = dryrun_row
    print(f"[chip_smoke] phase 13: {segment_reduce.launches} segment_reduce "
          f"and {embedding_bag.launches} embedding_bag launches; done in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # 14. records
    # each path's launches: phase 3's main path, phase 3b's service and
    # calibration, phase 3c's sharded and unsharded runs, phase 3d's
    # CommonGraph cell, phase 4b's ingestion
    by_phase = {"3": launches, "3b service": service_row["launches"],
                "3b calibrate": service_row["calibration"]["launches"],
                "3c shard": shard_row["launches"],
                "3d commongraph": commongraph_row["launches"],
                "4b": ingest_row["launches"]}
    edge_relax_row["launches"] = sum(c["edge_relax"]
                                     for c in by_phase.values())
    relax_multi_row["launches"] = sum(c["edge_relax_multi"]
                                      for c in by_phase.values())
    for row, key in ((edge_relax_row, "edge_relax"),
                     (relax_multi_row, "edge_relax_multi")):
        row["launches_by_phase"] = {p: c[key] for p, c in by_phase.items()}
    relax_multi_row["windows"] = windows_row
    relax_multi_row["service"] = service_row
    relax_multi_row["shard"] = shard_row
    relax_multi_row["commongraph"] = commongraph_row
    relax_multi_row["ingest"] = ingest_row
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [edge_relax_row, relax_multi_row,
                                  segment_row, bag_row]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
