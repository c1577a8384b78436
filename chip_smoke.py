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
   Prints kernel, plain and library times and the bytes bound per shape;
3. main path at full size: the port's evolve driver, all five modes, sssp,
   ``--verify`` (every mode equals from-scratch on every snapshot, each
   from-scratch result is a fixpoint), with the launch counters set to 0
   just before and read just after;
4. the other four semirings through all five modes with ``--verify`` at
   2^18 vertices and 2^20 edges;
5. segment_reduce vs plain, on the card, bit for bit (sums included), on
   every index array and width that phase 6's runs give it: gcn-cora/
   ogb_products by dst and by src at D in {1, 16, 47} (degrees, messages,
   gather backwards), pna/molecule by dst (D = 1 and 75, sum/min/max), by
   src (75) and by graph id (1), meshgraphnet/full_graph_sm by dst, src
   and clamped dst (128), graphcast/full_graph_sm's g2m, mesh and m2g
   edge sets by dst and by src (512); and sum, min and max on a 2^24-edge
   random message stream. -0.0 and ±inf entries everywhere; empty
   segments and sentinel ids where the arrays have them. Prints kernel,
   plain, library (``index_add_``, ``scatter_reduce_``) and bound ms per
   case;
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
8. the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Without a GPU, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
NODES, EDGES, SNAPSHOTS, CHANGES = 1 << 22, 1 << 24, 8, 75_000
OTHER_NODES, OTHER_EDGES = 1 << 18, 1 << 20
STREAM_SEGMENTS, STREAM_EDGES = 1 << 20, 1 << 24
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


def relax_bytes(blocks, lanes: int, active: int, track: bool, n: int) -> int:
    """Bytes a relax_multi sweep must move: src and dst of every edge of
    every lane, w of the active edges only, and the lane states (values,
    frontier, parents when tracked) read once and written once."""
    edges = sum(b.n_padded * (lanes if b.src.dim() == 2 else 1)
                for b in blocks)
    state = lanes * n * (4 + 1 + (4 if track else 0))
    return 8 * edges + 4 * active + 2 * state


def kernel_phase(device):
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
    er_ms = cuda_ms(lambda: edge_relax(*args, **kw), 20)
    er_plain = cuda_ms(lambda: edge_relax_ref(*args, **kw), 5)
    er_lib = cuda_ms(lambda: out.scatter_reduce_(0, dst_long, cand, "amin"),
                     20)
    er_bytes = 12 * snap.n_padded + 4 * n + 4 * n
    edge_relax_row = dict(
        name="edge_relax", route="cuda",
        source="src/repro_torch/kernels/csrc/relax.cu",
        replaces="src/repro/kernels/edge_relax/edge_relax.py:93",
        max_abs_err=err, ms=er_ms, plain_ms=er_plain,
        bound_ms=er_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=er_lib, bit_exact=True)
    print(f"[chip_smoke] edge_relax: 5 semirings bit-exact; kernel "
          f"{er_ms:.3f} ms, plain {er_plain:.3f} ms, scatter_reduce_ "
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
        ms = cuda_ms(lambda: relax_multi(values, parent, frontier, blocks,
                                         None, **kw), 10)
        plain = cuda_ms(lambda: relax_multi_ref(values, parent, frontier,
                                                blocks, None, **kw), 3)
        active = int(relax_multi(values, parent, frontier, blocks, None,
                                 **kw)[4].sum())
        nbytes = relax_bytes(blks, lanes, active, track, n)
        timed[label] = dict(ms=ms, plain_ms=plain,
                            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                            lanes=lanes, track_parents=track,
                            active_edges=active)
        print(f"[chip_smoke] relax_multi timed ({label} shape: sssp, k=1, "
              f"lanes={lanes}, track_parents={track}, {active} active "
              f"edges): kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
              f"{timed[label]['bound_ms']:.3f} ms", flush=True)
    dh = timed["dh"]
    relax_multi_row = dict(
        name="edge_relax_multi", route="cuda",
        source="src/repro_torch/kernels/csrc/relax.cu",
        replaces="src/repro/kernels/edge_relax_multi/edge_relax_multi.py:131",
        max_abs_err=err, ms=dh["ms"], plain_ms=dh["plain_ms"],
        bound_ms=dh["bound_ms"], bound_by="bytes", library_ms=None,
        bit_exact=True, shapes=timed)
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


def segment_phase(device):
    """Phase 5: segment_reduce against its plain version on the card, bit
    for bit, at every (index array, width, reduce) the GNN runs of phase 6
    give it, and on a 2^24-edge stream; timed per case."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import _arch_shape_cfg, shape_batch
    from repro_torch.data import DataCursor
    from repro_torch.kernels import segment_reduce
    from repro_torch.kernels.segment_reduce import (
        segment_layout,
        segment_reduce_ref,
    )

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
             ("stream", 75, ("sum", "min", "max")))
    layouts = {k: segment_layout(ids, n) for k, (ids, n) in index_sets.items()}
    torch.cuda.synchronize()
    print(f"[chip_smoke] phase 5: ogb_products {n_big} nodes, "
          f"{big['dst'].shape[0]} edges; molecule {mol['dst'].shape[0]} "
          f"edges; full_graph_sm {sm['dst'].shape[0]} edges, graphcast mesh "
          f"{n_mesh} nodes, {gc['mesh_dst'].shape[0]} edges; stream "
          f"{STREAM_EDGES} edges into {STREAM_SEGMENTS} segments (inputs and "
          f"layouts {time.perf_counter() - t0:.1f}s)", flush=True)
    del big, mol, sm, gc

    err, timed = 0.0, {}
    for label, d, reduces in cases:
        ids, n = index_sets[label]
        lay = layouts[label]
        counts = lay.offsets[1:] - lay.offsets[:-1]
        empty = int((counts == 0).sum())
        dropped = ids.shape[0] - int(lay.offsets[-1])
        if empty == 0 and label in with_empty:
            fail(f"segment_reduce[{label}]: no empty segment")
        data = special_messages(ids.shape[0], d, seed=d, device=device)
        seg_long = lay.seg.long()
        for reduce in reduces:
            tag = f"segment_reduce[{label},D={d},{reduce}]"
            kw = dict(num_segments=n, reduce=reduce, layout=lay)
            got = segment_reduce(data, ids, **kw)
            want = segment_reduce_ref(data, ids, **kw)
            err = max(err, same_bits(tag, got, want))
            del got, want
            ms = cuda_ms(lambda: segment_reduce(data, ids, **kw), 10)
            plain = cuda_ms(lambda: segment_reduce_ref(data, ids, **kw), 3)
            out = torch.zeros((n + 1, d), device=device)
            if reduce == "sum":
                lib = cuda_ms(lambda: out.index_add_(0, lay.seg, data), 10)
            else:
                index = seg_long[:, None].expand(-1, d)
                lib = cuda_ms(lambda: out.scatter_reduce_(
                    0, index, data, "amin" if reduce == "min" else "amax"),
                    10)
            del out
            bound = segment_bytes(lay, d) / HBM_BYTES_PER_S * 1e3
            timed[f"{label}/D={d}/{reduce}"] = dict(
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                edges=ids.shape[0], segments=n, empty_segments=empty,
                dropped_ids=dropped)
            print(f"[chip_smoke] {tag} bit-exact ({empty} empty segments, "
                  f"{dropped} dropped ids): kernel {ms:.3f} ms, plain "
                  f"{plain:.3f} ms, library {lib:.3f} ms, bound "
                  f"{bound:.3f} ms", flush=True)
        del data, seg_long
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
    from repro_torch.kernels import _build, edge_relax, relax_multi
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
            "--verify", "--device", "cuda"]
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
    walls = {m: round(s, 3) for m, s in summary["wall_s"].items()}
    print(f"[chip_smoke] phase 3: main path {argv} verified in {wall:.1f}s; "
          f"per-mode wall s {walls}; launches {launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    del summary
    torch.cuda.empty_cache()

    # 4. the other four semirings at a smaller size
    t0 = time.perf_counter()
    for alg in ("bfs", "sswp", "ssnp", "viterbi"):
        other = evolve.main(["--nodes", str(OTHER_NODES), "--edges",
                             str(OTHER_EDGES), "--snapshots", str(SNAPSHOTS),
                             "--changes", str(CHANGES), "--alg", alg,
                             "--verify", "--device", "cuda"])
        if not other["verified"]:
            fail(f"{alg} did not verify")
    print(f"[chip_smoke] phase 4: bfs/sswp/ssnp/viterbi verified at "
          f"{OTHER_NODES} vertices, {OTHER_EDGES} edges in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

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

    # 8. records
    edge_relax_row["launches"] = launches["edge_relax"]
    relax_multi_row["launches"] = launches["edge_relax_multi"]
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [edge_relax_row, relax_multi_row,
                                  segment_row]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
