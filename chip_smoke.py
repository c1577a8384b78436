"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero (nothing is caught):

1. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   and print the build seconds and the card's name and power limit;
2. kernels vs plain, on the card, on the blocks the main path gives them:
   a ``SnapshotStore`` of the main path's sequence (2^22 vertices, 2^24
   edges, 8 snapshots, 75,000 changes), its snapshot block (ks, and the
   ``--verify`` sweep), its common-graph block plus one snapshot's Δ block
   (dh, ws) and plus the stacked Δ of all 8 snapshots (dhb, wsb's first
   level). All five semirings, k in {1, 4}, parents tracked and not,
   lanes in {1, 8}, each call with an ``allowed`` cap on one lane and an
   early-exit lane; every output must equal the plain version bit for bit.
   Prints kernel, plain and library times and the bytes bound per shape;
3. main path at full size: the port's evolve driver, all five modes, sssp,
   ``--verify`` (every mode equals from-scratch on every snapshot, each
   from-scratch result is a fixpoint), with the launch counters set to 0
   just before and read just after;
4. the other four semirings through all five modes with ``--verify`` at
   2^18 vertices and 2^20 edges;
5. the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Without a GPU, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
NODES, EDGES, SNAPSHOTS, CHANGES = 1 << 22, 1 << 24, 8, 75_000
OTHER_NODES, OTHER_EDGES = 1 << 18, 1 << 20


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
    from repro_torch.launch import evolve

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

    # 5. records
    edge_relax_row["launches"] = launches["edge_relax"]
    relax_multi_row["launches"] = launches["edge_relax_multi"]
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [edge_relax_row, relax_multi_row]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
