#!/usr/bin/env python3
"""Where each mode of the PyTorch port spends its time: host profile of a
cold run, and wall time vs relax-kernel device time of a warm one.

    PYTHONPATH=src python scripts/torch_device_share.py            # full size
    PYTHONPATH=src python scripts/torch_device_share.py --nodes 16384 \
        --edges 131072 --snapshots 5 --changes 2000

Builds one evolving sequence and store on the GPU. Then:

1. cold pass: runs the modes once, in the order ``launch/evolve.py`` runs
   them (ks, dh, dhb, the plan DP, ws, wsb), each under ``cProfile``, and
   prints per mode its wall seconds, the functions with the most own time
   and the port's functions with the most cumulative time (device waits
   show up under ``host_sync``);
2. warm pass: with every block cached, runs each mode again while CUDA
   events bracket every call of the fused relax kernel
   (``engine.relax_multi``), and prints the wall seconds, the device
   milliseconds inside the relax kernel calls, their share of the wall
   time, the call count — the share the host leaves the card idle is the
   rest — and the SHA-256 of the mode's results (``results_sha256``), so
   that two trees can be shown to agree bit for bit.

The last line is one JSON object with both. Needs a GPU; the profiler's
own overhead inflates the cold pass's wall seconds somewhat.
"""

from __future__ import annotations

import argparse
import cProfile
import hashlib
import json
import pathlib
import pstats
import subprocess
import time

import torch

from repro_torch.core import (
    SnapshotStore,
    optimal_plan,
    run_direct_hop,
    run_direct_hop_batched,
    run_kickstarter_stream,
    run_plan,
    run_plan_batched,
)
from repro_torch.graph import engine, make_evolving_sequence
from repro_torch.graph.semiring import ALL_SEMIRINGS
from repro_torch.kernels import _build

TOP_OWN, TOP_PORT = 8, 12


def host_profile(prof: cProfile.Profile) -> dict:
    """The functions with the most own time, and the port's functions
    with the most cumulative time, of one profiled run."""
    stats = pstats.Stats(prof).stats

    def row(key, val):
        path, line, name = key
        _, calls, own, cum, _ = val
        return {"fn": f"{pathlib.Path(path).name}:{line}({name})",
                "calls": calls, "own_s": round(own, 4), "cum_s": round(cum, 4)}

    by_own = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)
    port = [kv for kv in stats.items() if "repro_torch" in kv[0][0]]
    by_cum = sorted(port, key=lambda kv: kv[1][3], reverse=True)
    return {"own": [row(*kv) for kv in by_own[:TOP_OWN]],
            "port_cum": [row(*kv) for kv in by_cum[:TOP_PORT]]}


def mode_runs(store, sr) -> dict:
    """The modes in the order ``launch/evolve.py`` runs them, each a
    function returning its result (the plan DP stores its plan for ws and
    wsb and returns it)."""
    plan = []

    def optimal():
        plan.append(optimal_plan(store))
        return plan[-1]
    return {
        "ks": lambda: run_kickstarter_stream(store, sr, 0),
        "dh": lambda: run_direct_hop(store, sr, 0),
        "dhb": lambda: run_direct_hop_batched(store, sr, 0),
        "plan": optimal,
        "ws": lambda: run_plan(store, plan[-1], sr, 0),
        "wsb": lambda: run_plan_batched(store, plan[-1], sr, 0),
    }


def results_sha256(out) -> str:
    """SHA-256 of a mode's per-snapshot values, in snapshot order (two
    trees agree bit for bit where these agree)."""
    if isinstance(out, tuple):          # run_kickstarter_stream
        values = out[0]
    elif isinstance(out.results, dict):  # run_plan, run_plan_batched
        values = [out.results[i] for i in sorted(out.results)]
    else:                               # run_direct_hop(_batched)
        values = out.results
    h = hashlib.sha256()
    for v in values:
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def warm_pass(modes: dict) -> dict:
    """Run each mode (blocks already cached) with CUDA events around every
    call of the fused relax kernel (``engine.relax_multi``): per mode the
    wall seconds, the device ms inside those calls, their share of the
    wall, the call count and the results' SHA-256."""
    events = []
    relax_multi = engine.relax_multi

    def timed_relax_multi(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = relax_multi(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    engine.relax_multi = timed_relax_multi
    rows = {}
    try:
        for name, run in modes.items():
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            device_ms = sum(s.elapsed_time(e) for s, e in events)
            rows[name] = {"wall_s": wall, "relax_device_ms": device_ms,
                          "device_share": device_ms / 1e3 / wall,
                          "relax_calls": len(events),
                          "results_sha256": results_sha256(out)}
            print(f"[device_share] {name}: wall {wall:.3f} s, relax kernels "
                  f"{device_ms:.1f} ms on the device "
                  f"({100 * device_ms / 1e3 / wall:.1f}% of wall) in "
                  f"{len(events)} calls; results sha256 "
                  f"{rows[name]['results_sha256'][:16]}", flush=True)
    finally:
        engine.relax_multi = relax_multi
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=1 << 22)
    p.add_argument("--edges", type=int, default=1 << 24)
    p.add_argument("--snapshots", type=int, default=8)
    p.add_argument("--changes", type=int, default=75_000)
    p.add_argument("--alg", default="sssp", choices=list(ALL_SEMIRINGS))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    _build.load_library()
    sr = ALL_SEMIRINGS[args.alg]
    seq = make_evolving_sequence(args.nodes, args.edges, args.snapshots,
                                 args.changes)
    store = SnapshotStore(seq, device="cuda")
    modes = mode_runs(store, sr)
    cold = {}
    for name, run in modes.items():  # cold pass, profiled; warms the cache
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        run()
        torch.cuda.synchronize()
        prof.disable()
        cold[name] = {"wall_s": time.perf_counter() - t0,
                      **host_profile(prof)}
        print(f"[host_profile] {name}: cold wall {cold[name]['wall_s']:.3f} s",
              flush=True)
        for kind in ("own", "port_cum"):
            for r in cold[name][kind]:
                print(f"[host_profile]   {kind:8s} {r['own_s']:9.3f} own "
                      f"{r['cum_s']:9.3f} cum {r['calls']:7d} calls  "
                      f"{r['fn']}", flush=True)
    del modes["plan"]
    rows = warm_pass(modes)
    print(json.dumps({"card": card, "nodes": args.nodes, "edges": args.edges,
                      "snapshots": args.snapshots, "alg": args.alg,
                      "cold": cold, "modes": rows}))


if __name__ == "__main__":
    main()
