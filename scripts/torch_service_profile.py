#!/usr/bin/env python3
"""Where the query service and live ingestion of the PyTorch port spend
their time on the card.

    PYTHONPATH=src python scripts/torch_service_profile.py     # full size

1. service, cold: ``chip_smoke.py`` phase 3b's load (``serve.generate_load``
   with 6 clients, seed 0) over the main path's sequence (2^22 vertices,
   2^24 edges, 8 snapshots, 75,000 changes) on a fresh store, under
   ``cProfile``: wall seconds, the functions with the most own time and
   the port's functions with the most cumulative time;
2. service, warm: the clients unregistered and the anchor states dropped
   (blocks stay cached, as ``benchmarks/serve.py`` times it), the same load
   again with CUDA events around every call of the fused relax kernel
   (``engine.relax_multi``): wall seconds, device ms inside those calls,
   their share of the wall and the call count;
3. ingestion: phase 4b's live replay (2^18 vertices, 2^20 edges, spill at
   1,024 pending, no queries) under ``cProfile``.

Prints one JSON object as its last line. Needs a GPU.
"""

from __future__ import annotations

import cProfile
import json
import subprocess
import time

import torch

from repro_torch.core import (
    EdgeLog,
    LiveSequence,
    SnapshotStore,
    Watermark,
    events_from_sequence,
    replay_events,
)
from repro_torch.graph import engine, make_evolving_sequence
from repro_torch.kernels import _build
from repro_torch.launch.serve import generate_load, run_service_load
from torch_device_share import host_profile

NODES, EDGES, SNAPSHOTS, CHANGES = 1 << 22, 1 << 24, 8, 75_000
INGEST_NODES, INGEST_EDGES = 1 << 18, 1 << 20
CLIENTS = 6


def profiled(label: str, fn) -> dict:
    """Wall seconds and host profile of one call of ``fn``."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    row = {"wall_s": time.perf_counter() - t0, **host_profile(prof)}
    print(f"[host_profile] {label}: wall {row['wall_s']:.3f} s", flush=True)
    for kind in ("own", "port_cum"):
        for r in row[kind]:
            print(f"[host_profile]   {kind:8s} {r['own_s']:9.3f} own "
                  f"{r['cum_s']:9.3f} cum {r['calls']:7d} calls  {r['fn']}",
                  flush=True)
    return row


def drop_clients(service) -> None:
    for client in list(service.clients):
        service.unregister(client)


def warm_service(store, specs, schedule) -> dict:
    """The load again with blocks cached and anchors cold, CUDA events
    around every relax_multi call."""
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
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        service, _ = run_service_load(store, specs, schedule)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.relax_multi = relax_multi
    device_ms = sum(s.elapsed_time(e) for s, e in events)
    m = service.metrics()
    drop_clients(service)
    row = {"wall_s": wall, "turn_wall_s": m.wall_s,
           "relax_device_ms": device_ms,
           "device_share": device_ms / 1e3 / wall,
           "relax_calls": len(events), "launches": m.launches,
           "queries_per_s": m.queries_per_sec,
           "p50_ms": m.latency_us(50) / 1e3, "p99_ms": m.latency_us(99) / 1e3}
    print(f"[service] warm: wall {wall:.3f} s, relax kernels "
          f"{device_ms:.1f} ms on the device ({100 * row['device_share']:.2f}"
          f"% of wall) in {len(events)} calls; {m.queries_per_sec:.2f} "
          f"queries/s, p50 {row['p50_ms']:.1f} ms, p99 {row['p99_ms']:.1f} ms",
          flush=True)
    return row


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    _build.load_library()
    seq = make_evolving_sequence(NODES, EDGES, SNAPSHOTS, CHANGES, seed=0)
    store = SnapshotStore(seq, device="cuda")
    specs, schedule = generate_load(SNAPSHOTS, num_clients=CLIENTS, seed=0)
    services = []
    cold = profiled("service cold", lambda: services.append(
        run_service_load(store, specs, schedule)[0]))
    drop_clients(services.pop())
    store.release(("AS",))
    warm = warm_service(store, specs, schedule)
    del store, seq
    torch.cuda.empty_cache()

    iseq = make_evolving_sequence(INGEST_NODES, INGEST_EDGES, SNAPSHOTS,
                                  CHANGES, seed=0)
    events = events_from_sequence(iseq)
    live = SnapshotStore(LiveSequence(iseq.num_nodes,
                                      weight_seed=iseq.weight_seed),
                         device="cuda")
    log = EdgeLog(iseq.num_nodes, max_pending_events=1024, policy="spill")
    ingest = profiled("ingest replay", lambda: replay_events(
        log, Watermark(log, live), events))
    ingest["events"] = len(events)
    print(json.dumps({"card": card, "service_cold": cold,
                      "service_warm": warm, "ingest": ingest}))


if __name__ == "__main__":
    main()
