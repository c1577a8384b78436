"""Serving entry points of the PyTorch port (counterpart of
``repro.launch.serve``): the evolving-graph query service (``--service``)
and the LM prefill + greedy decode loop (``--arch``).

A deterministic seeded load generator simulates concurrent clients issuing
heterogeneous window queries (mixed semirings, sources, window extents,
campaign widths) as an open-loop arrival schedule and drives a
:class:`~repro_torch.core.service.QueryService` one scheduler turn per
tick:

    PYTHONPATH=src python -m repro_torch.launch.serve --service \\
        --nodes 400 --edges 3000 --snaps 6 --changes 200 \\
        --clients 4 --seed 7 --device cpu

``--device`` picks where edge blocks and query state live (default
``cuda``, where every packed launch runs the port's CUDA relax kernel;
``cpu`` runs its plain PyTorch version).

``--arch <lm>`` serves an LM (``models/transformer.py``) with seeded
weights: a ``--batch`` x ``--prompt-len`` prefill, then greedy decode to
``--decode-steps`` tokens per row (``serve_lm``), printing the reference's
two ``[serve]`` lines:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --reduced --device cpu

On ``cuda`` the MoE configs' combine runs the ``segment_reduce`` kernel.
"""

from __future__ import annotations

import argparse
import random
import time

import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.core.service import QueryService
from repro_torch.core.snapshots import SnapshotStore
from repro_torch.core.window import slide_windows
from repro_torch.data import DataCursor
from repro_torch.graph.engine import host_sync
from repro_torch.graph.generators import make_evolving_sequence
from repro_torch.graph.semiring import ALL_SEMIRINGS
from repro_torch.models.transformer import (
    init_kv_cache,
    init_lm_params,
    lm_decode_step,
    lm_prefill,
)


def generate_load(num_snapshots, *, num_clients=6, seed=0,
                  algs=("sssp", "bfs"), num_sources=2, width_range=(2, 3),
                  campaign_widths=(1, 2, 3), bursts=3):
    """Deterministic seeded open-loop load plan for the query service.

    Draws per-client query specs from small pools (``algs`` semirings ×
    ``num_sources`` sources, small so clients collide on query keys and
    share anchors), a sliding-window plan of a seeded width from a seeded
    start, and a campaign width; then cuts each client's windows into
    ``bursts`` arrival chunks, later window starts arriving in later
    bursts. Returns ``(specs, schedule)``: one dict per client
    (``name``/``alg``/``source``/``campaign_width``/``windows``) and a list
    of ticks, each a list of ``(client_index, windows)`` bursts. Everything
    comes from ``random.Random(seed)``: same seed, same plan.
    """
    rng = random.Random(seed)
    specs = []
    for idx in range(num_clients):
        alg = algs[rng.randrange(len(algs))]
        source = rng.randrange(num_sources)
        width = rng.randint(*width_range)
        start = rng.randint(0, max(0, num_snapshots - width - 2))
        windows = slide_windows(num_snapshots, width, start=start)
        specs.append({
            "name": f"load-{seed}-{idx}",
            "alg": alg,
            "source": source,
            "campaign_width": campaign_widths[
                rng.randrange(len(campaign_widths))],
            "windows": windows,
        })
    order = sorted(range(num_clients),
                   key=lambda i: (specs[i]["windows"][0][0], i))
    schedule = [[] for _ in range(bursts)]
    for rank, idx in enumerate(order):
        windows = specs[idx]["windows"]
        first = min(rank * bursts // max(1, num_clients), bursts - 1)
        cut = max(1, -(-len(windows) // (bursts - first)))
        for chunk_no, lo in enumerate(range(0, len(windows), cut)):
            tick = min(first + chunk_no, bursts - 1)
            schedule[tick].append((idx, windows[lo:lo + cut]))
    return specs, schedule


def run_service_load(store, specs, schedule, *, lane_budget=8,
                     turn_budget=None, mesh=None):
    """Drive a :class:`QueryService` with an open-loop load plan: register
    one client per spec, then per tick admit that tick's bursts and run ONE
    turn, then drain. ``mesh`` splits every launch's lanes over a ``data``
    mesh (launch/mesh.py). Returns ``(service, clients)``."""
    service = QueryService(store, lane_budget=lane_budget,
                           turn_budget=turn_budget, mesh=mesh)
    clients = [service.register(ALL_SEMIRINGS[s["alg"]], s["source"],
                                campaign_width=s["campaign_width"],
                                name=s["name"])
               for s in specs]
    for tick in schedule:
        for idx, windows in tick:
            service.submit(clients[idx], windows)
        service.turn()
    service.drain()
    return service, clients


def _serve_graph(args):
    """CLI path for ``--service``: seeded load over a generated sequence;
    returns the service (results on its clients, metrics and launch log on
    the service)."""
    device = torch.device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.load_library()
    store = SnapshotStore(make_evolving_sequence(
        args.nodes, args.edges, args.snaps, args.changes, seed=args.seed),
        device=device)
    specs, schedule = generate_load(args.snaps, num_clients=args.clients,
                                    seed=args.seed)
    t0 = time.perf_counter()
    service, _clients = run_service_load(store, specs, schedule,
                                         lane_budget=args.lane_budget,
                                         turn_budget=args.turn_budget)
    wall = time.perf_counter() - t0
    m = service.metrics()
    print(f"[serve] {args.clients} clients over {args.snaps} snapshots: "
          f"{m.completed}/{m.admitted} queries in {m.turns} turns / "
          f"{m.launches} launches ({wall:.2f}s)")
    print(f"[serve] occupancy {m.batch_occupancy:.2f} lanes/launch "
          f"({m.padded_lanes} padded), anchors {m.anchor_rebuilds} rebuilds "
          f"+ {m.anchor_hops} hops + {m.anchor_hits} hits")
    print(f"[serve] {m.queries_per_sec:.1f} queries/s, "
          f"p50 {m.latency_us(50) / 1e3:.1f}ms, "
          f"p99 {m.latency_us(99) / 1e3:.1f}ms")
    return service


def serve_lm(cfg, params, tokens: torch.Tensor, decode_steps: int) -> dict:
    """The reference's ``--arch`` loop: prefill ``tokens`` [B, P], copy the
    prefill cache into one of ``P + decode_steps`` positions, take the
    greedy token, then ``decode_steps - 1`` decode steps, each feeding its
    greedy token to the next. Returns ``tokens`` (int32 [B,
    decode_steps]), the float32 ``prefill_logits`` [B, V] and each decode
    step's ``decode_logits``, and the walls ``prefill_s`` and ``decode_s``
    (the card synchronized at the end of each)."""
    b, p = tokens.shape
    device = tokens.device
    t0 = time.perf_counter()
    prefill_logits, pcache = lm_prefill(cfg, params, tokens)
    cache = init_kv_cache(cfg, b, p + decode_steps, dtype=pcache["k"].dtype,
                          device=device)
    cache["k"][:, :, :p] = pcache["k"]
    cache["v"][:, :, :p] = pcache["v"]
    del pcache
    next_tok = torch.argmax(prefill_logits, -1).to(torch.int32)[:, None]
    host_sync(next_tok)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_tokens, decode_logits = [next_tok], []
    for i in range(decode_steps - 1):
        logits, cache = lm_decode_step(cfg, params, cache, next_tok, p + i)
        decode_logits.append(logits)
        next_tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out_tokens.append(next_tok)
    out = torch.cat(out_tokens, dim=1)
    host_sync(out)
    return {"tokens": out, "prefill_logits": prefill_logits,
            "decode_logits": decode_logits, "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0}


def _serve_lm(args):
    """CLI path for ``--arch``: seeded weights (a generator seeded with
    ``--seed``) and prompt tokens (``DataCursor(seed, 0)``'s generator)
    on ``--device``, then ``serve_lm``. Returns the greedy tokens."""
    cfg, family = (reduced_config(args.arch) if args.reduced
                   else get_arch(args.arch))
    if family != "lm":
        raise SystemExit(f"--arch {args.arch} is not an LM; serve.py serves "
                         "LMs")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs an NVIDIA GPU; pass "
                             "--device cpu to run the plain versions")
        from repro_torch.kernels import _build
        _build.load_library()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_lm_params(gen, cfg)
    tok_gen = DataCursor(args.seed, 0).generator(device)
    toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                         generator=tok_gen, device=device, dtype=torch.int32)
    res = serve_lm(cfg, params, toks, args.decode_steps)
    out = res["tokens"]
    dt = res["prefill_s"] + res["decode_s"]
    print(f"[serve] {args.arch}: prefill {args.batch}x{args.prompt_len} + "
          f"{args.decode_steps} decode steps in {dt:.2f}s")
    print("[serve] sampled token ids:", out[0].tolist())
    for logits in [res["prefill_logits"], *res["decode_logits"]]:
        if bool(torch.isnan(logits).any()):
            raise AssertionError("NaN logits")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--service", action="store_true",
                   help="serve seeded graph query load (core/service.py)")
    p.add_argument("--arch", help="LM architecture to serve (prefill+decode)")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--decode-steps", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nodes", type=int, default=400)
    p.add_argument("--edges", type=int, default=3000)
    p.add_argument("--snaps", type=int, default=6)
    p.add_argument("--changes", type=int, default=200)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--lane-budget", type=int, default=8)
    p.add_argument("--turn-budget", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="device for edge blocks and query state, or the "
                        "LM's weights and cache (default cuda; cpu runs the "
                        "plain PyTorch kernel versions)")
    args = p.parse_args(argv)

    if args.service:
        return _serve_graph(args)
    if args.arch:
        return _serve_lm(args)
    raise SystemExit("pass --service (graph query load) or --arch <lm>")


if __name__ == "__main__":
    main()
