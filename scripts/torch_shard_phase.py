#!/usr/bin/env python3
"""Lane sharding of the PyTorch port on the card: ``chip_smoke.py``'s
phase 3c alone, then the relax kernels' device time per mesh.

    PYTHONPATH=src python scripts/torch_shard_phase.py

1. phase 3c (``chip_smoke.shard_phase``) on a fresh store of the main
   path's sequence (2^22 vertices, 2^24 edges, 8 snapshots, 75,000
   changes): dhb, wsb on the optimal plan, the batched slide of 5 width-4
   windows and the auto stream, unmeshed, on a mesh naming the card four
   times and, with two or more cards, on a mesh of every card, each
   meshed run bit for bit against the unmeshed one; the engine lane for
   lane; phase 3b's load at 2^18/2^20 through the service;
2. warm (blocks cached, anchor states dropped), each executor once more
   per mesh with CUDA events around every call of the fused relax kernel
   (``engine.relax_multi``), on the device of the call: wall seconds,
   relax device ms summed over the calls (over every card they ran on),
   and the call count.

Prints the card line and, last, one JSON object; writes it to
``chiprun_out/shard_phase.json`` too. Needs a GPU.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SnapshotStore,
    optimal_plan,
    run_direct_hop_batched,
    run_plan_batched,
    run_window_slide_batched,
    run_window_stream_batched,
    slide_windows,
)
from repro_torch.graph import make_evolving_sequence  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import make_snapshot_mesh  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    _build.build()
    _build.load_library()
    card = chip_smoke.card_line()
    print(f"[shard] card: {card}; {torch.cuda.device_count()} card(s)",
          flush=True)
    t0 = time.perf_counter()
    seq = make_evolving_sequence(chip_smoke.NODES, chip_smoke.EDGES,
                                 chip_smoke.SNAPSHOTS, chip_smoke.CHANGES,
                                 seed=0)
    store = SnapshotStore(seq, device=device)
    print(f"[shard] sequence in {time.perf_counter() - t0:.1f}s", flush=True)
    phase = chip_smoke.shard_phase(store, device)

    sr = ALL_SEMIRINGS["sssp"]
    plan = optimal_plan(store)
    windows = slide_windows(chip_smoke.SNAPSHOTS, chip_smoke.WINDOW)
    meshes = {"unmeshed": None,
              "4 x cuda:0": make_snapshot_mesh([device] * 4)}
    if torch.cuda.device_count() >= 2:
        meshes[f"{torch.cuda.device_count()} cards"] = make_snapshot_mesh()

    def stream(mesh):
        store.release(("AS",))
        return run_window_stream_batched(
            store, sr, 0, chip_smoke.WINDOW, campaign_width="auto",
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
    warm = {}
    for name, fn in executors.items():
        for label, mesh in meshes.items():
            fn(mesh)   # blocks and replicas cached
            _, wall, per_card, calls = chip_smoke.relax_device_ms(
                lambda: fn(mesh))
            ms = sum(per_card.values())
            warm[f"{name} {label}"] = dict(wall_s=wall, relax_device_ms=ms,
                                           relax_calls=calls)
            print(f"[shard] warm {name} {label}: wall {wall:.4f} s, relax "
                  f"{ms:.3f} device ms in {calls} calls", flush=True)
    out = dict(card=card, cards=torch.cuda.device_count(), phase_3c=phase,
               warm=warm)
    path = ROOT / "chiprun_out" / "shard_phase.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(card)
    print(json.dumps(dict(card=card, cards=out["cards"], warm=warm,
                          phase_3c_wall_s=phase["wall_s"])))


if __name__ == "__main__":
    main()
