"""Example 2 on the PyTorch port: many sliding-window queries, one batched
launch each (counterpart of ``examples/multi_query_window.py``).

A width-4 window slides over a 10-snapshot evolving sequence. CommonGraph
turns every window into an addition-only hop from the windows' common
super-window apex, so the hops are independent: the batched window
executor (``repro_torch.core.window``) stacks them as lanes of ONE relax
launch instead of re-running each window in turn. All five algorithms run
over the same windows and share one store. On ``cuda`` (the default) the
sweeps run in the port's CUDA kernels; ``--device cpu`` runs their plain
versions.

    PYTHONPATH=src python examples/torch_multi_query_window.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (
    SnapshotStore,
    run_window_slide,
    run_window_slide_batched,
    slide_windows,
)
from repro_torch.graph import EdgeView, make_evolving_sequence, run_to_fixpoint
from repro_torch.graph.semiring import ALL_SEMIRINGS

WIDTH = 4

p = argparse.ArgumentParser()
p.add_argument("--device", default="cuda")
p.add_argument("--nodes", type=int, default=10_000)
p.add_argument("--edges", type=int, default=100_000)
p.add_argument("--snapshots", type=int, default=10)
p.add_argument("--changes", type=int, default=4_000)
args = p.parse_args()

seq = make_evolving_sequence(num_nodes=args.nodes, num_edges=args.edges,
                             num_snapshots=args.snapshots,
                             batch_changes=args.changes, seed=1)
store = SnapshotStore(seq, device=torch.device(args.device))
windows = slide_windows(seq.num_snapshots, WIDTH)

for alg, sr in ALL_SEMIRINGS.items():
    t0 = time.perf_counter()
    bat = run_window_slide_batched(store, sr, source=0, width=WIDTH)
    dt = time.perf_counter() - t0
    # the sequential slide gives the same bits, one hop at a time
    seq_run = run_window_slide(store, sr, source=0, width=WIDTH)
    for wnd in windows:
        np.testing.assert_array_equal(bat.results[wnd].cpu().numpy(),
                                      seq_run.results[wnd].cpu().numpy())
    # spot-check the first and last window against from-scratch
    for wnd in (windows[0], windows[-1]):
        ref = run_to_fixpoint(
            EdgeView((store.window_block(*wnd),), store.num_nodes),
            sr, 0).values
        np.testing.assert_allclose(bat.results[wnd].cpu().numpy(),
                                   ref.cpu().numpy(), rtol=1e-6)
    reached = int(np.isfinite(bat.results[windows[-1]].cpu().numpy()).sum())
    print(f"{alg:8s}: {len(windows)} width-{WIDTH} windows in one batched "
          f"launch, {dt:5.2f}s (anchor T{bat.anchor}), "
          f"{reached:,} vertices reached ✓")
