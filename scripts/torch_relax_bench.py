"""Time the relax kernels of one or more source trees on the card, at the
cases of ``chip_smoke.py``'s phase 2, one process per tree.

    python scripts/torch_relax_bench.py [--evolve] [TREE ...]

Each argument is a checkout (default: this one). The trees run in the order
given (parent, change, change, parent compares two on one card), each in a
child process that puts the tree's ``src`` first on the path and runs this
checkout's ``chip_smoke.kernel_phase``: every tree meets the same cases,
each held bit for bit against that tree's plain version: ``edge_relax`` on
the snapshot block, ``relax_multi`` at the ks, dh and dhb shapes, and the
main path's own sweeps (``chip_smoke.main_path_sweeps``: the dh and dhb
incremental fixpoints, the batched window slide's launch, the stream's
anchor hop and the ks from-scratch fixpoint, one call at a time). Each call is timed as back-to-back ms, device µs (calls queued
behind a sleep, so the host never holds the card back) and the wrapper's
host µs per call, beside the bound and the sector floor. With ``--evolve``
each tree then runs ``scripts/torch_device_share.py``'s warm pass at full
size (after one cold pass that builds every block): per mode the wall
seconds, the relax calls' device ms and count, and the SHA-256 of the
mode's results, to show that two trees agree bit for bit. Beside the five
modes it runs ``chip_smoke.py`` phase 3's window section: the sequential
slide (``slide``), the batched slide (``slide_batch``) and the stream of
campaigns (``stream``, its anchor states dropped first so each run pays
its rebuild and hops). Prints a table
per case and tree and writes every number to
``chiprun_out/relax_bench.json``. Needs one card.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "relax_bench.json"


KERNEL_KINDS = ("prepare", "scatter", "finish", "fill", "decode")


def kernel_us(fn, reps: int) -> dict:
    """Device µs per call of each kind of kernel ``fn`` launches, from
    ``torch.profiler`` (``kernel_us_<kind>``; PyTorch's own fills and
    copies under ``kernel_us_other``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        kind = next((k for k in KERNEL_KINDS if f"{k}_kernel" in ev.key),
                    "other")
        out[f"kernel_us_{kind}"] = out.get(f"kernel_us_{kind}", 0.0) + us / reps
    return out


def bench_timing(fn, reps: int) -> dict:
    """``chip_smoke.relax_timing`` plus device µs and host µs per call, and
    the device µs by kind of kernel."""
    import chip_smoke
    return dict(ms=chip_smoke.cuda_ms(fn, reps),
                device_us=chip_smoke.device_ms(fn, reps) * 1e3,
                host_us=chip_smoke.host_us(fn, reps), **kernel_us(fn, reps))


def evolve_pass() -> dict:
    """``torch_device_share``'s cold pass (unprofiled) then its warm pass,
    on chip_smoke's main-path sequence, sssp."""
    import time

    import torch

    import chip_smoke
    import torch_device_share as share
    from repro_torch.core import (
        SnapshotStore,
        run_window_slide,
        run_window_slide_batched,
        run_window_stream_batched,
    )
    from repro_torch.graph import ALL_SEMIRINGS, make_evolving_sequence
    seq = make_evolving_sequence(chip_smoke.NODES, chip_smoke.EDGES,
                                 chip_smoke.SNAPSHOTS, chip_smoke.CHANGES)
    store = SnapshotStore(seq, device="cuda")
    sr = ALL_SEMIRINGS["sssp"]
    modes = share.mode_runs(store, sr)

    def stream():
        store.release(("AS",))
        return run_window_stream_batched(
            store, sr, 0, chip_smoke.WINDOW,
            campaign_width=chip_smoke.CAMPAIGN_WIDTH)
    modes.update(
        slide=lambda: run_window_slide(store, sr, 0, chip_smoke.WINDOW),
        slide_batch=lambda: run_window_slide_batched(store, sr, 0,
                                                     chip_smoke.WINDOW),
        stream=stream)
    cold = {}
    for name, run in modes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        cold[name] = time.perf_counter() - t0
    del modes["plan"]
    return dict(cold_wall_s=cold, warm=share.warm_pass(modes))


def child(tree: str, evolve: bool) -> None:
    """Run the cases against ``tree``'s kernels; print one JSON line."""
    sys.path[:0] = [str(pathlib.Path(tree).resolve() / "src"), str(ROOT),
                    str(ROOT / "scripts")]
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        chip_smoke.fail("needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    er, rm = chip_smoke.kernel_phase(device, bench_timing)
    torch.cuda.empty_cache()
    for case in rm["main_path"].values():
        del case["per_call"][5:-5]      # keep the first and last five calls
    result = {"card": chip_smoke.card_line(), "edge_relax": er,
              "relax_multi": rm}
    if evolve:
        result["evolve"] = evolve_pass()
    print(json.dumps(result))


def main(argv: list[str]) -> None:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2:] == ["--evolve"])
        return
    evolve = argv[:1] == ["--evolve"]
    runs = []
    for tree in argv[evolve:] or ["."]:
        env = dict(os.environ, PYTHONPATH="")
        proc = subprocess.run(
            [sys.executable, __file__, "--child", tree, *argv[:evolve]],
            env=env, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            sys.exit(f"{tree}: exit {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(result, tree=tree))

    def cases(run):
        yield "edge_relax snapshot block", run["edge_relax"]
        for label, row in run["relax_multi"]["shapes"].items():
            yield f"relax_multi {label} shape", row
        for label, row in run["relax_multi"]["main_path"].items():
            yield f"relax_multi main path {label} ({row['calls']} calls)", row

    print("case | device us by kernel kind per run")
    for i, (case, _) in enumerate(cases(runs[0])):
        cols = []
        for r in runs:
            row = list(cases(r))[i][1]
            cols.append(", ".join(f"{key[10:]} {row[key]:.1f}"
                                  for key in sorted(row)
                                  if key.startswith("kernel_us_")))
        print(f"{case} | " + " | ".join(cols))
    print("case | kernel ms (device us, host us) per run: "
          + " | ".join(r["tree"] for r in runs)
          + " | plain ms | library ms | bound ms | sector floor ms")
    for i, (case, first) in enumerate(cases(runs[0])):
        cols = []
        for r in runs:
            row = list(cases(r))[i][1]
            cols.append(f"{row['ms']:.4f} ({row['device_us']:.1f}, "
                        f"{row['host_us']:.1f})")
        lib = first.get("library_ms")
        print(f"{case} | " + " | ".join(cols)
              + f" | {first.get('plain_ms', float('nan')):.3f} | "
              + (f"{lib:.4f}" if lib is not None else "none")
              + f" | {first['bound_ms']:.4f} | "
              f"{first['sector_floor_ms']:.4f}")
    if "evolve" in runs[0]:
        for mode in runs[0]["evolve"]["warm"]:
            cols = [f"wall {r['evolve']['warm'][mode]['wall_s']:.3f} s, "
                    f"relax {r['evolve']['warm'][mode]['relax_device_ms']:.1f}"
                    f" ms in {r['evolve']['warm'][mode]['relax_calls']} calls,"
                    f" sha {r['evolve']['warm'][mode]['results_sha256'][:16]}"
                    for r in runs]
            print(f"evolve {mode} | " + " | ".join(cols))
    print("card:", runs[0]["card"])
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
