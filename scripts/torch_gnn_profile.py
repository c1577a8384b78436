#!/usr/bin/env python3
"""Where a GNN training step of the PyTorch port spends its time on the card.

    PYTHONPATH=src python scripts/torch_gnn_profile.py          # needs a GPU

For each full-width run of ``launch.train.SHAPE_RUNS`` (gcn-cora on
ogb_products, pna on molecule, meshgraphnet and graphcast on
full_graph_sm; the runs of ``chip_smoke.py``'s GNN phase), it sets the run
up with ``launch.train.shape_run``, takes two warm-up steps
through ``launch.train.train_step``, then traces two more with
``torch.profiler`` (CPU and CUDA activities) and prints per run:

- the wall ms per step (host clock, synchronised),
- the device-busy ms per step (the sum of every CUDA kernel's time, which
  run one at a time on the one stream) and its share of the wall time —
  the rest is time the host leaves the card idle,
- the device ms per step by kind of kernel (segment_reduce, sort,
  gather/index, GEMM, elementwise and reductions, other), and the top
  kernels by device time.

The last line is one JSON object with all of it, also written to
``chiprun_out/gnn_profile.json``. TF32 is off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import _build
from repro_torch.launch.train import SHAPE_RUNS, shape_run, train_step

WARM, TRACED, TOP = 2, 2, 8
KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("segment_reduce", ("segment_reduce_kernel",)),
    ("sort", ("radix", "Radix", "sort", "Sort", "searchsorted")),
    ("gather/index", ("index", "Index", "gather", "Gather", "scatter",
                      "Scatter")),
    ("gemm", ("gemm", "Gemm", "sm90_xmma", "cutlass", "nvjet")),
    ("elementwise/reduce", ("elementwise", "Elementwise", "reduce",
                            "Reduce", "vectorized", "unrolled", "cat",
                            "CatArray", "fill")),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile_run(arch: str, shape_id: str, lr: float, device) -> dict:
    _, batch, params, opt, loss_fn = shape_run(arch, shape_id, device)

    def step():
        nonlocal params, opt
        params, opt, loss, _ = train_step(loss_fn, params, opt, batch, lr=lr)
        return float(loss)

    for _ in range(WARM):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / TRACED
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / TRACED
    busy = sum(kernels.values())
    by_kind = {}
    for name, ms in kernels.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(wall_ms_per_step=wall_ms, device_ms_per_step=busy,
                device_share=busy / wall_ms if wall_ms else 0.0,
                by_kind_ms=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                top_kernels_ms=[(name[:90], ms) for name, ms in top])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _build.load_library()
    result = {"card": card_line(), "runs": {}}
    for arch, shape_id, lr in SHAPE_RUNS:
        r = profile_run(arch, shape_id, lr, device)
        tag = f"{arch}/{shape_id}"
        result["runs"][tag] = r
        kinds = ", ".join(f"{k} {v:.2f}" for k, v in r["by_kind_ms"].items())
        print(f"[gnn_profile] {tag}: wall {r['wall_ms_per_step']:.2f} ms/step, "
              f"device busy {r['device_ms_per_step']:.2f} ms/step "
              f"({100 * r['device_share']:.1f}%); by kind (ms/step): {kinds}",
              flush=True)
        for name, ms in r["top_kernels_ms"]:
            print(f"[gnn_profile]   {ms:9.3f} ms  {name}")
        torch.cuda.empty_cache()
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "gnn_profile.json").write_text(json.dumps(result, indent=1))
    print(result["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
