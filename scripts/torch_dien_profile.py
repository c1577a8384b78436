#!/usr/bin/env python3
"""Where DIEN's serving calls and training step spend their time on the card.

    PYTHONPATH=src python scripts/torch_dien_profile.py         # needs a GPU

At DIEN's full width (``configs/dien.py``: 2^23 items, embed 18, seq 100,
GRU 108), for each run of ``chip_smoke.py``'s DIEN phases — ``dien_forward``
at serve_p99 (512 rows) and serve_bulk (262,144 rows),
``dien_score_candidates`` at retrieval_cand (1 user x 1,000,448
candidates), and a ``train_step`` at ``launch.train.DIEN_TRAIN_BATCH`` rows —
it warms up, then traces with ``torch.profiler`` (CPU and CUDA activities)
and prints per run the wall ms per call, the device-busy ms per call and
its share of the wall time, the device ms by kind of kernel (embedding_bag,
segment_reduce, sort, gather/index, GEMM, elementwise and reductions,
other) and the top kernels (``torch_gnn_profile.trace``).

The last line is one JSON object with all of it, also written to
``chiprun_out/dien_profile.json``. TF32 is off, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import pathlib

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.recsys_family import shape_batch
from repro_torch.data import DataCursor
from repro_torch.kernels import _build
from repro_torch.launch.train import dien_run, train_step
from repro_torch.models import dien
from torch_gnn_profile import card_line, report, trace

# (run, warm-up calls, traced calls)
RUNS = (("serve_p99", 2, 3), ("serve_bulk", 1, 1), ("retrieval_cand", 1, 1),
        ("train_batch", 2, 2))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    _build.load_library()
    result = {"card": card_line(), "runs": {}}
    cfg = get_arch("dien")[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = dien.init_dien_params(gen, cfg)
    for shape_id, warm, traced in RUNS:
        if shape_id == "train_batch":
            del params
            torch.cuda.empty_cache()
            _, batch, params, opt, loss_fn = dien_run(shape_id, device)

            def step():
                nonlocal params, opt
                params, opt, loss, _ = train_step(loss_fn, params, opt, batch,
                                                  lr=1e-3)
                return float(loss)
        else:
            batch = shape_batch(cfg, shape_id, DataCursor(0, 0), device)
            score = (dien.dien_score_candidates if shape_id == "retrieval_cand"
                     else lambda c, p, b: dien.dien_forward(c, p, b)[0])

            @torch.no_grad()
            def step():
                return score(cfg, params, batch).sum().item()
        r = trace(step, warm, traced)
        result["runs"][shape_id] = r
        report(shape_id, r, "dien_profile")
        del batch
        torch.cuda.empty_cache()
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "dien_profile.json").write_text(json.dumps(result, indent=1))
    print(result["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
