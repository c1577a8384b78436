#!/usr/bin/env python3
"""The dry run and the model cells on the card: ``chip_smoke.py``'s phase
13 alone.

    PYTHONPATH=src python scripts/torch_dryrun_phase.py

Builds the kernels, then measures the peak of one step of phase 12's
stablelm run (``launch.train.lm_run``: 24 layers, bfloat16, 4 x 4,096
tokens, the allocator's peak from before the set-up through the step, as
phase 12 takes it), frees it, and runs phase 13 with the kernels' counts
set to 0 just before and read just after: the dry run of every cell on
both production meshes and the CommonGraph cells (13a), three cells on
the card against their entry points and their traced peaks, and the
stablelm step's traced peak against the measured one (13b), the fault
drill and compression card against CPU (13c). Prints the card line and,
last, one JSON object; writes it to ``chiprun_out/dryrun_phase.json``
too. Needs a GPU.
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
from repro_torch.kernels import _build, embedding_bag, segment_reduce  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def stablelm_step_peak(device) -> dict:
    """``lm_train_phase``'s row for stablelm as 13b reads it: the peak of
    its set-up and one step, beside ``lm_train_reckoned_bytes``."""
    arch = "stablelm-1.6b"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, batch, params, opt, loss_fn = train.lm_run(
        arch, device, 0, n_layers=dict(chip_smoke.LM_TRAIN_RUNS)[arch])
    params, opt, loss, _ = train.train_step(loss_fn, params, opt, batch,
                                            lr=chip_smoke.LM_TRAIN_LR)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    b, s = batch["tokens"].shape
    reckoned = chip_smoke.lm_train_reckoned_bytes(cfg, b, s)
    del params, opt, batch, loss
    torch.cuda.empty_cache()
    return {"runs": {arch: dict(peak_gib=peak / 2**30, reckoned_gib={
        k: v / 2**30 for k, v in reckoned.items()})}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    card = chip_smoke.card_line()
    print(f"[dryrun_phase] card: {card}; kernels built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lm_train_row = stablelm_step_peak(device)
    print(f"[dryrun_phase] stablelm set-up and one step in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    segment_reduce.launches = 0
    embedding_bag.launches = 0
    phase = dict(summary=chip_smoke.dryrun_summary(),
                 card=chip_smoke.dryrun_card_phase(device, lm_train_row),
                 fault=chip_smoke.fault_phase(device),
                 launches=dict(segment_reduce=segment_reduce.launches,
                               embedding_bag=embedding_bag.launches))
    out = dict(card=card, phase_13_s=time.perf_counter() - t0,
               phase_13=phase)
    path = ROOT / "chiprun_out" / "dryrun_phase.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(card)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
