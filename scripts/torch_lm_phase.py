#!/usr/bin/env python3
"""LM serving on the card: ``chip_smoke.py``'s phase 11 alone.

    PYTHONPATH=src python scripts/torch_lm_phase.py [--archs qwen3-moe-30b-a3b ...]

Builds the kernels, then runs ``chip_smoke.lm_serve_case`` for each LM
config (default all five, at ``chip_smoke.LM_DEPTH``'s depths): seeded
bfloat16 weights at published widths, a ``LM_BATCH`` x ``LM_PROMPT``
prefill and greedy decode to ``LM_DECODE_STEPS`` tokens with init s,
prefill and decode ms and tokens/s, peak GiB and segment_reduce launches;
the MoE configs' combine calls bit for bit against their plain version,
timed beside ``index_add_`` and the bytes bound; the dense configs' decode
against their forward. Then, unless ``--archs`` is given,
``chip_smoke.lm_card_vs_cpu``. TF32 off.

Prints the card line and, last, one JSON object; writes it to
``chiprun_out/lm_phase.json`` too. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--archs", nargs="+", default=None,
                   help="configs to serve (default: chip_smoke.LM_RUNS, "
                        "then the card against the CPU)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    card = chip_smoke.card_line()
    print(f"[lm] card: {card}; kernels built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if args.archs is None:
        phase = chip_smoke.lm_phase(device)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        phase = {"runs": {a: chip_smoke.lm_serve_case(device, a)
                          for a in args.archs}}
    out = dict(card=card, wall_s=time.perf_counter() - t0, phase_11=phase)
    path = ROOT / "chiprun_out" / "lm_phase.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(card)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
