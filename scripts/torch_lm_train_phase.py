#!/usr/bin/env python3
"""LM training on the card: ``chip_smoke.py``'s phase 12 alone.

    PYTHONPATH=src python scripts/torch_lm_train_phase.py [--archs stablelm-1.6b ...]

Builds the kernels, then runs ``chip_smoke.lm_train_case`` for each config
of ``chip_smoke.LM_TRAIN_RUNS`` (default both: stablelm-1.6b at 24 layers,
qwen3-moe-30b-a3b at 2 of 48; published widths, bfloat16 weights, AdamW
with float32 state, 4 x 4,096 tokens): ms/step, tokens/s, peak GiB beside
its reckoning, device-busy ms by kernel kind, segment_reduce launches,
every segment_reduce call of a step bit for bit against its plain version
beside ``index_add_`` and the bytes bound, and two runs of a step
bit-identical. Then, unless ``--archs`` is given, the card against the
CPU (``chip_smoke.lm_train_card_vs_cpu``) and the train CLI. TF32 off.

Prints the card line and, last, one JSON object; writes it to
``chiprun_out/lm_train_phase.json`` too. Needs a GPU.
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
                   help="configs to train (default: chip_smoke.LM_TRAIN_RUNS, "
                        "then the card against the CPU and the CLI)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    card = chip_smoke.card_line()
    print(f"[lm_train] card: {card}; kernels built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    if args.archs is None:
        phase = chip_smoke.lm_train_phase(device)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        depth = dict(chip_smoke.LM_TRAIN_RUNS)
        phase = {"runs": {a: chip_smoke.lm_train_case(device, a,
                                                      depth.get(a))
                          for a in args.archs}}
    out = dict(card=card, wall_s=time.perf_counter() - t0, phase_12=phase)
    path = ROOT / "chiprun_out" / "lm_train_phase.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(card)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
