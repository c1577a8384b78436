#!/usr/bin/env python3
"""Where an LM prefill and an LM decode step of the port spend their time
on the card.

    PYTHONPATH=src python scripts/torch_lm_profile.py [--archs stablelm-1.6b ...]

For each config of ``chip_smoke.LM_RUNS`` at ``chip_smoke.lm_cut``'s depth
(published widths, seeded bfloat16 weights), a ``LM_BATCH`` x
``LM_PROMPT`` prompt: one ``lm_prefill`` (one warm-up call, one traced),
then ``lm_decode_step`` at position ``LM_PROMPT`` (two warm-up calls,
three traced), each traced with ``torch_gnn_profile.trace``: wall ms per
call, device-busy ms per call and its share of the wall, device ms by
kind of kernel (segment_reduce, sort, gather/index, GEMM, elementwise and
reductions, other) and the top kernels. TF32 off.

The last line is one JSON object with all of it, also written to
``chiprun_out/lm_profile.json``. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.data import DataCursor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from torch_gnn_profile import card_line, report, trace  # noqa: E402


def profile_arch(arch: str, device) -> dict:
    cfg = chip_smoke.lm_cut(arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_lm_params(gen, cfg)
    b, p = chip_smoke.LM_BATCH, chip_smoke.LM_PROMPT
    tokens = torch.randint(0, cfg.vocab, (b, p),
                           generator=DataCursor(0, 0).generator(device),
                           device=device, dtype=torch.int32)
    prefill = trace(lambda: transformer.lm_prefill(cfg, params, tokens), 1,
                    1)
    logits, pc = transformer.lm_prefill(cfg, params, tokens)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    cache = transformer.init_kv_cache(cfg, b, p + 1, dtype=pc["k"].dtype,
                                      device=device)
    for key in ("k", "v"):
        cache[key][:, :, :p] = pc[key]
    del pc, logits
    decode = trace(lambda: transformer.lm_decode_step(cfg, params, cache,
                                                      first, p), 2, 3)
    del params, cache
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, prefill=prefill, decode=decode)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=list(chip_smoke.LM_RUNS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    _build.build()
    _build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[lm_profile] card: {card}", flush=True)
    out = dict(card=card, batch=chip_smoke.LM_BATCH,
               prompt=chip_smoke.LM_PROMPT, runs={})
    for arch in args.archs:
        run = profile_arch(arch, device)
        out["runs"][arch] = run
        for what in ("prefill", "decode"):
            report(f"{arch} ({run['layers']} layers) {what}", run[what],
                   prefix="lm_profile")
    path = ROOT / "chiprun_out" / "lm_profile.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
