#!/usr/bin/env python3
"""The paper's engine at production scale on the card: ``chip_smoke.py``'s
phase 3d alone.

    PYTHONPATH=src python scripts/torch_commongraph_phase.py [--shapes window_32x ...]

Runs ``chip_smoke.commongraph_phase``: for each shape of
``configs/commongraph.py`` (default ``window_32x`` then ``window_64x``,
each at its full published size) the generation and start-state seconds,
the cell's evolve step cold and warm with its relax_multi launches and
device ms, the peak device memory, per-lane iterations and edge_work; the
fixpoint certificate of every lane, three lanes from scratch and the
padding lanes; the cell on a mesh naming the card four times and, with two
or more cards, on a mesh of every card (the relax kernels' warm device ms
per card), each bit for bit against the unmeshed step; relax_multi at the
cell's launch shapes against its plain version.

Prints the card line and, last, one JSON object; writes it to
``chiprun_out/commongraph_phase.json`` too. Needs a GPU; on a machine of
four cards it adds the four-card mesh.
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
    p.add_argument("--shapes", nargs="+",
                   default=list(chip_smoke.COMMONGRAPH_SHAPES_RUN))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    card = chip_smoke.card_line()
    print(f"[commongraph] card: {card}; {torch.cuda.device_count()} card(s); "
          f"kernels built in {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    phase = chip_smoke.commongraph_phase(torch.device("cuda", 0),
                                         shapes=tuple(args.shapes))
    out = dict(card=card, cards=torch.cuda.device_count(),
               wall_s=time.perf_counter() - t0, phase_3d=phase)
    path = ROOT / "chiprun_out" / "commongraph_phase.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(card)
    summary = {shape: {k: v for k, v in row.items()
                       if k not in ("iterations", "edge_work")}
               for shape, row in phase["shapes"].items()}
    print(json.dumps(dict(card=card, cards=out["cards"],
                          wall_s=out["wall_s"], launches=phase["launches"],
                          shapes=summary), default=str))


if __name__ == "__main__":
    main()
