"""The control: the plain reference computed in bfloat16, the precision
below the configurations' float32, put in the program's place, through a
short window of a cell's own traffic and the same check as a run.

    python bench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds 1]

Prints per seed the numbers compared and their limits, and whether the
check found the control correct (it must not), then one JSON line with
every seed's readings. Runs on the card (as ``bench/run.py``); the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

_HERE = pathlib.Path(__file__).resolve().parent
if sys.path and pathlib.Path(sys.path[0]).resolve() == _HERE:
    del sys.path[0]
sys.path.insert(0, str(_HERE.parent))

import torch  # noqa: E402

from bench.drivers import Answer  # noqa: E402
from bench.reference import Reference  # noqa: E402
from bench.run import ROOT, load_cell, run  # noqa: E402 (puts src on the path)


class ControlDriver:
    """Answers every snapshot with the reference in ``dtype``."""

    def __init__(self, config, traffic, inputs, device, spans,
                 dtype=torch.bfloat16):
        self.ref = Reference(inputs, device, dtype)
        self.snapshots = inputs.num_snapshots

    def label_targets(self):
        return []

    def query(self, source: int) -> Answer:
        values = [next(self.ref.answers(s, [source]))
                  for s in range(self.snapshots)]
        return Answer(values, 0.0, 0.0, 0)

    def close(self):
        self.ref = None


def control(workload: str, seeds, seconds: float, device,
            root=ROOT) -> list[dict]:
    """The control's readings on ``seeds``: per seed ``correct`` and the
    checks' numbers."""
    spec = load_cell(root, workload)
    out = []
    for seed in seeds:
        result = run(root, spec, seed % (1 << 63), seconds, False,
                     torch.device(device), make_driver=ControlDriver,
                     warm_up=False)
        out.append(dict(seed=seed, correct=result["correct"],
                        checks=result["checks"]))
        readings = ", ".join(f"{k} {c['value']} (limit {c['limit']})"
                             for k, c in result["checks"].items())
        print(f"[control] {workload} seed {seed}: correct "
              f"{result['correct']}; {readings}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    readings = control(args.workload, args.seeds, args.seconds, "cuda")
    print(json.dumps(dict(workload=args.workload, readings=readings)))
    return 0 if not any(r["correct"] for r in readings) else 1


if __name__ == "__main__":
    sys.exit(main())
