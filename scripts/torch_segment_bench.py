"""Time the segment_reduce kernel of one or more source trees on the card,
at the shapes of ``chip_smoke.py``'s phases 5 and 8, one process per tree.

    python scripts/torch_segment_bench.py [--train] [TREE ...]

Each argument is a checkout (default: this one). The trees run in the order
given (parent, change, change, parent compares two on one card), each in a
child process that puts the tree's ``src`` first on the path and runs this
checkout's ``chip_smoke.segment_phase`` and ``dien_segment_cases``: every
tree meets the same cases, each held bit for bit against that tree's plain
version. Beside ``chip_smoke.segment_case``'s numbers it takes per case the
kernel's device time (calls queued behind a sleep on the card, so the host
is out of it), once with the layout's kept tiles and once computing them
anew in every call (``SegmentLayout.tiles`` emptied; the same where a tree
keeps none), and PyTorch's gather of the case's in-range rows by perm
(``index_select``: what reading them alone costs). With ``--train`` each
tree then runs ``chip_smoke.py``'s phases 6 and 10 (GNN and DIEN training
steps, CPU replays included). Prints the kernel's ms and device ms per
case and run (and ms/step and the last loss per training run), and
writes every number to ``chiprun_out/segment_bench.json``. Needs one card.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "segment_bench.json"


def bench_case(tag, data, ids, lay, reduce, plain_reps=3):
    """``chip_smoke.segment_case`` plus the device times and the gather."""
    import chip_smoke
    from repro_torch.kernels import segment_reduce
    timed, err = chip_smoke.segment_case(tag, data, ids, lay, reduce,
                                         plain_reps)
    kw = dict(num_segments=lay.num_segments, reduce=reduce, layout=lay)

    def fresh():
        getattr(lay, "tiles", {}).clear()
        return segment_reduce(data, ids, **kw)
    kept_perm = lay.perm[:int(lay.offsets[-1])]
    timed.update(
        device_ms=chip_smoke.device_ms(
            lambda: segment_reduce(data, ids, **kw), 10),
        fresh_device_ms=chip_smoke.device_ms(fresh, 10),
        gather_ms=chip_smoke.cuda_ms(
            lambda: data.index_select(0, kept_perm), 10))
    print(f"[bench] {tag}: device {timed['device_ms']:.4f} ms, with new "
          f"tiles {timed['fresh_device_ms']:.4f} ms, gather "
          f"{timed['gather_ms']:.3f} ms", flush=True)
    return timed, err


def child(tree: str, train: bool) -> None:
    """Run the cases against ``tree``'s kernel; print one JSON line."""
    sys.path[:0] = [str(pathlib.Path(tree).resolve() / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_family import shape_batch
    from repro_torch.data import DataCursor
    from repro_torch.launch.train import DIEN_TRAIN_BATCH

    if not torch.cuda.is_available():
        chip_smoke.fail("needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    graph = chip_smoke.host_graph("minibatch_lg")
    shapes = chip_smoke.segment_phase(device, graph, bench_case)["shapes"]
    torch.cuda.empty_cache()
    batch = shape_batch(get_arch("dien")[0], "train_batch", DataCursor(0, 0),
                        device, DIEN_TRAIN_BATCH)
    shapes.update(chip_smoke.dien_segment_cases(device, batch, bench_case))
    del batch
    steps = {}
    if train:
        torch.cuda.empty_cache()
        steps = chip_smoke.gnn_phase(device, graph)[1]
        torch.cuda.empty_cache()
        steps["dien/train_batch"] = chip_smoke.dien_train_phase(device)[2]
    print(json.dumps({"card": chip_smoke.card_line(), "shapes": shapes,
                      "steps": steps}))


def main(argv: list[str]) -> None:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2:] == ["--train"])
        return
    train = argv[:1] == ["--train"]
    runs = []
    for tree in argv[train:] or ["."]:
        env = dict(os.environ, PYTHONPATH="")
        proc = subprocess.run(
            [sys.executable, __file__, "--child", tree, *argv[:train]],
            env=env, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            sys.exit(f"{tree}: exit {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(result, tree=tree))
    cases = list(runs[0]["shapes"])
    print("case | kernel ms (device ms, with new tiles) per run: "
          + " | ".join(r["tree"] for r in runs) + " | bound ms")
    for case in cases:
        cols = [f"{r['shapes'][case]['ms']:.4f} "
                f"({r['shapes'][case]['device_ms']:.4f}, "
                f"{r['shapes'][case]['fresh_device_ms']:.4f})" for r in runs]
        print(f"{case} | " + " | ".join(cols)
              + f" | {runs[0]['shapes'][case]['bound_ms']:.4f}")
    for run in runs[0]["steps"]:
        cols = [f"{r['steps'][run]['ms_per_step']:.1f} "
                f"({r['steps'][run]['losses'][-1]!r})" for r in runs]
        print(f"{run} ms/step (last loss) | " + " | ".join(cols))
    print("card:", runs[0]["card"])
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
