"""Time the embedding_bag kernel of one or more source trees on the card,
at the cases of ``chip_smoke.py``'s phase 8, one process per tree.

    python scripts/torch_bag_bench.py [--dien] [TREE ...]

Each argument is a checkout (default: this one). The trees run in the order
given (parent, change, change, parent compares two on one card), each in a
child process that puts the tree's ``src`` first on the path and runs this
checkout's ``chip_smoke.bag_phase``: every tree meets the same cases, each
held bit for bit against that tree's plain version, and each timed as
``chip_smoke.bag_case`` times it: back-to-back ms, device µs (calls queued
behind a sleep), the wrapper's host µs per call, ``F.embedding_bag``'s ms
and device µs, the bytes bound and the sector floor; and beside them the
device time of PyTorch's gather of the same rows. A tree from before
``contiguous_layout`` gets one that sorts, as its DIEN path did. With
``--dien`` each tree then runs ``chip_smoke.py``'s phases 9 and 10 (DIEN
serving and training): ms per call or step, the serving outputs' SHA-256
and the training losses, to compare two trees' results bit for bit.
Prints a table per case and run and writes every number to
``chiprun_out/bag_bench.json``. Needs one card.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "bag_bench.json"


def _sorted_contiguous_layout() -> None:
    """Give a tree without ``contiguous_layout`` the layout its DIEN path
    built: a sort of ``arange(b).repeat_interleave(s)``, perm read."""
    import importlib

    import torch
    sr = importlib.import_module("repro_torch.kernels.segment_reduce")
    if hasattr(sr, "contiguous_layout"):
        return
    sr.SegmentLayout.identity_perm = False

    def contiguous_layout(n_bags, bag_len, device):
        bags = torch.arange(n_bags, dtype=torch.int32,
                            device=device).repeat_interleave(bag_len)
        return sr.segment_layout(bags, n_bags)
    sr.contiguous_layout = contiguous_layout


def bench_case(tag, table, ids, w, lay, library=None):
    """``chip_smoke.bag_case`` plus the device time of PyTorch's gather of
    the case's in-range rows (``index_select``: reading them once and
    writing them out, what the card's random row reads cost)."""
    import chip_smoke
    timed, err = chip_smoke.bag_case(tag, table, ids, w, lay, library)
    kept = int(lay.offsets[-1])
    rows = ids[:kept] if lay.identity_perm else ids[lay.perm[:kept]]
    timed["gather_us"] = chip_smoke.device_ms(
        lambda: table.index_select(0, rows), 20) * 1e3
    print(f"[bench] {tag}: gather of its rows {timed['gather_us']:.1f} us "
          "on the device", flush=True)
    return timed, err


def child(tree: str, dien: bool) -> None:
    """Run the cases against ``tree``'s kernel; print one JSON line."""
    sys.path[:0] = [str(pathlib.Path(tree).resolve() / "src"), str(ROOT)]
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        chip_smoke.fail("needs an NVIDIA GPU")
    _sorted_contiguous_layout()
    device = torch.device("cuda", 0)
    shapes = chip_smoke.bag_phase(device, bench_case)[0]["shapes"]
    torch.cuda.empty_cache()
    runs = {}
    if dien:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        runs = chip_smoke.serve_phase(device)[1]
        torch.cuda.empty_cache()
        runs["train_batch"] = chip_smoke.dien_train_phase(device)[2]
    print(json.dumps({"card": chip_smoke.card_line(), "shapes": shapes,
                      "dien": runs}))


def main(argv: list[str]) -> None:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2:] == ["--dien"])
        return
    dien = argv[:1] == ["--dien"]
    runs = []
    for tree in argv[dien:] or ["."]:
        env = dict(os.environ, PYTHONPATH="")
        proc = subprocess.run(
            [sys.executable, __file__, "--child", tree, *argv[:dien]],
            env=env, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            sys.exit(f"{tree}: exit {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(dict(result, tree=tree))
    print("case | kernel ms (device us, host us) per run: "
          + " | ".join(r["tree"] for r in runs)
          + " | F.embedding_bag ms (device us) | gather us | bound ms | "
          "sector floor ms")
    for case, first in runs[0]["shapes"].items():
        cols = [f"{r['shapes'][case]['ms']:.4f} "
                f"({r['shapes'][case]['device_us']:.1f}, "
                f"{r['shapes'][case]['host_us']:.1f})" for r in runs]
        lib = (f"{first['library_ms']:.4f} ({first['library_device_us']:.1f})"
               if first["library_ms"] is not None else "none")
        print(f"{case} | " + " | ".join(cols) + f" | {lib} | "
              f"{first['gather_us']:.1f} | {first['bound_ms']:.4f} | "
              f"{first['sector_floor_ms']:.4f}")
    for shape, first in runs[0]["dien"].items():
        if "ms_per_step" in first:
            cols = [f"{r['dien'][shape]['ms_per_step']:.1f} ms/step, losses "
                    f"{r['dien'][shape]['losses']!r}" for r in runs]
        else:
            cols = [f"{r['dien'][shape]['ms_per_call']:.1f} ms/call, sha "
                    f"{r['dien'][shape]['out_sha256'][:16]}" for r in runs]
        print(f"dien {shape} | " + " | ".join(cols))
    print("card:", runs[0]["card"])
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
