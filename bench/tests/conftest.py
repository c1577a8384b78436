"""Fixtures of the benchmark's own tests: a copy of the benchmark with toy
cells (the CPU runs them in seconds) and the card, decided inside a
fixture.

    PYTHONPATH=src python -m pytest -q bench/tests            # the CPU
    PYTHONPATH=src python -m pytest -q -m cuda bench/tests    # on a card
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TOY_SHAPE = dict(n_snapshots=5, n_nodes=1024, cg_edges=8192, delta_edges=256)
TOY_CELLS = ("cg-toy-fresh", "ev-toy-wsb", "ev-toy-dhb")
# each toy cell reports the metrics of the real cell it shrinks
# (the store's plan executor, ``wsb``, keeps its toy cell: its driver
# path stays for the cell that returns once the store's set-up is short)
TOY_OF = dict(zip(TOY_CELLS, ("cg64-sssp-fresh", "ev22-dhb-fresh",
                              "ev22-dhb-fresh")))


def make_toy_root(tmp: pathlib.Path) -> pathlib.Path:
    """A copy of ``bench/`` with toy configurations, a ``BENCHMARK.json``
    that adds their cells to the real ones, and ``src`` linked in."""
    shutil.copytree(REPO / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "src").symlink_to(REPO / "src")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = tmp / "bench" / "configs"
    cg = json.loads((configs / "cg-window64x.json").read_text())
    cg.update(name="cg-toy", shape_id="bench_toy", check_per_snapshot=2,
              **TOY_SHAPE)
    ev = json.loads((configs / "evolve-rmat22.json").read_text())
    ev.update(name="ev-toy", num_nodes=1024, num_edges=8192,
              num_snapshots=5, batch_changes=400, check_per_snapshot=2)
    for c in (cg, ev):
        (configs / f"{c['name']}.json").write_text(json.dumps(c))
        bench["configs"].append(dict(
            name=c["name"], source="a toy size of " + c["source"][:100],
            file=f"bench/configs/{c['name']}.json", reduced=[], why="tests"))
    for name, config, traffic in zip(
            TOY_CELLS, ("cg-toy", "ev-toy", "ev-toy"),
            ("fresh-source", "fresh-source.wsb", "fresh-source.dhb")):
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=traffic, chips=1, why="tests"))
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [toy for toy, real in TOY_OF.items()
                               if real in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """The toy copy, with the toy CommonGraph shape registered."""
    from repro_torch.configs import commongraph
    monkeypatch.setitem(commongraph.COMMONGRAPH_SHAPES, "bench_toy",
                        dict(TOY_SHAPE))
    return make_toy_root(tmp_path)


def run_line(root, capsys, workload, seed=2147483651, seconds=0.5,
             trace=0, device="cpu"):
    """Run a cell in this process; returns ``(exit code, last stdout line
    as a dict or None)``."""
    from bench import run
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  device=device, root=root)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out and out[-1].startswith("{")
                else None)


@pytest.fixture
def card():
    """The first CUDA card, or a skip without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
