"""Whole runs at toy size on the CPU: the result's line, cells found by
name, the JAX stack never loaded, and ``correct`` false for each fault
the cells can have in their timed path."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from conftest import REPO, TOY_CELLS, run_line

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("workload", TOY_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_toy_run_prints_the_result_line(toy_root, capsys, workload, trace):
    rc, line = run_line(toy_root, capsys, workload, trace=trace)
    assert rc == 0 and line is not None
    extra = {"checks"} | ({"breakdown"} if trace else set())
    assert REQUIRED <= set(line) <= REQUIRED | extra
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["checks"] == {"value_mismatches": {"value": 0, "limit": 0}}
    names = set(line["metrics"])
    if trace:
        assert {"cg_fixpoint_ms", "hop_ms", "sweeps_per_query"} <= names
        assert ("store_warm_s" in names) == workload.startswith("ev")
        assert "relax_roofline_pct" not in names   # device only
    else:
        assert {"setup_s", "answers_per_s", "query_p95_ms"} <= names
        assert "peak_mem_gib" not in names         # device only
    for name, m in line["metrics"].items():
        # the toy store's set algebra is below the timer's noise
        assert m["unit"] and (m["value"] > 0 or name == "store_warm_s")
    assert line["device"]["platform"] == "cpu"


def test_new_files_are_found_by_name(toy_root, capsys):
    """A configuration, a traffic mix and a per-layer metric added as new
    files (and entries in BENCHMARK.json) run with no other edit."""
    bench = json.loads((toy_root / "BENCHMARK.json").read_text())
    config = json.loads(
        (toy_root / "bench/configs/ev-toy.json").read_text())
    config.update(name="ev-other", num_nodes=700, num_snapshots=3)
    (toy_root / "bench/configs/ev-other.json").write_text(json.dumps(config))
    traffic = json.loads(
        (toy_root / "bench/traffic/fresh-source.dhb.json").read_text())
    traffic.update(name="few.dhb", pool=5)
    (toy_root / "bench/traffic/few.dhb.json").write_text(json.dumps(traffic))
    (toy_root / "bench/metrics/queries_in_window.py").write_text(
        "def read(records):\n    return float(len(records['queries']))\n")
    bench["configs"].append(dict(name="ev-other", source="tests",
                                 file="bench/configs/ev-other.json",
                                 reduced=[], why="tests"))
    bench["workloads"].append(dict(name="ev-other-few", config="ev-other",
                                   traffic="few.dhb", chips=1, why="tests"))
    bench["per_layer"].append(dict(
        name="queries_in_window", unit="queries", better="higher",
        source="host_clock", layer="whole query",
        moves="answers_per_s", workloads=["ev-other-few"]))
    (toy_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = run_line(toy_root, capsys, "ev-other-few", trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["queries_in_window"]["value"] >= 1
    assert line["attempted"] % 3 == 0


def test_no_jax_and_no_jax_package_loaded(toy_root):
    """A run in a fresh process loads no module whose top-level name is
    jax, jaxlib, flax or repro (``repro_torch`` is not ``repro``)."""
    script = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "from repro_torch.configs import commongraph\n"
        "commongraph.COMMONGRAPH_SHAPES['bench_toy'] = dict("
        "n_snapshots=5, n_nodes=1024, cg_edges=8192, delta_edges=256)\n"
        "from bench import run\n"
        "for w in ('cg-toy-fresh', 'ev-toy-wsb'):\n"
        "    assert run.main(['--workload', w, '--seed', '3', '--seconds',"
        " '0.3', '--trace', '1'], device='cpu',"
        " root=run.pathlib.Path('.')) == 0\n"
        "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ, PYTHONPATH=str(toy_root / "src"))
    out = subprocess.run([sys.executable, "-c", script], cwd=toy_root,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = json.loads(out.stdout.split("LOADED ")[-1].replace("'", '"'))
    assert "repro_torch" in loaded
    assert not {"jax", "jaxlib", "flax", "repro"} & set(loaded)


def test_run_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and bench/, the command
    exits non-zero and prints no result."""
    import shutil
    shutil.copytree(REPO / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "ev22-dhb-fresh",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout


# -- faults in the timed path: each must turn ``correct`` false -----------

def _state_unchanged(real):
    """The hop returns the state it was given."""
    def hop(semiring, n, max_iters, values, parent, *args, **kwargs):
        res = real(semiring, n, max_iters, values, parent, *args, **kwargs)
        return res._replace(values=values.clone())
    return hop


def _half_left_out(real):
    """The second half of the lanes keeps the state it was given."""
    def hop(semiring, n, max_iters, values, parent, *args, **kwargs):
        res = real(semiring, n, max_iters, values, parent, *args, **kwargs)
        out = res.values.clone()
        half = (out.shape[0] + 1) // 2
        out[half:] = values[half:]
        return res._replace(values=out)
    return hop


def _answer_altered(real):
    """Lane 0's farthest reached vertex is off by one."""
    def hop(semiring, n, max_iters, values, parent, *args, **kwargs):
        res = real(semiring, n, max_iters, values, parent, *args, **kwargs)
        out = res.values.clone()
        far = torch.where(torch.isfinite(out[0]), out[0], -1.0).argmax()
        out[0, far] += 1.0
        return res._replace(values=out)
    return hop


def _fixpoint_unchanged(real):
    """The common graph's fixpoint returns its starting state."""
    def fixpoint(view, semiring, source, *args, **kwargs):
        res = real(view, semiring, source, *args, **kwargs)
        from repro_torch.graph.engine import init_values
        return res._replace(values=init_values(view.num_nodes, semiring,
                                               source, device=view.device))
    return fixpoint


HOP_SITES = (("repro_torch.graph.engine", "batched_incremental"),
             ("repro_torch.configs.commongraph", "batched_incremental"))
FIXPOINT_SITES = (("repro_torch.graph.engine", "run_to_fixpoint"),
                  ("repro_torch.core.trigrid", "run_to_fixpoint"))


@pytest.mark.parametrize("workload", TOY_CELLS)
@pytest.mark.parametrize("fault,sites", [
    (_state_unchanged, HOP_SITES), (_half_left_out, HOP_SITES),
    (_answer_altered, HOP_SITES), (_fixpoint_unchanged, FIXPOINT_SITES)])
def test_fault_makes_the_run_incorrect(toy_root, capsys, monkeypatch,
                                       workload, fault, sites):
    import importlib
    for module, attr in sites:
        mod = importlib.import_module(module)
        monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    rc, line = run_line(toy_root, capsys, workload)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["value_mismatches"]["value"] > 0
    assert line["failed"] > 0
