"""Dry run of every (arch x shape) cell on the reference's production mesh,
on the meta device: what each chip of the reference's layout holds, and
what the port's one-card step would hold, compute and move.

Counterpart of ``repro.launch.dryrun``, with its flags and its record
layout. The reference lowers and compiles each cell with XLA; the port
builds the cell (``configs.make_cell``: arguments on meta) and traces its
step once on meta (``launch/meta_trace.py``). A record holds:

* ``mem_per_device``: ``argument_bytes`` and ``output_bytes``, the sums
  over the arguments (outputs) of ``per_device_bytes`` under the cell's
  ``in_specs`` (``out_specs``) on the mesh;
* ``one_device``: ``peak_bytes``, ``argument_bytes`` and ``temp_bytes``
  (peak less arguments) of the step run whole on one device, as the port
  runs it (no model is split);
* ``flops`` (every matrix product) and ``bytes_accessed`` (what the step's
  operators read and write) of that step; ``lower_s``, the seconds to
  build the cell and trace it; ``compile_s`` null, since nothing is
  compiled; ``collective_bytes`` ``{}``, since the step runs on one card.

The cells of one (arch, shape) whose ``Cell.trace_key`` s are equal run
the same step on every mesh (a MoE LM's train and prefill cells key on
their token groups, the mesh's batch shards): each key is traced once.
The cells are traced in worker processes (spawned, one per core) when
there are several.

CommonGraph cells (``--commongraph``): the engine reads a flag to the
host each sweep, so the fixpoint cannot run on meta. Their records hold
the per-device bytes, ``lane_axis``, and the ``flops``/``bytes_accessed``
and ``one_device`` of one ``relax_multi`` sweep over the lanes of one
device, marked ``"per_sweep": true``; ``collective_bytes`` holds what the
port's sharded step moves between devices, reckoned from shapes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --commongraph --json out.json
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import all_cells, make_cell, shapes_for
from repro_torch.configs.base import MeshAxes, meta_tensor, per_device_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.meta_trace import trace_step


def _record(cell, mesh, trace: dict, out, lower_s: float) -> dict:
    rec = {
        "cell": cell.name,
        "mesh": dict(mesh.shape),
        "lower_s": round(lower_s, 2),
        "compile_s": None,
        "flops": trace["flops"],
        "bytes_accessed": trace["bytes_accessed"],
        "collective_bytes": {},
        "mem_per_device": {
            "argument_bytes": per_device_bytes(cell.args, cell.in_specs, mesh),
            "output_bytes": per_device_bytes(out, cell.out_specs, mesh),
        },
        "one_device": trace["one_device"],
    }
    if cell.meta:
        rec["lane_axis"] = cell.meta
    return rec


def dryrun_cells(arch: str, shape: str, meshes) -> list[dict]:
    """The records of the (arch x shape) cell on each of ``meshes``: one
    trace for the cells whose ``Cell.trace_key`` s are equal."""
    t0 = time.perf_counter()
    cells = [make_cell(arch, shape, mesh) for mesh in meshes]
    build_s = time.perf_counter() - t0
    traces = {}
    for cell in cells:
        if cell.trace_key not in traces:
            t0 = time.perf_counter()
            out, trace = trace_step(cell.fn, cell.args)
            traces[cell.trace_key] = (trace, out,
                                      build_s + time.perf_counter() - t0)
    return [_record(cell, mesh, *traces[cell.trace_key])
            for cell, mesh in zip(cells, meshes)]


def dryrun_cell(arch: str, shape: str, mesh, verbose: bool = True) -> dict:
    """The record of one cell on one mesh."""
    rec = dryrun_cells(arch, shape, [mesh])[0]
    if verbose:
        print_record(rec)
    return rec


def _gib(n) -> str:
    return f"{n / 2**30:.3f} GiB"


def print_record(rec: dict) -> None:
    mem, one = rec["mem_per_device"], rec["one_device"]
    tag = " (one relax_multi sweep)" if rec.get("per_sweep") else ""
    print(f"[dryrun] {rec['cell']} mesh={rec['mesh']} "
          f"lower={rec['lower_s']}s compile={rec['compile_s']}")
    print(f"  mem_per_device: arguments {_gib(mem['argument_bytes'])}, "
          f"outputs {_gib(mem['output_bytes'])}; one_device{tag}: peak "
          f"{_gib(one['peak_bytes'])}, arguments "
          f"{_gib(one['argument_bytes'])}, temp {_gib(one['temp_bytes'])}")
    print(f"  flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
          f"collectives={ {k: f'{v:.2e}' for k, v in rec['collective_bytes'].items()} }")
    if "lane_axis" in rec:
        print(f"  lane_axis: {rec['lane_axis']}")


# -- CommonGraph cells ----------------------------------------------------------

def commongraph_collective_bytes(cell, extent: int) -> dict:
    """Bytes the port's sharded step moves between devices, from shapes:
    the lanes' state, Δ rows and ``lane_valid`` split from the first device
    onto the others, the common graph copied to each other device, and
    the results (values, parents, sweeps, work, seed work, unstable
    counts, ``lane_valid``) gathered onto the first device."""
    if extent == 1:
        return {}
    values, parent, cg, delta, lane_valid = cell.args
    lanes, n = values.shape
    moved = lanes - lanes // extent       # the lanes not on the first device
    state = n * (values.element_size() + parent.element_size())
    delta_row = sum(t[0].numel() * t.element_size() for t in delta)
    return {
        "lane_split": moved * (state + delta_row + lane_valid.element_size()),
        "common_graph_copies": (extent - 1) * sum(
            t.numel() * t.element_size() for t in cg),
        "gather": moved * (state + 4 * 4 + lane_valid.element_size()),
    }


def dryrun_commongraph(shape_id: str, mesh) -> dict:
    """The record of the ``commongraph/<shape_id>`` cell on ``mesh``: its
    per-device bytes and one ``relax_multi`` sweep over one device's
    lanes, traced on meta (``per_sweep``)."""
    from repro_torch.configs.commongraph import SEMIRING, make_commongraph_cell
    from repro_torch.graph.engine import KERNEL_OP_FOR
    from repro_torch.kernels import relax_multi
    t0 = time.perf_counter()
    cell = make_commongraph_cell(shape_id, mesh)
    values, parent, cg, delta, _ = cell.args
    lanes, n = values.shape
    extent = MeshAxes.for_mesh(mesh).n_batch_shards(mesh)
    per = lanes // extent
    rows = tuple(meta_tensor((per,) + t.shape[1:], t.dtype) for t in delta)
    state = (meta_tensor((per, n), values.dtype),
             meta_tensor((per, n), parent.dtype),
             meta_tensor((per, n), torch.bool))

    def sweep(values, parent, frontier, cg, rows):
        return relax_multi(values, parent, frontier, (tuple(cg), rows),
                           op=KERNEL_OP_FOR[SEMIRING.name], num_nodes=n, k=1,
                           track_parents=False)

    _, trace = trace_step(sweep, state + (tuple(cg), rows))
    outputs = (values, parent, meta_tensor((lanes,), torch.int32),
               meta_tensor((lanes,), torch.float32))
    rec = _record(cell, mesh, trace, outputs, time.perf_counter() - t0)
    rec["collective_bytes"] = commongraph_collective_bytes(cell, extent)
    rec["per_sweep"] = True
    return rec


# -- the CLI ----------------------------------------------------------------------

def _jobs(cells, meshes) -> list[tuple[str, str, list]]:
    """(arch, shape, meshes) per trace: the cell's meshes grouped by the
    ``trace_key`` of its cell on each. A cell that cannot be built is one
    job, whose worker reports why."""
    jobs = []
    for arch, shape in cells:
        groups: dict = {}
        for mesh in meshes:
            try:
                key = make_cell(arch, shape, mesh).trace_key
            except Exception:  # noqa: BLE001 — reported by the job's worker
                key = None
            groups.setdefault(key, []).append(mesh)
        jobs.extend((arch, shape, group) for group in groups.values())
    return jobs


def _run_job(job):
    """A job's records, or its failure and traceback (in a worker)."""
    arch, shape, meshes = job
    try:
        return dryrun_cells(arch, shape, meshes), None
    except Exception as e:  # noqa: BLE001 — reported by the caller
        return None, (str(e)[:200], traceback.format_exc())


def _run_jobs(jobs):
    """Each job's result in order: in spawned workers, one per core up to
    the number of jobs, when there are several."""
    workers = min(len(jobs), os.cpu_count() or 1)
    if workers <= 1:
        return [_run_job(job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        return list(ex.map(_run_job, jobs))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--commongraph", action="store_true",
                   help="also dry-run the paper engine cells")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    if args.both_meshes:
        meshes = [make_production_mesh(multi_pod=False),
                  make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]

    cells: list[tuple[str, str]] = []
    if args.all:
        cells = all_cells(meshes[0])
    elif args.arch:
        shapes = [args.shape] if args.shape else shapes_for(args.arch)
        cells = [(args.arch, s) for s in shapes]

    jobs = _jobs(cells, meshes)
    by_mesh: dict = {}
    failures = []
    for (arch, shape, group), (recs, err) in zip(jobs, _run_jobs(jobs)):
        if err is not None:
            print(err[1], file=sys.stderr)
            failures.extend((arch, shape, str(mesh.shape), err[0])
                            for mesh in group)
            continue
        for mesh, rec in zip(group, recs):
            by_mesh.setdefault(id(mesh), []).append(rec)

    records = []
    for mesh in meshes:
        for rec in by_mesh.get(id(mesh), []):
            print_record(rec)
            records.append(rec)
        if args.commongraph:
            from repro_torch.configs.commongraph import COMMONGRAPH_SHAPES
            for cs in COMMONGRAPH_SHAPES:
                try:
                    rec = dryrun_commongraph(cs, mesh)
                except Exception as e:  # noqa: BLE001 — report and continue
                    traceback.print_exc()
                    failures.append(("commongraph", cs, str(mesh.shape),
                                     str(e)[:200]))
                    continue
                print_record(rec)
                records.append(rec)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"records": records, "failures": failures}, f,
                      indent=1)
    print(f"\n[dryrun] {len(records)} cells OK, {len(failures)} failed")
    for f4 in failures:
        print("  FAIL:", *f4)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
