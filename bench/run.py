"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; ``src`` is put on the path here. The
cell, its configuration, its traffic and its metrics are found by name
(``BENCHMARK.json``, ``bench/configs/``, ``bench/traffic/``,
``bench/metrics/``, with the configuration's ``inputs`` and ``driver``
modules). A run makes its inputs from the seed, builds the program's
state, warms up with one query of the traffic's shapes, measures a
closed loop for ``--seconds``, then checks a seeded sample of the window's
answers against the plain reference bit for bit. With ``--trace 1`` it
then times the relax kernel's calls and profiles a few more queries, and
reports the per-layer metrics instead of the end-to-end ones.

Its last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``; last, ``checks``: each number compared and its limit); its
last lines of standard error are the same checks. It needs a CUDA card
and exits with 2 without one.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Run as a script, this folder leads the path; its module names are only
# for the ``bench`` package, so it goes.
if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "bench":
    del sys.path[0]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 1.0   # at least this long, and
TRACE_QUERIES = 3     # at least this many queries, per traced segment


def load_cell(root: pathlib.Path, workload: str) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def load_module(root: pathlib.Path, kind: str, name: str):
    """``bench/<kind>/<name>.py`` under ``root``, loaded by its path."""
    path = root / "bench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def timed_query(driver, source: int):
    """One query, timed from the call to the program's return: its record
    and its answer."""
    t0 = time.perf_counter()
    answer = driver.query(source)
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, fixpoint_s=answer.fixpoint_s,
                hop_s=answer.hop_s, sweeps=answer.sweeps), answer


def closed_loop(driver, loop, sample, seconds: float,
                min_queries: int = 1):
    """Queries back to back until ``seconds`` have passed (and at least
    ``min_queries`` ran); each query's answers are offered to the check's
    sample after its clock stops. Returns the queries' records, the
    window's seconds to the end of its last query less the time the
    sample took to copy what it keeps (the harness's work, not the
    program's), and that time."""
    records, held = [], 0.0
    w0 = time.perf_counter()
    while True:
        source = loop.next()
        record, answer = timed_query(driver, source)
        records.append(record)
        t = time.perf_counter()
        sample.offer(answer.values, source)
        held += time.perf_counter() - t
        del answer
        elapsed = time.perf_counter() - w0 - held
        if elapsed >= seconds and len(records) >= min_queries:
            return records, elapsed, held


def window_summary(queries, snapshots: int) -> str:
    """One line on how the window went: answers/s in each third of it
    (the host's speed drifts within a run) and the queries' median, 95th
    percentile and slowest milliseconds."""
    import numpy as np
    walls = np.array([q["wall_s"] for q in queries])
    ends = np.cumsum(walls)
    cuts = np.searchsorted(ends, ends[-1] * np.array([1, 2]) / 3)
    rates = [snapshots * len(w) / w.sum() for w in np.split(walls, cuts)
             if len(w)]
    ms = 1e3 * walls
    return (f"[bench] window {len(queries)} queries; answers/s by "
            f"thirds {', '.join(f'{r:.1f}' for r in rates)}; query ms "
            f"median {np.median(ms):.2f}, p95 {np.percentile(ms, 95):.2f}, "
            f"max {ms.max():.2f}")


def traced(driver, loop, sample, spans, cuda: bool) -> dict:
    """The traced run's extra segments after the window: the relax
    kernel's calls under CUDA events with their bytes, then the profiler
    over a few queries with the host's labels on."""
    from bench import tracing as trace
    out = {}
    if cuda:
        with trace.RelaxRecorder() as rec:
            closed_loop(driver, loop, sample, TRACE_SECONDS, TRACE_QUERIES)
        device_s, nbytes, calls = rec.totals()
        out["relax"] = dict(device_s=device_s, bytes=nbytes, calls=calls)
    with trace.labelled(driver.label_targets(), spans):
        out["profile"] = trace.profile(
            lambda: closed_loop(driver, loop, sample, TRACE_SECONDS,
                                TRACE_QUERIES), spans)
    return out


def run(root: pathlib.Path, spec: dict, seed: int, seconds: float,
        trace_on: bool, device, make_driver=None,
        warm_up: bool = True) -> dict | None:
    """One run of the cell ``spec``; the result's line as a dict, or None
    if the run loaded the JAX stack. ``make_driver`` puts another answerer
    in the program's place (the control, ``bench/control.py``)."""
    import torch

    from bench import check, tracing as trace
    from bench.traffic import ClosedLoop
    config, traffic = spec["config"], spec["traffic"]
    cuda = device.type == "cuda"
    spans = trace.Spans()
    # A configuration that names a graph seed holds one graph, as a data
    # set would, and one pool of sources; the run's seed then draws the
    # order of its queries and its sample.
    graph_seed = int(config.get("graph_seed", seed))
    steps = [("imports", time.perf_counter())]
    inputs = load_module(root, "inputs", config["inputs"]).make(
        config, graph_seed, device)
    steps.append(("inputs", time.perf_counter()))
    loop = ClosedLoop(traffic, inputs, seed, graph_seed, device)
    steps.append(("sources", time.perf_counter()))
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    if make_driver is None:
        make_driver = load_module(root, "drivers", config["driver"]).Driver
    t = time.perf_counter()
    driver = make_driver(config, traffic, inputs, device, spans)
    port_setup_s = time.perf_counter() - t
    steps.append(("program", time.perf_counter()))
    warm = [timed_query(driver, loop.warmup())[0]] if warm_up else []
    steps.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - T0
    print("[bench] set-up " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b)
        in zip([("", T0)] + steps, steps)), file=sys.stderr)

    s, n = inputs.num_snapshots, inputs.num_nodes
    sample = check.Sample(seed, s, int(config["check_per_snapshot"]), n,
                          device)
    queries, window_s, held_s = closed_loop(driver, loop, sample, seconds)
    print(window_summary(queries, s)
          + f"; the check's copies {held_s:.3f} s", file=sys.stderr)
    extra = traced(driver, loop, sample, spans, cuda) if trace_on else {}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.close()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    verdict = check.compare(sample, inputs, device)
    print(f"[bench] check {time.perf_counter() - t:.3f} s", file=sys.stderr)

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    records = dict(setup_s=setup_s, window_s=window_s, queries=queries,
                   snapshots=s, memory_peak_bytes=peak, warm=warm,
                   port_setup_s=port_setup_s,
                   min_query_bytes=inputs.min_query_bytes,
                   hbm_bytes_per_s=trace.peak(kind, "hbm_bytes_per_s"),
                   **extra)
    metrics = {}
    for m in spec["per_layer" if trace_on else "end_to_end"]:
        value = load_module(root, "metrics", m["name"]).read(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = dict(platform="gpu" if cuda else "cpu", kind=kind,
                       count=int(spec["cell"]["chips"]) if cuda else 0,
                       memory_peak_bytes=peak)
    if cuda:
        device_info["power_limit"] = power_limit()
    result = dict(correct=None, attempted=len(queries) * s,
                  failed=verdict["failed"],
                  metrics=metrics, device=device_info)
    prof = extra.get("profile")
    if prof:
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = dict(device_ops=prof["device_ops"],
                                   idle_gaps=prof["idle_gaps"])
    print(f"[bench] compared {verdict['compared']} answers kept from "
          f"{sample.offered} queries", file=sys.stderr)
    checks = {name: {"value": verdict[name], "limit": limit}
              for name, limit in check.LIMITS.items()}
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"[bench] the run loaded {found}", file=sys.stderr)
        return None
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, root: pathlib.Path = ROOT) -> int:
    """Run one cell; ``device`` and ``root`` are for the tests (a CPU run
    at toy size, a copy of the benchmark): the command line always asks
    for a CUDA card and reads the checkout it runs from."""
    import torch
    args = parse(argv)
    spec = load_cell(root, args.workload)
    if importlib.util.find_spec("repro_torch") is None:
        print("[bench] the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 1
    if device is None:
        need = int(spec["cell"]["chips"])
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < need:
            print(f"[bench] {args.workload} needs {need} CUDA card(s); "
                  f"this machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    result = run(root, spec, args.seed % (1 << 63), args.seconds,
                 bool(args.trace), torch.device(device))
    if result is None:
        return 1
    for name, c in result["checks"].items():
        print(f"[bench] check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
