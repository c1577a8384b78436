"""The four-card CommonGraph cell's configuration (``cg-window256x-4card``)
at toy size on the CPU named four times: a whole run reads ``correct``
true with its three per-layer metrics of the sharded step, the driver's
blocks are the port's block functions' layout, and each fault the placed
step can have in its timed path reads ``correct`` false."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import REPO, make_toy_root, run_line

TOY = "cg4-toy"
TOY_CELL = "cg4-toy-fresh"
REAL_CELL = "cg256x4-sssp-fresh"
SHARDED = ("xcard_mib_per_step", "shard_exchange_ms", "idle_shard_pct")


@pytest.fixture
def sharded_root(tmp_path):
    """The toy copy of the benchmark with a toy ``cg-window256x-4card``:
    5 snapshots, 1,024 vertices, 8,192 common-graph edges, 256 a Δ, on
    four CPU slots; it reports the metrics of the real cell."""
    root = make_toy_root(tmp_path)
    configs = root / "bench" / "configs"
    config = json.loads((configs / "cg-window256x-4card.json").read_text())
    assert config["cards"] == 4
    config.update(name=TOY, n_snapshots=5, n_nodes=1024, cg_edges=8192,
                  delta_edges=256, check_per_snapshot=2)
    (configs / f"{TOY}.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name=TOY, source="a toy size of the "
                                 "four-card window", file=f"bench/configs/"
                                 f"{TOY}.json", reduced=[], why="tests"))
    bench["workloads"].append(dict(name=TOY_CELL, config=TOY,
                                   traffic="fresh-source", chips=4,
                                   why="tests"))
    for m in bench["per_layer"] + bench["end_to_end"]:
        if REAL_CELL in m.get("workloads", []):
            m["workloads"].append(TOY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_the_real_cell_takes_four_cards():
    """The cell asks for four chips, its configuration for four cards of
    48 snapshots each in 48 lanes, no padding lane, and the three new
    metrics list it alone."""
    from bench.drivers.commongraph_sharded import lane_layout
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[REAL_CELL]
    assert cell["chips"] == 4 and cell["traffic"] == "fresh-source"
    config = json.loads(
        (REPO / "bench/configs/cg-window256x-4card.json").read_text())
    assert lane_layout(config["n_snapshots"], config["cards"]) == \
        list(range(4 * 48))
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for name in SHARDED:
        assert metrics[name]["workloads"] == [REAL_CELL]


@pytest.mark.parametrize("trace", [0, 1])
def test_toy_run_is_correct(sharded_root, capsys, trace):
    from repro_torch.runtime import trace as program_trace
    program_trace.reset()       # earlier runs in this process recorded too
    rc, line = run_line(sharded_root, capsys, TOY_CELL, trace=trace)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % 5 == 0 and line["attempted"] > 0
    names = set(line["metrics"])
    if trace:
        assert set(SHARDED) <= names
        for name in SHARDED:
            assert line["metrics"][name]["value"] is not None
        # the toy's broadcast: three later shards, a 4 KiB row each
        assert line["metrics"]["xcard_mib_per_step"]["value"] == \
            pytest.approx(3 * 4096 / 2**20, rel=0.01)
        assert "relax_roofline_pct" not in names
    else:
        assert {"setup_s", "answers_per_s", "query_p95_ms"} <= names


def test_driver_blocks_are_the_port_layout():
    """The driver's blocks, built on the run's device, equal
    ``make_block``'s and ``stack_delta_blocks``' arrays."""
    from bench.drivers.commongraph_sharded import device_block
    from repro_torch.graph.edgeset import make_block, stack_delta_blocks
    rng = np.random.default_rng(5)
    n = 300
    src, dst = (rng.integers(0, n, (3, 77)).astype(np.int32)
                for _ in range(2))
    w = rng.random((3, 77), dtype=np.float32)
    got = device_block(src, dst, w, n, 128, "cpu")
    want = stack_delta_blocks([(src[i], dst[i], w[i]) for i in range(3)],
                              n, granule=128, num_lanes=3, device="cpu")
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    got = device_block(src[0], dst[0], w[0], n, 96, "cpu")
    want = make_block(src[0], dst[0], w[0], n, granule=96, device="cpu")
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("snapshots,cards,want", [
    (256, 4, list(range(256))),
    (192, 4, list(range(192))),
    (5, 4, [0, 1, 2, 4, 6]),
    (6, 4, [0, 1, 2, 3, 4, 6]),
    (5, 2, [0, 1, 2, 3, 4]),
    (5, 1, [0, 1, 2, 3, 4])])
def test_lane_layout_shares_the_snapshots_evenly(snapshots, cards, want):
    """Each card's snapshots lead its slice of the window's lanes, as
    many a card, the cards' counts differing by one at most."""
    from bench.drivers.commongraph_sharded import lane_layout
    assert lane_layout(snapshots, cards) == want


# -- faults in the placed step: each must turn ``correct`` false -------------

def _shard_at_start(real):
    """The second shard's lanes keep the state they were given."""
    def resident(num_nodes, semiring, shards, *args, **kwargs):
        res = real(num_nodes, semiring, shards, *args, **kwargs)
        out = list(res.shards)
        out[1] = out[1]._replace(values=shards[1].values.clone())
        return res._replace(shards=tuple(out))
    return resident


def _shards_swapped(real):
    """The first two shards' answers come back in each other's place."""
    def resident(num_nodes, semiring, shards, *args, **kwargs):
        res = real(num_nodes, semiring, shards, *args, **kwargs)
        out = list(res.shards)
        out[0], out[1] = out[1], out[0]
        return res._replace(shards=tuple(out))
    return resident


@pytest.mark.parametrize("fault", [_shard_at_start, _shards_swapped])
def test_fault_makes_the_run_incorrect(sharded_root, capsys, monkeypatch,
                                       fault):
    from repro_torch.configs import commongraph
    monkeypatch.setattr(commongraph, "incremental_additions_resident",
                        fault(commongraph.incremental_additions_resident))
    rc, line = run_line(sharded_root, capsys, TOY_CELL)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["value_mismatches"]["value"] > 0
    assert line["failed"] > 0
