"""The port's execution modes held against the JAX reference, bit for bit:
KickStarter (per step: values, edge_work, sweeps, tainted), Direct-Hop
sequential and batched, Triangular-Grid work sharing sequential and
batched (results, per-hop edge_work, stable_milli, lane_layout), on the
same evolving sequence carried across with ``interop``; and the port's
evolve driver end to end on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402

SEMIRINGS = sorted(JSEMI)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def stores():
    seq = make_evolving_sequence(256, 2000, 5, 160, seed=7)
    tseq = interop.sequence_from_arrays(seq.num_nodes, seq.snapshot_keys,
                                        seq.additions, seq.deletions,
                                        seq.weight_seed)
    return (jcore.SnapshotStore(seq, granule=512),
            tcore.SnapshotStore(tseq, granule=512, device="cpu"))


def _assert_stats(t, j, msg):
    assert t.edge_work == j.edge_work, f"{msg}: edge_work"
    assert t.sweeps == j.sweeps, f"{msg}: sweeps"
    assert t.tainted == j.tainted, f"{msg}: tainted"


def _assert_values(t, j, msg):
    np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=msg)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_kickstarter_matches_reference(stores, name):
    js, ts = stores
    jres, jstats = jcore.run_kickstarter_stream(js, JSEMI[name], 0)
    tres, tstats = tcore.run_kickstarter_stream(ts, TSEMI[name], 0)
    assert len(tres) == len(jres) == 5
    for i, (t, j) in enumerate(zip(tres, jres)):
        _assert_values(t, j, f"{name} step {i}")
    for i, (t, j) in enumerate(zip(tstats, jstats)):
        _assert_stats(t, j, f"{name} step {i}")
    assert sum(s.tainted for s in tstats) > 0


@pytest.mark.parametrize("name", SEMIRINGS)
def test_direct_hop_matches_reference(stores, name):
    js, ts = stores
    for runner in ("run_direct_hop", "run_direct_hop_batched"):
        j = getattr(jcore, runner)(js, JSEMI[name], 0)
        t = getattr(tcore, runner)(ts, TSEMI[name], 0)
        for i, (a, b) in enumerate(zip(t.results, j.results)):
            _assert_values(a, b, f"{name} {runner} snap {i}")
        _assert_stats(t.base_stats, j.base_stats, f"{name} {runner} base")
        assert len(t.hop_stats) == len(j.hop_stats)
        for i, (a, b) in enumerate(zip(t.hop_stats, j.hop_stats)):
            _assert_stats(a, b, f"{name} {runner} hop {i}")
        assert t.lane_layout == j.lane_layout


def test_plans_match_reference(stores):
    js, ts = stores

    def shape(node):
        return (node.window, [shape(c) for c in node.children])

    jp, tp = jcore.optimal_plan(js), tcore.optimal_plan(ts)
    assert shape(tp) == shape(jp)
    assert tcore.plan_added_edges(ts, tp) == jcore.plan_added_edges(js, jp)
    assert shape(tcore.bisection_plan(n=5)) == shape(jcore.bisection_plan(n=5))
    assert [[(pi, c.window) for pi, c in lvl] for lvl in
            tcore.plan_levels(tp)] == \
        [[(pi, c.window) for pi, c in lvl] for lvl in jcore.plan_levels(jp)]
    with pytest.raises(ValueError, match="j= or n="):
        tcore.direct_hop_plan()


@pytest.mark.parametrize("name", SEMIRINGS)
def test_work_sharing_matches_reference(stores, name):
    js, ts = stores
    jplan, tplan = jcore.optimal_plan(js), tcore.optimal_plan(ts)
    for runner, kw in (("run_plan", {}), ("run_plan_batched", {}),
                       ("run_plan", {"track_parents": True})):
        j = getattr(jcore, runner)(js, jplan, JSEMI[name], 0, **kw)
        t = getattr(tcore, runner)(ts, tplan, TSEMI[name], 0, **kw)
        assert sorted(t.results) == sorted(j.results) == list(range(5))
        for i in range(5):
            _assert_values(t.results[i], j.results[i], f"{name} {runner} {i}")
        _assert_stats(t.base_stats, j.base_stats, f"{name} {runner} base")
        assert [(s.edge_work, s.sweeps) for s in t.hop_stats] == \
            [(s.edge_work, s.sweeps) for s in j.hop_stats], runner
        assert t.stable_milli == j.stable_milli
        assert t.lane_layout == j.lane_layout
        assert t.added_edges == j.added_edges


def test_evolve_driver_runs_clean_on_cpu(capsys):
    from repro_torch.launch import evolve
    summary = evolve.main(["--nodes", "300", "--edges", "2000",
                           "--snapshots", "4", "--changes", "120",
                           "--alg", "sswp", "--verify", "--device", "cpu"])
    assert summary["verified"]
    assert set(summary["wall_s"]) == set(evolve.MODES)
    assert all(len(v) == 4 for v in summary["results"].values())
    assert "verify: all modes match" in capsys.readouterr().out


def test_evolve_fixpoint_certificate_rejects_unconverged(stores):
    from repro_torch.graph.engine import init_values
    from repro_torch.launch.evolve import _check_fixpoint
    _, ts = stores
    view = ts.snapshot_view(0)
    fresh = init_values(ts.num_nodes, TSEMI["sssp"], 0, device="cpu")
    with pytest.raises(AssertionError, match="not a fixpoint"):
        _check_fixpoint(TSEMI["sssp"], view, fresh, "fresh")
