"""The port's measured-cost model (``repro_torch.core.costmodel``) and
evolve's ``--calibrate``, held against the JAX package.

``SweepCostModel`` is integer arithmetic, so its fit and prices equal the
reference's exactly, the degenerate-spread fallback and the errors
included, and the campaign planner priced by a fixed model picks the
reference's plan. ``calibrate`` measures host time, so its coefficients
are not a parity target: on the CPU it must return integers with
``per_edge_nanos >= 1``, and the calibrated plan must cost no more than
the raw-count plan under the same model (``BENCH_kernels``'
``calibrated_not_worse`` at its smoke plan parameters).
"""

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402

PLAN_FIELDS = ("campaigns", "anchors", "lane_budget", "data_extent",
               "slide_edges", "anchor_edges", "padding_edges",
               "total_edges", "stable_milli")
MODEL_FIELDS = ("per_edge_nanos", "per_sweep_nanos", "stable_milli")


def _model(m):
    return tuple(getattr(m, f) for f in MODEL_FIELDS)


def _stores(n, e, snaps, changes, seed):
    seq = make_evolving_sequence(n, e, snaps, changes, seed=seed)
    tseq = interop.sequence_from_arrays(seq.num_nodes, seq.snapshot_keys,
                                        seq.additions, seq.deletions,
                                        seq.weight_seed)
    return (jcore.SnapshotStore(seq),
            tcore.SnapshotStore(tseq, device="cpu"))


FIT_CASES = [
    ([(1000, 50_000), (4000, 140_000)], 0),           # a full affine fit
    ([(1000, 50_000), (4000, 140_000), (2500, 91_000)], 400),
    ([(3000, 9_000), (3000, 12_000)], 250),           # degenerate spread
    ([(0, 7_000), (0, 9_000)], 0),                    # degenerate, zero edges
    ([(1000, 900_000), (9000, 100_000)], 0),          # negative slope: clamps
    ([(10, 5), (20, 6)], 1000),                       # rounds to 0: clamps
    ([(5000, 1_000)], 0),                             # one sample
]


@pytest.mark.parametrize("samples,stable", FIT_CASES)
def test_fit_and_prices_equal_reference(samples, stable):
    """``fit``, ``hop_cost`` and ``anchor_cost`` equal the reference's."""
    t = tcost.SweepCostModel.fit(samples, stable_milli=stable)
    j = jcost.SweepCostModel.fit(samples, stable_milli=stable)
    assert _model(t) == _model(j)
    assert all(isinstance(x, int) for x in _model(t))
    assert t.per_edge_nanos >= 1 and t.per_sweep_nanos >= 0
    for edges in (0, 1, 999, 1000, 123_457, 1 << 24):
        assert t.hop_cost(edges) == j.hop_cost(edges)
        assert t.anchor_cost(edges) == j.anchor_cost(edges)


@settings(max_examples=40, deadline=None)
@given(samples=st.lists(st.tuples(st.integers(0, 1 << 22),
                                  st.integers(0, 10**9)),
                        min_size=1, max_size=5),
       stable=st.integers(0, 1000))
def test_fit_property_equals_reference(samples, stable):
    t = tcost.SweepCostModel.fit(samples, stable_milli=stable)
    j = jcost.SweepCostModel.fit(samples, stable_milli=stable)
    assert _model(t) == _model(j)
    assert t.hop_cost(samples[0][0]) == j.hop_cost(samples[0][0])


def test_errors_equal_reference():
    for mod in (tcost, jcost):
        with pytest.raises(ValueError):
            mod.SweepCostModel.fit([])
        for bad in (-1, 1001):
            with pytest.raises(ValueError):
                mod.SweepCostModel(3, 10, bad).hop_cost(100)
    # a frozen dataclass, as in the reference
    with pytest.raises(Exception):
        tcost.SweepCostModel(1, 0).per_edge_nanos = 2


@pytest.mark.parametrize("lane_budget", [2, 4, 8])
@pytest.mark.parametrize("coeffs", [(1, 0, 0), (17, 498_960, 500),
                                    (3, 2_000_000, 950)])
def test_optimal_campaigns_with_fixed_model_equal_reference(lane_budget,
                                                            coeffs):
    """The campaign DP priced by the same fixed model picks the reference's
    partition and volumes; (1, 0, 0) equals the raw-count plan."""
    js, ts = _stores(400, 3_000, 6, 200, 0)
    windows = tcore.slide_windows(6, 2)
    t = tcore.optimal_campaigns(ts, windows, lane_budget=lane_budget,
                                cost_model=tcost.SweepCostModel(*coeffs))
    j = jcore.optimal_campaigns(js, windows, lane_budget=lane_budget,
                                cost_model=jcost.SweepCostModel(*coeffs))
    for field in PLAN_FIELDS:
        assert getattr(t, field) == getattr(j, field), field
    if coeffs == (1, 0, 0):
        raw = tcore.optimal_campaigns(ts, windows, lane_budget=lane_budget)
        assert t.total_edges == raw.total_edges
        assert t.campaigns == raw.campaigns


def test_calibrate_on_cpu_returns_integer_model():
    """``calibrate`` times two sweep scales on the CPU and fits integer
    coefficients; ``measure_sweep_nanos`` is a positive integer."""
    _, ts = _stores(400, 3_000, 6, 200, 0)
    sr = TSEMI["sssp"]
    model = tcost.calibrate(ts, sr, 0, stable_milli=500, fused_k=4,
                            repeats=2)
    assert isinstance(model, tcore.SweepCostModel)
    assert all(isinstance(x, int) for x in _model(model))
    assert model.per_edge_nanos >= 1 and model.per_sweep_nanos >= 0
    assert model.stable_milli == 500
    nanos = tcost.measure_sweep_nanos(ts.common_graph_view(), sr, 0,
                                      repeats=1)
    assert isinstance(nanos, int) and nanos > 0


def test_calibrated_not_worse_at_bench_kernels_smoke():
    """``BENCH_kernels``' planner_calibration row (plan_n 400, plan_e
    3,000, 6 snapshots, 200 changes, width 3, stable 500‰, fused k 4):
    the calibrated plan costs no more than the raw-count plan priced under
    the same model; the reference's planner picks the same two plans under
    the port's coefficients."""
    js, ts = _stores(400, 3_000, 6, 200, 0)
    windows = tcore.slide_windows(6, 3)
    model = tcost.calibrate(ts, TSEMI["sssp"], 0, stable_milli=500,
                            fused_k=4)
    raw_plan = tcore.optimal_campaigns(ts, windows)
    raw_priced = tcore.campaign_volume(ts, raw_plan.campaigns,
                                       cost_model=model).total_edges
    cal_plan = tcore.optimal_campaigns(ts, windows, cost_model=model)
    assert cal_plan.total_edges <= raw_priced
    jmodel = jcost.SweepCostModel(*_model(model))
    jraw = jcore.optimal_campaigns(js, windows)
    jcal = jcore.optimal_campaigns(js, windows, cost_model=jmodel)
    assert raw_plan.campaigns == jraw.campaigns
    assert cal_plan.campaigns == jcal.campaigns
    assert cal_plan.total_edges == jcal.total_edges
    assert raw_priced == jcore.campaign_volume(
        js, jraw.campaigns, cost_model=jmodel).total_edges


def test_evolve_calibrate_on_cpu(capsys):
    """``evolve --calibrate --device cpu`` prints the fitted prices, plans
    the timed stream in modeled ns, verifies, and needs ``--stream``."""
    from repro_torch.launch import evolve
    summary = evolve.main(["--nodes", "300", "--edges", "2000",
                           "--snapshots", "5", "--changes", "120",
                           "--alg", "sssp", "--verify", "--device", "cpu",
                           "--window", "3", "--stream", "--campaign-width",
                           "auto", "--fused-k", "4", "--calibrate"])
    out = capsys.readouterr().out
    assert summary["verified"]
    win = summary["windows"]
    model = win["cost_model"]
    assert isinstance(model, tcore.SweepCostModel)
    assert win["stream"].plan.cost_model is model
    assert model.stable_milli == win["stream"].plan.cost_model.stable_milli
    assert (f"[evolve] calibrated sweep cost: {model.per_edge_nanos}ns/edge"
            f" + {model.per_sweep_nanos}ns/sweep") in out
    assert "modeled ns (priced at calibrated SweepCostModel)" in out
    plain = evolve.main(["--nodes", "300", "--edges", "2000", "--snapshots",
                         "5", "--changes", "120", "--device", "cpu",
                         "--window", "3", "--stream"])
    assert plain["windows"]["cost_model"] is None
    with pytest.raises(SystemExit):
        evolve.main(["--device", "cpu", "--window", "3", "--calibrate"])
