"""Lane sharding over a ``data`` mesh in the port (``repro_torch.launch.mesh``,
``core/trigrid.py`` ``_shard_snapshot_axis`` and the ``mesh=`` of every
batched executor, the stream planner, the query service and evolve's
``--shard``), held against the JAX package's *unmeshed* runs.

The meshed JAX tests fail on this tree's jax (ROADMAP §C), so the
reference's forced 4-device cases run here at their own parameters on a
mesh of the CPU named four times: a real 4-way split of the lane axis.
Tolerance everywhere: none, bit for bit; ``edge_work`` totals within
1e-6, as the reference's own forced-mesh tests assert.
"""

import contextlib
import io
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core.trigrid import _shard_snapshot_axis as j_shard  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from repro.graph.edgeset import lane_bucket as j_lane_bucket  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from repro.launch import evolve as jevolve  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.trigrid import _shard_snapshot_axis  # noqa: E402
from repro_torch.graph.edgeset import lane_bucket  # noqa: E402
from repro_torch.graph.engine import (  # noqa: E402
    LaneShard,
    gather_lane_states,
    incremental_additions_batched,
    incremental_additions_sharded,
    run_to_fixpoint,
)
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402
from repro_torch.launch import evolve as tevolve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import SnapshotMesh, make_snapshot_mesh  # noqa: E402

SEMIRINGS = sorted(JSEMI)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, msg=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=msg)


def _cpu_mesh(extent):
    return make_snapshot_mesh(["cpu"] * extent)


def _stores(n, e, snaps, changes, seed, granule):
    """The same sequence in a reference store and a port store (CPU)."""
    seq = make_evolving_sequence(n, e, snaps, changes, seed=seed)
    tseq = interop.sequence_from_arrays(seq.num_nodes, seq.snapshot_keys,
                                        seq.additions, seq.deletions,
                                        seq.weight_seed)
    return (jcore.SnapshotStore(seq, granule=granule),
            tcore.SnapshotStore(tseq, granule=granule, device="cpu"))


def _forced_mesh_stores():
    """The reference's forced-mesh plan and slide cases' sequence."""
    return _stores(150, 900, 5, 120, seed=11, granule=64)


def _work(run):
    return sum(h.edge_work for h in run.hop_stats)


# -- (a) the mesh ----------------------------------------------------------------

def test_make_snapshot_mesh_extent_repeats_and_no_card(monkeypatch):
    """The extent is the device count, a device may repeat, the shape
    reads like the reference's ``mesh.shape["data"]``; without a card
    and without ``devices`` it raises (no CPU fallback), and a mesh of
    two kinds of device is refused."""
    mesh = make_snapshot_mesh(["cpu"] * 4)
    assert isinstance(mesh, SnapshotMesh)
    assert mesh.shape == {"data": 4} and mesh.shape["data"] == 4
    assert mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_snapshot_mesh([torch.device("cpu")]).shape["data"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        make_snapshot_mesh()
    with pytest.raises(ValueError, match="one kind of device"):
        make_snapshot_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one device"):
        make_snapshot_mesh([])


@pytest.mark.parametrize("device,order", [
    ("cuda", [0, 1, 2, 3]), ("cuda:0", [0, 1, 2, 3]),
    ("cuda:1", [1, 0, 2, 3]), ("cuda:3", [3, 0, 1, 2])])
def test_evolve_shard_mesh_leads_with_the_chosen_card(monkeypatch, device,
                                                      order):
    """evolve's ``--shard`` mesh (``mesh_led_by``, as evolve builds it)
    on 4 cards: the ``--device`` card first, then the others in index
    order, so results gather on the store's card; ``--device cpu`` keeps
    the one-device CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = tevolve.mesh_led_by(torch.device(device))
    assert mesh.devices == tuple(torch.device("cuda", i) for i in order)
    assert mesh.shape["data"] == 4
    cpu = tevolve.mesh_led_by(torch.device("cpu"))
    assert cpu.devices == (torch.device("cpu"),)


# -- (b) the split ----------------------------------------------------------------

@pytest.mark.parametrize("extent", [1, 2, 4, 8])
def test_shard_snapshot_axis_contiguous_slices(extent):
    """Device d of D gets lanes [d·b/D, (d+1)·b/D) of values, parents,
    every stacked block and lane_valid, on its device; without a mesh
    the inputs come back unchanged."""
    _, store = _forced_mesh_stores()
    bucket = lane_bucket(5, extent)
    hops = [((0, 4), (i, i)) for i in range(5)]
    stacked = store.delta_stack(hops, num_lanes=bucket)
    n = store.num_nodes
    values = torch.arange(bucket * n, dtype=torch.float32).reshape(bucket, n)
    parent = torch.arange(bucket * n, dtype=torch.int32).reshape(bucket, n)
    lane_valid = torch.arange(bucket) < 5
    blocks = (stacked,)
    inputs = (values, parent, blocks, lane_valid)
    same = _shard_snapshot_axis(None, *inputs)
    assert all(a is b for a, b in zip(same, inputs))
    shards = _shard_snapshot_axis(_cpu_mesh(extent), values, parent,
                                  (stacked,), lane_valid)
    assert len(shards) == extent
    per = bucket // extent
    for d, shard in enumerate(shards):
        rows = slice(d * per, (d + 1) * per)
        assert isinstance(shard, LaneShard)
        assert shard.values.device == torch.device("cpu")
        assert torch.equal(shard.values, values[rows])
        assert torch.equal(shard.parent, parent[rows])
        assert torch.equal(shard.lane_valid, lane_valid[rows])
        (blk,) = shard.delta_blocks
        for got, want in zip(blk, stacked):
            assert torch.equal(got, want[rows])
        assert shard.shared_blocks == ()


def test_shard_snapshot_axis_refuses_what_the_reference_refuses():
    """A lane count the extent does not divide raises the reference's
    ValueError, word for word (no replicated fallback); a mesh whose
    first device is not the state's is refused too."""
    values = torch.zeros((6, 10))
    parent = torch.zeros((6, 10), dtype=torch.int32)
    lane_valid = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError) as want:
        j_shard(types.SimpleNamespace(shape={"data": 4}), np.zeros((6, 10)),
                np.zeros((6, 10), np.int32), (), np.ones(6, bool))
    with pytest.raises(ValueError) as got:
        _shard_snapshot_axis(_cpu_mesh(4), values, parent, (), lane_valid)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="first device"):
        _shard_snapshot_axis(make_snapshot_mesh(["meta", "meta"]), values,
                             parent, (), lane_valid)
    _, store = _forced_mesh_stores()
    with pytest.raises(ValueError, match="first device"):
        tcore.run_direct_hop_batched(store, TSEMI["sssp"], 0,
                                     mesh=make_snapshot_mesh(["meta"]))


# -- (c) the reference's forced-mesh cases, at their own parameters ---------------

@pytest.mark.parametrize("plan_name", ["optimal", "direct_hop"])
def test_plan_on_forced_four_device_mesh(plan_name):
    """tests/test_trigrid_batched.py's forced-mesh script on a 4 x cpu
    mesh: every level's lanes (some not dividing 4) bucket to the
    reference's ``lane_bucket(lanes, 4)`` and shard; results equal the
    reference's unmeshed batched and sequential runs bit for bit, and the
    edge_work totals agree within 1e-6."""
    js, ts = _forced_mesh_stores()
    plan = {"optimal": jcore.optimal_plan(js),
            "direct_hop": jcore.direct_hop_plan(n=5)}[plan_name]
    tplan = {"optimal": tcore.optimal_plan(ts),
             "direct_hop": tcore.direct_hop_plan(n=5)}[plan_name]
    levels = [len(level) for level in jcore.plan_levels(plan)]
    assert [len(level) for level in tcore.plan_levels(tplan)] == levels
    assert any(lanes % 4 for lanes in levels)
    sr = JSEMI["sssp"]
    seq_run = jcore.run_plan(js, plan, sr, 0, track_parents=True)
    jbat = jcore.run_plan_batched(js, plan, sr, 0, track_parents=True)
    run = tcore.run_plan_batched(ts, tplan, TSEMI["sssp"], 0,
                                 track_parents=True, mesh=_cpu_mesh(4))
    assert run.lane_layout == [(lanes, j_lane_bucket(lanes, 4))
                               for lanes in levels]
    for i in range(5):
        _same(run.results[i], jbat.results[i], f"{plan_name} snap {i}")
        _same(run.results[i], seq_run.results[i], f"{plan_name} snap {i}")
    assert abs(_work(run) - _work(seq_run)) < 1e-6
    assert abs(_work(run) - _work(jbat)) < 1e-6
    assert run.stable_milli == jbat.stable_milli


def test_window_slide_on_forced_four_device_mesh():
    """tests/test_window.py's forced-mesh script: 3 windows on a 4 x cpu
    mesh bucket to 4 lanes, one per device (shards of one lane, one of
    them masked), and equal the reference's unmeshed slides bit for bit
    with the same edge_work total."""
    js, ts = _forced_mesh_stores()
    windows = jcore.slide_windows(5, 3)
    assert len(windows) == 3
    seq_run = jcore.run_window_slide(js, JSEMI["sssp"], 0, 3,
                                     track_parents=True)
    jbat = jcore.run_window_slide_batched(js, JSEMI["sssp"], 0, 3,
                                          track_parents=True)
    run = tcore.run_window_slide_batched(ts, TSEMI["sssp"], 0, 3,
                                         track_parents=True,
                                         mesh=_cpu_mesh(4))
    assert run.lane_layout == [(3, j_lane_bucket(3, 4))] == [(3, 4)]
    for wnd in windows:
        _same(run.results[wnd], seq_run.results[wnd], f"window {wnd}")
        _same(run.results[wnd], jbat.results[wnd], f"window {wnd}")
    assert abs(_work(run) - _work(seq_run)) < 1e-6
    assert run.stable_milli == jbat.stable_milli


def test_window_stream_on_forced_four_device_mesh():
    """tests/test_window_stream.py's snapshot-mesh case (campaigns of 2
    width-2 windows) on a 4 x cpu mesh equals the reference's unmeshed
    stream bit for bit: values, anchor events and edge_work totals."""
    js, ts = _stores(200, 1400, 5, 100, seed=29, granule=64)
    plain = jcore.run_window_stream_batched(js, JSEMI["sssp"], 0, 2,
                                            campaign_width=2)
    meshed = tcore.run_window_stream_batched(ts, TSEMI["sssp"], 0, 2,
                                             campaign_width=2,
                                             mesh=_cpu_mesh(4))
    assert list(meshed.results) == list(plain.results)
    for wnd in plain.results:
        _same(meshed.results[wnd], plain.results[wnd], f"window {wnd}")
    assert meshed.anchor_events == plain.anchor_events
    assert meshed.lane_layout == [(lanes, j_lane_bucket(lanes, 4))
                                  for lanes, _ in plain.lane_layout]
    assert abs(_work(meshed) - _work(plain)) < 1e-6


# -- (d) five semirings x extents x parents ----------------------------------------

_REFERENCE_RUNS = {}


def _reference_runs(name, track):
    """The reference's unmeshed dhb and optimal-plan wsb over the
    forced-mesh sequence (computed once per semiring and parents)."""
    key = (name, track)
    if key not in _REFERENCE_RUNS:
        js, _ = _forced_mesh_stores()
        sr = JSEMI[name]
        _REFERENCE_RUNS[key] = (
            jcore.run_direct_hop_batched(js, sr, 0, track_parents=track),
            jcore.run_plan_batched(js, jcore.optimal_plan(js), sr, 0,
                                   track_parents=track))
    return _REFERENCE_RUNS[key]


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("extent", [1, 2, 4])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_batched_executors_on_mesh(name, extent, track):
    """``run_direct_hop_batched`` and ``run_plan_batched`` on an
    ``extent`` x cpu mesh equal the unmeshed port and the reference bit
    for bit: values, per-launch edge_work and sweeps, stable fraction."""
    jdhb, jwsb = _reference_runs(name, track)
    _, ts = _forced_mesh_stores()
    sr = TSEMI[name]
    plan = tcore.optimal_plan(ts)
    mesh = _cpu_mesh(extent)
    dhb = tcore.run_direct_hop_batched(ts, sr, 0, track_parents=track,
                                       mesh=mesh)
    wsb = tcore.run_plan_batched(ts, plan, sr, 0, track_parents=track,
                                 mesh=mesh)
    plain_dhb = tcore.run_direct_hop_batched(ts, sr, 0, track_parents=track)
    plain_wsb = tcore.run_plan_batched(ts, plan, sr, 0, track_parents=track)
    for got, plain, want in ((dhb, plain_dhb, jdhb), (wsb, plain_wsb, jwsb)):
        assert got.lane_layout == [(lanes, j_lane_bucket(lanes, extent))
                                   for lanes, _ in want.lane_layout]
        assert [(h.edge_work, h.sweeps) for h in got.hop_stats] == \
            [(h.edge_work, h.sweeps) for h in plain.hop_stats] == \
            [(h.edge_work, h.sweeps) for h in want.hop_stats]
    for i in range(5):
        _same(dhb.results[i], plain_dhb.results[i], f"dhb snap {i}")
        _same(dhb.results[i], jdhb.results[i], f"dhb snap {i}")
        _same(wsb.results[i], plain_wsb.results[i], f"wsb snap {i}")
        _same(wsb.results[i], jwsb.results[i], f"wsb snap {i}")
    assert wsb.stable_milli == plain_wsb.stable_milli == jwsb.stable_milli


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("extent", [2, 4, 8])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_sharded_engine_lane_for_lane(name, extent, track):
    """The engine alone: 8 direct-hop lanes (3 masked) split into shards
    of 4, 2 or 1 lanes equal the unsharded launch lane for lane, bit for
    bit: values, parents, iterations, edge_work and unstable."""
    _, store = _stores(150, 900, 5, 120, seed=11, granule=64)
    sr = TSEMI[name]
    apex = store.common_graph_view(0, 4)
    base = run_to_fixpoint(apex, sr, 0, track_parents=track)
    stacked = store.delta_stack([((0, 4), (i, i)) for i in range(5)],
                                num_lanes=8)
    values, parent = gather_lane_states(base.values[None], base.parent[None],
                                        [0] * 8)
    lane_valid = torch.arange(8) < 5
    want = incremental_additions_batched(
        store.num_nodes, sr, values, parent, shared_blocks=apex.blocks,
        delta_blocks=(stacked,), seed_blocks=(stacked,),
        lane_valid=lane_valid, track_parents=track)
    shards = [s._replace(shared_blocks=apex.blocks)
              for s in _shard_snapshot_axis(_cpu_mesh(extent), values,
                                            parent, (stacked,), lane_valid)]
    got = incremental_additions_sharded(store.num_nodes, sr, shards,
                                        track_parents=track)
    for field in want._fields:
        _same(getattr(got, field), getattr(want, field), field)
        assert getattr(got, field).dtype == getattr(want, field).dtype


# -- (e) the planner on a mesh ------------------------------------------------------

PLAN_FIELDS = ("campaigns", "anchors", "lane_budget", "data_extent",
               "slide_edges", "anchor_edges", "padding_edges",
               "stable_milli")


@pytest.mark.parametrize("extent", [1, 2, 4])
@pytest.mark.parametrize("snaps,width", [(5, 2), (8, 3)])
def test_auto_campaigns_on_mesh_match_reference_plan(snaps, width, extent):
    """``campaign_width="auto"`` on an ``extent`` x cpu mesh plans with
    the mesh's data extent: the ``CampaignPlan`` equals the reference's
    ``optimal_campaigns(..., data_extent=extent)`` field for field, and
    every window equals the reference's unmeshed auto stream bit for
    bit."""
    js, ts = _stores(200, 1400, snaps, 100, seed=29, granule=64)
    windows = jcore.slide_windows(snaps, width)
    want = jcore.optimal_campaigns(js, windows, data_extent=extent)
    run = tcore.run_window_stream_batched(ts, TSEMI["sssp"], 0, width,
                                          campaign_width="auto",
                                          mesh=_cpu_mesh(extent))
    for field in PLAN_FIELDS:
        assert getattr(run.plan, field) == getattr(want, field), field
    assert run.campaigns == want.campaigns
    assert run.lane_layout == [(len(c), j_lane_bucket(len(c), extent))
                               for c in want.campaigns]
    plain = jcore.run_window_stream_batched(js, JSEMI["sssp"], 0, width,
                                            campaign_width="auto")
    for wnd in windows:
        _same(run.results[wnd], plain.results[wnd], f"window {wnd}")


# -- (f) the query service on a mesh -------------------------------------------------

METRIC_FIELDS = ("admitted", "completed", "turns", "launches", "lanes",
                 "anchor_rebuilds", "anchor_hops", "anchor_hits",
                 "edge_work", "seeded_vertex_lanes", "unstable_vertex_lanes",
                 "stable_fraction_milli")
RECORD_FIELDS = ("group", "anchor", "windows", "clients", "lanes",
                 "anchor_events", "edge_work", "iterations")


def _smoke_service(mesh):
    """The SKILL's smoke load (``serve --service --clients 4 --seed 7``)
    on a fresh CPU store."""
    _, store = _stores(400, 3_000, 6, 200, seed=7, granule=4096)
    specs, schedule = tserve.generate_load(6, num_clients=4, seed=7)
    service, clients = tserve.run_service_load(store, specs, schedule,
                                               mesh=mesh)
    return store, service, clients


def _ds_nbytes(store):
    return sum(sum(a.numel() * a.element_size() for a in blk)
               for tag, blk in store._blocks.items() if tag[0] == "DS")


def test_query_service_on_four_device_mesh():
    """The smoke load on a 4 x cpu mesh equals the unmeshed port's (and
    the reference's) results bit for bit, with every metric count and
    launch record equal except the bucket, which is the reference's
    ``lane_bucket(lanes, 4)`` (and so ``padded_lanes``). The store's LRU
    holds the same tags in the same order, each stacked Δ tag under its
    re-bucketed lane count, with the same evictions and the same bytes
    outside the stacks: the mesh adds no cached entry."""
    store0, plain, plain_clients = _smoke_service(None)
    store, svc, clients = _smoke_service(_cpu_mesh(4))
    m, pm = svc.metrics(), plain.metrics()
    for field in METRIC_FIELDS:
        assert getattr(m, field) == getattr(pm, field), field
    assert m.padded_lanes == sum(r.bucket - r.lanes for r in svc.launch_log)
    assert len(svc.launch_log) == len(plain.launch_log)
    for rec, prec in zip(svc.launch_log, plain.launch_log):
        for field in RECORD_FIELDS:
            assert getattr(rec, field) == getattr(prec, field), field
        assert rec.bucket == j_lane_bucket(rec.lanes, 4)
    for got, want in zip(clients, plain_clients):
        assert list(got.results) == list(want.results)
        for wnd, vals in want.results.items():
            _same(got.results[wnd], vals, f"{got.name} {wnd}")
    js, _ = _stores(400, 3_000, 6, 200, seed=7, granule=4096)
    from repro.launch import serve as jserve
    specs, schedule = jserve.generate_load(6, num_clients=4, seed=7)
    _, jclients = jserve.run_service_load(js, specs, schedule)
    for got, want in zip(clients, jclients):
        for wnd, vals in want.results.items():
            _same(got.results[wnd], vals, f"{got.name} {wnd} vs reference")

    def rebucket(tag):
        if tag[0] == "DS":
            return ("DS", lane_bucket(len(tag) - 2, 4)) + tag[2:]
        return tag

    assert list(store._blocks) == [rebucket(t) for t in store0._blocks]
    assert store.evictions == store0.evictions
    assert store.cached_nbytes - _ds_nbytes(store) == \
        store0.cached_nbytes - _ds_nbytes(store0)
    assert store.cached_nbytes == sum(
        sum(a.numel() * a.element_size() for a in blk)
        if not hasattr(blk, "nbytes") else blk.nbytes
        for blk in store._blocks.values())


def test_replicas_stay_outside_the_lru():
    """``SnapshotStore.replicas`` places a view's blocks on another device
    (here ``meta``) without touching the LRU: ``cached_nbytes``,
    evictions and tag order are unchanged; the copy is kept per (tag,
    device) and dropped with its tag (release, eviction). A block
    already on the device comes back as itself."""
    _, store = _forced_mesh_stores()
    view = store.common_graph_view(0, 4)
    store.delta_block((0, 4), (1, 1))
    tags, nbytes, evictions = list(store._blocks), store.cached_nbytes, \
        store.evictions
    meta = torch.device("meta")
    (copy,) = store.replicas(view.blocks, meta)
    assert copy.src.device == meta and copy.src.shape == view.blocks[0].src.shape
    assert store.replicas(view.blocks, meta)[0] is copy
    assert store.replicas(view.blocks, torch.device("cpu"))[0] \
        is view.blocks[0]
    assert (list(store._blocks), store.cached_nbytes, store.evictions) == \
        (tags, nbytes, evictions)
    store.release(("T",))
    view = store.common_graph_view(0, 4)
    assert store.replicas(view.blocks, meta)[0] is not copy
    # an eviction drops the evicted tag's copies too
    store.cache_bytes = 1
    (copy,) = store.replicas(view.blocks, meta)
    store.delta_block((0, 4), (2, 2))
    assert ("T", 0, 4) not in store._blocks
    view = store.common_graph_view(0, 4)
    assert store.replicas(view.blocks, meta)[0] is not copy


# -- (g) evolve --shard ---------------------------------------------------------------

def _reference_report(label, layout):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jevolve._shard_report(types.SimpleNamespace(shape={"data": 1}),
                              label, layout)
    return out.getvalue().splitlines()


def test_evolve_shard_on_cpu(capsys):
    """``evolve --device cpu --shard --verify --window 3 --window-batch
    --stream`` runs clean on a one-device CPU mesh, and each
    ``shard[...]`` line is the reference's ``_shard_report`` line for the
    same lane layout, word for word."""
    summary = tevolve.main(["--nodes", "400", "--edges", "2500",
                            "--snapshots", "5", "--changes", "150",
                            "--device", "cpu", "--shard", "--verify",
                            "--window", "3", "--window-batch", "--stream"])
    out = capsys.readouterr().out
    assert summary["verified"]
    win = summary["windows"]
    layouts = {"dhb": summary["lane_layout"]["dhb"],
               "wsb": summary["lane_layout"]["wsb"],
               "windows": win["batch"].lane_layout,
               "stream": win["stream"].lane_layout}
    want = [line for label, layout in layouts.items()
            for line in _reference_report(label, layout)]
    got = [line for line in out.splitlines() if "shard[" in line]
    assert got == want and len(got) == 4
    for layout in layouts.values():
        assert all(b == j_lane_bucket(lanes, 1) for lanes, b in layout)
