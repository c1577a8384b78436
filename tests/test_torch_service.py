"""The port's query service (``repro_torch.core.service``) and its serving
CLI, held against the JAX package bit for bit.

Counterparts of the 11 tests of tests/test_service.py, each also run on
the reference's service over the same sequence: the port's drained
results equal its solo streams and the reference's service (values, every
``ServiceMetrics`` count, every ``LaunchRecord``). Also: ``generate_load``
plans equal the reference's for several seeds, ``BENCH_serve``'s smoke
``exact`` fields are reproduced to the digit, and ``serve --service``
runs on the CPU. The port has no ``gated`` option; the reference runs
gated where noted, with the same results.
"""

import json
import pathlib

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.snapshots import anchor_tag  # noqa: E402
from repro_torch.graph.edgeset import lane_bucket  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SNAPS = 7
SEMIRINGS = sorted(JSEMI)
METRIC_FIELDS = ("admitted", "completed", "turns", "launches", "lanes",
                 "padded_lanes", "anchor_rebuilds", "anchor_hops",
                 "anchor_hits", "edge_work", "seeded_vertex_lanes",
                 "unstable_vertex_lanes", "stable_fraction_milli")
RECORD_FIELDS = ("group", "anchor", "windows", "clients", "lanes", "bucket",
                 "anchor_events", "edge_work", "iterations")
# (package core, semirings) of the reference and of the port
J, T = (jcore, JSEMI), (tcore, TSEMI)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _seq_pair(n, e, snaps, changes, seed):
    seq = make_evolving_sequence(n, e, snaps, changes, seed=seed)
    return seq, interop.sequence_from_arrays(
        seq.num_nodes, seq.snapshot_keys, seq.additions, seq.deletions,
        seq.weight_seed)


def _stores(n=250, e=1800, snaps=SNAPS, changes=120, seed=13, granule=128,
            **kw):
    """The same sequence in a reference store and a port store (CPU)."""
    seq, tseq = _seq_pair(n, e, snaps, changes, seed)
    return (jcore.SnapshotStore(seq, granule=granule, **kw),
            tcore.SnapshotStore(tseq, granule=granule, device="cpu", **kw))


_SHARED = None


def _shared_stores():
    """One module-level store pair for the property test (see the
    reference's ``_shared_store``); both stores see the same history."""
    global _SHARED
    if _SHARED is None:
        _SHARED = _stores()
    return _SHARED


def _register(pkg, svc, alg, source, *, gated=False, **kw):
    """``svc.register`` with the package's semiring; ``gated`` reaches the
    reference only (the port has no gate)."""
    core, semi = pkg
    if core is jcore:
        kw["gated"] = gated
    return svc.register(semi[alg], source, **kw)


def _same(t, j, msg):
    np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=msg)


def _norm_tag(tag):
    """A cache tag with the reference's ``gated`` dropped from its qkey."""
    if tag[0] == "AS" and len(tag[1]) == 6:
        qkey = tag[1]
        return ("AS", qkey[:3] + qkey[4:], tag[2])
    return tag


def _assert_service(tsvc, jsvc, tclients, jclients, msg=""):
    """Port service == reference service: every metric count, every
    launch record and every client's results, bit for bit."""
    tm, jm = tsvc.metrics(), jsvc.metrics()
    for field in METRIC_FIELDS:
        assert getattr(tm, field) == getattr(jm, field), f"{msg} {field}"
    assert len(tsvc.launch_log) == len(jsvc.launch_log), msg
    for k, (tr, jr) in enumerate(zip(tsvc.launch_log, jsvc.launch_log)):
        for field in RECORD_FIELDS:
            assert getattr(tr, field) == getattr(jr, field), \
                f"{msg} launch {k} {field}"
    for tc, jc in zip(tclients, jclients):
        assert tc.name == jc.name and list(tc.results) == list(jc.results)
        assert tc.campaigns_done == jc.campaigns_done
        for wnd in jc.results:
            _same(tc.results[wnd], jc.results[wnd], f"{msg} {tc.name} {wnd}")


def _solo(pkg, store, client, windows, campaign_width):
    """The pre-service baseline: this client's stream alone, cold anchors."""
    core, semi = pkg
    store.release(("AS",))
    return core.run_window_stream_batched(
        store, semi[client.semiring.name], client.source, windows=windows,
        campaign_width=campaign_width)


# -- scheduling: fairness + bit-identity --------------------------------------

def _every_semiring(pkg, store):
    svc = pkg[0].QueryService(store, lane_budget=8, turn_budget=4)
    windows = tcore.slide_windows(SNAPS, 3)
    clients = [_register(pkg, svc, name, 0, campaign_width=2,
                         name=f"sr-{name}") for name in SEMIRINGS]
    for client in clients:
        svc.submit(client, windows)
    m = svc.drain()
    assert m.completed == m.admitted == len(SEMIRINGS) * len(windows)
    for client in clients:
        svc.unregister(client)
    return svc, clients, windows


def test_service_bit_identical_to_solo_every_semiring():
    """One client per semiring, drained together through packed launches:
    every window equals the port's solo stream and the reference's
    service bit for bit, with equal metrics and launch records."""
    js, ts = _stores()
    tsvc, tclients, windows = _every_semiring(T, ts)
    jsvc, jclients, _ = _every_semiring(J, js)
    _assert_service(tsvc, jsvc, tclients, jclients)
    for client in tclients:
        solo = _solo(T, ts, client, windows, campaign_width=2)
        for wnd in windows:
            _same(client.results[wnd], _np(solo.results[wnd]),
                  f"{client.name} diverged from solo at window {wnd}")
    assert ts.pinned_tags() == set()


def _twins(pkg, store, gated=False):
    svc = pkg[0].QueryService(store, lane_budget=8)
    windows = tcore.slide_windows(SNAPS, 2)
    clients = [_register(pkg, svc, "sssp", 0, campaign_width=2,
                         name=f"twin-{i}", gated=gated) for i in range(3)]
    for client in clients:
        svc.submit(client, windows)
    svc.drain()
    for client in clients:
        svc.unregister(client)
    return svc, clients, windows


def test_shared_qkey_strictly_fewer_rebuilds_than_solo():
    """Clients sharing a query key share anchor states: strictly fewer
    rebuilds than solo streams, same values; the reference's service run
    gated gives the same counts, records and values."""
    js, ts = _stores()
    tsvc, tclients, windows = _twins(T, ts)
    jsvc, jclients, _ = _twins(J, js, gated=True)
    _assert_service(tsvc, jsvc, tclients, jclients, "gated reference")
    m = tsvc.metrics()
    solo_rebuilds = 0
    for client in tclients:
        solo = _solo(T, ts, client, windows, campaign_width=2)
        solo_rebuilds += solo.anchor_rebuilds
        for wnd in windows:
            _same(client.results[wnd], _np(solo.results[wnd]), f"{wnd}")
    assert m.anchor_rebuilds < solo_rebuilds
    assert m.anchor_rebuilds + m.anchor_hops + m.anchor_hits > 0


def _round_robin(pkg, store, num_clients, turn_budget, width, start):
    svc = pkg[0].QueryService(store, lane_budget=8, turn_budget=turn_budget)
    windows = tcore.slide_windows(SNAPS, width, start=start)
    clients = [_register(pkg, svc, SEMIRINGS[i % len(SEMIRINGS)], i % 2,
                         campaign_width=1 + i % 3, name=f"prop-{i}")
               for i in range(num_clients)]
    for client in clients:
        svc.submit(client, windows)
    widths = [c.stream.campaign_width for c in clients]
    lane_cap = (sum(widths) if turn_budget is None
                else max(turn_budget, max(widths)))
    while svc.pending():
        ready = [c for c in clients if c.pending()]
        before = {c.name: c.campaigns_done for c in ready}
        for _ in range(len(svc.clients)):
            if not svc.pending():
                break
            records = svc.turn()
            assert sum(r.lanes for r in records) <= lane_cap
        for client in ready:
            assert client.campaigns_done > before[client.name], \
                f"{client.name} starved for {len(svc.clients)} turns"
    for client in clients:
        assert not client.pending()
        svc.unregister(client)
    return svc, clients, windows


@settings(max_examples=12, deadline=None)
@given(num_clients=st.integers(2, 4),
       turn_budget=st.sampled_from([2, 3, None]),
       width=st.integers(1, 3),
       start=st.integers(0, 2))
def test_round_robin_is_starvation_free(num_clients, turn_budget, width,
                                        start):
    """Bounded-turn advancement and bounded per-turn lanes in the port, for
    mixed semirings, widths and turn budgets; the port's service equals
    the reference's on the same store history, and its results equal its
    solo streams."""
    js, ts = _shared_stores()
    args = (num_clients, turn_budget, width, start)
    tsvc, tclients, windows = _round_robin(T, ts, *args)
    jsvc, jclients, _ = _round_robin(J, js, *args)
    _assert_service(tsvc, jsvc, tclients, jclients, f"{args}")
    for client in tclients:
        solo = _solo(T, ts, client, windows,
                     campaign_width=client.stream.campaign_width)
        for wnd in windows:
            _same(client.results[wnd], _np(solo.results[wnd]), f"{wnd}")
    for store in (ts, js):      # the next example starts both in lockstep
        store.release(("AS",))


# -- concurrent-eviction soak -------------------------------------------------

def test_eviction_soak_pins_hold_and_drain():
    """Bursty load under a byte budget small enough to evict mid-service:
    chain-pinned anchor tags are never evicted, all pins drain after
    unregister, and after every turn the port's LRU (evictions,
    ``cached_nbytes``, tag order) equals the reference's."""
    js, ts = _stores(cache_bytes=48 * 1024)
    runs = []
    for pkg, store in ((T, ts), (J, js)):
        svc = pkg[0].QueryService(store, lane_budget=8, turn_budget=4)
        clients = [_register(pkg, svc, "sssp", 0, campaign_width=2,
                             name="soak-a"),
                   _register(pkg, svc, "sssp", 0, campaign_width=2,
                             name="soak-b"),
                   _register(pkg, svc, "bfs", 3, campaign_width=2,
                             name="soak-c")]
        runs.append((svc, clients, store))
    (tsvc, tclients, _), (jsvc, jclients, _) = runs
    windows = tcore.slide_windows(SNAPS, 2)
    seen_tags = set()
    for burst in range(3):
        lo = 2 * burst
        for svc, clients, _ in runs:
            for client in clients:
                svc.submit(client,
                           [w for w in windows if lo <= w[0] < lo + 2])
        while tsvc.pending():
            tsvc.turn()
            jsvc.turn()
            assert ts.evictions == js.evictions
            assert ts.cached_nbytes == js.cached_nbytes
            assert list(ts._blocks) == [_norm_tag(t) for t in js._blocks]
            for qkey, chain in tsvc._chains.items():
                for link in chain._pinned:
                    tag = anchor_tag(qkey, link)
                    seen_tags.add(tag)
                    assert tag in ts.pinned_tags()
                    assert tag in ts._blocks    # a lookup would touch the LRU
        assert not jsvc.pending()
    assert ts.evictions > 0, "soak never pressured the LRU"
    assert seen_tags, "soak never pinned an anchor link"
    assert tsvc.metrics().completed == tsvc.metrics().admitted
    _assert_service(tsvc, jsvc, tclients, jclients)
    for svc, clients, _ in runs:
        for client in clients:
            svc.unregister(client)
    assert ts.pinned_tags() == set() == js.pinned_tags()
    assert all(ts.pin_count(tag) == 0 for tag in seen_tags)


# -- admission / batch packing ------------------------------------------------

def _pack_two(pkg, store, specs, windows):
    svc = pkg[0].QueryService(store, lane_budget=8)
    clients = [_register(pkg, svc, name, source, campaign_width=width,
                         name=cname)
               for name, source, width, cname in specs]
    for client, wnds in zip(clients, windows):
        svc.submit(client, wnds)
    return svc, clients, svc.turn()


def test_packing_compatible_clients_share_one_launch():
    """Two sssp clients with different sources pack into ONE launch whose
    edge work equals the solo slides at the same anchor; the reference
    packs the same launch."""
    js, ts = _stores()
    specs = [("sssp", 0, 2, "pack-a"), ("sssp", 1, 2, "pack-b")]
    windows = [[(0, 2), (1, 3)]] * 2
    tsvc, tclients, records = _pack_two(T, ts, specs, windows)
    jsvc, jclients, _ = _pack_two(J, js, specs, windows)
    _assert_service(tsvc, jsvc, tclients, jclients)
    assert len(records) == 1
    rec = records[0]
    assert rec.lanes == 4 and rec.bucket == 4
    assert sorted(set(rec.clients)) == ["pack-a", "pack-b"]
    assert len(rec.anchor_events) == 2          # one per distinct qkey
    assert tsvc.metrics().batch_occupancy > 1
    solo_work = sum(
        stat.edge_work
        for source in (0, 1)
        for stat in tcore.run_window_slide_batched(
            ts, TSEMI["sssp"], source, windows=windows[0],
            anchor=rec.anchor).hop_stats)
    assert rec.edge_work == solo_work


def test_packing_never_mixes_semirings():
    js, ts = _stores()
    specs = [("sssp", 0, 2, "mix-sssp"), ("bfs", 0, 2, "mix-bfs")]
    windows = [[(0, 2), (1, 3)]] * 2
    tsvc, tclients, records = _pack_two(T, ts, specs, windows)
    jsvc, jclients, _ = _pack_two(J, js, specs, windows)
    _assert_service(tsvc, jsvc, tclients, jclients)
    assert len(records) == 2
    for rec in records:
        assert len(set(rec.clients)) == 1       # no cross-semiring lanes
    assert {rec.group[0] for rec in records} == {"sssp", "bfs"}


def test_packing_never_mixes_width_buckets():
    """Same query key, very different slide-Δ: the horizon-wide window and
    the single-snapshot window land in different pow2 buckets, hence
    different launches, as in the reference."""
    js, ts = _stores()
    specs = [("sssp", 0, 1, "bucket-wide"), ("sssp", 0, 1, "bucket-narrow")]
    windows = [[(0, SNAPS - 1)], [(3, 3)]]
    tsvc, tclients, records = _pack_two(T, ts, specs, windows)
    jsvc, jclients, _ = _pack_two(J, js, specs, windows)
    _assert_service(tsvc, jsvc, tclients, jclients)
    assert len(records) == 2
    assert len({rec.group[1] for rec in records}) == 2
    for rec in records:
        assert len(set(rec.clients)) == 1


def test_lone_campaign_pads_to_pow2_bucket():
    js, ts = _stores()
    specs = [("sssp", 0, 3, "lone")]
    windows = [[(0, 2), (1, 3), (2, 4)]]
    tsvc, tclients, records = _pack_two(T, ts, specs, windows)
    jsvc, jclients, _ = _pack_two(J, js, specs, windows)
    _assert_service(tsvc, jsvc, tclients, jclients)
    rec, = records
    assert rec.lanes == 3
    assert rec.bucket == lane_bucket(3) == 4
    assert tsvc.metrics().padded_lanes == 1


# -- service API contract -----------------------------------------------------

def test_service_register_and_submit_validation():
    js, ts = _stores()
    for pkg, store in ((T, ts), (J, js)):
        core, semi = pkg
        sr = semi["sssp"]
        svc = core.QueryService(store, lane_budget=4)
        with pytest.raises(ValueError):         # planner mode is solo-only
            svc.register(sr, 0, campaign_width="auto")
        with pytest.raises(ValueError):         # campaign must fit a launch
            svc.register(sr, 0, campaign_width=5)
        with pytest.raises(ValueError):
            svc.register(sr, 0, campaign_width=0)
        client = svc.register(sr, 0, name="dup", horizon=4)
        with pytest.raises(ValueError):         # names are unique
            svc.register(semi["bfs"], 1, name="dup")
        with pytest.raises(ValueError):         # window ends past horizon
            svc.submit(client, [(2, 5)])
        assert svc.submit(client, [(2, 4)]) == 1
        with pytest.raises(ValueError):         # pending work is never lost
            svc.unregister(client)
        svc.drain()
        svc.unregister(client)
        assert svc.clients == []
        with pytest.raises(ValueError):
            core.QueryService(store, lane_budget=0)
        with pytest.raises(ValueError):
            core.QueryService(store, turn_budget=0)


def test_idle_turn_is_uncounted_noop():
    js, ts = _stores()
    for pkg, store in ((T, ts), (J, js)):
        svc = pkg[0].QueryService(store)
        assert svc.turn() == []
        assert svc.metrics().turns == 0
        client = _register(pkg, svc, "bfs", 0, campaign_width=1,
                           name="idle")
        svc.submit(client, [(0, 1)])
        assert len(svc.turn()) == 1
        assert svc.metrics().turns == 1
        assert svc.turn() == []                 # drained again
        assert svc.metrics().turns == 1


def test_drain_raises_on_backlog_overrun():
    js, ts = _stores()
    for pkg, store in ((T, ts), (J, js)):
        svc = pkg[0].QueryService(store, turn_budget=1)
        client = _register(pkg, svc, "bfs", 0, campaign_width=1,
                           name="overrun")
        svc.submit(client, tcore.slide_windows(SNAPS, 2))  # 6 turns needed
        with pytest.raises(RuntimeError):
            svc.drain(max_turns=2)
        assert svc.metrics().turns == 3


# -- the load generator, the serve bench and the CLI -------------------------

@pytest.mark.parametrize("seed", [0, 7, 11, 2024])
@pytest.mark.parametrize("snaps,clients", [(6, 4), (8, 6), (3, 2)])
def test_generate_load_matches_reference(seed, snaps, clients):
    """Same seed, same plan: specs and arrival schedule equal the
    reference's ``generate_load``."""
    got = tserve.generate_load(snaps, num_clients=clients, seed=seed)
    want = jserve.generate_load(snaps, num_clients=clients, seed=seed)
    assert got == want


def _exact(bench):
    path = REPO / "benchmarks" / "baselines" / "smoke" / f"BENCH_{bench}.json"
    return {row["name"]: row["exact"]
            for row in json.loads(path.read_text())["rows"]}


def test_serve_reproduces_smoke_baseline():
    """``BENCH_serve``'s smoke row's exact fields to the digit, computed as
    ``benchmarks/serve.py`` does (n 400, e 3,000, 6 snapshots, 200
    changes, 4 clients, seed 7): a warm-up load, cold anchors, the timed
    load, then each client's stream solo with a fresh anchor cache."""
    _, tseq = _seq_pair(400, 3_000, 6, 200, 7)
    store = tcore.SnapshotStore(tseq, device="cpu")
    specs, schedule = tserve.generate_load(6, num_clients=4, seed=7)
    warm, _ = tserve.run_service_load(store, specs, schedule)
    for client in list(warm.clients):
        warm.unregister(client)
    store.release(("AS",))
    service, clients = tserve.run_service_load(store, specs, schedule)
    m = service.metrics()
    for client in list(service.clients):
        service.unregister(client)
    solo_rebuilds = solo_hops = 0
    bit_identical = True
    for spec, client in zip(specs, clients):
        store.release(("AS",))
        solo = tcore.run_window_stream_batched(
            store, TSEMI[spec["alg"]], spec["source"],
            windows=spec["windows"], campaign_width=spec["campaign_width"])
        solo_rebuilds += solo.anchor_rebuilds
        solo_hops += solo.anchor_hops
        for wnd, vals in solo.results.items():
            bit_identical &= torch.equal(vals, client.results[wnd])
    assert any(len(set(rec.clients)) > 1 for rec in service.launch_log)
    got = {"clients": 4, "admitted": m.admitted, "completed": m.completed,
           "turns": m.turns, "launches": m.launches, "lanes": m.lanes,
           "padded_lanes": m.padded_lanes,
           "occupancy_milli": int(round(1000 * m.lanes / m.launches)),
           "rebuilds_service": m.anchor_rebuilds,
           "hops_service": m.anchor_hops, "hits_service": m.anchor_hits,
           "rebuilds_solo": solo_rebuilds, "hops_solo": solo_hops,
           "stable_fraction_milli": m.stable_fraction_milli,
           "bit_identical": bool(bit_identical)}
    assert got == _exact("serve")["serve/load"]


def test_serve_cli_on_cpu(capsys):
    """``serve --service --device cpu`` returns the drained service (the
    smoke load's counts) and prints its three lines; ``--arch <lm>
    --reduced --device cpu`` serves greedy tokens; no mode is an error."""
    service = tserve.main(["--service", "--nodes", "400", "--edges", "3000",
                           "--snaps", "6", "--changes", "200", "--clients",
                           "4", "--seed", "7", "--device", "cpu"])
    out = capsys.readouterr().out
    m = service.metrics()
    assert (m.completed, m.admitted, m.turns, m.launches) == (14, 14, 5, 11)
    for line in ("[serve] 4 clients over 6 snapshots: 14/14 queries in 5 "
                 "turns / 11 launches",
                 "[serve] occupancy 1.27 lanes/launch (1 padded), anchors 3 "
                 "rebuilds + 8 hops + 0 hits", "queries/s, p50 "):
        assert line in out
    for client in service.clients:
        for vals in client.results.values():
            assert vals.device.type == "cpu"
    toks = tserve.main(["--arch", "stablelm-1.6b", "--reduced", "--device",
                        "cpu"])
    assert tuple(toks.shape) == (4, 8) and toks.device.type == "cpu"
    assert "[serve] stablelm-1.6b: prefill 4x16 + 8 decode steps" in (
        capsys.readouterr().out)
    with pytest.raises(SystemExit):
        tserve.main([])
