"""The benchmark's inputs: the frozen numpy helpers and the device draws
of the weights equal the port's bit for bit; the device draws follow the
port's protocols and are deterministic in the seed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench.inputs import commongraph_window, draw, evolving_sequence, frozen


def test_frozen_helpers_equal_the_ports():
    from repro_torch.graph import edgeset, generators
    rng = np.random.default_rng(3)
    keys = np.concatenate([rng.integers(0, 2**46, 100_000),
                           np.array([0, 1, 2**46 - 1, 2**62])])
    for seed in (0, 5):
        got = frozen.edge_weights(keys, seed)
        want = generators.edge_weights(keys, seed)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert got.min() > 0.0009 and got.max() <= 1.0
    assert np.array_equal(frozen.unique_keys(keys % 5000),
                          edgeset.unique_keys(keys % 5000))
    for got, want in zip(frozen.keys_to_edges(keys % 2**40, 2**20),
                         edgeset.keys_to_edges(keys % 2**40, 2**20)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_device_edge_weights_equal_the_frozen_ones():
    rng = np.random.default_rng(4)
    keys = np.concatenate([rng.integers(0, 2**46, 200_000),
                           np.array([0, 1, 2**46 - 1])])
    got = draw.edge_weights(torch.from_numpy(keys)).numpy()
    want = frozen.edge_weights(keys)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_rmat_draw_follows_the_ports_distribution():
    """Distinct edges without self-loops, as many as asked, with the
    skew of the port's numpy R-MAT at the same size."""
    from repro_torch.graph import generators
    n, e = 2**14, 2**17
    keys = draw.rmat_keys(n, e, draw.generator(1, "cpu"), "cpu").numpy()
    assert keys.size == e and np.unique(keys).size == e
    src, dst = keys // n, keys % n
    assert not np.any(src == dst)
    ref_src, ref_dst = generators.rmat_edges(n, e, seed=1)
    for got, want in ((src, ref_src), (dst, ref_dst)):
        for bit in (n // 2, n // 4):
            assert abs(np.mean(got & bit > 0)
                       - np.mean(want & bit > 0)) < 0.01
        top = np.sort(np.bincount(got, minlength=n))[-20:].sum()
        ref_top = np.sort(np.bincount(want, minlength=n))[-20:].sum()
        assert abs(top - ref_top) < 0.1 * ref_top


def _sequence(seed):
    config = dict(num_nodes=1500, num_edges=9000, num_snapshots=6,
                  batch_changes=700)
    return evolving_sequence.make(config, seed, "cpu")


def test_sequence_follows_the_protocol():
    inputs = _sequence(9)
    d = inputs.data
    snaps, adds, dels = d["snapshot_keys"], d["additions"], d["deletions"]
    assert len(snaps) == 6 and len(adds) == len(dels) == 5
    assert snaps[0].size == 9000
    for cur, nxt, add, gone in zip(snaps, snaps[1:], adds, dels):
        assert add.size == gone.size == 350
        assert np.all(np.diff(add) > 0) and np.all(np.diff(gone) > 0)
        assert np.isin(gone, cur).all() and not np.isin(add, cur).any()
        assert not np.any(add // 1500 == add % 1500)
        want = np.union1d(np.setdiff1d(cur, gone), add)
        assert np.array_equal(nxt, want)
    cg = snaps[0]
    for k in snaps[1:]:
        cg = np.intersect1d(cg, k)
    assert np.array_equal(
        inputs.common_graph[0].astype(np.int64) * 1500
        + inputs.common_graph[1], cg)
    delta = sum(k.size - cg.size for k in snaps)
    assert inputs.min_query_bytes == 12 * (cg.size + delta) + 4 * 1500 * 6
    (src, dst, w), = inputs.snapshot_edges(3)
    assert np.array_equal(w.numpy(), frozen.edge_weights(snaps[3]))
    want_src, want_dst = frozen.keys_to_edges(snaps[3], 1500)
    assert np.array_equal(src.numpy(), want_src)
    assert np.array_equal(dst.numpy(), want_dst)
    with pytest.raises(ValueError):
        snaps[0][0] = 1     # the program gets read-only arrays


def test_sequence_is_deterministic_in_the_seed():
    a, b, c = _sequence(2**31 + 1), _sequence(2**31 + 1), _sequence(3)
    for x, y in zip(a.data["snapshot_keys"], b.data["snapshot_keys"]):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.data["snapshot_keys"][0],
                              c.data["snapshot_keys"][0])


def _window(seed):
    config = dict(n_nodes=2048, cg_edges=12000, delta_edges=300,
                  n_snapshots=4)
    return commongraph_window.make(config, seed, "cpu")


def test_window_is_deterministic_in_the_seed():
    a, b, c = _window(2**31 + 1), _window(2**31 + 1), _window(2**31 + 2)
    for key in ("cg", "delta"):
        for x, y in zip(a.data[key], b.data[key]):
            assert np.array_equal(x, y)
    assert not np.array_equal(a.data["cg"][0], c.data["cg"][0])


def test_window_draws_distinct_absent_delta_edges():
    inputs = _window(17)
    n = inputs.num_nodes
    src, dst, w = inputs.data["cg"]
    cg_keys = src.astype(np.int64) * n + dst
    assert np.unique(cg_keys).size == cg_keys.size == 12000
    assert not np.any(src == dst)
    assert np.array_equal(w, frozen.edge_weights(cg_keys))
    dsrc, ddst, dw = inputs.data["delta"]
    assert dsrc.shape == (4, 300)
    for i in range(4):
        keys = dsrc[i].astype(np.int64) * n + ddst[i]
        assert np.unique(keys).size == 300
        assert np.all(np.diff(keys) > 0)
        assert not np.isin(keys, cg_keys).any()
        assert not np.any(dsrc[i] == ddst[i])
        assert np.array_equal(dw[i], frozen.edge_weights(keys))
    assert inputs.common_graph[0] is src and inputs.common_graph[1] is dst
    parts = inputs.snapshot_edges(2)
    assert parts[0][0] is src and np.array_equal(parts[1][0], dsrc[2])


def test_pool_is_a_draw_among_vertices_with_an_out_edge():
    """The pool is a draw without repeats among the common graph's
    vertices of out-degree at least 1, and all of them where it asks for
    more."""
    from bench.traffic import ClosedLoop
    inputs = _window(5)
    has_out = set(np.unique(inputs.common_graph[0]).tolist())
    mix = dict(loop="closed", clients=1, pool=40)
    pool = ClosedLoop(mix, inputs, 1, 0, "cpu").pool
    assert len(set(pool.tolist())) == 40 and set(pool.tolist()) <= has_out
    everything = ClosedLoop(dict(mix, pool=10**9), inputs, 1, 0,
                            "cpu").pool
    assert set(everything.tolist()) == has_out


def test_every_seed_asks_the_same_pool_in_its_own_order():
    """The pool is drawn from the graph's seed; a run's seed only orders
    it, and a round asks each source of the pool once."""
    from bench.traffic import ClosedLoop
    inputs = _window(5)
    mix = dict(loop="closed", clients=1, pool=40)
    rounds = {}
    for seed in (1, 2**33 + 7):
        loop = ClosedLoop(mix, inputs, seed, 0, "cpu")
        asked = [loop.next() for _ in range(80)]
        assert sorted(asked[:40]) == sorted(asked[40:]) == loop.pool.tolist()
        assert asked[:40] != asked[40:]
        rounds[seed] = asked
        assert loop.warmup() in loop.pool
    assert rounds[1] != rounds[2**33 + 7]
    assert sorted(rounds[1]) == sorted(rounds[2**33 + 7])
    other = ClosedLoop(mix, inputs, 1, 1, "cpu")
    assert other.pool.tolist() != ClosedLoop(mix, inputs, 1, 0,
                                             "cpu").pool.tolist()
