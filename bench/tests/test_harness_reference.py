"""The plain reference against a plain label-setting search (Dijkstra)
on toy graphs, and its control in bfloat16 against it."""

from __future__ import annotations

import heapq

import numpy as np
import pytest
import torch

from bench.reference import solve

F32 = np.float32


def dijkstra(n, src, dst, w, source):
    """Label setting in float32: pop the least tentative distance, settle
    it, relax its out-edges."""
    best = np.full(n, F32(np.inf), dtype=F32)
    best[source] = F32(0.0)
    out = [[] for _ in range(n)]
    for s, d, x in zip(src, dst, w):
        out[s].append((d, F32(x)))
    heap, done = [(best[source], source)], np.zeros(n, bool)
    while heap:
        _, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for v, x in out[u]:
            cand = F32(best[u] + x)
            if cand < best[v]:
                best[v] = cand
                heapq.heappush(heap, (cand, v))
    return best


def toy_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) * 0.999 + 0.001).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_reference_equals_dijkstra(seed):
    n = 300
    src, dst, w = toy_graph(n, 1500, seed)
    half = 700
    parts = [tuple(torch.from_numpy(a[:half]) for a in (src, dst, w)),
             tuple(torch.from_numpy(a[half:]) for a in (src, dst, w))]
    sources = (0, 17, int(src[5]), 17)
    got = solve(parts, n, sources).numpy()
    for row, source in zip(got, sources):
        want = dijkstra(n, src, dst, w, source)
        assert np.array_equal(row.view(np.int32), want.view(np.int32))
    assert np.array_equal(solve(parts, n, [17])[0].numpy(), got[1])


def test_bfloat16_control_differs():
    n = 400
    src, dst, w = toy_graph(n, 3000, 5)
    parts = [tuple(torch.from_numpy(a) for a in (src, dst, w))]
    exact = solve(parts, n, [0])[0]
    low = solve(parts, n, [0], dtype=torch.bfloat16)[0]
    reached = torch.isfinite(exact)
    assert int(reached.sum()) > 100
    assert int((low != exact).sum()) > int(reached.sum()) // 2
    assert torch.equal(low.to(torch.bfloat16).to(torch.float32), low)
