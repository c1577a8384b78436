"""Seeded numpy inputs shared by the port's kernel tests (no jax, so the
CUDA legs can run on a machine without it), and a fixture that runs a test
module on one PyTorch thread."""

import numpy as np
import pytest

# numpy copies of the semiring identities and source values
IDENTITY = {"bfs": np.inf, "sssp": np.inf, "sswp": -np.inf, "ssnp": np.inf,
            "viterbi": 0.0}
SOURCE_VALUE = {"bfs": 0.0, "sssp": 0.0, "sswp": np.inf, "ssnp": -np.inf,
                "viterbi": 1.0}


def edges(n, e, seed, *, dup_heavy=False, pad=0):
    """Fuzzed edges (+ ``pad`` padding edges with dst == n), as numpy."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, max(1, n // 8) if dup_heavy else n, e).astype(
        np.int32)
    w = (rng.random(e) * 0.999 + 1e-3).astype(np.float32)
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.full(pad, n, np.int32)])
        w = np.concatenate([w, np.zeros(pad, np.float32)])
    return src, dst, w


def values(name, n, seed, lanes=None):
    """Mid-run values: reached vertices, identities and the source value;
    Viterbi values in (0, 1] with some that underflow when multiplied."""
    rng = np.random.default_rng(seed + 7)
    shape = (n,) if lanes is None else (lanes, n)
    if name == "viterbi":
        vals = rng.random(shape).astype(np.float32)
        vals[rng.random(shape) < 0.2] = np.float32(1e-37)
    else:
        vals = (rng.random(shape) * 4 + 0.5).astype(np.float32)
    vals[rng.random(shape) < 0.3] = np.float32(IDENTITY[name])
    vals[..., 0] = np.float32(SOURCE_VALUE[name])
    return vals


def state(name, n, seed, lanes, frontier="mixed"):
    """(values, parent, frontier) with a lane axis; the frontier is mixed
    (~40%), empty, or the source only."""
    rng = np.random.default_rng(seed + 13)
    vals = values(name, n, seed, lanes)
    parent = rng.integers(-1, n, (lanes, n)).astype(np.int32)
    if frontier == "empty":
        fro = np.zeros((lanes, n), bool)
    elif frontier == "source":
        fro = np.zeros((lanes, n), bool)
        fro[:, 0] = True
    else:
        fro = rng.random((lanes, n)) < 0.4
    return vals, parent, fro


def messages(n, e, d, seed, *, oob=False):
    """An [e, d] float32 message stream and int32 segment ids for ``n``
    segments: segment 1 empty, -0.0/+0.0 and ±inf entries mixed in, and
    with ``oob`` some ids at the sentinel ``n`` and past it."""
    rng = np.random.default_rng(seed + 101)
    data = rng.standard_normal((e, d)).astype(np.float32)
    for value, share in ((-0.0, 0.05), (0.0, 0.05), (np.inf, 0.01),
                         (-np.inf, 0.01)):
        data[rng.random((e, d)) < share] = np.float32(value)
    seg = rng.integers(0, n + 3 if oob else n, e).astype(np.int32)
    seg[seg == 1] = 0
    return data, seg


def bag_lookups(v, d, n, b, seed, *, oob=False, zeros=False, infs=False):
    """(table [v, d] float32, ids [n] int32, bags [n] int32, weights [n]
    float32) for ``b`` bags, in no order: bag 1 empty (when b > 2); with
    ``oob`` some bags at the sentinel ``b`` and past it; with ``zeros``
    -0.0/+0.0 table entries and -0.0 weights; with ``infs`` ±inf table
    entries."""
    rng = np.random.default_rng(seed + 211)
    table = rng.standard_normal((v, d)).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    if zeros:
        table[rng.random((v, d)) < 0.1] = np.float32(-0.0)
        table[rng.random((v, d)) < 0.1] = np.float32(0.0)
        w[rng.random(n) < 0.05] = np.float32(-0.0)
    if infs:
        table[rng.random((v, d)) < 0.01] = np.float32(np.inf)
        table[rng.random((v, d)) < 0.01] = np.float32(-np.inf)
    ids = rng.integers(0, v, n).astype(np.int32)
    bags = rng.integers(0, b + 3 if oob else b, n).astype(np.int32)
    if b > 2:
        bags[bags == 1] = 0
    return table, ids, bags, w


def index_case(case, d, seed, *, small=False):
    """(data [e, d] float32, seg [e] int32, n) for an index array at the
    edges of the card kernel's tiling, with -0.0/+0.0, ±inf and NaN entries:

    * ``hub``: one segment holding about 10^5 ids (1,000 with ``small``),
      more than a tile, and a second of 5,000 (300), among random ids and
      a few sentinel ids;
    * ``sparse``: 2^20 segments (2^14 with ``small``) and only 100 ids,
      so almost every segment is empty;
    * ``dropped``: every id out of range (the sentinel n, past it, and
      negative).
    """
    rng = np.random.default_rng(seed + 307)
    if case == "hub":
        n = 41 if small else 1000
        big, mid, rest = ((1000, 300, 500) if small
                          else (100_000, 5_000, 45_000))
        seg = np.concatenate([np.full(big, n // 2), np.full(mid, 3),
                              rng.integers(0, n, rest), np.full(10, n)])
        seg = rng.permutation(seg)
    elif case == "sparse":
        n = 1 << (14 if small else 20)
        seg = rng.integers(0, n, 100)
    elif case == "dropped":
        n = 41 if small else 3000
        e = 1500 if small else 20_000
        seg = np.where(rng.random(e) < 0.5, rng.integers(n, n + 50, e),
                       rng.integers(-50, 0, e))
    else:
        raise ValueError(case)
    e = seg.shape[0]
    data = rng.standard_normal((e, d)).astype(np.float32)
    for value, share in ((-0.0, 0.05), (0.0, 0.05), (np.inf, 0.01),
                         (-np.inf, 0.01), (np.nan, 0.002)):
        data[rng.random((e, d)) < share] = np.float32(value)
    return data, seg.astype(np.int32), n


def skewed_edges(n, e, seed, *, sort=True, pad=0):
    """R-MAT-like edges: dst drawn with weight ``rank^-0.65`` over a seeded
    permutation of the vertices (a few hubs take many in-edges, as the
    evolve path's R-MAT graphs do), src uniform; stably sorted by dst as
    ``make_block`` sorts, unless ``sort`` is False; ``pad`` padding edges
    (dst == n, src 0) at the end."""
    rng = np.random.default_rng(seed + 401)
    weight = np.arange(1, n + 1, dtype=np.float64) ** -0.65
    dst = rng.permutation(n)[rng.choice(n, e, p=weight / weight.sum())]
    src = rng.integers(0, n, e)
    if sort:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    w = (rng.random(e) * 0.999 + 1e-3).astype(np.float32)
    return (np.concatenate([src, np.zeros(pad)]).astype(np.int32),
            np.concatenate([dst, np.full(pad, n)]).astype(np.int32),
            np.concatenate([w, np.zeros(pad, np.float32)]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the importing test module on one intra-op thread: its small
    graphs gain nothing from more, and the suite's parallel workers would
    oversubscribe the cores (a 10^5-edge run took 30x longer so)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def elsewhere(*tensors):
    """CPU tensors that report another device (``xpu``), to check that a
    wrapper refuses every device but cuda, cpu and meta."""
    import torch

    class Elsewhere(torch.Tensor):
        device = property(lambda self: torch.device("xpu"))
        is_cpu = is_cuda = is_meta = property(lambda self: False)

    return tuple(t.as_subclass(Elsewhere) for t in tensors)
