"""Seeded numpy inputs shared by the port's kernel tests (no jax, so the
CUDA legs can run on a machine without it)."""

import numpy as np

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
