"""Edge draws on the run's device with a seeded ``torch.Generator``: the
distributions of the port's numpy generators (``repro_torch.graph.
generators``), drawn in a few large calls instead of on the host. The
same seed on the same kind of device gives the same edges.
"""

from __future__ import annotations

import math

import torch

_MULT = 0x9E3779B97F4A7C15 - (1 << 64)  # as a signed 64-bit integer
_LOW63 = (1 << 63) - 1


def edge_weights(keys: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``frozen.edge_weights`` on int64 keys in a tensor: the same
    wrapping multiply, logical shift and float64 modulus, so the same
    float32 weights bit for bit."""
    h = ((keys * _MULT + seed) >> 1) & _LOW63
    u = torch.fmod(h.to(torch.float64), float(1 << 24)) / float(1 << 24)
    return (u * (1.0 - 1e-3) + 1e-3).to(torch.float32)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def rmat_keys(n: int, e: int, gen: torch.Generator, device,
              a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """R-MAT edge keys ``src * n + dst`` as the port's ``rmat_edges``
    draws them (Graph500's a, b, c by default; 1.3x oversampled, without
    duplicates or self-loops, shuffled, cut to ``e``)."""
    scale = max(1, math.ceil(math.log2(n)))
    n_draw = int(e * 1.3) + 16
    src = torch.zeros(n_draw, dtype=torch.int64, device=device)
    dst = torch.zeros(n_draw, dtype=torch.int64, device=device)
    p_ab, p_abc = a + b, a + b + c
    for _ in range(scale):
        r = torch.rand(n_draw, generator=gen, device=device,
                       dtype=torch.float64)
        src = (src << 1) | (r >= p_ab)
        dst = (dst << 1) | (((r >= a) & (r < p_ab)) | (r >= p_abc))
        del r
    src %= n
    dst %= n
    keep = src != dst
    keys = torch.unique(src[keep] * n + dst[keep])
    del src, dst, keep
    perm = torch.randperm(keys.numel(), generator=gen, device=device)
    return keys[perm[:e]]


def absent_keys(n: int, count: int, table: torch.Tensor,
                gen: torch.Generator, device) -> torch.Tensor:
    """``count`` distinct uniform edge keys without self-loops that are
    not in the sorted ``table``, sorted; drawn as the port's generator
    draws a snapshot's additions."""
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < count:
        m = count - keys.numel()
        m += m // 8 + 64
        a = torch.randint(0, n, (m,), generator=gen, device=device)
        b = torch.randint(0, n, (m,), generator=gen, device=device)
        ok = a != b
        cand = torch.unique(a[ok] * n + b[ok])
        pos = torch.searchsorted(table, cand).clamp_(max=table.numel() - 1)
        cand = cand[table[pos] != cand]
        keys = torch.unique(torch.cat([keys, cand]))
    perm = torch.randperm(keys.numel(), generator=gen, device=device)
    return torch.sort(keys[perm[:count]]).values
