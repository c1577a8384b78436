"""The port's CUDA kernels held against their plain PyTorch versions on a
card, bit for bit: the relax kernels (min/max reductions are order-free)
and segment_reduce (sums too: kernel and plain version both reduce each
segment in edge order). No tolerance.

Imports neither jax nor repro, so it runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest clears jax caches after each
module, which needs jax.)

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is False (the kernels have no CPU mode; CPU tensors take the plain
versions, which ``test_torch_kernels.py`` holds against the JAX package).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _torch_inputs import edges, messages, state, values  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS  # noqa: E402
from repro_torch.kernels import edge_relax, relax_multi, segment_reduce  # noqa: E402
from repro_torch.kernels.segment_reduce import (  # noqa: E402
    gather_rows,
    segment_layout,
    segment_reduce_ref,
)
from repro_torch.launch import train  # noqa: E402
from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR, edge_relax_ref  # noqa: E402
from repro_torch.kernels.edge_relax_multi.ref import relax_multi_ref  # noqa: E402

SEMIRINGS = sorted(ALL_SEMIRINGS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _on(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEMIRINGS)
def test_cuda_edge_relax_matches_plain(cuda_device, name):
    n = 3000
    args = _on(cuda_device, values(name, n, 1),
               *edges(n, 40_000, 1, dup_heavy=True, pad=96))
    op = KERNEL_OP_FOR[name]
    before = edge_relax.launches
    got = edge_relax(*args, op=op, num_nodes=n)
    assert edge_relax.launches == before + 1
    want = edge_relax_ref(*args, op=op, num_nodes=n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("k,track", [(1, True), (4, True), (4, False)])
def test_cuda_relax_multi_matches_plain(cuda_device, name, k, track):
    """A shared block plus a stacked Δ block over 8 lanes, one lane capped
    at one sweep: state, sweeps and work equal the plain version's."""
    n, lanes = 2000, 8
    shared = _on(cuda_device, *edges(n, 30_000, 2))
    stacked = _on(cuda_device, *(np.stack(a) for a in zip(
        *[edges(n, 500, 30 + i, pad=12) for i in range(lanes)])))
    st = _on(cuda_device, *state(name, n, 4, lanes))
    allowed = torch.full((lanes,), k, dtype=torch.int32, device=cuda_device)
    allowed[-1] = 1
    kw = dict(op=KERNEL_OP_FOR[name], num_nodes=n, k=k, track_parents=track)
    before = relax_multi.launches
    got = relax_multi(*st, [shared, stacked], allowed, **kw)
    assert relax_multi.launches == before + 1
    want = relax_multi_ref(*st, [shared, stacked], allowed, **kw)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def _same_bits(got, want):
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("d", [1, 3, 16, 47, 75, 130])
def test_cuda_segment_reduce_matches_plain(cuda_device, reduce, d):
    """Empty segments, sentinel and out-of-range ids, -0.0/±inf entries."""
    n = 2500
    data, seg = _on(cuda_device, *messages(n, 60_000, d, seed=d, oob=True))
    lay = segment_layout(seg, n)
    before = segment_reduce.launches
    got = segment_reduce(data, seg, num_segments=n, reduce=reduce, layout=lay)
    assert segment_reduce.launches == before + 1
    want = segment_reduce_ref(data, seg, num_segments=n, reduce=reduce,
                              layout=lay)
    _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_cuda_segment_reduce_gradients_match_cpu(cuda_device, reduce):
    """The card's gradients (kernel tie counts and gather backward) equal
    the CPU's (plain version) bit for bit, ties included."""
    rng = np.random.default_rng(7)
    n = 300
    data = rng.integers(-2, 3, (20_000, 24)).astype(np.float32)
    seg = rng.integers(0, n + 2, 20_000).astype(np.int32)
    w = rng.standard_normal((n, 24)).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        x, s, ww = _on(dev, data, seg, w)
        x.requires_grad_()
        h = x[:n].detach().clone().requires_grad_()
        out = segment_reduce(x, s, num_segments=n, reduce=reduce)
        g = gather_rows(h, s.clamp(max=n - 1), segment_layout(
            s.clamp(max=n - 1), n))
        loss = torch.sum(out * ww) + torch.sum(g * x.detach())
        grads.append([t.cpu() for t in torch.autograd.grad(loss, (x, h))])
    for got, want in zip(grads[1], grads[0]):
        _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gcn-cora", "pna", "meshgraphnet",
                                  "graphcast"])
def test_cuda_train_driver_decreases_loss(cuda_device, arch):
    before = segment_reduce.launches
    losses = train.main(["--arch", arch, "--reduced", "--steps", "4",
                         "--device", "cuda"])
    assert losses[-1] < losses[0]
    assert segment_reduce.launches > before
