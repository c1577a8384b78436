"""The port's segment_reduce held against the JAX package on the CPU.

On the CPU the wrapper runs its plain version, which reduces every
(segment, column) in edge order from the identity. It must equal
``repro``'s ``segment_reduce_ref`` (``jax.ops.segment_*``, a sequential
scatter on the CPU) and the Pallas kernel in interpret mode bit for bit —
sums included, with no tolerance — and its gradients must equal
``jax.grad``'s, ties split equally. The CUDA kernel is held against the
plain version on a card in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.segment_reduce.ops import segment_reduce as j_segment_reduce  # noqa: E402
from repro.kernels.segment_reduce.ref import segment_reduce_ref as j_ref  # noqa: E402
from repro_torch.kernels import segment_reduce  # noqa: E402
from repro_torch.kernels.segment_reduce import (  # noqa: E402
    gather_rows,
    segment_layout,
    segment_reduce_ref,
)
from _torch_inputs import messages  # noqa: E402

REDUCES = ("sum", "min", "max")


def _bits(a):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("d", [1, 5, 24, 130])
def test_plain_equals_jax_ref_and_pallas_bit_for_bit(reduce, d):
    """Empty segments, the sentinel id, ids past it, -0.0/+0.0 and ±inf
    entries (sums of +inf and -inf give NaN, also bit-equal)."""
    n = 41
    data, seg = messages(n, 1500, d, seed=d, oob=True)
    want = j_ref(jnp.asarray(data), jnp.asarray(seg), num_segments=n,
                 reduce=reduce)
    pallas = j_segment_reduce(jnp.asarray(data), jnp.asarray(seg),
                              num_segments=n, reduce=reduce, use_pallas=True,
                              interpret=True)
    got = segment_reduce(*_t(data, seg), num_segments=n, reduce=reduce)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


@pytest.mark.parametrize("reduce", REDUCES)
def test_negative_ids_dropped_and_vector_data(reduce):
    """Negative ids are dropped like ids past the end (``jax.ops``
    semantics); [E] data gives an [N] result."""
    n = 9
    data, seg = messages(n, 300, 1, seed=3, oob=True)
    seg = seg.copy()
    seg[::7] = -1 - seg[::7] % 5
    vec = data[:, 0].copy()
    want = j_ref(jnp.asarray(vec)[:, None], jnp.asarray(seg), num_segments=n,
                 reduce=reduce)[:, 0]
    got = segment_reduce(*_t(vec, seg), num_segments=n, reduce=reduce)
    assert got.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sum_follows_edge_order():
    """A sum that rounds differently in another order: 1e8 + 1 - 1e8 + 1
    in edge order is 1.0 (the 1 before -1e8 is lost)."""
    data = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    seg = np.zeros(4, np.int32)
    got = segment_reduce(*_t(data, seg), num_segments=1)
    assert float(got[0]) == float(j_ref(jnp.asarray(data)[:, None],
                                        jnp.asarray(seg),
                                        num_segments=1)[0, 0]) == 1.0


def test_zero_sign_and_empty_segments():
    """+0.0 start for sums (a lone -0.0 sums to +0.0); min prefers -0.0 and
    max +0.0 in either order; empty segments keep the identity."""
    data = np.array([-0.0, 0.0, 0.0, -0.0, -0.0], np.float32)
    seg = np.array([0, 0, 1, 1, 2], np.int32)
    d, s = _t(data, seg)
    assert _bits(segment_reduce(d, s, num_segments=4)).tolist() == [0, 0, 0, 0]
    mn = segment_reduce(d, s, num_segments=4, reduce="min")
    mx = segment_reduce(d, s, num_segments=4, reduce="max")
    assert torch.signbit(mn[:3]).tolist() == [True, True, True]
    assert torch.signbit(mx[:3]).tolist() == [False, False, True]
    assert mn[3] == np.inf and mx[3] == -np.inf


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("d", [1, 6])
def test_gradients_match_jax_grad_with_ties(reduce, d):
    """Gradients equal jax.grad bit for bit: sums gather, min/max split
    among ties (a segment at its identity counts the identity as a tie);
    dropped ids get 0."""
    n = 7
    rng = np.random.default_rng(d)
    data = rng.integers(-2, 3, (200, d)).astype(np.float32)  # many ties
    data[rng.random((200, d)) < 0.05] = -np.inf
    data[rng.random((200, d)) < 0.05] = np.inf
    seg = rng.integers(0, n + 2, 200).astype(np.int32)
    seg[seg == 4] = 5                                   # an empty segment
    w = rng.standard_normal((n, d)).astype(np.float32)
    jgrad = jax.grad(lambda x: jnp.sum(
        j_ref(x, jnp.asarray(seg), num_segments=n, reduce=reduce)
        * jnp.asarray(w)))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    out = segment_reduce(x, torch.from_numpy(seg), num_segments=n,
                         reduce=reduce)
    (tgrad,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), x)
    np.testing.assert_array_equal(_bits(tgrad), _bits(jgrad))


def test_gather_rows_backward_sums_in_edge_order():
    """gather_rows' backward is segment_reduce's sum by idx: equal to
    jax.grad of ``h[idx]`` bit for bit."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((30, 8)).astype(np.float32)
    idx = rng.integers(0, 30, 400).astype(np.int32)
    g = rng.standard_normal((400, 8)).astype(np.float32) * 1e3
    jgrad = jax.grad(lambda a: jnp.sum(a[jnp.asarray(idx)] * jnp.asarray(g)))(
        jnp.asarray(h))
    ht, it, gt = _t(h, idx, g)
    ht.requires_grad_()
    out = gather_rows(ht, it, segment_layout(it, 30))
    np.testing.assert_array_equal(out.detach().numpy(), h[idx])
    (tgrad,) = torch.autograd.grad(torch.sum(out * gt), ht)
    np.testing.assert_array_equal(_bits(tgrad), _bits(jgrad))


def test_layout_is_a_stable_csr_sort():
    seg = torch.tensor([3, 0, 3, 9, 1, -2, 0, 3], dtype=torch.int32)
    lay = segment_layout(seg, 4)
    assert lay.seg.tolist() == [3, 0, 3, 4, 1, 4, 0, 3]
    assert lay.offsets.tolist() == [0, 2, 3, 3, 6]
    assert lay.perm.tolist()[:6] == [1, 6, 4, 0, 2, 7]
    assert (lay.perm.dtype, lay.offsets.dtype) == (torch.int32, torch.int32)
    got = segment_reduce(torch.arange(8.0), seg, num_segments=4, layout=lay)
    assert got.tolist() == [7.0, 4.0, 0.0, 9.0]
    assert segment_reduce_ref(torch.arange(8.0), seg, num_segments=4,
                              layout=lay).tolist() == got.tolist()


def test_wrapper_validates_inputs():
    data, seg = _t(*messages(5, 20, 3, seed=0))
    with pytest.raises(TypeError, match="float32"):
        segment_reduce(data.double(), seg, num_segments=5)
    with pytest.raises(TypeError, match="int32"):
        segment_reduce(data, seg.long(), num_segments=5)
    with pytest.raises(TypeError, match="int32"):
        segment_reduce(data, seg[:-1], num_segments=5)
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce(data.t().contiguous().t(), seg, num_segments=5)
    with pytest.raises(ValueError, match="reduce"):
        segment_reduce(data, seg, num_segments=5, reduce="mean")
    with pytest.raises(ValueError, match="layout"):
        segment_reduce(data, seg, num_segments=5,
                       layout=segment_layout(seg, 6))
    with pytest.raises(ValueError, match="cuda or cpu"):
        segment_reduce(data.to("meta"), seg.to("meta"), num_segments=5)
    empty = segment_reduce(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int32),
                           num_segments=2, reduce="max")
    assert empty.shape == (2, 3) and bool((empty == -np.inf).all())
