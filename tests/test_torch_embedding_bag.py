"""The port's embedding_bag held against the JAX package on the CPU.

On the CPU the wrapper runs its plain version: each lookup's product
``w * row`` is rounded, then added to its bag in lookup order from +0.0.
It must equal ``repro.models.embedding.embedding_bag`` (take -> multiply ->
``jax.ops.segment_sum``, a sequential scatter-add on the CPU) and the
Pallas kernel in interpret mode bit for bit, with no tolerance; mean and
max follow the reference's composition bit for bit too. The table and
weights gradients equal ``jax.grad`` of the reference composition bit for
bit (for kept lookups; dropped lookups contribute nothing). The CUDA
kernel is held against the plain version on a card in
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.embedding_bag.ops import embedding_bag_fused  # noqa: E402
from repro.models.embedding import embedding_bag as j_bag  # noqa: E402
from repro.models.embedding import embedding_lookup as j_lookup  # noqa: E402
from repro_torch.kernels import embedding_bag  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.segment_reduce import (  # noqa: E402
    contiguous_layout,
    segment_layout,
)
from repro_torch.models import dien as tdien  # noqa: E402
from repro_torch.models.embedding import embedding_bag as t_bag  # noqa: E402
from repro_torch.models.embedding import embedding_lookup  # noqa: E402
from _torch_inputs import bag_lookups, elsewhere  # noqa: E402


def _bits(a):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# (vocabulary, width, lookups, bags, what the case holds)
CASES = {
    "dien_width": (777, 18, 5000, 40, ()),
    "dropped_bags": (300, 7, 3000, 33, ("oob",)),
    "empty_bags": (100, 18, 400, 64, ("oob",)),
    "signed_zeros": (50, 5, 1200, 9, ("zeros",)),
    "infinities": (64, 18, 900, 12, ("infs", "oob")),
    "one_bag": (1000, 18, 100, 1, ()),
}


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_jax_bit_for_bit(mode, case):
    """Unsorted bags, random weights (some -0.0), -0.0/+0.0 and ±inf table
    entries (inf - inf gives NaN, also bit-equal); empty bags, the
    sentinel bag and bags past it where the case has them. Sums also equal
    the Pallas kernel in interpret mode."""
    v, d, n, b, flags = CASES[case]
    table, ids, bags, w = bag_lookups(v, d, n, b, seed=v + d,
                                      oob="oob" in flags,
                                      zeros="zeros" in flags,
                                      infs="infs" in flags)
    want = j_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), b,
                 weights=jnp.asarray(w), mode=mode)
    got = t_bag(*_t(table, ids, bags), b, weights=torch.from_numpy(w),
                mode=mode)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if mode == "sum":
        pallas = embedding_bag_fused(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(np.minimum(bags, b)),
                                     jnp.asarray(w), n_bags=b, interpret=True)
        np.testing.assert_array_equal(_bits(got), _bits(pallas))
        kernel = embedding_bag(*_t(table, ids, bags, w), n_bags=b)
        np.testing.assert_array_equal(_bits(kernel), _bits(want))
    if "oob" in flags and mode != "max":
        counts = np.bincount(bags[bags < b], minlength=b)
        assert (counts == 0).any()
        assert _bits(got)[counts == 0].tolist() == [[0] * d] * int(
            (counts == 0).sum())                  # +0.0, not -0.0


def test_unweighted_bags_and_lookup():
    """No weights: sum and mean of the plain rows; the lookup equals
    ``jnp.take`` for ids of any shape."""
    table, ids, bags, _ = bag_lookups(60, 6, 500, 12, seed=2)
    for mode in ("sum", "mean", "max"):
        want = j_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags),
                     12, mode=mode)
        got = t_bag(*_t(table, ids, bags), 12, mode=mode)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    ids2 = ids[:60].reshape(3, 4, 5)
    got = embedding_lookup(*_t(table, ids2))
    assert got.shape == (3, 4, 5, 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_lookup(jnp.asarray(table),
                                                      jnp.asarray(ids2))))


def test_sum_follows_lookup_order():
    """1e8 + 1 - 1e8 + 1 in lookup order is 1.0 (the first 1 is lost), the
    order of the reference's sequential scatter-add."""
    table = np.array([[1e8], [1.0], [-1e8]], np.float32)
    ids = np.array([0, 1, 2, 1], np.int32)
    bags = np.zeros(4, np.int32)
    w = np.ones(4, np.float32)
    got = embedding_bag(*_t(table, ids, bags, w), n_bags=1)
    want = j_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 1,
                 weights=jnp.asarray(w))
    assert float(got[0, 0]) == float(want[0, 0]) == 1.0


@pytest.mark.parametrize("case", ["dien_width", "dropped_bags", "empty_bags"])
def test_gradients_match_jax_grad(case):
    """The table gradient (rows ``w * g[bag]`` summed by id in lookup order
    through segment_reduce) and the weights gradient (``<row, g[bag]>``
    summed over the columns in order) equal ``jax.grad`` bit for bit on
    kept lookups; a dropped lookup's weight gradient is 0."""
    v, d, n, b, flags = CASES[case]
    table, ids, bags, w = bag_lookups(v, d, n, b, seed=v, oob="oob" in flags)
    g = np.random.default_rng(v).standard_normal((b, d)).astype(np.float32)

    def loss(t, ww):
        return jnp.sum(j_bag(t, jnp.asarray(ids), jnp.asarray(bags), b,
                             weights=ww) * jnp.asarray(g))
    jt, jw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                            jnp.asarray(w))
    tt, tw = _t(table, w)
    tt.requires_grad_()
    tw.requires_grad_()
    out = embedding_bag(tt, *_t(ids, bags), tw, n_bags=b)
    gt, gw = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)),
                                 (tt, tw))
    np.testing.assert_array_equal(_bits(gt), _bits(jt))
    kept = (bags >= 0) & (bags < b)
    np.testing.assert_array_equal(_bits(gw)[kept], _bits(jw)[kept])
    assert not gw.numpy()[~kept].any()
    # only the table: the weights' gradient is not computed
    tt2 = torch.from_numpy(table).requires_grad_()
    out = embedding_bag(tt2, *_t(ids, bags, w), n_bags=b)
    (gt2,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), tt2)
    np.testing.assert_array_equal(_bits(gt2), _bits(jt))


def test_mean_and_max_gradients_match_jax_grad():
    """Through the count division (mean) and segment_reduce's max split,
    the table gradient equals ``jax.grad``'s."""
    table, ids, bags, w = bag_lookups(90, 5, 700, 17, seed=9, oob=True)
    g = np.random.default_rng(1).standard_normal((17, 5)).astype(np.float32)
    for mode in ("mean", "max"):
        jt = jax.grad(lambda t, m=mode: jnp.sum(j_bag(
            t, jnp.asarray(ids), jnp.asarray(bags), 17,
            weights=jnp.asarray(w), mode=m) * jnp.asarray(g)))(
                jnp.asarray(table))
        tt = torch.from_numpy(table).requires_grad_()
        out = t_bag(tt, *_t(ids, bags), 17, weights=torch.from_numpy(w),
                    mode=mode)
        (gt,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), tt)
        np.testing.assert_array_equal(_bits(gt), _bits(jt))


def test_layout_is_shared_and_plain_version_direct():
    """A layout passed in gives the same result as one computed inside;
    the plain version called directly equals the wrapper."""
    table, ids, bags, w = bag_lookups(40, 3, 300, 11, seed=4, oob=True)
    args = _t(table, ids, bags, w)
    lay = segment_layout(args[2], 11)
    a = embedding_bag(*args, n_bags=11)
    b = embedding_bag(*args, n_bags=11, layout=lay)
    c = embedding_bag_ref(*args, n_bags=11, layout=lay)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_wrapper_validates_inputs():
    table, ids, bags, w = _t(*bag_lookups(20, 4, 50, 5, seed=0))
    with pytest.raises(TypeError, match="table"):
        embedding_bag(table.double(), ids, bags, w, n_bags=5)
    with pytest.raises(TypeError, match="ids"):
        embedding_bag(table, ids.long(), bags, w, n_bags=5)
    with pytest.raises(TypeError, match="bags"):
        embedding_bag(table, ids, bags[:-1], w, n_bags=5)
    with pytest.raises(TypeError, match="weights"):
        embedding_bag(table, ids, bags, w.double(), n_bags=5)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.t().contiguous().t(), ids, bags, w, n_bags=5)
    with pytest.raises(ValueError, match="layout"):
        embedding_bag(table, ids, bags, w, n_bags=5,
                      layout=segment_layout(bags, 6))
    # meta tensors give the output's shape (the dry run's path)
    on_meta = embedding_bag(*(t.to("meta") for t in (table, ids, bags, w)),
                            n_bags=5)
    assert on_meta.device.type == "meta" and on_meta.shape == (
        5, table.shape[1])
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        embedding_bag(*elsewhere(table, ids, bags, w), n_bags=5)
    with pytest.raises(ValueError):
        t_bag(table, ids, bags, 5, mode="min")
    empty = embedding_bag(table, torch.zeros(0, dtype=torch.int32),
                          torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                          n_bags=3)
    assert empty.shape == (3, 4) and not bool(empty.any())


@pytest.mark.parametrize("b,s", [(1, 1), (1, 100), (7, 1), (5, 3), (64, 10),
                                 (0, 4)])
def test_contiguous_layout_equals_the_sorted_layout(b, s):
    """DIEN's bags laid out without a sort: field by field the layout that
    sorting ``arange(b).repeat_interleave(s)`` gives, flagged identity."""
    got = contiguous_layout(b, s, "cpu")
    want = segment_layout(
        torch.arange(b, dtype=torch.int32).repeat_interleave(s), b)
    for field in ("seg", "perm", "offsets"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w), field
    assert got.num_segments == want.num_segments == b
    assert got.identity_perm and not want.identity_perm
    assert got.tiles == {} and got.tiles is not want.tiles


def test_pooled_history_equals_jax_bags_bit_for_bit():
    """DIEN's pooled history (two bags per row, the contiguous layout, a
    ragged mask as weights) equals the JAX package's bag of the same
    lookups, item then category, bit for bit."""
    rng = np.random.default_rng(16)
    b, s, d = 9, 12, 18
    tables = {name: rng.standard_normal((v, d)).astype(np.float32)
              for name, v in (("item_emb", 300), ("cat_emb", 20))}
    items = rng.integers(0, 300, (b, s)).astype(np.int32)
    cats = rng.integers(0, 20, (b, s)).astype(np.int32)
    mask = np.arange(s)[None, :] < rng.integers(0, s + 1, b)[:, None]
    got = tdien._pooled_history(
        {k: torch.from_numpy(v) for k, v in tables.items()},
        *_t(items, cats, mask))
    bags = jnp.asarray(np.repeat(np.arange(b, dtype=np.int32), s))
    w = jnp.asarray(mask.reshape(-1).astype(np.float32))
    want = jnp.concatenate([
        j_bag(jnp.asarray(tables[name]), jnp.asarray(ids.reshape(-1)), bags,
              b, weights=w)
        for name, ids in (("item_emb", items), ("cat_emb", cats))], -1)
    np.testing.assert_array_equal(_bits(got), _bits(want))
