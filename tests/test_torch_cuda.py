"""The port's CUDA kernels held against their plain PyTorch versions on a
card, bit for bit: the relax kernels (min/max reductions are order-free),
segment_reduce and embedding_bag (sums too: kernel and plain version both
add each segment or bag in edge or lookup order), and the window
executors on the card against the same runs on the CPU. No tolerance.

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

from _torch_inputs import (  # noqa: E402
    bag_lookups,
    edges,
    index_case,
    messages,
    skewed_edges,
    state,
    values,
)
from repro_torch.core import (  # noqa: E402
    SnapshotStore,
    run_window_slide_batched,
    run_window_stream_batched,
)
from repro_torch.core.window import _stream_qkey  # noqa: E402
from repro_torch.graph import make_evolving_sequence  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    edge_relax,
    embedding_bag,
    relax_multi,
    segment_reduce,
)
from repro_torch.kernels.embedding_bag import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.segment_reduce import (  # noqa: E402
    contiguous_layout,
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


def _stacked(lanes, n, e, seed, *, sort=False, pad=0, padding_lanes=()):
    """A stacked [lanes, e + pad] block; the lanes in ``padding_lanes`` are
    all padding (dst == n), as a masked lane of a lane bucket is."""
    rows = [(skewed_edges if sort else edges)(n, e, seed + i, pad=pad)
            for i in range(lanes)]
    src, dst, w = (np.stack(a) for a in zip(*rows))
    for lane in padding_lanes:
        src[lane], dst[lane], w[lane] = 0, n, 0.0
    return src, dst, w


def _hub(n, e, seed, *, sort):
    """A hub: vertex 7 takes 10^5 in-edges from distinct sources (1,000
    on), all of whose candidates are equal (their values and weights are),
    among ``e`` skewed edges; with ``sort`` every edge is dst-sorted."""
    src, dst, w = skewed_edges(n, e, seed, sort=False)
    hub_src = np.arange(1000, 101_000, dtype=np.int32)
    src = np.concatenate([src, hub_src])
    dst = np.concatenate([dst, np.full(hub_src.size, 7, np.int32)])
    w = np.concatenate([w, np.full(hub_src.size, 0.5, np.float32)])
    order = (np.argsort(dst, kind="stable") if sort
             else np.random.default_rng(seed).permutation(dst.size))
    return src[order], dst[order], w[order]


def _relax_case(case, name):
    """(state, blocks, allowed, k) of one ``test_cuda_relax_multi_design``
    case (see there), as numpy."""
    n, lanes, k = 3000, 8, 3
    if case in ("lanes33", "lanes40"):
        lanes = int(case[5:])
        blocks = [edges(n, 20_000, 5), _stacked(lanes, n, 300, 50, pad=20)]
    elif case in ("hub-sorted", "hub-unsorted"):
        n, lanes, k = 120_000, 2, 2
        blocks = [_hub(n, 50_000, 6, sort=case == "hub-sorted")]
    elif case in ("sorted", "unsorted"):
        blocks = [skewed_edges(n, 30_000, 7, sort=case == "sorted", pad=64),
                  _stacked(lanes, n, 500, 70, sort=case == "sorted", pad=8)]
    elif case == "stacked-only":
        blocks = [_stacked(lanes, n, 4000, 80, sort=True, pad=16,
                           padding_lanes=(6, 7))]
    elif case == "shared+2stacked":
        blocks = [skewed_edges(n, 20_000, 9), _stacked(lanes, n, 700, 90),
                  _stacked(lanes, n, 300, 100, sort=True, pad=4)]
    elif case == "all-padding":
        pad = (np.zeros(4096, np.int32), np.full(4096, n, np.int32),
               np.zeros(4096, np.float32))
        blocks = [pad, _stacked(lanes, n, 500, 110, padding_lanes=(3,)),
                  tuple(np.stack([a] * lanes) for a in pad)]
    else:
        raise ValueError(case)
    vals, parent, fro = state(name, n, 11, lanes)
    if case.startswith("hub"):
        vals[:, 1000:101_000] = np.float32(
            {"viterbi": 0.75, "sswp": 0.75}.get(name, 1.0))
        fro[:, 1000:101_000] = True
    allowed = np.full(lanes, k, np.int32)
    allowed[1] = 0                       # a lane allowed nothing
    allowed[-1] = 1                      # a capped lane
    return (vals, parent, fro), blocks, allowed, k


RELAX_DESIGN_CASES = ("lanes33", "lanes40", "hub-sorted", "hub-unsorted",
                      "sorted", "unsorted", "stacked-only", "shared+2stacked",
                      "all-padding")


@pytest.mark.cuda
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("case", RELAX_DESIGN_CASES)
def test_cuda_relax_multi_design(cuda_device, case, name, track):
    """What the packed frontier, the warp merge and the fresh outputs could
    get wrong, bit for bit against the plain version: 33 and 40 lanes (two
    groups of lane bits), a hub of 10^5 equal candidates (the smallest src
    wins), dst-sorted and unsorted blocks, stacked blocks only, shared plus
    two stacked groups, all-padding blocks and lanes, a lane allowed 0 and
    a capped one; and the inputs are unmodified after the call."""
    st, blocks, allowed, k = _relax_case(case, name)
    st = _on(cuda_device, *st)
    blocks = [_on(cuda_device, *b) for b in blocks]
    allowed = _on(cuda_device, allowed)[0]
    before = [t.clone() for t in (*st, allowed)] + [
        t.clone() for b in blocks for t in b]
    kw = dict(op=KERNEL_OP_FOR[name], num_nodes=st[0].shape[1], k=k,
              track_parents=track)
    got = relax_multi(*st, blocks, allowed, **kw)
    torch.cuda.synchronize()
    after = [*st, allowed] + [t for b in blocks for t in b]
    for b, a in zip(before, after):
        assert torch.equal(b, a), "an input was modified"
    want = relax_multi_ref(*st, blocks, allowed, **kw)
    for part, g, r in zip(("values", "parent", "frontier", "sweeps", "work"),
                          got, want):
        assert g.dtype == r.dtype and g.shape == r.shape, part
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), part
    if case.startswith("hub") and track:
        # lane 1 runs one sweep: the hub's equal candidates win, src 1000
        assert int(got[1][1, 7]) == 1000


@pytest.mark.cuda
def test_cuda_relax_multi_lane_limit(cuda_device):
    """The most lanes the kernel takes run bit for bit; one more raises
    ValueError naming the limit."""
    from repro_torch.kernels import _build
    most = _build.load_library().relax_multi_max_lanes()
    src, dst, w = _on(cuda_device, *edges(5, 12, 3))
    for lanes in (most, most + 1):
        st = _on(cuda_device, *state("sssp", 5, 3, lanes))
        kw = dict(op="min_plus", num_nodes=5, k=2)
        if lanes > most:
            with pytest.raises(ValueError, match=f"at most {most} lanes"):
                relax_multi(*st, [(src, dst, w)], **kw)
            continue
        for g, r in zip(relax_multi(*st, [(src, dst, w)], **kw),
                        relax_multi_ref(*st, [(src, dst, w)], **kw)):
            assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_cuda_edge_relax_skewed(cuda_device, name, sort):
    """The warp merge on R-MAT-like hubs, dst-sorted and not."""
    n = 5000
    args = _on(cuda_device, values(name, n, 2),
               *skewed_edges(n, 200_000, 3, sort=sort, pad=100))
    op = KERNEL_OP_FOR[name]
    got = edge_relax(*args, op=op, num_nodes=n)
    want = edge_relax_ref(*args, op=op, num_nodes=n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _same_bits(got, want):
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# random ids at the widths where the kernel's 16-, 8- and 4-byte pieces and
# its column groups change; and ``index_case``'s index arrays: a segment of
# 10^5 ids (more than a tile) and one of 5,000, 2^20 segments holding 100
# ids, every id out of range
SEGMENT_CASES = ([("random", d) for d in (1, 2, 3, 4, 8, 16, 17, 18, 32, 33,
                                          47, 64, 65, 75, 128, 129, 130, 512,
                                          513)]
                 + [(case, d) for case in ("hub", "sparse", "dropped")
                    for d in (1, 18, 129)])


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("case,d", SEGMENT_CASES,
                         ids=[str(d) if c == "random" else f"{c}-{d}"
                              for c, d in SEGMENT_CASES])
def test_cuda_segment_reduce_matches_plain(cuda_device, reduce, case, d):
    """Empty segments, sentinel and out-of-range ids, -0.0/±inf entries
    (and NaN entries in the index cases)."""
    if case == "random":
        n = 2500
        data, seg = messages(n, 60_000, d, seed=d, oob=True)
    else:
        data, seg, n = index_case(case, d, seed=d)
    data, seg = _on(cuda_device, data, seg)
    lay = segment_layout(seg, n)
    before = segment_reduce.launches
    got = segment_reduce(data, seg, num_segments=n, reduce=reduce, layout=lay)
    assert segment_reduce.launches == before + 1
    want = segment_reduce_ref(data, seg, num_segments=n, reduce=reduce,
                              layout=lay)
    _same_bits(got, want)
    # a second call on the layout reuses the tiles the first one kept
    assert len(lay.tiles) == 1
    got = segment_reduce(-data, seg, num_segments=n, reduce=reduce,
                         layout=lay)
    assert segment_reduce.launches == before + 2 and len(lay.tiles) == 1
    _same_bits(got, segment_reduce_ref(-data, seg, num_segments=n,
                                       reduce=reduce, layout=lay))


@pytest.mark.cuda
def test_cuda_segment_reduce_width_limit(cuda_device):
    """Rows up to the kernel's widest are reduced bit for bit; a wider call
    raises ValueError naming the width and the limit."""
    from repro_torch.kernels import _build
    widest = _build.load_library().segment_reduce_max_width()
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 9, 40).astype(np.int32)
    for d in (widest, widest + 1):
        data = rng.standard_normal((40, d)).astype(np.float32)
        x, s = _on(cuda_device, data, seg)
        if d > widest:
            with pytest.raises(ValueError, match=f"width {d} .*{widest}"):
                segment_reduce(x, s, num_segments=7)
        else:
            _same_bits(segment_reduce(x, s, num_segments=7),
                       segment_reduce_ref(x, s, num_segments=7))


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 18, 36])
@pytest.mark.parametrize("flags", ["plain", "specials"])
def test_cuda_embedding_bag_matches_plain(cuda_device, d, flags):
    """Unsorted bags, random weights; with "specials" also -0.0/±inf
    entries, empty bags, the sentinel bag and bags past it."""
    special = flags == "specials"
    n_bags = 700
    table, ids, bags, w = _on(cuda_device, *bag_lookups(
        5000, d, 40_000, n_bags, seed=d, oob=special, zeros=special,
        infs=special))
    lay = segment_layout(bags, n_bags)
    before = embedding_bag.launches
    got = embedding_bag(table, ids, bags, w, n_bags=n_bags, layout=lay)
    assert embedding_bag.launches == before + 1
    _same_bits(got, embedding_bag_ref(table, ids, bags, w, n_bags=n_bags,
                                      layout=lay))


def _bag_kernel_equals_plain(table, ids, w, lay):
    """One launch of the bag kernel on the layout's bags, bit for bit
    against the plain version."""
    kw = dict(n_bags=lay.num_segments, layout=lay)
    before = embedding_bag.launches
    got = embedding_bag(table, ids, lay.seg, w, **kw)
    assert embedding_bag.launches == before + 1
    _same_bits(got, embedding_bag_ref(table, ids, lay.seg, w, **kw))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lookups", [100, 1000, 5000])
def test_cuda_embedding_bag_one_long_bag(cuda_device, lookups):
    """One bag of 100 lookups (a retrieval user) and bags longer than a
    chunk of the kernel, which carry their sums from chunk to chunk."""
    table, ids, _, w = _on(cuda_device, *bag_lookups(
        50_000, 18, lookups, 1, seed=lookups, zeros=True))
    _bag_kernel_equals_plain(table, ids, w,
                             contiguous_layout(1, lookups, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4, 8])
def test_cuda_embedding_bag_short_bags(cuda_device, d):
    """4,096 bags of 1-3 lookups at small widths: several bags per warp."""
    rng = np.random.default_rng(d)
    sizes = rng.integers(1, 4, 4096)
    bags = np.repeat(np.arange(4096, dtype=np.int32), sizes)
    table, ids, _, w = bag_lookups(10_000, d, bags.shape[0], 4096, seed=d,
                                   zeros=True, infs=True)
    table, ids, w, bags = _on(cuda_device, table, ids, w, bags)
    _bag_kernel_equals_plain(table, ids, w, segment_layout(bags, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 18, 128, 513, 2051])
def test_cuda_embedding_bag_widths(cuda_device, d):
    """Odd widths (4-byte pieces), widths past a warp, and one past the
    kernel's 1,024-column slab; unsorted bags with empty, sentinel and
    dropped bags."""
    table, ids, bags, w = _on(cuda_device, *bag_lookups(
        3000, d, 20_000, 300, seed=d, oob=True, zeros=True, infs=True))
    _bag_kernel_equals_plain(table, ids, w, segment_layout(bags, 300))


@pytest.mark.cuda
def test_cuda_embedding_bag_masked_contiguous_bags(cuda_device):
    """DIEN's bags: contiguous rows of 100 lookups, the mask as weights;
    a zero weight on an infinite row gives NaN, as the reference's."""
    b, s = 700, 100
    table, ids, _, _ = bag_lookups(20_000, 18, b * s, b, seed=5, infs=True)
    rng = np.random.default_rng(5)
    keep = rng.integers(0, s + 1, b)
    w = (np.arange(s)[None, :] < keep[:, None]).astype(np.float32).ravel()
    inf_rows = np.flatnonzero(np.isinf(table).any(1))
    ids[w == 0] = inf_rows[0]
    table, ids, w = _on(cuda_device, table, ids, w)
    got = _bag_kernel_equals_plain(table, ids, w,
                                   contiguous_layout(b, s, cuda_device))
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
def test_cuda_embedding_bag_identity_flag(cuda_device):
    """The same contiguous bags with the identity flag (perm not read) and
    without it (perm read) give the same bits."""
    b, s = 1000, 37
    table, ids, _, w = _on(cuda_device, *bag_lookups(8000, 18, b * s, b,
                                                     seed=3, zeros=True))
    flagged = contiguous_layout(b, s, cuda_device)
    sorted_ = segment_layout(flagged.seg, b)
    assert flagged.identity_perm and not sorted_.identity_perm
    _same_bits(_bag_kernel_equals_plain(table, ids, w, flagged),
               _bag_kernel_equals_plain(table, ids, w, sorted_))


@pytest.mark.cuda
def test_cuda_embedding_bag_gradients_match_cpu(cuda_device):
    """The card's table gradient (segment_reduce's sum by id) and weights
    gradient (column-ordered dot products) equal the CPU's bit for bit."""
    n_bags = 300
    arrays = bag_lookups(2000, 18, 30_000, n_bags, seed=11, oob=True)
    g = np.random.default_rng(2).standard_normal((n_bags, 18)).astype(
        np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        table, ids, bags, w, gg = _on(dev, *arrays, g)
        table.requires_grad_()
        w.requires_grad_()
        out = embedding_bag(table, ids, bags, w, n_bags=n_bags)
        grads.append([t.cpu() for t in torch.autograd.grad(
            torch.sum(out * gg), (table, w))])
    for got, want in zip(grads[1], grads[0]):
        _same_bits(got, want)


@pytest.mark.cuda
def test_cuda_dien_train_driver_decreases_loss(cuda_device):
    """Reduced DIEN trains on the card through both kernels: the pooled
    history in embedding_bag, the gradient sums in segment_reduce."""
    before = embedding_bag.launches, segment_reduce.launches
    losses = train.main(["--arch", "dien", "--reduced", "--steps", "4",
                         "--device", "cuda"])
    assert losses[-1] < losses[0]
    assert embedding_bag.launches > before[0]
    assert segment_reduce.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("fused_k", [1, 4])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_cuda_window_slide_and_stream_match_cpu(cuda_device, name, fused_k):
    """The batched slide (5 windows on 8 lanes, 3 masked) and a stream (2
    campaigns of 3 windows on 4 lanes, one masked; 1 rebuild + 1 anchor
    hop) on the card equal the CPU's runs bit for bit, parents tracked, at
    k = 1 and 4; only the card launches relax_multi."""
    seq = make_evolving_sequence(3000, 24_000, 8, 500, seed=3)
    sr = ALL_SEMIRINGS[name]
    runs = []
    for dev in ("cpu", cuda_device):
        store = SnapshotStore(seq, granule=512, device=dev)
        before = relax_multi.launches
        slide = run_window_slide_batched(store, sr, 0, 4, track_parents=True,
                                         fused_k=fused_k)
        stream = run_window_stream_batched(store, sr, 0, 3, campaign_width=3,
                                           track_parents=True,
                                           fused_k=fused_k)
        runs.append((store, slide, stream, relax_multi.launches - before))
    (cpu_store, cpu_slide, cpu_stream, cpu_n), \
        (card_store, slide, stream, card_n) = runs
    assert cpu_n == 0 < card_n
    assert slide.lane_layout == cpu_slide.lane_layout == [(5, 8)]
    assert stream.lane_layout == [(3, 4), (3, 4)]
    assert stream.anchor_events == cpu_stream.anchor_events == \
        ["rebuild", "hop"]
    for got, want in ((slide, cpu_slide), (stream, cpu_stream)):
        assert list(got.results) == list(want.results)
        for wnd, vals in got.results.items():
            assert vals.is_cuda
            _same_bits(vals.cpu(), want.results[wnd])
        assert got.stable_milli == want.stable_milli
        assert [(h.edge_work, h.sweeps) for h in got.hop_stats] == \
            [(h.edge_work, h.sweeps) for h in want.hop_stats]
    qkey = _stream_qkey(sr, 0, 10_000, 1, True)
    for anchor in stream.anchors:
        got = card_store.anchor_state_get(qkey, anchor)
        want = cpu_store.anchor_state_get(qkey, anchor)
        _same_bits(got.values.cpu(), want.values)
        assert torch.equal(got.parent.cpu(), want.parent)
