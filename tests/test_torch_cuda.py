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
    EdgeLog,
    direct_hop_plan,
    optimal_plan,
    run_direct_hop_batched,
    run_plan_batched,
    LiveSequence,
    LiveWindowFeed,
    SnapshotStore,
    SweepCostModel,
    Watermark,
    WindowStream,
    calibrate,
    campaign_volume,
    events_from_sequence,
    optimal_campaigns,
    replay_events,
    run_window_slide_batched,
    run_window_stream_batched,
    slide_windows,
)
from repro_torch.core.window import _stream_qkey  # noqa: E402
from repro_torch.graph import make_evolving_sequence  # noqa: E402
from repro_torch.graph.edgeset import lane_bucket  # noqa: E402
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
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import make_snapshot_mesh  # noqa: E402
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
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_cuda_relax_multi_past_convergence(cuda_device, name, track):
    """A chunk run well past its lanes' last live round (8 lanes that stop
    at different sweeps, one allowed nothing, one capped): the dead rounds
    leave values, parents, frontier, sweeps and work exactly as the last
    live round left them, bit for bit against a chunk that ends there and
    the plain version; the work starts from the lanes' running totals
    (2^24 - 3 on one lane) and adds each sweep in turn."""
    n, lanes = 3000, 8
    shared = _on(cuda_device, *edges(n, 9000, 41, pad=16))
    stacked = _on(cuda_device, *_stacked(lanes, n, 300, 42, pad=8,
                                         padding_lanes=(5,)))
    st = _on(cuda_device, *state(name, n, 43, lanes))
    allowed = torch.full((lanes,), 64, dtype=torch.int32,
                         device=cuda_device)
    allowed[1], allowed[-1] = 0, 2
    total = torch.arange(lanes, dtype=torch.float32, device=cuda_device)
    total[3] = 2.0 ** 24 - 3
    kw = dict(op=KERNEL_OP_FOR[name], num_nodes=n, track_parents=track,
              work=total)
    blocks = [shared, stacked]
    got = relax_multi(*st, blocks, allowed, k=64, **kw)
    live = int(got[3].max())
    assert 2 < live < 40 and len(set(got[3].tolist())) > 2
    ends = relax_multi(*st, blocks, allowed, k=live, **kw)
    want = relax_multi_ref(*st, blocks, allowed, k=64, **kw)
    for part, g, e, r in zip(("values", "parent", "frontier", "sweeps",
                              "work"), got, ends, want):
        if g.dtype == torch.float32:
            g, e, r = (t.view(torch.int32) for t in (g, e, r))
        assert torch.equal(g, e), part
        assert torch.equal(g, r), part
    stopped = [0, 2, 3, 4, 5, 6]     # not allowed 0 (lane 1) nor capped
    assert not got[2][stopped].any()
    assert int(got[3][1]) == 0 and float(got[4][1]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEMIRINGS)
def test_cuda_engine_chunks_equal_one_sweep_chunks(cuda_device, name):
    """The engine's own chunks (``fused_k=None``) on the card equal its
    one-sweep loop (``fused_k=1``) on the card and on the CPU bit for
    bit, edge_work included: from scratch, with max_iters caps that land
    inside a chunk, and batched over 3 Δ lanes bucketed to 4 that stop
    at different sweeps."""
    from repro_torch.graph import engine
    from repro_torch.graph.edgeset import EdgeBlock, EdgeView
    n, lanes = 4000, 4
    sr = ALL_SEMIRINGS[name]
    runs = {}
    for dev in ("cpu", cuda_device):
        base = EdgeBlock(*_on(dev, *edges(n, 20_000, 51, pad=32)))
        delta = EdgeBlock(*_on(dev, *_stacked(lanes, n, 400, 52, pad=8,
                                              padding_lanes=(3,))))
        view = EdgeView((base,), n)
        for fk in (None, 1):
            out = []
            for cap in (10_000, 3, 9):
                out.append(engine.run_to_fixpoint(view, sr, 0,
                                                  max_iters=cap, fused_k=fk))
            start = out[0]
            values = start.values.expand(lanes, n).contiguous()
            parent = start.parent.expand(lanes, n).contiguous()
            valid = torch.arange(lanes, device=values.device) < 3
            for cap in (10_000, 6):
                out.append(engine.incremental_additions_batched(
                    n, sr, values, parent, (base,), (delta,),
                    max_iters=cap, lane_valid=valid, fused_k=fk))
            runs[(str(dev), fk)] = out
    want = runs[("cpu", 1)]
    assert len(set(want[3].iterations[:3].tolist())) > 1
    for key, got in runs.items():
        for g, w in zip(got, want):
            for part in ("values", "parent", "iterations", "edge_work"):
                a, b = getattr(g, part).cpu(), getattr(w, part)
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b), (key, part)


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


def _sampled_nodes(device):
    """minibatch_lg's sampled ``nodes`` at its full batch_nodes and fanout
    (169,984 ids) on ``device``, from a graph with the shape's 232,965
    nodes (and fewer edges), and the feature table's rows (233,472)."""
    from repro_torch.configs.gnn_family import GNN_SHAPES, NODE_PAD, _pad
    from repro_torch.data import DataCursor, sample_subgraph, uniform_graph
    sh = GNN_SHAPES["minibatch_lg"]
    graph = uniform_graph(sh["n_nodes"], 4_000_000, seed=0)
    sub = sample_subgraph(DataCursor(0, 0), graph, sh["batch_nodes"],
                          sh["fanout"])
    return (torch.from_numpy(sub.nodes).to(device),
            _pad(sh["n_nodes"], NODE_PAD))


@pytest.mark.cuda
def test_cuda_segment_reduce_sampled_nodes_into_the_feature_table(
        cuda_device):
    """The feature table's gradient: 169,984 sampled ids into 233,472 rows
    at D = 602, most rows empty, bit for bit against the plain version."""
    nodes, rows = _sampled_nodes(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    data = torch.randn((nodes.shape[0], 602), generator=gen,
                       device=cuda_device)
    lay = segment_layout(nodes, rows)
    assert int((lay.offsets.diff() == 0).sum()) > rows - nodes.shape[0]
    before = segment_reduce.launches
    got = segment_reduce(data, nodes, num_segments=rows, layout=lay)
    assert segment_reduce.launches == before + 1
    _same_bits(got, segment_reduce_ref(data, nodes, num_segments=rows,
                                       layout=lay))


@pytest.mark.cuda
def test_cuda_gather_rows_backward_on_sampled_nodes_matches_index_add(
        cuda_device):
    """``gather_rows``' backward over the sampled nodes (the table's
    gradient) against ``index_add_``, which adds in another order: within
    the rounding of a sum, 2 (k - 1) 2^-24 times the sum of the |terms|
    for a row of k terms."""
    nodes, rows = _sampled_nodes(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    table = torch.randn((rows, 602), generator=gen,
                        device=cuda_device).requires_grad_()
    up = torch.randn((nodes.shape[0], 602), generator=gen, device=cuda_device)
    before = segment_reduce.launches
    out = gather_rows(table, nodes, segment_layout(nodes, rows))
    (got,) = torch.autograd.grad(out, table, up)
    assert segment_reduce.launches == before + 1
    idx = nodes.long()
    want = torch.zeros_like(got).index_add_(0, idx, up)
    terms = torch.zeros_like(got).index_add_(0, idx, up.abs())
    k = torch.bincount(idx, minlength=rows).float()[:, None]
    tol = 2 * torch.clamp(k - 1, min=0) * 2.0**-24 * terms
    assert bool(((got - want).abs() <= tol).all())
    assert torch.equal(got[k[:, 0] == 0], torch.zeros_like(got[k[:, 0] == 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gcn-cora", "pna", "meshgraphnet",
                                  "graphcast"])
def test_cuda_sampled_step_matches_cpu(cuda_device, monkeypatch, arch):
    """Three AdamW steps of a reduced model on a small sampled batch (16
    seeds, fanout 3-2, a 1,024-row feature table) on the card and on the
    CPU from the same weights and batch: the first loss and gradient norm
    within 1e-5 and 1e-4 relative, later losses within 2e-2 (``chip_smoke``'s
    card-vs-CPU tolerances)."""
    import dataclasses
    from repro_torch.configs import gnn_family, reduced_config
    from repro_torch.data import DataCursor
    from repro_torch.models.gnn import gnn_loss, init_gnn_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map
    monkeypatch.setitem(gnn_family.GNN_SHAPES, "minibatch_xs", dict(
        kind="minibatch", n_nodes=1_000, n_edges=100_000, batch_nodes=16,
        fanout=(3, 2), d_feat=12))
    cfg = reduced_config(arch)[0]
    cfg = dataclasses.replace(
        cfg, d_in=cfg.n_vars if arch == "graphcast" else 12,
        d_out=cfg.n_vars if arch == "graphcast" else 5,
        task="node_class" if arch in ("gcn-cora", "pna") else "node_reg",
        feature_table=1_024)
    batch = gnn_family.shape_batch(cfg, "minibatch_xs", DataCursor(0, 0),
                                   "cpu")
    params = init_gnn_params(torch.Generator().manual_seed(0), cfg)
    runs = []
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t, d=dev: t.to(d), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        o, losses, gnorms = adamw_init(p), [], []
        for _ in range(3):
            p, o, loss, gnorm = train.train_step(
                lambda q, bb: gnn_loss(cfg, q, bb), p, o, b, lr=1e-3)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
        runs.append((losses, gnorms))
    (cpu_l, cpu_g), (card_l, card_g) = runs
    assert abs(card_l[0] - cpu_l[0]) <= 1e-5 * abs(cpu_l[0])
    assert abs(card_g[0] - cpu_g[0]) <= 1e-4 * abs(cpu_g[0])
    for a, b in zip(card_l[1:], cpu_l[1:]):
        assert abs(a - b) <= 2e-2 * abs(b)


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
@pytest.mark.parametrize("fused_k", [1, 4, None])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_cuda_window_slide_and_stream_match_cpu(cuda_device, name, fused_k):
    """The batched slide (5 windows on 8 lanes, 3 masked) and a stream (2
    campaigns of 3 windows on 4 lanes, one masked; 1 rebuild + 1 anchor
    hop) on the card equal the CPU's runs bit for bit, parents tracked, at
    k = 1 and 4 and in the engine's own chunks; only the card launches
    relax_multi."""
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


@pytest.mark.cuda
def test_cuda_service_load_matches_cpu(cuda_device):
    """A seeded service load (4 clients, seed 7) on the card equals the
    same load on the CPU: every count, every launch record and every
    client's results bit for bit; only the card launches relax_multi."""
    seq = make_evolving_sequence(3000, 24_000, 6, 500, seed=7)
    specs, schedule = serve.generate_load(6, num_clients=4, seed=7)
    runs = []
    for dev in ("cpu", cuda_device):
        store = SnapshotStore(seq, granule=512, device=dev)
        before = relax_multi.launches
        service, clients = serve.run_service_load(store, specs, schedule)
        runs.append((service, clients, relax_multi.launches - before))
    (cpu_svc, cpu_clients, cpu_n), (svc, clients, card_n) = runs
    assert cpu_n == 0 < card_n
    m, cm = svc.metrics(), cpu_svc.metrics()
    for field in ("admitted", "completed", "turns", "launches", "lanes",
                  "padded_lanes", "anchor_rebuilds", "anchor_hops",
                  "anchor_hits", "edge_work", "unstable_vertex_lanes"):
        assert getattr(m, field) == getattr(cm, field), field
    assert m.completed == m.admitted > 0
    assert [(r.group, r.anchor, r.windows, r.clients, r.bucket,
             r.anchor_events, r.edge_work, r.iterations)
            for r in svc.launch_log] == \
        [(r.group, r.anchor, r.windows, r.clients, r.bucket,
          r.anchor_events, r.edge_work, r.iterations)
         for r in cpu_svc.launch_log]
    for got, want in zip(clients, cpu_clients):
        assert list(got.results) == list(want.results)
        for wnd, vals in got.results.items():
            assert vals.is_cuda
            _same_bits(vals.cpu(), want.results[wnd])


@pytest.mark.cuda
def test_cuda_ingested_store_matches_cpu(cuda_device):
    """A store born from a spill-policy replay on the card, with a live
    feed into a stream and a compaction, serves the precomputed CPU
    store's window results bit for bit, before and after compacting."""
    seq = make_evolving_sequence(3000, 24_000, 6, 500, seed=5)
    sr = ALL_SEMIRINGS["sssp"]
    store = SnapshotStore(LiveSequence(seq.num_nodes,
                                       weight_seed=seq.weight_seed),
                          granule=512, device=cuda_device)
    log = EdgeLog(seq.num_nodes, max_pending_events=4096, policy="spill")
    watermark = Watermark(log, store)
    stream = WindowStream(2, name="live",
                          feed=LiveWindowFeed(store, width=3, name="live"))
    live = {}
    replay_events(log, watermark, events_from_sequence(seq),
                  on_cut=lambda _i: live.update(run_window_stream_batched(
                      store, sr, 0, stream=stream).results))
    assert log.metrics.spilled > 0
    for i in range(seq.num_snapshots):
        assert np.array_equal(store.seq.snapshot_keys[i],
                              seq.snapshot_keys[i])
    cpu = SnapshotStore(seq, granule=512, device="cpu")
    want = run_window_slide_batched(cpu, sr, 0, 3)
    assert set(live) == set(want.results)
    for wnd, vals in want.results.items():
        assert live[wnd].is_cuda
        _same_bits(live[wnd].cpu(), vals)
    before = store.stored_edges
    stats = watermark.compact()
    assert stats.retired > 0 and store.stored_edges < before
    lo = store.first_live
    got = run_window_slide_batched(store, sr, 0, 2, start=lo)
    ref = run_window_slide_batched(cpu, sr, 0, 2, start=lo)
    for wnd, vals in ref.results.items():
        _same_bits(got.results[wnd].cpu(), vals)


@pytest.mark.cuda
def test_cuda_calibrate(cuda_device):
    """``calibrate`` on the card launches relax_multi, returns integer
    coefficients with per_edge >= 1, and its plan is no worse than the
    raw-count plan under the same model."""
    seq = make_evolving_sequence(3000, 24_000, 6, 500, seed=0)
    store = SnapshotStore(seq, granule=512, device=cuda_device)
    before = relax_multi.launches
    model = calibrate(store, ALL_SEMIRINGS["sssp"], 0, stable_milli=500,
                      fused_k=4)
    assert relax_multi.launches > before
    assert isinstance(model, SweepCostModel)
    assert isinstance(model.per_edge_nanos, int) and model.per_edge_nanos >= 1
    assert isinstance(model.per_sweep_nanos, int)
    windows = slide_windows(6, 3)
    raw = optimal_campaigns(store, windows)
    cal = optimal_campaigns(store, windows, cost_model=model)
    assert cal.total_edges <= campaign_volume(
        store, raw.campaigns, cost_model=model).total_edges


# -- lane sharding over a data mesh ------------------------------------------
#
# The CPU's tests/test_torch_shard.py cases on the card: a mesh naming the
# card four times, and a mesh of every local card where there are two or
# more. Each meshed run equals the unmeshed run on the card bit for bit.

MESHES = ["repeat", "cards"]


def _mesh(kind, cuda_device):
    if kind == "repeat":
        return make_snapshot_mesh([cuda_device] * 4)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    return make_snapshot_mesh()


def _card_store(cuda_device, snaps=8, seed=3):
    return SnapshotStore(make_evolving_sequence(3000, 24_000, snaps, 500,
                                                seed=seed),
                         granule=512, device=cuda_device)


def _same_runs(got, want, keys):
    assert [(h.edge_work, h.sweeps) for h in got.hop_stats] == \
        [(h.edge_work, h.sweeps) for h in want.hop_stats]
    assert got.stable_milli == want.stable_milli
    for key in keys:
        assert got.results[key].device == want.results[key].device
        _same_bits(got.results[key].cpu(), want.results[key].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("kind", MESHES)
def test_cuda_batched_executors_on_mesh(cuda_device, kind, name, track):
    """``run_direct_hop_batched`` and ``run_plan_batched`` (optimal and
    direct-hop plans) on a mesh equal the unmeshed runs on the card bit
    for bit; every level buckets to ``lane_bucket(lanes, extent)`` and the
    meshed runs launch relax_multi."""
    mesh = _mesh(kind, cuda_device)
    extent = mesh.shape["data"]
    store = _card_store(cuda_device)
    sr = ALL_SEMIRINGS[name]
    plain = run_direct_hop_batched(store, sr, 0, track_parents=track)
    before = relax_multi.launches
    got = run_direct_hop_batched(store, sr, 0, track_parents=track,
                                 mesh=mesh)
    assert relax_multi.launches > before
    assert got.lane_layout == [(8, lane_bucket(8, extent))]
    for i in range(8):
        _same_bits(got.results[i].cpu(), plain.results[i].cpu())
    for plan in (optimal_plan(store), direct_hop_plan(n=8)):
        plain = run_plan_batched(store, plan, sr, 0, track_parents=track)
        got = run_plan_batched(store, plan, sr, 0, track_parents=track,
                               mesh=mesh)
        assert got.lane_layout == [(lanes, lane_bucket(lanes, extent))
                                   for lanes, _ in plain.lane_layout]
        _same_runs(got, plain, range(8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MESHES)
def test_cuda_window_slide_and_stream_on_mesh(cuda_device, kind):
    """The batched slide (3 and 5 windows) and a stream of campaigns of 2
    on a mesh equal the unmeshed runs on the card bit for bit, parents
    tracked: values, per-launch work and sweeps, anchor events."""
    mesh = _mesh(kind, cuda_device)
    extent = mesh.shape["data"]
    store = _card_store(cuda_device)
    sr = ALL_SEMIRINGS["sssp"]
    for width in (4, 6):
        plain = run_window_slide_batched(store, sr, 0, width,
                                         track_parents=True)
        got = run_window_slide_batched(store, sr, 0, width,
                                       track_parents=True, mesh=mesh)
        lanes = 9 - width
        assert got.lane_layout == [(lanes, lane_bucket(lanes, extent))]
        _same_runs(got, plain, plain.results)
    plain = run_window_stream_batched(store, sr, 0, 3, campaign_width=2,
                                      track_parents=True)
    store.release(("AS",))
    got = run_window_stream_batched(store, sr, 0, 3, campaign_width=2,
                                    track_parents=True, mesh=mesh)
    assert got.anchor_events == plain.anchor_events
    assert got.lane_layout == [(lanes, lane_bucket(lanes, extent))
                               for lanes, _ in plain.lane_layout]
    _same_runs(got, plain, plain.results)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MESHES)
def test_cuda_auto_campaigns_on_mesh(cuda_device, kind):
    """``campaign_width="auto"`` on a mesh plans at its data extent (the
    plan equals ``optimal_campaigns(..., data_extent=extent)``) and every
    window equals the unmeshed auto stream on the card bit for bit."""
    mesh = _mesh(kind, cuda_device)
    extent = mesh.shape["data"]
    store = _card_store(cuda_device)
    sr = ALL_SEMIRINGS["sssp"]
    windows = slide_windows(8, 3)
    plain = run_window_stream_batched(store, sr, 0, 3,
                                      campaign_width="auto")
    store.release(("AS",))
    got = run_window_stream_batched(store, sr, 0, 3, campaign_width="auto",
                                    mesh=mesh)
    want = optimal_campaigns(store, windows, data_extent=extent)
    assert got.plan.campaigns == want.campaigns
    assert got.plan.total_edges == want.total_edges
    assert got.plan.data_extent == extent
    for wnd in windows:
        _same_bits(got.results[wnd].cpu(), plain.results[wnd].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MESHES)
def test_cuda_service_load_on_mesh(cuda_device, kind):
    """A seeded service load (4 clients, seed 7) on a mesh equals the
    unmeshed load on the card: every count but the padding, every launch
    record but its bucket (``lane_bucket(lanes, extent)``) and every
    client's results bit for bit, on the store's card."""
    mesh = _mesh(kind, cuda_device)
    extent = mesh.shape["data"]
    seq = make_evolving_sequence(3000, 24_000, 6, 500, seed=7)
    specs, schedule = serve.generate_load(6, num_clients=4, seed=7)
    runs = []
    for m in (None, mesh):
        store = SnapshotStore(seq, granule=512, device=cuda_device)
        runs.append(serve.run_service_load(store, specs, schedule, mesh=m))
    (plain, plain_clients), (svc, clients) = runs
    m, pm = svc.metrics(), plain.metrics()
    for field in ("admitted", "completed", "turns", "launches", "lanes",
                  "anchor_rebuilds", "anchor_hops", "anchor_hits",
                  "edge_work", "unstable_vertex_lanes"):
        assert getattr(m, field) == getattr(pm, field), field
    assert [(r.group, r.anchor, r.windows, r.clients, r.anchor_events,
             r.edge_work, r.iterations) for r in svc.launch_log] == \
        [(r.group, r.anchor, r.windows, r.clients, r.anchor_events,
          r.edge_work, r.iterations) for r in plain.launch_log]
    assert all(r.bucket == lane_bucket(r.lanes, extent)
               for r in svc.launch_log)
    for got, want in zip(clients, plain_clients):
        assert list(got.results) == list(want.results)
        for wnd, vals in got.results.items():
            assert vals.device == want.results[wnd].device
            _same_bits(vals.cpu(), want.results[wnd].cpu())


# -- the paper's engine at production scale (configs/commongraph.py) ----------
#
# tests/test_torch_commongraph.py's small shape on the card: the cell's step
# equals the same step on the CPU (which that file holds against the JAX
# package), unmeshed and on a mesh naming the card twice.

SMALL_CELL = dict(n_snapshots=5, n_nodes=1024, cg_edges=8192,
                  delta_edges=512)


@pytest.mark.cuda
@pytest.mark.parametrize("extent", [1, 2])
def test_cuda_commongraph_cell_matches_cpu(cuda_device, monkeypatch, extent):
    from repro_torch.configs import commongraph
    monkeypatch.setitem(commongraph.COMMONGRAPH_SHAPES, "small_5x",
                        dict(SMALL_CELL))
    edges = commongraph.commongraph_edges("small_5x", extent, seed=0)
    want = commongraph.make_commongraph_cell("small_5x").fn(
        *commongraph.commongraph_inputs("small_5x", extent, 0, "cpu", edges))
    inputs = commongraph.commongraph_inputs("small_5x", extent, 0,
                                            cuda_device, edges)
    mesh = (None if extent == 1
            else make_snapshot_mesh([inputs.values.device] * extent))
    cell = commongraph.make_commongraph_cell("small_5x", mesh)
    before = relax_multi.launches
    got = cell.fn(*inputs)
    assert relax_multi.launches > before
    for g, w in zip(got, want):
        assert g.device == inputs.values.device
        _same_bits(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("cards", ["repeat", "every"])
def test_cuda_placed_window_matches_unmeshed(cuda_device, monkeypatch,
                                             cards):
    """The window placed on a mesh naming the card four times, and on
    every card (skipped below two), with each shard's lanes kept on its
    card (``place_window``, ``PlacedWindow.step``): every lane, padding
    lanes included, equals the unmeshed cell's step on the card bit for
    bit (values, iterations, ``edge_work``), and lies on its shard's
    card; the broadcast's bytes and, between cards, its copies' device
    time are counted."""
    from repro_torch.configs import commongraph
    from repro_torch.runtime import trace
    if cards == "every":
        count = torch.cuda.device_count()
        if count < 2:
            pytest.skip("needs two or more cards")
        devices = [torch.device("cuda", i) for i in range(count)]
    else:
        devices = [torch.device("cuda", torch.cuda.current_device())] * 4
    extent = len(devices)
    monkeypatch.setitem(commongraph.COMMONGRAPH_SHAPES, "small_5x",
                        dict(SMALL_CELL))
    edges = commongraph.commongraph_edges("small_5x", extent, seed=1)
    inputs = commongraph.commongraph_inputs("small_5x", extent, 1,
                                            devices[0], edges)
    want = commongraph.make_commongraph_cell("small_5x").fn(*inputs)
    mesh = make_snapshot_mesh(devices)
    lanes = commongraph.window_lanes(SMALL_CELL["n_snapshots"], extent)
    window = commongraph.place_window(
        SMALL_CELL, mesh, inputs.cg,
        type(inputs.delta)(*(a[:lanes] for a in inputs.delta)),
        inputs.lane_valid[:lanes])
    trace.reset()
    with trace.recording():
        got = window.step(inputs.values[0])
    copied = trace.totals()["counts"]
    trace.reset()
    assert copied["shard.copied_bytes"] >= (extent - 1) * 4 * 1024
    if cards == "every":    # the copies between cards, on the first's clock
        assert copied["shard.broadcast_device_ns"] > 0
    assert [r.values.shape[0] for r in got.shards] == \
        [lanes // extent] * extent
    lane = 0
    for dev, r in zip(devices, got.shards):
        for i in range(r.values.shape[0]):
            assert r.values.device == dev
            for g, w in zip((r.values[i], r.iterations[i], r.edge_work[i]),
                            (want[0][lane], want[2][lane], want[3][lane])):
                _same_bits(g.cpu().reshape(-1), w.cpu().reshape(-1))
            lane += 1
    assert lane == lanes


@pytest.mark.cuda
def test_cuda_device_span_times_the_stream(cuda_device):
    """On a card a device span keeps its two CUDA events unread and
    ``totals`` reads them: a 256 MiB copy takes more than 50 us there
    and less than the host's time around it, synchronized."""
    import time

    from repro_torch.runtime import trace
    x = torch.empty(2**26, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    trace.reset()
    with trace.recording():
        t0 = time.perf_counter_ns()
        with trace.device_span("probe_ns", cuda_device):
            x.clone()
        assert len(trace._events["probe_ns"]) == 1
        torch.cuda.synchronize(cuda_device)
        host = time.perf_counter_ns() - t0
    ns = trace.totals()["counts"]["probe_ns"]
    trace.reset()
    assert 50_000 < ns <= host and trace._events == {}


@pytest.mark.cuda
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("lanes", [32, 33, 64])
def test_cuda_relax_multi_wide_lanes(cuda_device, lanes, track):
    """The CommonGraph cell's launch shape at 32, 33 and 64 lanes (one and
    two words of lane bits per vertex): a shared block plus a stacked Δ
    block with masked trailing lanes, k = 3, bit for bit against the
    plain version."""
    n = 20_000
    shared = _on(cuda_device, *skewed_edges(n, 120_000, 21, pad=32))
    stacked = _on(cuda_device, *_stacked(lanes, n, 400, 22, sort=True, pad=8,
                                         padding_lanes=(lanes - 1,)))
    st = _on(cuda_device, *state("sssp", n, 23, lanes))
    allowed = torch.full((lanes,), 3, dtype=torch.int32, device=cuda_device)
    allowed[lanes // 2] = 1
    kw = dict(op="min_plus", num_nodes=n, k=3, track_parents=track)
    got = relax_multi(*st, [shared, stacked], allowed, **kw)
    want = relax_multi_ref(*st, [shared, stacked], allowed, **kw)
    for part, g, r in zip(("values", "parent", "frontier", "sweeps", "work"),
                          got, want):
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), part


@pytest.mark.cuda
def test_cuda_evolve_shard_on_a_second_card(cuda_device):
    """``evolve --device cuda:1 --shard`` builds its mesh with cuda:1
    first and verifies, its results on cuda:1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    from repro_torch.launch import evolve
    summary = evolve.main(["--nodes", "3000", "--edges", "24000",
                           "--snapshots", "5", "--changes", "500",
                           "--device", "cuda:1", "--shard", "--verify",
                           "--window", "3", "--window-batch"])
    assert summary["verified"]
    for per_snap in summary["results"].values():
        assert all(v.device == torch.device("cuda", 1) for v in per_snap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_groups", [1, 3])
def test_cuda_moe_combine_matches_plain(cuda_device, dtype, n_groups):
    """The MoE combine (``transformer._combine``) at qwen3's width on the
    card: one segment_reduce launch, bit for bit the combine on the CPU
    (the kernel's plain version) from the same slot rows, gates and
    destinations, sentinel slots included."""
    from repro_torch.models import transformer
    g_sz, slots, d = 64, 640, 2048
    gen = torch.Generator().manual_seed(n_groups)
    yflat = torch.randn((n_groups, slots, d), generator=gen).to(dtype)
    gate = torch.rand((n_groups, slots), generator=gen).to(dtype)
    stt = torch.randint(0, g_sz + 1, (n_groups, slots), generator=gen)
    before = segment_reduce.launches
    got = transformer._combine(*(t.to(cuda_device) for t in
                                 (yflat, gate, stt)), g_sz)
    assert segment_reduce.launches == before + 1
    want = transformer._combine(yflat, gate, stt, g_sz)
    assert got.dtype == dtype and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-maverick-"
                                  "400b-a17b", "llama3.2-3b",
                                  "nemotron-4-340b", "stablelm-1.6b"])
def test_cuda_reduced_lm_serving_matches_cpu(cuda_device, arch):
    """A reduced float32 config (TF32 off): prefill 2 x 32 and 4 decode
    steps on the card and on the CPU from the same weights and tokens,
    every logit within 1e-5 of the largest (``chip_smoke.LOGIT_TOL``), the
    same greedy tokens, and one segment_reduce launch per MoE layer and
    step on the card."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.tree import tree_map
    cfg = reduced_config(arch)[0]
    params = init_lm_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = segment_reduce.launches
        card = serve.serve_lm(cfg, tree_map(lambda t: t.to(cuda_device),
                                            params),
                              toks.to(cuda_device), 5)
        launches = segment_reduce.launches - before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu = serve.serve_lm(cfg, params, toks, 5)
    assert launches == cfg.layer_kinds().count("moe") * 5
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    for c, h in zip([card["prefill_logits"], *card["decode_logits"]],
                    [cpu["prefill_logits"], *cpu["decode_logits"]]):
        assert float((c.cpu() - h).abs().max()) <= 1e-5 * float(
            h.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_lm_gathers_backward_in_the_kernel(cuda_device, dtype):
    """The LM's two gathers on the card (``transformer._embed`` into a
    100,352-row table at D = 2,048, ``transformer._dispatch`` with empty
    slots): each backward is one segment_reduce launch, bit for bit the
    CPU's gradient (the plain version) from the same rows and ids."""
    from repro_torch.models import transformer
    gen = torch.Generator().manual_seed(3)
    table = torch.randn((100_352, 2048), generator=gen).to(dtype)
    tokens = torch.randint(0, 100_352, (2, 512), generator=gen,
                           dtype=torch.int32)
    xg = torch.randn((2, 64, 2048), generator=gen).to(dtype)
    slot_token = torch.randint(0, 64, (2, 640), generator=gen)
    slot_valid = torch.rand((2, 640), generator=gen) < 0.8

    def grads(device):
        t = table.to(device).requires_grad_()
        x = xg.to(device).requires_grad_()
        rows = transformer._embed(t, tokens.to(device))
        xe = transformer._dispatch(x, slot_token.to(device),
                                   slot_valid.to(device))
        ct = [torch.randn(r.shape, generator=torch.Generator().manual_seed(
            4)).to(dtype).to(device) for r in (rows, xe)]
        return torch.autograd.grad((rows, xe), (t, x), ct)
    before = segment_reduce.launches
    card = grads(cuda_device)
    assert segment_reduce.launches == before + 2
    for got, want in zip(card, grads("cpu")):
        assert got.dtype == dtype and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 96, 80), (3, 64, 96, 80)])
def test_cuda_matmul_f32_gradient_matches_widened_product(cuda_device,
                                                          shape):
    """``matmul_f32`` of bfloat16 operands on the card (``_MatmulF32``):
    the float32 product of the widened operands, and each gradient the
    widened product's cast to bfloat16, within 1e-6 of the largest."""
    from repro_torch.models.common import matmul_f32
    gen = torch.Generator().manual_seed(5)
    *batch, m, k, n = shape
    a = torch.randn((*batch, m, k), generator=gen).bfloat16().to(cuda_device)
    b = torch.randn((*batch, k, n), generator=gen).bfloat16().to(cuda_device)
    g = torch.randn((*batch, m, n), generator=gen).to(cuda_device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, want = [], []
        for fn, out in ((matmul_f32, got),
                        (lambda x, y: torch.matmul(x.float(), y.float()),
                         want)):
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            z = fn(x, y)
            out += [z, *torch.autograd.grad(z, (x, y), g)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert [t.dtype for t in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max()) \
            or torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "stablelm-1.6b"])
def test_cuda_reduced_lm_train_step_is_deterministic(cuda_device, arch):
    """A reduced LM in bfloat16 on the card: two runs of a train step
    from the same state give bit-identical gradients and parameters, with
    one segment_reduce launch for the embedding's gradient and two per MoE
    layer; the loss equals the CPU's within 1e-2 relative (bfloat16)."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataCursor, lm_batch
    from repro_torch.models.transformer import init_lm_params, lm_loss
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(reduced_config(arch)[0],
                              param_dtype=torch.bfloat16)
    host = init_lm_params(torch.Generator().manual_seed(0), cfg)
    params = tree_map(lambda t: t.to(cuda_device), host)
    batch = lm_batch(DataCursor(0, 0), 4, 64, cfg.vocab, device=cuda_device)

    def loss_fn(p, b):
        return lm_loss(cfg, p, b["tokens"], b["labels"])
    opt = adamw_init(params)
    runs = []
    for _ in range(2):
        before = segment_reduce.launches
        loss, grads = train.loss_and_grads(loss_fn, params, batch)
        assert segment_reduce.launches - before == 1 + 2 * cfg.layer_kinds(
        ).count("moe")
        new = adamw_update(grads, opt, params, lr=1e-3, weight_decay=0.0)[0]
        runs.append((loss, tree_leaves(grads), tree_leaves(new)))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        assert torch.equal(a, b)
    cpu = loss_fn(host, {k: v.cpu() for k, v in batch.items()})
    assert abs(float(runs[0][0]) - float(cpu)) <= 1e-2 * abs(float(cpu))


# -- the dry run's cells on the card, the fault drill, compression --------------

def _held():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _step_temp(fn, args):
    """The output of ``fn(*args)`` and the allocator's peak over it above
    what was live before it."""
    before = _held()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _near(measured: int, traced: int) -> bool:
    """Within 5% or 1 MiB (chip_smoke.py phase 13b's bound)."""
    return abs(measured - traced) <= max(0.05 * traced, 2**20)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape", [("gcn-cora", "full_graph_sm"),
                                        ("pna", "molecule")])
def test_cuda_gnn_cell_equals_train_step_and_its_traced_peak(cuda_device,
                                                             arch, shape):
    """``make_cell`` on ``make_local_mesh()``, run on the card from
    ``shape_run``'s arguments: the output equals ``train_step``'s bit for
    bit, and the arguments' bytes on the card and the step's temporaries
    each lie within 5% or 1 MiB of the meta trace's (chip_smoke.py phase
    13b)."""
    from repro_torch.configs import make_cell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.meta_trace import trace_step
    from repro_torch.tree import tree_leaves
    cell = make_cell(arch, shape, make_local_mesh())
    _, trace = trace_step(cell.fn, cell.args)
    held = _held()
    _, batch, params, opt, loss_fn, _ = train.shape_run(arch, shape,
                                                        cuda_device, 0)
    arg_bytes = _held() - held
    # the entry point first: the process's first product takes cuBLAS's
    # workspace, which stays for the process (live before chip_smoke.py's
    # phase 13b, after twelve phases)
    p, o, loss, gnorm = train.train_step(loss_fn, params, opt, batch, lr=1e-3)
    out, temp = _step_temp(cell.fn, (params, opt, batch))
    one = trace["one_device"]
    assert _near(arg_bytes, one["argument_bytes"])
    assert _near(temp, one["temp_bytes"])
    for a, b in zip(tree_leaves(out), tree_leaves((p, o, {"loss": loss,
                                                          "grad_norm": gnorm})),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_dien_serve_cell_equals_the_forward(cuda_device):
    import repro_torch.configs as configs
    from repro_torch.configs import recsys_family
    from repro_torch.data import DataCursor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.meta_trace import trace_step
    from repro_torch.models import dien
    cell = configs.make_cell("dien", "serve_p99", make_local_mesh())
    _, trace = trace_step(cell.fn, cell.args)
    cfg = configs.get_arch("dien")[0]
    held = _held()
    params = dien.init_dien_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg)
    batch = recsys_family.shape_batch(cfg, "serve_p99", DataCursor(0, 0),
                                      cuda_device)
    arg_bytes = _held() - held
    with torch.no_grad():     # first, as the GNN cells' entry point
        want = dien.dien_forward(cfg, params, batch)[0]
    out, temp = _step_temp(cell.fn, (params, batch))
    one = trace["one_device"]
    assert _near(arg_bytes, one["argument_bytes"])
    assert _near(temp, one["temp_bytes"])
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_cuda_fault_drill_equals_a_run_without_failures(cuda_device,
                                                        tmp_path):
    """The reduced gcn-cora trained 8 steps with failures at 3 and 6 and
    checkpoints every 2: replayed [2, 3, 6], the final state bit for bit
    (chip_smoke.py phase 13c, tests/test_torch_runtime.py's drill)."""
    from repro_torch.data import DataCursor
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import CheckpointManager, FaultTolerantRunner
    from repro_torch.tree import tree_leaves
    _, _, params_init, loss_fn, data_fn = train.build("gcn-cora", True, 8,
                                                      128, cuda_device)
    params = params_init(torch.Generator(device=cuda_device).manual_seed(0))

    def step_fn(state, step):
        p, o, _, _ = train.train_step(loss_fn, state["params"], state["opt"],
                                      data_fn(DataCursor(0, step)), lr=1e-2)
        return {"params": p, "opt": o}
    straight = {"params": params, "opt": adamw_init(params)}
    for step in range(8):
        straight = step_fn(straight, step)
    runner = FaultTolerantRunner(CheckpointManager(str(tmp_path),
                                                   device=cuda_device),
                                 ckpt_every=2)
    got, replayed = runner.run({"params": params, "opt": adamw_init(params)},
                               step_fn, 8, fail_at={3, 6})
    assert replayed == [2, 3, 6]
    for a, b in zip(tree_leaves(got), tree_leaves(straight), strict=True):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_error_feedback_compression_matches_cpu(cuda_device, dtype):
    from repro_torch.optim import ef_compress_update, init_residuals
    rng = np.random.default_rng(3)
    host = {"w": torch.from_numpy(rng.standard_normal((300, 70))
                                  .astype(np.float32) * 1e-3).to(dtype),
            "zero": torch.zeros(9, dtype=dtype),
            "halves": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5],
                                   dtype=dtype)}
    card = {k: v.to(cuda_device) for k, v in host.items()}
    res_h, res_c = init_residuals(host), init_residuals(card)
    for _ in range(5):
        comp_h, res_h = ef_compress_update(host, res_h)
        comp_c, res_c = ef_compress_update(card, res_c)
        for k in host:
            assert torch.equal(comp_c[k].cpu(), comp_h[k])
            assert torch.equal(res_c[k].cpu(), res_h[k])
