"""``chip_smoke.main_path_sweeps`` replays the main path's relax calls in
the engine's own chunks: on the CPU (plain versions) its final states,
iterations, work and number of calls equal the engine's own fixpoints bit
for bit — the dh hop
(``incremental_additions``), the batched hops
(``incremental_additions_batched``) and KickStarter's from-scratch run
(``run_to_fixpoint``, parents tracked), and on the window path the
batched slide's launch (masked lanes included) and the stream's anchor
hop — for all five semirings; and each replayed call equals the same
call made one round at a time (``chip_smoke.round_by_round``). The card
holds each replayed call against both in ``chip_smoke.py``'s phase 2."""

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    SnapshotStore,
    run_window_slide_batched,
    run_window_stream_batched,
    slide_windows,
)
from repro_torch.core.window import _stream_qkey  # noqa: E402
from repro_torch.graph import make_evolving_sequence  # noqa: E402
from repro_torch.graph.edgeset import lane_bucket  # noqa: E402
from repro_torch.graph.engine import (  # noqa: E402
    _chunk_sweeps,
    incremental_additions,
    incremental_additions_batched,
    run_to_fixpoint,
)
from repro_torch.graph.semiring import ALL_SEMIRINGS  # noqa: E402
from repro_torch.kernels.edge_relax_multi.ref import (  # noqa: E402
    relax_multi_ref,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
SNAPSHOTS = 5


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


@pytest.fixture(scope="module")
def store():
    seq = make_evolving_sequence(600, 4000, SNAPSHOTS, 300, seed=3)
    return SnapshotStore(seq, granule=256, device="cpu")


def _same(got, want, msg):
    assert got.shape == want.shape, msg
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), msg


def _chunks(sweeps):
    """Calls the engine's schedule makes for a fixpoint of ``sweeps``."""
    launched = calls = 0
    while launched < sweeps:
        launched += _chunk_sweeps(None, launched, 10_000)
        calls += 1
    return calls


def _check(replay, res, msg):
    _same(replay["values"], res.values, f"{msg}: values")
    _same(replay["parent"], res.parent, f"{msg}: parent")
    _same(replay["iterations"], res.iterations, f"{msg}: iterations")
    _same(replay["work"], res.edge_work, f"{msg}: work")
    assert not bool(replay["frontier"].any()), f"{msg}: frontier not empty"


@pytest.mark.parametrize("name", sorted(ALL_SEMIRINGS))
def test_main_path_replay_equals_engine(smoke, store, name):
    sr = ALL_SEMIRINGS[name]
    n = store.num_nodes
    replay = smoke.main_path_sweeps(store, sr)
    window = (0, SNAPSHOTS - 1)
    cg = store.common_graph_view(*window)
    anchor = run_to_fixpoint(cg, sr, 0, track_parents=False)
    delta = store.delta_block(window, (1, 1))
    dh = incremental_additions(cg.extended(delta), delta, sr, anchor.values,
                               anchor.parent, track_parents=False)
    _check({key: (v[0] if isinstance(v, torch.Tensor) else v)
            for key, v in replay["dh"].items()}, dh, f"{name} dh")
    lanes = lane_bucket(SNAPSHOTS)
    stacked = store.delta_stack([(window, (i, i)) for i in range(SNAPSHOTS)],
                                num_lanes=lanes)
    dhb = incremental_additions_batched(
        n, sr, anchor.values.expand(lanes, n), anchor.parent.expand(lanes, n),
        cg.blocks, (stacked,), track_parents=False)
    _check(replay["dhb"], dhb, f"{name} dhb")
    ks = run_to_fixpoint(store.snapshot_view(0), sr, 0)
    _check({key: (v[0] if isinstance(v, torch.Tensor) else v)
            for key, v in replay["ks"].items()}, ks, f"{name} ks")
    assert replay["ks"]["calls"] == _chunks(int(ks.iterations))
    assert replay["dh"]["calls"] == 1 + _chunks(int(dh.iterations) - 1)


@pytest.mark.parametrize("name", sorted(ALL_SEMIRINGS))
def test_replayed_chunks_equal_one_round_calls(smoke, store, name):
    """Every replayed call, made again one round at a time, gives the
    same outputs bit for bit; a round is counted where some lane ran, and
    the replay's chunks reach past their fixpoints (dead rounds)."""
    sr = ALL_SEMIRINGS[name]
    n = store.num_nodes
    seen = []

    def call(case, args, kw):
        got = relax_multi_ref(*args, **kw)
        rounds, (nbytes, floor, pairs, ran) = smoke.round_by_round(args, kw,
                                                                   n)
        for part, g, o in zip(("values", "parent", "frontier", "sweeps",
                               "work"), got, rounds):
            _same(g, o, f"{name} {case} k={kw['k']} {part}")
        assert ran == int(got[3].max())
        assert (nbytes > 0) == (ran > 0) and floor >= nbytes and pairs >= 0
        seen.append((kw["k"], ran))
        return got

    smoke.main_path_sweeps(store, sr, call)
    assert any(k > ran for k, ran in seen)
    assert any(k > 1 and ran > 1 for k, ran in seen)


@pytest.mark.parametrize("name", sorted(ALL_SEMIRINGS))
def test_window_replay_equals_engine(smoke, name):
    """At 8 snapshots, as on the main path: the slide case is 5 width-4
    windows on 8 lanes (3 masked), and its valid lanes are the batched
    slide's results; the anchor hop's state is the stream's cached state
    for its second campaign's anchor."""
    sr = ALL_SEMIRINGS[name]
    store = SnapshotStore(make_evolving_sequence(600, 4000, 8, 300, seed=5),
                          granule=256, device="cpu")
    n = store.num_nodes
    replay = smoke.main_path_sweeps(store, sr)
    window = (0, 7)
    cg = store.common_graph_view(*window)
    anchor = run_to_fixpoint(cg, sr, 0, track_parents=False)
    windows = slide_windows(8, smoke.WINDOW)
    slide = store.slide_stack(windows, window, num_lanes=8)
    assert slide.src.shape[0] == replay["slide"]["values"].shape[0] == 8
    res = incremental_additions_batched(
        n, sr, anchor.values.expand(8, n), anchor.parent.expand(8, n),
        cg.blocks, (slide,), track_parents=False)
    _check(replay["slide"], res, f"{name} slide")
    bat = run_window_slide_batched(store, sr, 0, smoke.WINDOW)
    for lane, wnd in enumerate(windows):
        _same(replay["slide"]["values"][lane], bat.results[wnd],
              f"{name} slide lane {lane}")
    hop_window = (smoke.CAMPAIGN_WIDTH, 7)
    delta = store.delta_block(window, hop_window)
    hop = incremental_additions(cg.extended(delta), delta, sr, anchor.values,
                                anchor.parent, track_parents=False)
    _check({key: (v[0] if isinstance(v, torch.Tensor) else v)
            for key, v in replay["anchor_hop"].items()}, hop,
           f"{name} anchor hop")
    stream = run_window_stream_batched(store, sr, 0, smoke.WINDOW,
                                       campaign_width=smoke.CAMPAIGN_WIDTH)
    assert stream.anchors[1] == hop_window
    assert stream.anchor_events[1] == "hop"
    cached = store.anchor_state_get(_stream_qkey(sr, 0, 10_000, 1, False),
                                    hop_window)
    _same(replay["anchor_hop"]["values"][0], cached.values,
          f"{name} anchor hop state")
