"""``chip_smoke.main_path_sweeps`` replays the main path's relax calls one
at a time: on the CPU (plain versions) its final states, iterations and
work equal the engine's own fixpoints bit for bit — the dh hop
(``incremental_additions``), the batched hops
(``incremental_additions_batched``) and KickStarter's from-scratch run
(``run_to_fixpoint``, parents tracked) — for all five semirings. The card
holds each replayed call against the plain version in ``chip_smoke.py``'s
phase 2."""

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import SnapshotStore  # noqa: E402
from repro_torch.graph import make_evolving_sequence  # noqa: E402
from repro_torch.graph.edgeset import lane_bucket  # noqa: E402
from repro_torch.graph.engine import (  # noqa: E402
    incremental_additions,
    incremental_additions_batched,
    run_to_fixpoint,
)
from repro_torch.graph.semiring import ALL_SEMIRINGS  # noqa: E402

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
    assert replay["ks"]["calls"] == int(ks.iterations)
    assert replay["dh"]["calls"] == int(dh.iterations)
