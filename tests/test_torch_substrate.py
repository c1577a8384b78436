"""PyTorch port substrate held against the JAX reference, bit for bit:
semirings, generators, padded edge blocks, the snapshot store, interop,
and the port's import hygiene (no jax, no repro)."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.snapshots import SnapshotStore as JStore  # noqa: E402
from repro.graph import edgeset as jedge  # noqa: E402
from repro.graph import generators as jgen  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.snapshots import SnapshotStore as TStore  # noqa: E402
from repro_torch.graph import edgeset as tedge  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SEMIRINGS = sorted(JSEMI)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_block_equal(jblk, tblk):
    for j, t in zip(jblk, tblk):
        np.testing.assert_array_equal(np.asarray(j), _np(t))
        assert _np(t).dtype == np.asarray(j).dtype


@pytest.fixture(scope="module")
def seqs():
    args = (300, 2400, 5, 160)
    return (jgen.make_evolving_sequence(*args, seed=4, weight_seed=2),
            tgen.make_evolving_sequence(*args, seed=4, weight_seed=2))


# -- semirings -----------------------------------------------------------------


def test_semiring_registry_matches_reference():
    assert sorted(TSEMI) == SEMIRINGS
    for name in SEMIRINGS:
        j, t = JSEMI[name], TSEMI[name]
        assert (t.name, t.reduce, t.needs_weights) == (j.name, j.reduce,
                                                       j.needs_weights)
        assert np.float32(t.identity) == np.float32(j.identity)
        assert np.float32(t.source_value) == np.float32(j.source_value)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_semiring_ops_bit_identical(name):
    """combine/better/strictly_better equal the reference on mixed values,
    including identities, infinities and products that underflow."""
    rng = np.random.default_rng(1)
    j, t = JSEMI[name], TSEMI[name]
    a = (rng.random(400) * 3).astype(np.float32)
    a[::7] = np.float32(j.identity)
    a[::11] = np.float32(j.source_value)
    a[::13] = np.float32(1e-37)
    w = (rng.random(400) * 0.999 + 1e-3).astype(np.float32)
    w[::5] = np.float32(1e-3)
    for op in ("combine", "better", "strictly_better"):
        jr = np.asarray(getattr(j, op)(jnp.asarray(a), jnp.asarray(w)))
        tr = _np(getattr(t, op)(torch.from_numpy(a), torch.from_numpy(w)))
        np.testing.assert_array_equal(tr, jr, err_msg=f"{name}.{op}")


def test_viterbi_combine_flushes_denormals_like_reference():
    v = np.array([1e-38, 1e-37, -1e-38, 2e-38], np.float32)
    w = np.array([0.01, 0.001, 0.01, 0.75], np.float32)
    jr = np.asarray(JSEMI["viterbi"].combine(jnp.asarray(v), jnp.asarray(w)))
    tr = _np(TSEMI["viterbi"].combine(torch.from_numpy(v), torch.from_numpy(w)))
    np.testing.assert_array_equal(tr.view(np.int32), jr.view(np.int32))
    assert tr[0] == 0.0 and np.signbit(tr[2])


# -- generators and key algebra --------------------------------------------------


def test_generators_bit_identical(seqs):
    js, ts = seqs
    assert ts.num_nodes == js.num_nodes and ts.weight_seed == js.weight_seed
    for field in ("snapshot_keys", "additions", "deletions"):
        a, b = getattr(js, field), getattr(ts, field)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    keys = js.snapshot_keys[2]
    np.testing.assert_array_equal(ts.weights_for(keys), js.weights_for(keys))
    for x, y in zip(jgen.rmat_edges(500, 3000, seed=9),
                    tgen.rmat_edges(500, 3000, seed=9)):
        np.testing.assert_array_equal(x, y)


def test_key_algebra_bit_identical(seqs):
    js, _ = seqs
    k0, k1 = js.snapshot_keys[0], js.snapshot_keys[1]
    s, d = jedge.keys_to_edges(k0, js.num_nodes)
    for a, b in zip((s, d), tedge.keys_to_edges(k0, js.num_nodes)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tedge.edge_keys(s, d, js.num_nodes),
                                  jedge.edge_keys(s, d, js.num_nodes))
    np.testing.assert_array_equal(
        tedge.merge_changes(k0, js.additions[0], js.deletions[0]), k1)


@pytest.mark.parametrize("size", [0, 1, 2, 1000])
def test_sort_based_set_ops_equal_numpy(size):
    """The sort-based helpers return exactly what np.unique, np.isin and a
    stable np.argsort return, duplicates, ties and empty inputs included."""
    rng = np.random.default_rng(size)
    keys = rng.integers(0, 50, size).astype(np.int64) << 30
    np.testing.assert_array_equal(tedge.unique_keys(keys), np.unique(keys))
    table = np.unique(rng.integers(0, 50, size // 3).astype(np.int64) << 30)
    np.testing.assert_array_equal(tedge.isin_sorted(keys, table),
                                  np.isin(keys, table))
    dst = rng.integers(0, 7, size).astype(np.int32)
    np.testing.assert_array_equal(tedge.stable_order(dst),
                                  np.argsort(dst, kind="stable"))


@pytest.mark.parametrize("lanes,extent",[(1, 1), (3, 1), (5, 2), (9, 4),
                                          (16, 4)])
def test_lane_bucket_matches_reference(lanes, extent):
    assert tedge.lane_bucket(lanes, extent) == jedge.lane_bucket(lanes, extent)


# -- padded blocks -----------------------------------------------------------------


@pytest.mark.parametrize("pad_pow2", [False, True])
@pytest.mark.parametrize("n_edges", [0, 1, 700, 1024])
def test_make_block_bit_identical(n_edges, pad_pow2):
    rng = np.random.default_rng(n_edges)
    n = 90
    src = rng.integers(0, n, n_edges).astype(np.int32)
    dst = rng.integers(0, n, n_edges).astype(np.int32)
    w = rng.random(n_edges).astype(np.float32)
    jb = jedge.make_block(src, dst, w, n, granule=256, pad_pow2=pad_pow2)
    tb = tedge.make_block(src, dst, w, n, granule=256, pad_pow2=pad_pow2,
                          device="cpu")
    _assert_block_equal(jb, tb)
    assert tb.n_padded == jb.n_padded
    # padding convention: PAD_SRC src, sentinel dst, zero weight
    assert (_np(tb.dst)[n_edges:] == n).all()
    assert (_np(tb.src)[n_edges:] == tedge.PAD_SRC).all()


def test_pad_edges_and_stack_delta_blocks_bit_identical():
    rng = np.random.default_rng(3)
    n = 60
    lists = []
    for m in (5, 0, 130):
        lists.append((rng.integers(0, n, m).astype(np.int32),
                      rng.integers(0, n, m).astype(np.int32),
                      rng.random(m).astype(np.float32)))
    for a, b in zip(jedge.pad_edges(*lists[2], n, granule=64, pad_pow2=True),
                    tedge.pad_edges(*lists[2], n, granule=64, pad_pow2=True)):
        np.testing.assert_array_equal(a, b)
    bucket = tedge.lane_bucket(len(lists))
    jb = jedge.stack_delta_blocks(lists, n, granule=64, num_lanes=bucket)
    tb = tedge.stack_delta_blocks(lists, n, granule=64, num_lanes=bucket,
                                  device="cpu")
    _assert_block_equal(jb, tb)
    assert tuple(tb.src.shape) == (4, 256)


def test_edge_view_arrays_and_extended():
    blocks = [tedge.make_block(np.array([0, 1], np.int32),
                               np.array([1, 2], np.int32), None, 4,
                               granule=4, device="cpu") for _ in range(2)]
    view = tedge.EdgeView((blocks[0],), 4)
    assert view.arrays()[0] is blocks[0].src
    both = view.extended(blocks[1])
    assert both.n_padded == 8 and both.blocks[0] is blocks[0]
    assert tuple(both.arrays()[1].shape) == (8,)
    with pytest.raises(ValueError):
        tedge.concat_views(view, tedge.EdgeView((blocks[1],), 5))


# -- snapshot store ------------------------------------------------------------------


def test_store_windows_deltas_and_blocks_bit_identical(seqs):
    js, _ = seqs
    ts = interop.sequence_from_arrays(js.num_nodes, js.snapshot_keys,
                                      js.additions, js.deletions,
                                      js.weight_seed)
    jst = JStore(js, granule=256)
    tst = TStore(ts, granule=256, device="cpu")
    for i, j in ((0, 4), (1, 3), (2, 2)):
        np.testing.assert_array_equal(tst.window_keys(i, j),
                                      jst.window_keys(i, j))
        _assert_block_equal(jst.window_block(i, j), tst.window_block(i, j))
    _assert_block_equal(jst.delta_block((0, 4), (1, 3)),
                        tst.delta_block((0, 4), (1, 3)))
    _assert_block_equal(jst.addition_block(1), tst.addition_block(1))
    np.testing.assert_array_equal(tst.deletion_keys(2), jst.deletion_keys(2))
    for jb, tb in zip(jst.window_view_split(0, 4, 3).blocks,
                      tst.window_view_split(0, 4, 3).blocks):
        _assert_block_equal(jb, tb)
    hops = [((0, 4), (k, k)) for k in range(5)]
    bucket = tedge.lane_bucket(len(hops))
    _assert_block_equal(jst.delta_stack(hops, num_lanes=bucket),
                        tst.delta_stack(hops, num_lanes=bucket))
    assert tst.cached_nbytes == jst.cached_nbytes


def test_store_lru_pins_and_release_match_reference(seqs):
    js, ts = seqs
    budget = 40_000
    jst = JStore(js, granule=256, cache_bytes=budget)
    tst = TStore(ts, granule=256, cache_bytes=budget, device="cpu")
    for st in (jst, tst):
        st.window_block(0, 4)
        st.pin(("T", 0, 4))
        for k in range(5):
            st.window_block(k, k)
        st.delta_block((0, 4), (1, 1))
    assert tst.evictions == jst.evictions > 0
    assert tst.cached_nbytes == jst.cached_nbytes
    assert list(tst._blocks) == list(jst._blocks)
    assert tst.pin_count(("T", 0, 4)) == 1
    assert tst.release() == jst.release()
    assert list(tst._blocks) == [("T", 0, 4)]
    tst.unpin(("T", 0, 4))
    with pytest.raises(ValueError):
        tst.unpin(("T", 0, 4))


def test_store_anchor_state_family(seqs):
    _, ts = seqs
    st = TStore(ts, granule=256, device="cpu")
    state = interop.state_from_arrays(np.zeros(ts.num_nodes),
                                      np.full(ts.num_nodes, -1), "cpu")
    assert state.nbytes == ts.num_nodes * 8
    st.anchor_state_put(("q",), (0, 4), state)
    assert st.anchor_state_get(("q",), (0, 4)) is state
    cover = st.anchor_state_cover(("q",), (1, 3))
    assert cover is not None and cover[0] == (0, 4)
    assert st.anchor_state_cover(("q",), (0, 4)) is None
    assert st.release(("AS",)) == state.nbytes


def test_interop_block_and_sequence_validation():
    blk = interop.block_from_arrays(np.arange(4), np.arange(4) + 1,
                                    np.ones(4), "cpu")
    assert (blk.src.dtype, blk.dst.dtype, blk.w.dtype) == (
        torch.int32, torch.int32, torch.float32)
    with pytest.raises(ValueError, match="change batches"):
        interop.sequence_from_arrays(4, [np.arange(2)] * 3, [], [])


# -- import hygiene --------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and chip_smoke.py import with jax and repro
    blocked, and neither gets loaded."""
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    assert {"repro_torch.configs.base", "repro_torch.configs.commongraph",
            "repro_torch.graph.sampler", "repro_torch.models.transformer",
            "repro_torch.configs.lm_family",
            "repro_torch.configs.qwen3_moe_30b_a3b"} <= set(modules)
    script = f"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in {modules!r}:
    importlib.import_module(name)
sys.path.insert(0, {str(REPO)!r})
import chip_smoke
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not loaded, loaded
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")
    assert int(proc.stdout.split()[1]) >= 20


def test_roadmap_labels_cited_by_the_port_exist():
    """Every ``ROADMAP §…``/``ROADMAP A…`` label cited under
    ``src/repro_torch/`` still heads an item (``**A10.4 — …``) or a
    section (``### C. …``) of ROADMAP.md."""
    roadmap = (REPO / "ROADMAP.md").read_text()
    heads = set(re.findall(r"\*\*([A-C]\d+(?:\.\d+)*)\b", roadmap))
    sections = set(re.findall(r"^### ([A-C])\. ", roadmap, re.M))
    cited = {}
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for m in re.finditer(r"ROADMAP(?:\.md)?\s+(§?[A-C][\w./§]*)", text):
            for label in m.group(1).rstrip(".").split("/"):
                cited.setdefault(label.lstrip("§"), []).append(
                    path.relative_to(REPO).as_posix())
    assert {"A9", "A10.4"} <= set(cited)
    stale = {label: where for label, where in cited.items()
             if label not in (sections if len(label) == 1 else heads)}
    assert not stale, stale


def test_kernel_sources_export_every_bound_signature():
    """Every source under csrc/ is built, and each ctypes signature in
    ``_build.SIGNATURES`` names an ``extern "C"`` entry point of those
    sources with as many parameters (no compiler here checks it)."""
    from repro_torch.kernels import _build
    assert sorted(_build.SOURCES) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    text = "\n".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for name, argtypes in _build.SIGNATURES.items():
        found = re.search(rf"\bint {name}\(([^)]*)\)", text)
        assert found, name
        params = found.group(1).strip()
        count = 0 if params in ("", "void") else len(params.split(","))
        assert count == len(argtypes), name


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    """Without a card (this machine) or beside no checkout, chip_smoke
    exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, path in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        proc = subprocess.run([sys.executable, str(path)],
                              cwd=cwd, capture_output=True, text=True,
                              timeout=120,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
