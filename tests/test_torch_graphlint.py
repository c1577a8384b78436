"""The port's graphlint (src/repro_torch/analysis) against the JAX package's.

* Parity: on the same inputs the port's linter core (``Module``'s dotted
  names, ancestors and suppressions, ``find_root``, ``iter_python_files``,
  suppression handling in ``Linter``, ``render_human``/``render_json``)
  and its apidoc parsing give the reference's output.
* Rules carried over by name: the reference's own G002, G003, G005, G007,
  G008, G009 and G010 fixtures (tests/test_graphlint.py), module paths
  mapped from ``repro`` to ``repro_torch``, give the same ``(path, line,
  col)`` set under the T rule as under the G rule.
* Torch-idiom bad/good fixtures for every T rule: a bad one triggers only
  its rule, a good one is clean under all ten.
* The registry, the CLI, import hygiene, and the gate itself: the port's
  tree is clean under its own rules.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

import repro.analysis as ref
import repro.analysis.apidoc as ref_apidoc
import repro.analysis.linter as ref_linter
import repro_torch.analysis as port
import repro_torch.analysis.apidoc as port_apidoc
import repro_torch.analysis.linter as port_linter
import test_graphlint as g  # the reference's fixtures, reused as they are

REPO = pathlib.Path(__file__).resolve().parent.parent
CLI = REPO / "scripts" / "torch_invariant_lint.py"

API_TORCH_DOC = """# API reference

## `repro_torch.core.documented`

### `covered(x)`
Documented and docstringed.
"""

T_IDS = [f"T{i:03d}" for i in range(1, 11)]


def make_repo(tmp_path: pathlib.Path) -> pathlib.Path:
    """A rooted mini-repo holding both packages' layouts and API pages."""
    root = g.make_repo(tmp_path)
    (root / "docs" / "API_TORCH.md").write_text(API_TORCH_DOC)
    (root / "src" / "repro_torch").mkdir(parents=True)
    return root


def lint(root, code, relpath, rules=None, linter_mod=port):
    target = root / relpath
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(code)
    return linter_mod.Linter(rules=rules, root=root).lint([target])


def lint_snippet(tmp_path, code, relpath="src/repro_torch/mod.py",
                 rules=None):
    return lint(make_repo(tmp_path), code, relpath, rules)


def to_port(text: str) -> str:
    """Map a reference fixture's module paths and imports to the port's."""
    return (text.replace("repro.", "repro_torch.")
            .replace("src/repro/", "src/repro_torch/"))


# -- parity: the linter core -------------------------------------------------

SUPPRESSIONS = """\
x = 1  # graphlint: disable=G004
y = 2  # graphlint: disable=T004, T007
z = 3  #graphlint:disable=ALL
# graphlint: disable-file=G008,G010
# graphlint: disable-file=T009
w = 4  # graphlint: disable=lowercase
"""

NESTED = """\
def outer(a):
    def inner(b):
        return (lambda c: c + b)(a)
    return inner

class K:
    def method(self):
        return [i for i in range(3)]
"""


@pytest.mark.parametrize("relpath", [
    "src/repro_torch/core/thing.py", "src/repro/core/thing.py",
    "src/repro_torch/analysis/__init__.py", "benchmarks/bench.py",
    "scripts/tool.py", "src/a/src/repro_torch/x.py"])
def test_module_paths_and_suppressions_match_reference(tmp_path, relpath):
    root = make_repo(tmp_path)
    path = root / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(SUPPRESSIONS)
    for r in (root, None):
        mine = port_linter.Module(path, SUPPRESSIONS, r)
        want = ref_linter.Module(path, SUPPRESSIONS, r)
        assert mine.dotted_name() == want.dotted_name()
        assert mine.rel == want.rel
        assert mine.line_disables == want.line_disables
        assert mine.file_disables == want.file_disables
        for rule in ("G004", "T004", "T007", "T009", "G010", "X"):
            for line in range(1, 8):
                assert mine.suppressed(rule, line) == \
                    want.suppressed(rule, line)


def _node_key(node):
    return None if node is None else (type(node).__name__,
                                      getattr(node, "lineno", 0),
                                      getattr(node, "col_offset", 0))


def test_ancestors_and_ast_helpers_match_reference(tmp_path):
    path = tmp_path / "nested.py"
    mine = port_linter.Module(path, NESTED)
    want = ref_linter.Module(path, NESTED)
    pairs = list(zip(ast.walk(mine.tree), ast.walk(want.tree)))
    assert len(pairs) > 30
    for a, b in pairs:
        assert _node_key(a) == _node_key(b)
        assert [_node_key(n) for n in mine.function_ancestors(a)] == \
            [_node_key(n) for n in want.function_ancestors(b)]
        assert _node_key(mine.enclosing_function(a)) == \
            _node_key(want.enclosing_function(b))
        assert _node_key(mine.parent(a)) == _node_key(want.parent(b))
        if isinstance(a, ast.Call):
            assert port_linter.call_name(a) == ref_linter.call_name(b)
            assert port_linter.get_keyword(a, "x") is None
    assert port_linter.defined_function_names(mine.tree) == \
        ref_linter.defined_function_names(want.tree) == \
        {"outer", "inner", "method"}
    for name in ("range", "inner"):
        assert [_node_key(c) for c in port_linter.calls_named(mine.tree,
                                                              name)] == \
            [_node_key(c) for c in ref_linter.calls_named(want.tree, name)]


def test_find_root_and_file_listing_match_reference(tmp_path):
    (tmp_path / "marked").mkdir()
    marked = make_repo(tmp_path / "marked")
    doc_only = tmp_path / "doc_only"
    (doc_only / "docs").mkdir(parents=True)
    (doc_only / "docs" / "API.md").write_text("# x\n")
    bare = tmp_path / "bare" / "deep"
    bare.mkdir(parents=True)
    tree = marked / "src" / "repro_torch"
    for rel in ("a.py", "sub/b.py", "sub/__pycache__/c.py", "sub/deeper/.git/d.py",
                "node_modules/e.py", "notes.txt", "sub/deeper/f.py"):
        f = tree / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text("x = 1\n")
    for p in (tree / "a.py", tree / "sub", doc_only / "docs" / "API.md",
              doc_only, bare):
        assert port_linter.find_root(p) == ref_linter.find_root(p)
    assert port_linter.find_root(tree / "a.py") == marked.resolve()
    inputs = [tree, tree / "a.py", tree / "notes.txt", tree / "sub"]
    assert port_linter.iter_python_files(inputs) == \
        ref_linter.iter_python_files(inputs)
    assert [p.name for p in port_linter.iter_python_files([tree])] == \
        ["a.py", "b.py", "f.py"]


def _every_call_rule(linter_mod, rule_id, doc_line):
    """A rule flagging every call, plus one finding against a doc page."""

    class EveryCall(linter_mod.Rule):
        id = rule_id
        title = "every call"

        def check(self, module):
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Call):
                    yield self.finding(module, node,
                                       f"call {linter_mod.call_name(node)}")
            yield self.finding(module, module.tree, "doc entry",
                               path="docs/API.md", line=doc_line)

    return EveryCall()


CALLS = """\
a = f(1)
b = g(2)  # graphlint: disable=X001
c = h(3)  # graphlint: disable=ALL
d = k(f(4))  # graphlint: disable=X002
"""


def test_linter_applies_suppressions_like_reference(tmp_path):
    root = make_repo(tmp_path)
    out = {}
    for name, mod in (("port", port_linter), ("ref", ref_linter)):
        linter = mod.Linter(rules=[_every_call_rule(mod, "X001", 2)],
                            root=root)
        target = root / "src" / "repro_torch" / "calls.py"
        target.write_text(CALLS)
        findings = linter.lint([target, target.parent])
        out[name] = [(f.path, f.line, f.col, f.rule, f.message)
                     for f in findings]
        assert linter.files_checked == 1   # the file and its directory
    assert out["port"] == out["ref"]
    # a finding against another file is not silenced by line 2's comment
    assert ("docs/API.md", 2, 0, "X001", "doc entry") in out["port"]
    assert [f[1] for f in out["port"] if f[0] != "docs/API.md"] == [1, 4, 4]


@pytest.mark.parametrize("n", [0, 1, 3])
def test_render_matches_reference(n):
    rows = [("src/repro_torch/b.py", 3, 4, "T004", "msg b"),
            ("src/repro_torch/a.py", 9, 0, "T010", "msg a"),
            ("docs/API_TORCH.md", 1, 0, "T006", "stale")][:n]
    mine = sorted(port_linter.Finding(*r) for r in rows)
    want = sorted(ref_linter.Finding(*r) for r in rows)
    for files in (0, 7):
        assert port.render_human(mine, files) == ref.render_human(want,
                                                                  files)
        assert port.render_json(mine, files) == ref.render_json(want, files)
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in want]


# -- parity: apidoc ----------------------------------------------------------

def test_parse_api_doc_matches_reference():
    path = REPO / "docs" / "API.md"
    got = port_apidoc.parse_api_doc(path)
    assert got == ref_apidoc.parse_api_doc(path)
    assert len(got) == 10 and all(m.startswith("repro.") for m in got)


def test_public_surface_matches_reference_on_every_port_module():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 60
    for f in files:
        tree = ast.parse(f.read_text(encoding="utf-8"))
        mine = port_apidoc.public_surface(tree)
        want = ref_apidoc.public_surface(tree)
        assert {k: v.lineno for k, v in mine.items()} == \
            {k: v.lineno for k, v in want.items()}, f


def test_api_torch_page_mirrors_api_md():
    """docs/API_TORCH.md: the ten sections of docs/API.md under the port's
    names, every reference entry mirrored, 144 entries, each naming a
    public name of its module."""
    mine = port_apidoc.parse_api_doc(REPO / "docs" / "API_TORCH.md")
    want = ref_apidoc.parse_api_doc(REPO / "docs" / "API.md")
    assert sorted(mine) == sorted(to_port(m) for m in want)
    assert sum(len(e) for e in mine.values()) == 144
    port_only = {}
    for module, entries in mine.items():
        ref_entries = want[module.replace("repro_torch.", "repro.", 1)]
        assert set(ref_entries) <= set(entries), module
        extra = sorted(set(entries) - set(ref_entries))
        if extra:
            port_only[module] = extra
        src = REPO / "src" / pathlib.Path(*module.split(".")).with_suffix(
            ".py")
        surface = port_apidoc.public_surface(ast.parse(src.read_text()))
        assert set(entries) == set(surface), module
    assert port_only == {
        "repro_torch.core.snapshots": ["SnapshotStore.replicas"],
        "repro_torch.graph.engine": ["LaneShard", "ShardedResult",
                                     "ShardedResult.rows",
                                     "incremental_additions_resident",
                                     "incremental_additions_sharded"],
        "repro_torch.kernels.edge_relax_multi.ref": ["lane_edges"]}


# -- rules carried over by name ----------------------------------------------

CARRIED = [
    # (G rule, fixture, path in the reference's layout, findings there, as
    # tests/test_graphlint.py counts them)
    ("G002", g.BAD_G002, "src/repro/mod.py", 3),
    ("G002", g.GOOD_G002, "src/repro/mod.py", 0),
    ("G002", "from repro.graph.edgeset import stack_delta_blocks\n"
             "def f(lanes, n):\n"
             "    return stack_delta_blocks(lanes, n)\n",
     "src/repro/mod.py", 1),
    ("G003", g.BAD_G003, "src/repro/mod.py", 2),
    ("G003", g.GOOD_G003, "src/repro/mod.py", 0),
    ("G003", "class SnapshotStore:\n"
             "    '''The canonical tag module.'''\n"
             "    def anchor_state_get(self, qkey, window):\n"
             "        '''doc'''\n"
             "        return self._cache_get(('AS', qkey, tuple(window)))\n",
     "src/repro/mod.py", 0),
    ("G005", g.BAD_G005, "src/repro/mod.py", 3),
    ("G005", g.GOOD_G005, "src/repro/mod.py", 0),
    ("G007", g.BAD_G007, "src/repro/core/service.py", 2),
    ("G007", g.GOOD_G007, "src/repro/core/service.py", 0),
    ("G007", g.BAD_G007, "src/repro/core/scheduler.py", 0),
    ("G007", "def poll(engine, res):\n"
             "    engine.host_sync(res.values)\n",
     "src/repro/launch/service.py", 1),
    ("G008", g.BAD_G008, "src/repro/core/executor.py", 1),
    ("G008", g.GOOD_G008, "src/repro/core/executor.py", 0),
    ("G008", g.BAD_G008, "src/repro/graph/stability.py", 0),
    ("G008", "def relax_sweep(semiring, n, values, parent, frontier, "
             "blocks):\n"
             "    '''the sweep primitive itself'''\n"
             "    return values\n"
             "def _fixpoint(semiring, n, values, parent, frontier, blocks):\n"
             "    def body(carry):\n"
             "        return relax_sweep(semiring, n, *carry, blocks)\n"
             "    return body\n"
             "def rogue_seed(semiring, n, values, parent, frontier, "
             "blocks):\n"
             "    return relax_sweep(semiring, n, values, parent, frontier,\n"
             "                       blocks)\n",
     "src/repro/graph/engine.py", 1),
    ("G009", g.BAD_G009, "src/repro/launch/firehose.py", 3),
    ("G009", g.GOOD_G009, "src/repro/launch/firehose.py", 0),
    ("G009", "import numpy as np\n"
             "class Watermark:\n"
             "    '''doc'''\n"
             "    def cut(self):\n"
             "        '''doc'''\n"
             "        return self.store.ingest_cut(self.k, self.a, self.d)\n"
             "    def shortcut(self):\n"
             "        '''doc'''\n"
             "        return self.store.ingest_cut(self.k, self.a, self.d)\n",
     "src/repro/core/ingest.py", 1),
    ("G009", "class SnapshotStore:\n"
             "    '''the canonical store module'''\n"
             "    def ingest_cut(self, keys, added, deleted):\n"
             "        '''doc'''\n"
             "        self._t[(0, 0)] = keys\n"
             "        return 0\n",
     "src/repro/core/snapshots.py", 0),
    ("G010", g.BAD_G010, "src/repro/core/executor.py", 2),
    ("G010", g.GOOD_G010, "src/repro/core/executor.py", 0),
    ("G010", "from repro.graph.engine import relax_sweep_fused\n"
             "def seed_state(semiring, n, values, parent, frontier, "
             "blocks):\n"
             "    return relax_sweep_fused(semiring, n, values, parent,\n"
             "                             frontier, blocks, k=1)\n",
     "src/repro/graph/stability.py", 0),
    ("G010", "def relax_sweep_fused(semiring, n, values, parent, frontier,\n"
             "                      blocks, k=1):\n"
             "    '''the fused chunk primitive itself'''\n"
             "    return values\n"
             "def _fixpoint(semiring, n, values, parent, frontier, blocks,\n"
             "              fused_k=1):\n"
             "    def chunk(carry):\n"
             "        return relax_sweep_fused(semiring, n, *carry, blocks,\n"
             "                                 k=fused_k)\n"
             "    return chunk\n"
             "def rogue(semiring, n, values, parent, frontier, blocks):\n"
             "    return relax_sweep_fused(semiring, n, values, parent,\n"
             "                             frontier, blocks, k=2)\n",
     "src/repro/graph/engine.py", 1),
    ("G010", "def run_to_fixpoint(view, semiring, source, fused_k=1):\n"
             "    '''doc'''\n"
             "    return _fixpoint_jit(view, semiring, source, fused_k=1)\n",
     "src/repro/graph/engine.py", 0),
]


@pytest.mark.parametrize("gid,code,relpath,count", CARRIED,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CARRIED)])
def test_rule_carried_over_by_name(tmp_path, gid, code, relpath, count):
    """The T rule on the port's layout finds exactly what the G rule finds
    on the reference's, at the same lines and columns."""
    tid = "T" + gid[1:]
    root = make_repo(tmp_path)
    want = lint(root, code, relpath, [ref.get_rule(gid)], linter_mod=ref)
    got = lint(root, to_port(code), to_port(relpath), [port.get_rule(tid)])
    assert {(to_port(f.path), f.line, f.col) for f in want} == \
        {(f.path, f.line, f.col) for f in got}
    assert {f.rule for f in got} <= {tid}
    assert len(got) == count


# -- torch-idiom fixtures, one bad/good pair (or more) per rule --------------

def assert_only_rule(findings, rule_id, count):
    """The bad fixture discipline: found, and nothing but this rule."""
    assert {f.rule for f in findings} == {rule_id}, findings
    assert len(findings) == count, findings


BAD_T001 = """\
import ctypes
import subprocess
import torch
from torch.utils.cpp_extension import load_inline

def bind(path):
    return ctypes.CDLL(path)

def bind_again(path):
    return ctypes.cdll.LoadLibrary(path)

def ops(path):
    torch.ops.load_library(path)

def jit_ext(src):
    return torch.utils.cpp_extension.load(name="k", sources=[src])

def compile_it(src, out):
    subprocess.run(["nvcc", "-shared", "-o", out, src], check=True)
"""

TRITON_KERNEL = """\
import triton
import triton.language as tl

@triton.jit
def scale(x_ptr, n, BLOCK: tl.constexpr):
    pass
"""

GOOD_T001 = """\
from repro_torch.kernels import _build

def lib():
    return _build.load_library()

def run_tool(cmd):
    import subprocess
    return subprocess.run(["nvidia-smi", "-L"], check=True)
"""


def test_t001_bad(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T001,
                            relpath="src/repro_torch/core/sneaky.py")
    # the import, CDLL, cdll.LoadLibrary, ops.load_library,
    # cpp_extension.load and the nvcc subprocess
    assert_only_rule(findings, "T001", count=6)


def test_t001_triton_kernel_outside_kernels(tmp_path):
    findings = lint_snippet(tmp_path, TRITON_KERNEL,
                            relpath="src/repro_torch/models/fast.py")
    assert_only_rule(findings, "T001", count=1)
    assert "triton" in findings[0].message


def test_t001_good(tmp_path):
    root = make_repo(tmp_path)
    assert lint(root, GOOD_T001, "src/repro_torch/core/fine.py") == []
    assert lint(root, TRITON_KERNEL,
                "src/repro_torch/kernels/scale/scale.py") == []
    # the one sanctioned home of every load and build
    assert lint(root, BAD_T001, "src/repro_torch/kernels/_build.py") == []


def test_t001_kernel_packages_still_load_through_build(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T001,
                            relpath="src/repro_torch/kernels/relax/ops.py")
    assert_only_rule(findings, "T001", count=6)


BAD_T002 = """\
from repro_torch.graph.engine import incremental_additions_batched

def stack_exact(store, hops):
    return store.delta_stack(hops, num_lanes=len(hops))

def launch_unbucketed(n, sr, values, parent, shared, stacked):
    return incremental_additions_batched(n, sr, values, parent, shared,
                                         stacked)
"""

GOOD_T002 = """\
from repro_torch.graph.edgeset import lane_bucket
from repro_torch.graph.engine import incremental_additions_batched

def stack_bucketed(store, hops, mesh):
    data_extent = mesh.shape["data"] if mesh is not None else 1
    bucket = lane_bucket(len(hops), data_extent)
    return store.delta_stack(hops, num_lanes=bucket)

def launch(n, sr, values, parent, shared, hops, store):
    bucket = lane_bucket(len(hops))
    stacked = store.delta_stack(hops, num_lanes=bucket)
    return incremental_additions_batched(n, sr, values, parent, shared,
                                         (stacked,))
"""


def test_t002_bad(tmp_path):
    assert_only_rule(lint_snippet(tmp_path, BAD_T002), "T002", count=2)


def test_t002_good(tmp_path):
    assert lint_snippet(tmp_path, GOOD_T002) == []


BAD_T003 = """\
def hold(store, qkey, window):
    store.pin(("AS", qkey, tuple(window)))

def peek(store, i, j):
    return store._cache_put(("T", i, j), None)

def fetch(store, keys, i):
    return store.block_for_keys(keys, f"D{i}")
"""

GOOD_T003 = """\
from repro_torch.core.snapshots import anchor_tag

def hold(store, qkey, window):
    store.pin(anchor_tag(qkey, window))
"""


def test_t003_bad(tmp_path):
    assert_only_rule(lint_snippet(tmp_path, BAD_T003), "T003", count=3)


def test_t003_good(tmp_path):
    assert lint_snippet(tmp_path, GOOD_T003) == []


BAD_T004_HOT = """\
import numpy as np
import torch

def _count(frontier):
    return frontier.sum().item()

def relax_sweep_fused(semiring, n, values, parent, frontier, blocks, k=1):
    if _count(frontier) == 0:
        return values
    torch.cuda.synchronize()
    host = values.cpu()
    rows = values.tolist()
    arr = values.numpy()
    return np.asarray(host)

@torch.compile
def fused_gate(x):
    return x.sum().item()

def _scan(x):
    return x.tolist()

scan = torch.jit.script(_scan)
traced = torch.jit.trace(lambda y: y.cpu(), (torch.zeros(1),))
"""

BAD_T004_BARE = """\
import time
import torch

def timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0
"""

GOOD_T004 = """\
import time
import numpy as np
import torch

def host_sync(x):
    '''the sanctioned sync point'''
    torch.cuda.synchronize(x.device)
    return x

def relax_sweep(semiring, n, values, parent, frontier, blocks):
    return values + 1, parent, frontier, values.new_zeros(())

def timed(fn):
    t0 = time.perf_counter()
    out = host_sync(fn())
    return out, time.perf_counter() - t0

def report(result):
    # not reachable from the hot path: host reads are fine here
    return np.asarray(result.values.cpu()), result.iterations.tolist()
"""


def test_t004_hot_path(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T004_HOT)
    # _count's .item() (a callee of the seed), the seed's synchronize,
    # .cpu(), .tolist(), .numpy() and np.asarray, the compiled def's
    # .item(), the scripted def's .tolist(), the traced lambda's .cpu()
    assert_only_rule(findings, "T004", count=9)
    assert all("hot-path" in f.message for f in findings)


def test_t004_bare_sync(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T004_BARE)
    assert_only_rule(findings, "T004", count=1)
    assert "host_sync" in findings[0].message


def test_t004_good(tmp_path):
    assert lint_snippet(tmp_path, GOOD_T004) == []


@pytest.mark.parametrize("relpath", ["benchmarks/bench_thing.py",
                                     "scripts/torch_thing_bench.py"])
def test_t004_timing_dirs_allowlisted(tmp_path, relpath):
    assert lint_snippet(tmp_path, BAD_T004_BARE, relpath=relpath) == []


BAD_T005 = """\
import torch
from repro_torch.graph.semiring import Semiring

SSSP = Semiring(name="sssp", reduce="min", identity=float("inf"),
                source_value=0.0, combine=lambda v, w: v + w)
PARTIAL = Semiring(name="oops", reduce="min")
SOFTMIN = Semiring(name="soft", reduce="softmin", identity=0.0,
                   source_value=0.0, combine=lambda v, w: torch.minimum(v, w))
POSITIONAL = Semiring("p", "min", 0.0, 0.0, lambda v, w: v)

ALL_SEMIRINGS = {s.name: s for s in (SSSP, PARTIAL, POSITIONAL)}
"""

GOOD_T005 = """\
import torch
from repro_torch.graph.semiring import Semiring

SSWP = Semiring(name="sswp", reduce="max", identity=-float("inf"),
                source_value=float("inf"),
                combine=lambda v, w: torch.minimum(v, w))
SSNP = Semiring(name="ssnp", reduce="min", identity=float("inf"),
                source_value=-float("inf"),
                combine=lambda v, w: torch.maximum(v, w))

ALL_SEMIRINGS: dict = {s.name: s for s in (SSWP, SSNP)}
"""


def test_t005_bad(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T005)
    # PARTIAL's missing fields; SOFTMIN's reduce and its absence from the
    # registry; POSITIONAL's positional arguments and missing keywords
    assert_only_rule(findings, "T005", count=5)


def test_t005_good(tmp_path):
    assert lint_snippet(tmp_path, GOOD_T005) == []


def test_t006_bad(tmp_path):
    findings = lint_snippet(tmp_path, g.BAD_G006,
                            relpath="src/repro_torch/core/documented.py")
    assert_only_rule(findings, "T006", count=2)
    messages = " | ".join(f.message for f in findings)
    assert "no docstring" in messages and "undocumented" in messages
    assert "docs/API_TORCH.md" in messages


def test_t006_good(tmp_path):
    assert lint_snippet(tmp_path, g.GOOD_G006,
                        relpath="src/repro_torch/core/documented.py") == []


def test_t006_stale_entry_flagged_in_api_torch_md(tmp_path):
    findings = lint_snippet(tmp_path, "def other(x):\n    '''doc'''\n",
                            relpath="src/repro_torch/core/documented.py",
                            rules=[port.get_rule("T006")])
    stale = [f for f in findings if "stale" in f.message]
    assert len(stale) == 1 and stale[0].path == "docs/API_TORCH.md"
    assert stale[0].line == 5


def test_t006_reads_only_the_port_page(tmp_path):
    # docs/API.md's repro.core.documented section binds the reference's
    # module, not the port's; an undocumented port module is out of scope
    root = make_repo(tmp_path)
    assert lint(root, g.BAD_G006, "src/repro/core/documented.py",
                [port.get_rule("T006")]) == []
    assert lint(root, "def undocumented(x):\n    return x\n",
                "src/repro_torch/core/elsewhere.py",
                [port.get_rule("T006")]) == []


BAD_T007 = """\
import torch
from repro_torch.graph.engine import host_sync

def schedule_turn(service, pending):
    for query in pending:
        res = service.launch_one(query)
        host_sync(res.values)
        service.work.append(res.edge_work.tolist())
        service.iters.append(res.iterations.cpu())
    return service
"""

GOOD_T007 = """\
from repro_torch.graph.engine import host_sync

def _packed_launch(store, windows, states):
    '''One packed launch; the campaign-boundary sync lives here.'''
    res = store.run(windows, states)
    host_sync(res.values)
    return res, res.iterations.tolist()

def schedule_turn(service, launches):
    return [_packed_launch(service.store, w, s) for (w, s) in launches]
"""


def test_t007_bad(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T007,
                            relpath="src/repro_torch/core/service.py")
    assert_only_rule(findings, "T007", count=3)
    assert all("_launch" in f.message for f in findings)


def test_t007_flags_a_device_wide_sync_too(tmp_path):
    code = ("import torch\n"
            "def account(results):\n"
            "    torch.cuda.synchronize()\n"
            "    return results\n")
    root = make_repo(tmp_path)
    t007 = [port.get_rule("T007")]
    findings = lint(root, code, "src/repro_torch/core/service.py", t007)
    assert_only_rule(findings, "T007", count=1)
    assert lint(root, code, "src/repro_torch/core/scheduler.py", t007) == []


def test_t007_good(tmp_path):
    assert lint_snippet(tmp_path, GOOD_T007,
                        relpath="src/repro_torch/core/service.py") == []


BAD_T008 = """\
import torch
from repro_torch.graph.engine import relax_sweep

def seed_from_raw_delta(semiring, n, values, parent, delta_blocks):
    frontier = torch.ones_like(values, dtype=torch.bool)
    return relax_sweep(semiring, n, values, parent, frontier, delta_blocks)
"""


def test_t008_bad(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T008,
                            relpath="src/repro_torch/core/executor.py")
    assert_only_rule(findings, "T008", count=1)
    assert "seed_state" in findings[0].message


def test_t008_good(tmp_path):
    root = make_repo(tmp_path)
    assert lint(root, to_port(g.GOOD_G008),
                "src/repro_torch/core/executor.py") == []
    assert lint(root, BAD_T008, "src/repro_torch/graph/stability.py") == []


ENGINE = """\
def relax_sweep(semiring, n, values, parent, frontier, blocks):
    '''the k = 1 chunk'''
    return relax_sweep_fused(semiring, n, values, parent, frontier, blocks,
                             k=1)

def relax_sweep_fused(semiring, n, values, parent, frontier, blocks, k=1):
    '''the fused chunk primitive'''
    return values

def _fixpoint_shards(semiring, n, shards, fused_k=1):
    for values, parent, frontier, blocks in shards:
        relax_sweep_fused(semiring, n, values, parent, frontier, blocks,
                          k=fused_k)
        relax_sweep(semiring, n, values, parent, frontier, blocks)

def _fixpoint(semiring, n, values, parent, frontier, blocks, fused_k=1):
    return _fixpoint_shards(semiring, n, [(values, parent, frontier,
                                           blocks)], fused_k=1)

def rogue(semiring, n, values, parent, frontier, blocks):
    relax_sweep(semiring, n, values, parent, frontier, blocks)
    return relax_sweep_fused(semiring, n, values, parent, frontier, blocks,
                             k=4)
"""


def test_t008_t010_engine_sanctions_the_ports_fixpoint(tmp_path):
    findings = lint_snippet(tmp_path, ENGINE,
                            relpath="src/repro_torch/graph/engine.py")
    # only rogue's two calls; relax_sweep's k=1 chunk, _fixpoint_shards'
    # chunks and _fixpoint's literal fused_k= are the engine's own
    assert sorted((f.rule, f.line) for f in findings) == \
        [("T008", 21), ("T010", 22)]


BAD_T009 = """\
import numpy as np

def sneak_snapshot(store, keys):
    store.ingest_cut(keys, np.empty(0, np.int64), np.empty(0, np.int64))

def grow_directly(seq, keys):
    seq.snapshot_keys.append(keys)
    seq.deletions.append(keys[:0])

def plant_block(store, tag, block):
    store._blocks[tag] = block
"""


def test_t009_bad(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T009,
                            relpath="src/repro_torch/launch/firehose.py")
    assert_only_rule(findings, "T009", count=4)


def test_t009_good(tmp_path):
    root = make_repo(tmp_path)
    assert lint(root, g.GOOD_G009, "src/repro_torch/launch/firehose.py") == []
    # the ingest module owns the appends (LiveSequence.append)
    assert lint(root, "def append(self, keys):\n"
                      "    self.snapshot_keys.append(keys)\n",
                "src/repro_torch/core/ingest.py") == []


BAD_T010 = """\
from repro_torch.graph.engine import relax_sweep_fused, run_to_fixpoint

def hand_rolled_chunk(sr, n, values, parent, frontier, blocks):
    return relax_sweep_fused(sr, n, values, parent, frontier, blocks, k=8)

def hardcoded_knob(view, sr, source):
    return run_to_fixpoint(view, sr, source, fused_k=8)
"""


def test_t010_bad(tmp_path):
    findings = lint_snippet(tmp_path, BAD_T010,
                            relpath="src/repro_torch/core/executor.py")
    assert_only_rule(findings, "T010", count=2)
    assert "fused_k=8" in " | ".join(f.message for f in findings)


def test_t010_good(tmp_path):
    assert lint_snippet(tmp_path, to_port(g.GOOD_G010),
                        relpath="src/repro_torch/core/executor.py") == []


# -- suppressions --------------------------------------------------------------

HEADED = """\
# graphlint: disable-file=G008,G010
from repro_torch.graph.engine import relax_sweep, relax_sweep_fused

def seed(sr, n, values, parent, frontier, blocks):
    relax_sweep(sr, n, values, parent, frontier, blocks)
    return relax_sweep_fused(sr, n, values, parent, frontier, blocks, k=2)
"""


def test_reference_headers_do_not_silence_port_rules(tmp_path):
    root = make_repo(tmp_path)
    got = lint(root, HEADED, "src/repro_torch/core/executor.py")
    assert sorted(f.rule for f in got) == ["T008", "T010"]
    # ... while they do silence the reference's rules on the same file
    assert lint(root, HEADED.replace("repro_torch.", "repro."),
                "src/repro/core/executor.py", linter_mod=ref) == []
    assert lint(root, HEADED.replace("G008,G010", "T008,T010"),
                "src/repro_torch/core/executor.py") == []


def test_line_suppression_is_per_rule(tmp_path):
    line = "    torch.cuda.synchronize(device)"
    root = make_repo(tmp_path)
    for comment, expected in (("  # graphlint: disable=T004", 0),
                              ("  # graphlint: disable=G004", 1),
                              ("  # graphlint: disable=ALL", 0)):
        code = BAD_T004_BARE.replace(line, line + comment)
        assert len(lint(root, code, "src/repro_torch/m.py")) == expected


# -- registry, CLI, import hygiene --------------------------------------------

def test_rule_registry_complete_and_apart_from_the_reference():
    assert [r.id for r in port.all_rules()] == T_IDS
    assert [r.id for r in ref.all_rules()] == \
        [f"G{i:03d}" for i in range(1, 11)]
    for rule in port.all_rules():
        assert rule.title and rule.contract
        assert "repro_torch" in rule.contract or "port" in rule.contract
    for missing in ("T999", "G001"):
        with pytest.raises(KeyError):
            port.get_rule(missing)


def _cli(*args):
    return subprocess.run([sys.executable, str(CLI), *map(str, args)],
                          capture_output=True, text=True, timeout=120)


def test_cli_exit_codes_and_json(tmp_path):
    root = make_repo(tmp_path)
    bad = root / "src" / "repro_torch" / "bad.py"
    bad.write_text(BAD_T004_BARE)
    proc = _cli("--format", "json", bad)
    assert proc.returncode == 1, proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["version"] == 1 and payload["files_checked"] == 1
    assert payload["count"] == 1 and payload["findings"][0]["rule"] == "T004"
    assert set(payload["findings"][0]) == \
        {"rule", "path", "line", "col", "message"}
    proc = _cli("--select", "T001,T007", bad)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "graphlint: 1 files clean"
    assert _cli("--select", "G004", bad).returncode == 2


def test_cli_lists_rules_and_lints_the_port_by_default():
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    heads = [ln.split()[0] for ln in listed.stdout.splitlines()
             if ln[:1] == "T"]
    assert heads == T_IDS
    proc = _cli("--format", "json")
    assert proc.returncode == 0, proc.stdout
    payload = json.loads(proc.stdout)
    assert payload["count"] == 0 and payload["files_checked"] > 60


def test_importing_the_port_linter_loads_no_framework():
    script = ("import sys\n"
              "import repro_torch.analysis as a\n"
              "a.Linter().lint([])\n"
              "bad = [m for m in sys.modules\n"
              "       if m.split('.')[0] in ('torch', 'jax', 'jaxlib',"
              " 'repro', 'numpy')]\n"
              "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# -- the gate itself: the port is clean under its own rules -------------------

def test_torch_graphlint_clean_on_port():
    linter = port.Linter(root=REPO)
    findings = linter.lint([REPO / "src" / "repro_torch"])
    assert findings == [], "\n".join(f.render() for f in findings)
    assert linter.files_checked > 60


def test_port_suppresses_no_t_rule_file_wide_and_keeps_g_headers():
    headers = {}
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        module = port_linter.Module(path, path.read_text(encoding="utf-8"))
        assert not {r for r in module.file_disables if r.startswith("T")}, \
            path
        if module.file_disables:
            headers[path.relative_to(REPO).as_posix()] = \
                module.file_disables
    assert headers == {
        "src/repro_torch/graph/engine.py": {"G008", "G010"},
        "src/repro_torch/graph/stability.py": {"G008", "G010"},
        "src/repro_torch/core/ingest.py": {"G009"}}
