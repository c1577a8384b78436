"""Rules T001–T005, T007–T010: the port's launch/cache/sync/seeding
invariants (counterparts of ``repro.analysis.rules`` G001–G005, G007–G010).

Each rule holds one contract the port's module docstrings state in prose
(kernels/_build.py, core/trigrid.py, core/snapshots.py, core/window.py,
core/service.py, core/ingest.py, graph/engine.py, graph/semiring.py,
graph/stability.py), keyed on ``repro_torch`` module names and on the
port's idiom: CUDA libraries loaded with ``ctypes``, host syncs through
``torch.cuda.synchronize``/``.tolist()``/``.cpu()``, ``torch.compile`` in
place of ``jax.jit``. docs/ANALYSIS_TORCH.md is the catalog, with a bad
and a good example from the port's own code for each rule. Rules are
static and name-based: they resolve callees by their rightmost name within
one module, as the reference's do. Escape hatch for a deliberate
exception: ``# graphlint: disable=TNNN`` on the offending line, with a
comment saying why.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.linter import (
    Finding,
    Module,
    Rule,
    call_name,
    calls_named,
    defined_function_names,
    dotted,
    get_keyword,
    names_any,
    register,
)

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _inside_def_named(module: Module, node: ast.AST, names) -> bool:
    """Whether a def whose name is in ``names`` encloses ``node``."""
    return any(isinstance(fn, _DEFS) and fn.name in names
               for fn in module.function_ancestors(node))


def _is_sync_method(node: ast.Call, methods) -> bool:
    """``x.item()``-style call: an argument-less method in ``methods``."""
    return (isinstance(node.func, ast.Attribute) and not node.args
            and not node.keywords and node.func.attr in methods)


@register
class CudaLibraryLocation(Rule):
    """T001: CUDA libraries are built and loaded only by kernels/_build.py."""

    id = "T001"
    title = "CUDA library loaded or built outside kernels/_build.py"
    contract = (
        "The port's kernels are CUDA C++ under src/repro_torch/kernels/"
        "csrc, compiled by one nvcc per source into one plain-C library "
        "whose file name hashes the sources and flags, and bound with "
        "ctypes — all in repro_torch/kernels/_build.py, which every "
        "kernel wrapper (<name>/ops.py) reaches through load_library(). "
        "A ctypes.CDLL / ctypes.cdll.LoadLibrary, torch.ops.load_library, "
        "torch.utils.cpp_extension.load/load_inline or a subprocess that "
        "runs nvcc anywhere else builds or binds a second library that the "
        "hash, the flags (sm_90a, no fast math, no FMA contraction) and the "
        "bound signatures do not cover. A Triton kernel (@triton.jit) "
        "lives under repro_torch/kernels/ beside its plain version."
    )

    BUILD_MODULE = "repro_torch.kernels._build"
    KERNELS_PACKAGE = "repro_torch.kernels"
    #: Call targets (dotted suffixes) that load or build a native library.
    LOADERS = ("CDLL", "cdll.LoadLibrary", "ops.load_library",
               "cpp_extension.load", "cpp_extension.load_inline")
    CPP_EXTENSION = "torch.utils.cpp_extension"
    CPP_LOADERS = ("load", "load_inline")
    SUBPROCESS = ("subprocess.run", "subprocess.Popen", "subprocess.call",
                  "subprocess.check_call", "subprocess.check_output",
                  "os.system")
    COMPILER = "nvcc"
    TRITON_JIT = ("triton.jit",)

    def check(self, module: Module) -> Iterator[Finding]:
        dotted_name = module.dotted_name()
        in_kernels = (dotted_name == self.KERNELS_PACKAGE
                      or dotted_name.startswith(self.KERNELS_PACKAGE + "."))
        if not in_kernels:
            for node in ast.walk(module.tree):
                if isinstance(node, _DEFS) and any(
                        names_any(d.func if isinstance(d, ast.Call) else d,
                                  self.TRITON_JIT)
                        for d in node.decorator_list):
                    yield self.finding(
                        module, node,
                        f"@triton.jit kernel {node.name} outside "
                        "src/repro_torch/kernels/ — kernels ship as "
                        "<name>/<name>.py + ops.py + ref.py (the plain "
                        "version the CPU runs)")
        if dotted_name == self.BUILD_MODULE:
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) \
                    and node.module == self.CPP_EXTENSION:
                for alias in node.names:
                    if alias.name in self.CPP_LOADERS:
                        yield self.finding(
                            module, node,
                            f"importing cpp_extension.{alias.name} outside "
                            "kernels/_build.py — the port builds its "
                            "kernels in one place, with one set of flags")
            if not isinstance(node, ast.Call):
                continue
            if names_any(node.func, self.LOADERS):
                yield self.finding(
                    module, node,
                    f"{dotted(node.func)}(...) outside kernels/_build.py — "
                    "load the kernel library through _build.load_library() "
                    "so the build hash, flags and ctypes signatures hold")
            elif names_any(node.func, self.SUBPROCESS) \
                    and self._mentions_compiler(node):
                yield self.finding(
                    module, node,
                    "a subprocess running nvcc outside kernels/_build.py "
                    "— add the source to _build.SOURCES instead of "
                    "compiling a second library")

    def _mentions_compiler(self, call: ast.Call) -> bool:
        for arg in (*call.args, *(kw.value for kw in call.keywords)):
            for n in ast.walk(arg):
                if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                        and self.COMPILER in n.value:
                    return True
                if isinstance(n, ast.Name) and self.COMPILER in n.id:
                    return True
                if isinstance(n, ast.Call) \
                        and self.COMPILER in (call_name(n) or ""):
                    return True
        return False


@register
class LaneBucketDiscipline(Rule):
    """T002: batched launches must use ``lane_bucket``-derived lane counts."""

    id = "T002"
    title = "batched launch without lane_bucket-derived lane count"
    contract = (
        "The port keeps the reference's shape bucketing (core/trigrid.py): "
        "every stacked lane buffer pads its lane axis to lane_bucket(lanes, "
        "data_extent) — a power of two divisible by the mesh's data extent, "
        "trailing lanes masked by lane_valid — so the store's stack tags "
        "and the relax_multi launches stay keyed on a few lane counts and "
        "every launch splits evenly over the cards of a snapshot mesh "
        "(incremental_additions_sharded). Raw-integer or un-bucketed "
        "num_lanes= arguments, and batched-engine launches from functions "
        "that never compute a bucket, break that silently."
    )

    STACKERS = ("stack_delta_blocks", "delta_stack", "slide_stack")
    LAUNCHES = ("incremental_additions_batched", "batched_incremental")
    BUCKET_FN = "lane_bucket"

    def check(self, module: Module) -> Iterator[Finding]:
        local_defs = defined_function_names(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in self.STACKERS:
                yield from self._check_stacker(module, node, name)
            elif name in self.LAUNCHES and name not in local_defs \
                    and not self._scope_calls_bucket(module, node):
                # Launch calls inside the defining module are engine
                # plumbing (incremental_additions_batched ->
                # batched_incremental), hence the local_defs exemption.
                yield self.finding(
                    module, node,
                    f"{name} launched from a scope that never calls "
                    f"{self.BUCKET_FN}() — pad the lane axis to "
                    "lane_bucket(lanes, data_extent) (masked trailing "
                    "lanes) before launching")

    def _check_stacker(self, module: Module, node: ast.Call,
                       name: str) -> Iterator[Finding]:
        value = get_keyword(node, "num_lanes")
        if value is None:
            yield self.finding(
                module, node,
                f"{name} without num_lanes= stacks the exact lane count — "
                "pass num_lanes=lane_bucket(lanes, data_extent) so the "
                "lane axis is pow2 and mesh-divisible")
            return
        if isinstance(value, ast.Constant):
            what = ("num_lanes=None disables"
                    if value.value is None else
                    f"raw literal num_lanes={value.value!r} bypasses")
            yield self.finding(
                module, node,
                f"{name}: {what} lane bucketing — derive the count via "
                "lane_bucket(lanes, data_extent)")
            return
        if not self._bucket_derived(module, node, value):
            yield self.finding(
                module, node,
                f"{name}: num_lanes is not derived from "
                f"{self.BUCKET_FN}() in the enclosing scope — un-bucketed "
                "lane counts multiply the stack tags and break mesh "
                "divisibility")

    def _bucket_derived(self, module: Module, call: ast.Call,
                        value: ast.expr) -> bool:
        if isinstance(value, ast.Call) and call_name(value) == self.BUCKET_FN:
            return True
        if not isinstance(value, ast.Name):
            return False
        scope = self._outermost_scope(module, call)
        for fn in module.function_ancestors(call):
            # Pass-through wrappers: forwarding a parameter literally named
            # num_lanes (SnapshotStore.delta_stack/slide_stack) is the
            # caller's obligation, not the wrapper's.
            args = fn.args
            params = [a.arg for a in (*args.posonlyargs, *args.args,
                                      *args.kwonlyargs)]
            if value.id == "num_lanes" and value.id in params:
                return True
        return any(
            isinstance(assign, ast.Assign)
            and isinstance(assign.value, ast.Call)
            and call_name(assign.value) == self.BUCKET_FN
            and any(isinstance(t, ast.Name) and t.id == value.id
                    for t in assign.targets)
            for assign in ast.walk(scope))

    def _scope_calls_bucket(self, module: Module, node: ast.Call) -> bool:
        return any(calls_named(self._outermost_scope(module, node),
                               self.BUCKET_FN))

    @staticmethod
    def _outermost_scope(module: Module, node: ast.AST) -> ast.AST:
        ancestors = module.function_ancestors(node)
        return ancestors[-1] if ancestors else module.tree


def _defines_snapshot_store(module: Module) -> bool:
    return any(isinstance(node, ast.ClassDef) and node.name == "SnapshotStore"
               for node in module.tree.body)


@register
class CanonicalCacheTags(Rule):
    """T003: SnapshotStore cache tags only via the canonical tag helpers."""

    id = "T003"
    title = "literal SnapshotStore cache tag outside the canonical helpers"
    contract = (
        "The port's SnapshotStore (core/snapshots.py) is a pure cache of "
        "device tensors: every block is a pure function of (sequence, tag), "
        "its LRU charges each entry's device bytes by tag, stack tags embed "
        "the lane bucket, and pinning is by tag. All tag tuples are built "
        "in ONE module — the one defining SnapshotStore ('T'/'Ts'/'D'/'DS'/"
        "'A'/'AS' families, plus anchor_tag for pin/unpin callers). A "
        "literal or f-string tag anywhere else can silently alias or miss "
        "the canonical entry, and the private _cache_get/_cache_put bypass "
        "the accessors that build tags."
    )

    TAG_ARGS = {"pin": 0, "unpin": 0, "_cache_get": 0, "_cache_put": 0,
                "block_for_keys": 1}
    PRIVATE = ("_cache_get", "_cache_put")

    @staticmethod
    def _literal_tag(value: ast.expr) -> bool:
        if isinstance(value, ast.JoinedStr):
            return True
        if isinstance(value, ast.Constant) and isinstance(value.value, str):
            return True
        if isinstance(value, ast.Tuple) and value.elts:
            head = value.elts[0]
            return (isinstance(head, ast.JoinedStr)
                    or (isinstance(head, ast.Constant)
                        and isinstance(head.value, str)))
        return False

    def check(self, module: Module) -> Iterator[Finding]:
        if _defines_snapshot_store(module):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name not in self.TAG_ARGS:
                continue
            if name in self.PRIVATE:
                yield self.finding(
                    module, node,
                    f"SnapshotStore.{name} is private cache plumbing — go "
                    "through a canonical accessor (window_block/delta_block/"
                    "delta_stack/anchor_state_*) so tags stay bucketed")
                continue
            idx = self.TAG_ARGS[name]
            value = (node.args[idx] if len(node.args) > idx
                     else get_keyword(node, "tag"))
            if value is not None and self._literal_tag(value):
                yield self.finding(
                    module, node,
                    f"literal cache tag passed to {name}() — build tags "
                    "with the canonical helpers in core/snapshots.py "
                    "(e.g. anchor_tag) so family strings and lane-bucket "
                    "components cannot drift")


#: Argument-less tensor methods that wait for the card and copy to the host.
TENSOR_SYNCS = ("item", "tolist", "cpu", "numpy")
#: The device-wide wait, by its dotted suffix.
CUDA_SYNC = ("cuda.synchronize",)
#: The port's one sanctioned sync point (graph/engine.py).
HOST_SYNC = "host_sync"


@register
class HostSyncDiscipline(Rule):
    """T004: no host syncs on the device hot path; timing syncs via
    ``host_sync``."""

    id = "T004"
    title = "host synchronization on the device hot path"
    contract = (
        "The relax sweep is the port's hot path: relax_sweep and "
        "relax_sweep_fused enqueue kernels and return, and _fixpoint reads "
        "ONE host flag per chunk of fused_k sweeps. An .item(), .tolist(), "
        ".cpu(), .numpy(), np.asarray/np.array or torch.cuda.synchronize "
        "inside them — or inside anything they call in the same module, or "
        "a def compiled by torch.compile / torch.jit.script / "
        "torch.jit.trace — waits for the card once per sweep (or breaks "
        "the graph). Outside the hot path, wall-clock timing syncs are "
        "legal but go through repro_torch.graph.engine.host_sync(x), the "
        "one sanctioned, greppable sync point (torch.cuda.synchronize on "
        "each card x lies on); a bare torch.cuda.synchronize anywhere "
        "else is flagged. benchmarks/ and scripts/ are allowlisted "
        "wholesale."
    )

    NUMPY_NAMES = ("np", "numpy")
    HOST_CONVERTERS = ("asarray", "array")
    HOT_SEEDS = ("relax_sweep", "relax_sweep_fused")
    COMPILERS = ("torch.compile", "torch.jit.script", "torch.jit.trace")
    TIMING_DIRS = ("benchmarks", "scripts")

    def check(self, module: Module) -> Iterator[Finding]:
        hot = self._hot_functions(module)
        timing_module = bool(set(self.TIMING_DIRS) & set(module.path.parts))
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            in_hot = module.enclosing_function(node) in hot
            if _is_sync_method(node, TENSOR_SYNCS):
                if in_hot:
                    yield self.finding(
                        module, node,
                        f".{func.attr}() inside a hot-path or compiled "
                        "function waits for the card on every sweep — "
                        "hoist the read to the driver")
            elif names_any(func, CUDA_SYNC):
                if in_hot:
                    yield self.finding(
                        module, node,
                        "torch.cuda.synchronize inside a hot-path or "
                        "compiled function waits for the card on every "
                        "sweep — hoist it to the driver")
                elif not timing_module and not _inside_def_named(
                        module, node, (HOST_SYNC,)):
                    yield self.finding(
                        module, node,
                        "bare torch.cuda.synchronize — route timing syncs "
                        "through repro_torch.graph.engine.host_sync(x) (the "
                        "sanctioned sync point; benchmarks/ and scripts/ "
                        "are allowlisted)")
            elif in_hot and isinstance(func, ast.Attribute) \
                    and func.attr in self.HOST_CONVERTERS \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id in self.NUMPY_NAMES:
                yield self.finding(
                    module, node,
                    f"np.{func.attr} inside a hot-path or compiled function "
                    "copies a device tensor to the host — keep the hot "
                    "path on the device")

    def _hot_functions(self, module: Module) -> set[ast.AST]:
        """Seed defs, compiled defs and lambdas, plus everything they
        (transitively) nest or call, resolved by name within this
        module."""
        defs = [n for n in ast.walk(module.tree)
                if isinstance(n, (*_DEFS, ast.Lambda))]
        by_name: dict[str, list[ast.AST]] = {}
        for n in defs:
            if not isinstance(n, ast.Lambda):
                by_name.setdefault(n.name, []).append(n)

        hot: set[ast.AST] = set()
        for n in defs:
            if isinstance(n, ast.Lambda):
                continue
            if n.name in self.HOT_SEEDS or any(
                    self._mentions_compiler(d) for d in n.decorator_list):
                hot.add(n)
        # torch.compile(fn) / torch.jit.script(lambda ...) as an expression.
        for call in ast.walk(module.tree):
            if isinstance(call, ast.Call) \
                    and names_any(call.func, self.COMPILERS):
                for arg in call.args:
                    if isinstance(arg, ast.Lambda):
                        hot.add(arg)
                    elif isinstance(arg, ast.Name):
                        hot.update(by_name.get(arg.id, ()))

        changed = True
        while changed:
            changed = False
            for fn in list(hot):
                for node in ast.walk(fn):
                    if isinstance(node, (*_DEFS, ast.Lambda)) \
                            and node not in hot:
                        hot.add(node)
                        changed = True
                    elif isinstance(node, ast.Call):
                        for callee in by_name.get(call_name(node) or "", ()):
                            if callee not in hot:
                                hot.add(callee)
                                changed = True
        return hot

    def _mentions_compiler(self, decorator: ast.expr) -> bool:
        return any(names_any(n, self.COMPILERS) for n in ast.walk(decorator)
                   if isinstance(n, (ast.Name, ast.Attribute)))


@register
class SemiringSurface(Rule):
    """T005: semiring definitions complete + registered in ALL_SEMIRINGS."""

    id = "T005"
    title = "incomplete or unregistered Semiring definition"
    contract = (
        "Every monotone path semiring of the port (graph/semiring.py) "
        "supplies the full contract surface (name/reduce/identity/"
        "source_value/combine, by keyword; reduce the literal 'min' or "
        "'max' — Semiring.meet branches on it, and each kernel op of "
        "kernels/edge_relax/ref.py's KERNEL_OP_FOR scatters in that "
        "order) and, "
        "in a module that defines the ALL_SEMIRINGS registry, appears in "
        "that registry: the evolve and serve CLIs, chip_smoke.py and the "
        "parity tests enumerate ALL_SEMIRINGS, so an unregistered "
        "semiring is silently untested and unservable."
    )

    REQUIRED = ("name", "reduce", "identity", "source_value", "combine")
    REGISTRY = "ALL_SEMIRINGS"

    def check(self, module: Module) -> Iterator[Finding]:
        instances: dict[str, ast.Assign] = {}
        registry_value: "ast.expr | None" = None
        for stmt in module.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            targets = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            if self.REGISTRY in targets:
                registry_value = stmt.value
            elif isinstance(stmt.value, ast.Call) \
                    and call_name(stmt.value) == "Semiring" and targets:
                instances[targets[0]] = stmt
                yield from self._check_call(module, stmt.value)
        # AnnAssign (ALL_SEMIRINGS: dict[...] = {...}) registry form.
        for stmt in module.tree.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and stmt.target.id == self.REGISTRY:
                registry_value = stmt.value
        if registry_value is not None:
            registered = {n.id for n in ast.walk(registry_value)
                          if isinstance(n, ast.Name)}
            for name, stmt in instances.items():
                if name not in registered:
                    yield self.finding(
                        module, stmt,
                        f"Semiring {name} is not referenced by "
                        f"{self.REGISTRY} — unregistered semirings are "
                        "invisible to the CLIs, chip_smoke.py and the tests")

    def _check_call(self, module: Module,
                    call: ast.Call) -> Iterator[Finding]:
        if call.args:
            yield self.finding(
                module, call,
                "Semiring(...) with positional arguments — use keywords so "
                "the contract surface is checkable and reorder-proof")
        given = {kw.arg for kw in call.keywords if kw.arg}
        missing = [k for k in self.REQUIRED if k not in given]
        if missing:
            yield self.finding(
                module, call,
                f"Semiring(...) missing required field(s) "
                f"{', '.join(missing)} — the monotone-op contract surface "
                "is name/reduce/identity/source_value/combine")
        reduce_kw = get_keyword(call, "reduce")
        if reduce_kw is not None and not (
                isinstance(reduce_kw, ast.Constant)
                and reduce_kw.value in ("min", "max")):
            yield self.finding(
                module, call,
                'Semiring reduce= must be the literal "min" or "max" — '
                "the meet and the relax kernels' scatter order follow it")


@register
class ServiceSyncBoundary(Rule):
    """T007: service modules sync only at packed-launch boundaries."""

    id = "T007"
    title = "per-query host sync in a service scheduling loop"
    contract = (
        "The port's query service (core/service.py: admission -> pack -> "
        "launch) stays sync-free: the ONE host sync per packed launch "
        "lives at the campaign boundary, inside a function whose name ends "
        "with _launch (core/window.py::_slide_launch or a service-side "
        "*_launch executor). A host_sync(), .item(), .tolist(), .cpu(), "
        ".numpy() or torch.cuda.synchronize anywhere else in a service "
        "module — per admitted query, per lane, per client in a "
        "scheduling loop — waits for the card inside the open-loop "
        "pipeline and destroys batching (and makes scheduling depend on "
        "wall-clock, breaking the exact fields the service's metrics "
        "report). Applies to modules named service; other modules keep "
        "T004's discipline."
    )

    SANCTIONED_SUFFIX = "_launch"
    MODULE_NAME = "service"

    def check(self, module: Module) -> Iterator[Finding]:
        if module.dotted_name().split(".")[-1] != self.MODULE_NAME:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (isinstance(func, ast.Name) and func.id == HOST_SYNC) \
                    or (isinstance(func, ast.Attribute)
                        and func.attr == HOST_SYNC):
                label = func.id if isinstance(func, ast.Name) \
                    else f".{func.attr}"
            elif _is_sync_method(node, TENSOR_SYNCS):
                label = f".{func.attr}"
            elif names_any(func, CUDA_SYNC):
                label = "torch.cuda.synchronize"
            else:
                continue
            if not self._at_launch_boundary(module, node):
                yield self.finding(
                    module, node,
                    f"{label} outside a *{self.SANCTIONED_SUFFIX} function "
                    "— the service hot loop syncs once per packed launch "
                    "at the campaign boundary, never per query")

    def _at_launch_boundary(self, module: Module, node: ast.AST) -> bool:
        return any(isinstance(fn, _DEFS)
                   and fn.name.endswith(self.SANCTIONED_SUFFIX)
                   for fn in module.function_ancestors(node))


STABILITY_MODULE = "repro_torch.graph.stability"
ENGINE_MODULE = "repro_torch.graph.engine"


@register
class StabilitySeedDiscipline(Rule):
    """T008: seed frontiers come from graph/stability.py, not raw Δ
    sweeps."""

    id = "T008"
    title = "raw relax_sweep seeding outside the stability layer"
    contract = (
        "Frontier seeding is the port's stable-vertex analysis' monopoly "
        "(repro_torch/graph/stability.py::seed_state): it masks the seed "
        "sweep to the semiring's improvement test so stable vertices never "
        "enter the seed frontier, and it is the one place the "
        "instability/delta mode switch and the unstable counts live. A "
        "direct relax_sweep call anywhere else re-derives a seed frontier "
        "from the raw Δ edge endpoints — bypassing the pruning, the mode "
        "switch and the accounting at once. Only the stability module and "
        "the engine's fixpoint machinery (_fixpoint, _fixpoint_shards) "
        "may call it; in the port relax_sweep is itself a k = 1 fused "
        "chunk, so the engine's own sweeps go through relax_sweep_fused "
        "(T010)."
    )

    SWEEP = "relax_sweep"
    ENGINE_SANCTIONED = ("_fixpoint", "_fixpoint_shards")

    def check(self, module: Module) -> Iterator[Finding]:
        dotted_name = module.dotted_name()
        if dotted_name == STABILITY_MODULE:
            return
        for node in calls_named(module.tree, self.SWEEP):
            if dotted_name == ENGINE_MODULE and _inside_def_named(
                    module, node, self.ENGINE_SANCTIONED):
                continue
            yield self.finding(
                module, node,
                f"{self.SWEEP} called outside graph/stability.py — seed "
                "frontiers must come from repro_torch.graph.stability."
                "seed_state (the stable-vertex analysis), not a raw Δ edge "
                "sweep")


@register
class IngestCutDiscipline(Rule):
    """T009: snapshots are cut only via Watermark.cut; no ad-hoc store
    writes."""

    id = "T009"
    title = "snapshot write outside the watermark cut path"
    contract = (
        "A live SnapshotStore of the port grows through exactly one write "
        "path: repro_torch.core.ingest.Watermark.cut consumes watermarked "
        "events (timestamp order, last-op-wins, redundancy filtered), "
        "maintains the running common graph, and installs the snapshot and "
        "its canonical Δ pair via SnapshotStore.ingest_cut. An ingest_cut "
        "call anywhere else skips that bookkeeping (metrics, sealing, "
        "common-graph maintenance); growing the live sequence directly "
        "(.snapshot_keys/.additions/.deletions .append) desynchronizes the "
        "store's window cache from its sequence; and writing the store's "
        "_t/_blocks caches from outside the SnapshotStore module plants "
        "device entries the pure-cache contract and the LRU's byte count "
        "cannot rebuild. All three are flagged outside their one legal "
        "home (ingest.Watermark.cut / ingest.LiveSequence.append / the "
        "SnapshotStore module itself)."
    )

    WRITE_PATH = "ingest_cut"
    INGEST_MODULE = "repro_torch.core.ingest"
    SANCTIONED_FN = "cut"
    GROW_ATTRS = ("snapshot_keys", "additions", "deletions")
    CACHE_ATTRS = ("_t", "_blocks")

    def check(self, module: Module) -> Iterator[Finding]:
        in_ingest = module.dotted_name() == self.INGEST_MODULE
        canonical = _defines_snapshot_store(module)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) \
                    and call_name(node) == self.WRITE_PATH:
                if not (in_ingest and _inside_def_named(
                        module, node, (self.SANCTIONED_FN,))):
                    yield self.finding(
                        module, node,
                        f"{self.WRITE_PATH} called outside "
                        "ingest.Watermark.cut — snapshots are born only "
                        "from watermarked cuts (event ordering, sealing, "
                        "common-graph maintenance live there)")
            elif isinstance(node, ast.Call) and not in_ingest \
                    and self._grows_sequence(node):
                yield self.finding(
                    module, node,
                    "appending to a live sequence's snapshot_keys/"
                    "additions/deletions outside core/ingest.py — the "
                    "store's window cache would not see the new snapshot; "
                    "cut it via ingest.Watermark.cut")
            elif isinstance(node, ast.Assign) and not canonical:
                for target in node.targets:
                    attr = self._cache_subscript(target)
                    if attr is not None:
                        yield self.finding(
                            module, node,
                            f"direct write to SnapshotStore.{attr}[...] "
                            "outside core/snapshots.py — cache entries "
                            "must be installable only by the store (pure-"
                            "cache contract); use ingest_cut/the canonical "
                            "accessors")

    def _grows_sequence(self, node: ast.Call) -> bool:
        func = node.func
        return (isinstance(func, ast.Attribute) and func.attr == "append"
                and isinstance(func.value, ast.Attribute)
                and func.value.attr in self.GROW_ATTRS)

    def _cache_subscript(self, target: ast.expr) -> "str | None":
        if isinstance(target, ast.Subscript) \
                and isinstance(target.value, ast.Attribute) \
                and target.value.attr in self.CACHE_ATTRS:
            return target.value.attr
        return None


@register
class FusedLaunchDiscipline(Rule):
    """T010: fused relax chunks launch only through the engine's
    fixpoint."""

    id = "T010"
    title = "fused relax chunk launched outside the sanctioned fixpoint path"
    contract = (
        "relax_sweep_fused (up to k frontier-masked sweeps in one "
        "relax_multi launch, kernels/edge_relax_multi) extends T008's "
        "seeding monopoly: it IS a relax-sweep sequence, so launching it "
        "from an executor re-opens the raw-Δ seeding hole T008 closes, and "
        "it carries the bit-exactness contract (a chunk of k equals k "
        "single sweeps, with min(k, allowed) caps per lane) that only the "
        "engine's fixpoint machinery is tested to keep. In the port the "
        "sanctioned callers are the stability layer (its seed sweep, via "
        "relax_sweep) and the engine's relax_sweep (the k = 1 chunk), "
        "_fixpoint and _fixpoint_shards (the chunked fixpoint over lane "
        "shards). Everything else reaches fused execution through the "
        "fused_k launch option threaded engine -> trigrid -> window -> "
        "service, and that knob flows from launch options (a variable or "
        "attribute), never a literal at a call site outside the engine, "
        "so one setting controls every launch in a run and packed lanes "
        "cannot mix chunk sizes."
    )

    FUSED = "relax_sweep_fused"
    KNOB = "fused_k"
    ENGINE_SANCTIONED = ("relax_sweep", "_fixpoint", "_fixpoint_shards")

    def check(self, module: Module) -> Iterator[Finding]:
        dotted_name = module.dotted_name()
        if dotted_name != STABILITY_MODULE:
            for node in calls_named(module.tree, self.FUSED):
                if dotted_name == ENGINE_MODULE and _inside_def_named(
                        module, node, self.ENGINE_SANCTIONED):
                    continue
                yield self.finding(
                    module, node,
                    f"{self.FUSED} called outside graph/stability.py and "
                    "the engine's fixpoint — executors reach fused "
                    "execution via the fused_k launch option "
                    "(run_to_fixpoint/incremental_additions/...), never by "
                    "launching fused chunks directly")
        if dotted_name == ENGINE_MODULE:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            value = get_keyword(node, self.KNOB)
            if isinstance(value, ast.Constant):
                yield self.finding(
                    module, node,
                    f"literal {self.KNOB}={value.value!r} at a call site — "
                    "the fused chunk size is a launch option: thread it "
                    "from the caller's options (a variable or attribute), "
                    "so one knob configures every launch in the run")
