"""Rule T006: docs/API_TORCH.md coverage + docstrings for the port's
documented core (counterpart of ``repro.analysis.apidoc``'s G006).

The hand-written ``## `repro_torch.x.y` `` sections of docs/API_TORCH.md
define which of the port's modules are *documented core*; for those
modules this rule enforces, in both directions,

* every ``### `name(...)` `` entry still names a public def/class (or
  ``Class.method``) — else a stale-entry finding anchored in the page;
* every public module-level def/class, and every public method of a
  public class, has an entry — else an undocumented-surface finding at
  the def;
* every such public name carries a docstring — the one-line contract
  the page summarizes must exist at the def itself.

Modules without a section are out of scope. :func:`parse_api_doc` and
:func:`public_surface` are the reference's; a module heading may name a
module of either package, so the parser reads docs/API.md exactly as the
reference does, and the rule keys on the port's dotted names.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterator

from repro_torch.analysis.linter import Finding, Module, Rule, register

API_MODULE_RE = re.compile(r"^##\s+`(repro(?:_torch)?\.[\w.]+)`")
API_ENTRY_RE = re.compile(r"^###\s+`([A-Za-z_][\w.]*)")

#: Parsed API page per file path → (mtime, {module: {entry: line}}).
_API_CACHE: dict = {}


def parse_api_doc(path: pathlib.Path) -> "dict[str, dict[str, int]]":
    """``{module: {entry_name: line}}`` from the ``##``/``###`` structure
    of an API reference file; a non-module ``## `` heading closes the
    current module scope."""
    mtime = path.stat().st_mtime_ns
    cached = _API_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    sections: dict[str, dict[str, int]] = {}
    module = None
    for lineno, line in enumerate(
            path.read_text(encoding="utf-8").splitlines(), start=1):
        m = API_MODULE_RE.match(line)
        if m:
            module = m.group(1)
            sections.setdefault(module, {})
            continue
        if line.startswith("## "):
            module = None
            continue
        e = API_ENTRY_RE.match(line)
        if e and module is not None:
            sections[module].setdefault(e.group(1), lineno)
    _API_CACHE[path] = (mtime, sections)
    return sections


def public_surface(tree: ast.Module) -> "dict[str, ast.AST]":
    """Public names an API reference must cover: module-level defs/classes
    plus public methods of public classes — nested helper defs are not
    surface. Maps each name to its def node (for line anchors and
    docstring checks)."""
    names: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                names[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names[node.name] = node
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and not sub.name.startswith("_"):
                    names[f"{node.name}.{sub.name}"] = sub
    return names


@register
class ApiDocCoverage(Rule):
    """T006: documented-core modules ↔ docs/API_TORCH.md, with
    docstrings."""

    id = "T006"
    title = "docs/API_TORCH.md drift or missing docstring on documented " \
        "surface"
    contract = (
        "docs/API_TORCH.md is the hand-written contract sheet for the "
        "port's core modules — the counterparts of the ten modules "
        "docs/API.md documents — and the lint holds it in both "
        "directions. For every module with a '## `repro_torch.x.y`' "
        "section: each '### `name(...)`' entry must name a live public "
        "def/class/method (stale entries are flagged in the page itself), "
        "each public name must have an entry (new surface cannot ship "
        "undocumented), and each public name must carry a docstring — the "
        "contract the page summarizes has to exist at the def."
    )

    DOC_RELPATH = ("docs", "API_TORCH.md")

    def _api_path(self, module: Module) -> "pathlib.Path | None":
        if module.root is None:
            return None
        path = module.root.joinpath(*self.DOC_RELPATH)
        return path if path.is_file() else None

    def check(self, module: Module) -> Iterator[Finding]:
        api_path = self._api_path(module)
        if api_path is None:
            return
        sections = parse_api_doc(api_path)
        entries = sections.get(module.dotted_name())
        if entries is None:
            return
        doc_rel = "/".join(self.DOC_RELPATH)
        surface = public_surface(module.tree)
        for entry, lineno in entries.items():
            if entry not in surface:
                yield self.finding(
                    module, module.tree,
                    f"stale API reference entry `{entry}` — no such public "
                    f"def/class in {module.dotted_name()}; update or drop "
                    "the entry",
                    path=doc_rel, line=lineno)
        for name, node in surface.items():
            if name not in entries:
                yield self.finding(
                    module, node,
                    f"public name {name} of {module.dotted_name()} is "
                    f"undocumented — add a '### `{name}(...)`' entry to "
                    f"{doc_rel}")
            if not ast.get_docstring(node):
                yield self.finding(
                    module, node,
                    f"{name} is documented API surface but has no "
                    "docstring — state the contract at the def, not only "
                    f"in {doc_rel}")
