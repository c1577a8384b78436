"""graphlint rule-engine core of the PyTorch port (counterpart of
``repro.analysis.linter``): modules, rules, suppressions, findings.

The same model as the reference's, with a registry of its own, so the
port's rules (``T001``…) and the reference's (``G001``…) never mix:

* A :class:`Module` is one parsed source file plus the derived structure
  rules keep re-needing — a child→parent AST map, the enclosing-function
  chain of any node, per-line ``# graphlint: disable=RULE`` suppressions,
  and the module's dotted import name (for rules keyed by module, like the
  API-doc coverage rule).
* A :class:`Rule` has a stable id (``T001``…), a one-line title, and a
  ``check(module)`` generator yielding :class:`Finding` s. Rules register
  themselves with :func:`register`; :class:`Linter` runs every registered
  rule (or a selected subset) over a file tree and applies suppressions.
* Output is deterministic (findings sorted by path/line/col/rule) and
  renders either human (``path:line:col: TNNN message``) or JSON
  (:func:`render_json`).

Suppression syntax, checked per finding line:

    x = risky_thing()   # graphlint: disable=<rule ids>
    # graphlint: disable-file=<rule ids>   <- anywhere: the whole file

A suppression names rule ids, so a ``disable-file=G008,G010`` header kept
for the reference's rules silences none of the port's.

Stdlib only: linting never imports the code under analysis (rules read
source, they never execute it), and importing this package loads neither
``torch`` nor ``jax``.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import pathlib
import re
from typing import Iterable, Iterator

SUPPRESS_LINE_RE = re.compile(r"#\s*graphlint:\s*disable=([A-Z0-9,\s]+)")
SUPPRESS_FILE_RE = re.compile(r"#\s*graphlint:\s*disable-file=([A-Z0-9,\s]+)")

#: Files/dirs never worth parsing.
SKIP_DIR_NAMES = {"__pycache__", ".git", ".venv", "node_modules"}

#: Markers that identify a repo root (for locating docs/API.md etc.).
ROOT_MARKERS = ("pyproject.toml", ".git")

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, anchored to a file/line/col."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _rule_ids(spec: str) -> set[str]:
    return {part.strip() for part in spec.split(",") if part.strip()}


def find_root(path: pathlib.Path) -> "pathlib.Path | None":
    """Nearest ancestor directory that looks like a repo root (else None)."""
    cur = path.resolve()
    if cur.is_file():
        cur = cur.parent
    for candidate in (cur, *cur.parents):
        if any((candidate / marker).exists() for marker in ROOT_MARKERS):
            return candidate
        if (candidate / "docs" / "API.md").exists():
            return candidate
    return None


class Module:
    """One parsed source file + the structure rules need to query it."""

    def __init__(self, path: pathlib.Path, source: str,
                 root: "pathlib.Path | None" = None):
        self.path = pathlib.Path(path).resolve()
        self.root = root
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self._parent: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parent[child] = node
        self.line_disables: dict[int, set[str]] = {}
        self.file_disables: set[str] = set()
        for lineno, line in enumerate(source.splitlines(), start=1):
            m = SUPPRESS_FILE_RE.search(line)
            if m:
                self.file_disables |= _rule_ids(m.group(1))
                continue
            m = SUPPRESS_LINE_RE.search(line)
            if m:
                self.line_disables.setdefault(lineno, set()).update(
                    _rule_ids(m.group(1)))

    @property
    def rel(self) -> str:
        """Display path: root-relative when a root is known."""
        if self.root is not None:
            with contextlib.suppress(ValueError):
                return str(self.path.relative_to(self.root))
        return str(self.path)

    def dotted_name(self) -> str:
        """Import path of the module (``repro_torch.core.window``),
        derived from the file path: everything after the last ``src``
        component, else the root-relative path. ``__init__`` maps to its
        package."""
        parts = list(self.path.with_suffix("").parts)
        if "src" in parts:
            parts = parts[len(parts) - parts[::-1].index("src"):]
        elif self.root is not None:
            with contextlib.suppress(ValueError):
                parts = list(
                    self.path.relative_to(self.root).with_suffix("").parts)
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def parent(self, node: ast.AST) -> "ast.AST | None":
        return self._parent.get(node)

    def function_ancestors(self, node: ast.AST) -> list[ast.AST]:
        """Enclosing function-like nodes, innermost first."""
        out = []
        cur = self._parent.get(node)
        while cur is not None:
            if isinstance(cur, FunctionNode):
                out.append(cur)
            cur = self._parent.get(cur)
        return out

    def enclosing_function(self, node: ast.AST) -> "ast.AST | None":
        """The innermost function-like node containing ``node`` (else None)."""
        ancestors = self.function_ancestors(node)
        return ancestors[0] if ancestors else None

    def suppressed(self, rule_id: str, line: int) -> bool:
        if rule_id in self.file_disables or "ALL" in self.file_disables:
            return True
        active = self.line_disables.get(line, ())
        return rule_id in active or "ALL" in active


# -- shared AST helpers (imported by the rule modules) ------------------------


def call_name(node: ast.Call) -> "str | None":
    """Rightmost name of a call target: ``ctypes.CDLL(...)`` → ``CDLL``."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def calls_named(tree: ast.AST, name: str) -> Iterator[ast.Call]:
    """Every call in ``tree`` whose target's rightmost name is ``name``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and call_name(node) == name:
            yield node


def defined_function_names(tree: ast.AST) -> set[str]:
    """Names of every def/async-def anywhere in ``tree`` (methods included)."""
    return {node.name for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def get_keyword(node: ast.Call, name: str) -> "ast.expr | None":
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def dotted(node: ast.AST) -> "str | None":
    """The dotted name a ``Name``/``Attribute`` chain spells
    (``torch.cuda.synchronize``), else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def names_any(node: ast.AST, names: "tuple[str, ...]") -> bool:
    """Whether the ``Name``/``Attribute`` chain ``node`` spells one of
    ``names``, whole or as its dotted tail: ``torch.cuda.synchronize``
    matches ``"cuda.synchronize"`` and ``"torch.cuda.synchronize"``."""
    name = dotted(node)
    return name is not None and any(
        name == n or name.endswith("." + n) for n in names)


# -- rule base + registry -----------------------------------------------------


class Rule:
    """Base class: subclass, set ``id``/``title``/``contract``, implement
    :meth:`check`, and decorate with :func:`register`."""

    id: str = ""
    title: str = ""
    #: One-paragraph statement of the invariant (rendered by --list-rules).
    contract: str = ""

    def check(self, module: Module) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, module: Module, node: ast.AST, message: str,
                path: "str | None" = None,
                line: "int | None" = None) -> Finding:
        """Build a finding anchored at ``node`` (or an explicit path/line —
        used by rules that report against a non-source file like API.md)."""
        return Finding(path if path is not None else module.rel,
                       line if line is not None
                       else getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) if path is None else 0,
                       self.id, message)


_REGISTRY: dict[str, Rule] = {}


def register(cls: type) -> type:
    """Class decorator adding a rule (by its ``id``) to the global registry."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in _REGISTRY and type(_REGISTRY[rule.id]) is not cls:
        raise ValueError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> list[Rule]:
    return [_REGISTRY[rule_id] for rule_id in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown rule {rule_id!r} (known: {known})") from None


# -- the linter driver --------------------------------------------------------


def iter_python_files(paths: Iterable[pathlib.Path]) -> list[pathlib.Path]:
    """Expand files/directories to a sorted, de-duplicated .py file list."""
    out: set[pathlib.Path] = set()
    for path in paths:
        path = pathlib.Path(path)
        if path.is_dir():
            for sub in path.rglob("*.py"):
                if not SKIP_DIR_NAMES & set(sub.parts):
                    out.add(sub.resolve())
        elif path.suffix == ".py":
            out.add(path.resolve())
    return sorted(out)


class Linter:
    """Runs a set of rules over files/trees and applies suppressions.

    ``rules=None`` runs every registered rule. ``root=`` overrides repo-root
    detection (tests point it at fixture trees); by default each file's
    root is found by walking up to the nearest ``pyproject.toml``/``.git``.
    """

    def __init__(self, rules: "Iterable[Rule] | None" = None,
                 root: "pathlib.Path | None" = None):
        self.rules = list(rules) if rules is not None else all_rules()
        self.root = pathlib.Path(root).resolve() if root is not None else None
        self.files_checked = 0

    def lint_file(self, path: pathlib.Path) -> list[Finding]:
        path = pathlib.Path(path)
        root = self.root if self.root is not None else find_root(path)
        module = Module(path, path.read_text(encoding="utf-8"), root)
        self.files_checked += 1
        findings = []
        for rule in self.rules:
            for f in rule.check(module):
                # Line suppressions apply to findings anchored in this
                # module; findings a rule reports against another file
                # (e.g. a stale API.md entry) cannot be suppressed here.
                if f.path == module.rel and module.suppressed(f.rule, f.line):
                    continue
                findings.append(f)
        return findings

    def lint(self, paths: Iterable[pathlib.Path]) -> list[Finding]:
        findings: list[Finding] = []
        for path in iter_python_files(paths):
            findings.extend(self.lint_file(path))
        return sorted(set(findings))


# -- output -------------------------------------------------------------------


def render_human(findings: list[Finding], files_checked: int = 0) -> str:
    if not findings:
        return f"graphlint: {files_checked} files clean"
    lines = [f.render() for f in findings]
    lines.append(f"graphlint: {len(findings)} finding(s) in "
                 f"{files_checked} files")
    return "\n".join(lines)


def render_json(findings: list[Finding], files_checked: int = 0) -> str:
    return json.dumps({
        "version": 1,
        "files_checked": files_checked,
        "count": len(findings),
        "findings": [f.to_dict() for f in findings],
    }, indent=2)
