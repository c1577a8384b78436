#!/usr/bin/env python3
"""graphlint CLI for the PyTorch port: the ``repro_torch.analysis`` rules.

Runs rules T001–T010 (see docs/ANALYSIS_TORCH.md for the catalog) over
source trees, by default ``src/repro_torch``, and exits 1 if and only if a
finding survives suppression. Stdlib-only: rules read source with ``ast``,
they never import or execute the code under analysis, so this needs
neither ``torch`` nor ``jax``.

    python scripts/torch_invariant_lint.py                    # lint src/repro_torch
    python scripts/torch_invariant_lint.py --format json src/repro_torch
    python scripts/torch_invariant_lint.py --select T004,T007 src/repro_torch/core
    python scripts/torch_invariant_lint.py --list-rules
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.analysis import (  # noqa: E402  (path bootstrap above)
    Linter,
    all_rules,
    get_rule,
    render_human,
    render_json,
)


def list_rules() -> str:
    blocks = []
    for rule in all_rules():
        contract = textwrap.fill(rule.contract, width=76,
                                 initial_indent="    ",
                                 subsequent_indent="    ")
        blocks.append(f"{rule.id}  {rule.title}\n{contract}")
    return "\n\n".join(blocks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="torch_invariant_lint.py",
        description="graphlint for the PyTorch port: static AST checks of "
                    "repro_torch's launch/cache/sync contracts")
    p.add_argument("paths", nargs="*", type=pathlib.Path,
                   default=[REPO / "src" / "repro_torch"],
                   help="files or directories to lint (default: "
                        "src/repro_torch)")
    p.add_argument("--format", choices=("human", "json"), default="human",
                   help="output format")
    p.add_argument("--select", metavar="IDS",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        print(list_rules())
        return 0

    rules = None
    if args.select:
        try:
            rules = [get_rule(rid.strip())
                     for rid in args.select.split(",") if rid.strip()]
        except KeyError as e:
            p.error(str(e.args[0]))
    linter = Linter(rules=rules)
    findings = linter.lint(args.paths)
    render = render_json if args.format == "json" else render_human
    print(render(findings, linter.files_checked))
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
