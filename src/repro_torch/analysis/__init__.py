"""graphlint for the PyTorch port: AST-enforced launch/cache/sync
invariants keyed on ``repro_torch`` (docs/ANALYSIS_TORCH.md).

The counterpart of ``repro.analysis``. The port's cross-cutting contracts
— one place that builds and binds the CUDA library, lane bucketing before
batched launches, canonical SnapshotStore cache tags, one sanctioned host
sync, the semiring registry, the stability layer's seeding monopoly, the
watermark cut path, fused chunks only from the engine's fixpoint, and
docs/API_TORCH.md coverage — constrain *every* call site, including ones
later changes add, which no single unit test can guard. The rules are
``T001``–``T010``, each the counterpart of the reference's ``G0NN``, in a
registry of their own: a ``disable-file`` header for a G id silences no T
rule.

Stdlib only (``ast`` + ``pathlib``): importing this package loads neither
``torch``, ``jax`` nor ``repro``, and linting never imports the code under
analysis.

    PYTHONPATH=src python scripts/torch_invariant_lint.py         # CLI
    from repro_torch.analysis import Linter; Linter().lint([path])  # library

Layout:

* :mod:`repro_torch.analysis.linter` — the rule-engine core: parsed-module
  model, ``# graphlint: disable=RULE`` suppressions, rule registry,
  finding type, human/JSON rendering.
* :mod:`repro_torch.analysis.rules` — rules T001–T005, T007–T010.
* :mod:`repro_torch.analysis.apidoc` — rule T006 (docs/API_TORCH.md
  coverage + docstring presence).
"""

from repro_torch.analysis.linter import (
    Finding,
    Linter,
    Module,
    Rule,
    all_rules,
    get_rule,
    register,
    render_human,
    render_json,
)
from repro_torch.analysis import rules as _rules    # noqa: F401  (T001-T005, T007-T010)
from repro_torch.analysis import apidoc as _apidoc  # noqa: F401  (registers T006)

__all__ = [
    "Finding",
    "Linter",
    "Module",
    "Rule",
    "all_rules",
    "get_rule",
    "register",
    "render_human",
    "render_json",
]
