"""The control (the reference in bfloat16 in the program's place) fails
the check that sound runs pass; on the card at the cells' own size it is
run by ``bench/control.py``."""

from __future__ import annotations

import pytest

from conftest import TOY_CELLS


@pytest.mark.parametrize("workload", TOY_CELLS)
def test_control_is_not_correct(toy_root, workload):
    from bench.control import control
    readings = control(workload, [5, 2**31 + 9, 77], 0.2, "cpu",
                       root=toy_root)
    for r in readings:
        assert r["correct"] is False
        assert r["checks"]["value_mismatches"]["value"] > 0
