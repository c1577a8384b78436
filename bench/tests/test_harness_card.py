"""The harness on a card at toy size: the kernels' path, the relax
kernel's timed calls and the profiler's reading of the device."""

from __future__ import annotations

import pytest

from conftest import TOY_CELLS, run_line


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TOY_CELLS)
def test_toy_run_on_the_card(toy_root, capsys, card, workload):
    rc, line = run_line(toy_root, capsys, workload, trace=1, device=card)
    assert rc == 0 and line["correct"] is True
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert line["breakdown"]["device_ops"]
    metrics = line["metrics"]
    assert 0 < metrics["relax_roofline_pct"]["value"] <= 105
    assert 0 <= metrics["device_idle_pct"]["value"] < 100


@pytest.mark.cuda
def test_control_on_the_card(toy_root, card):
    from bench.control import control
    for r in control("ev-toy-dhb", [1, 2, 3], 0.2, card, root=toy_root):
        assert r["correct"] is False
