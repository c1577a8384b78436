"""Fault tolerance, straggler mitigation, elastic re-sharding.

Counterpart of ``repro.runtime.fault``:

* :class:`FaultTolerantRunner`: step-level retry with checkpoint restore.
  A failed step (a node failure, a preemption, a NaN blow-up) rolls the
  state back to the last checkpoint (``runtime/checkpoint.py``, restored
  onto its manager's device with the same bits) and replays the steps
  from there; the data pipeline is a function of (seed, step), so the
  replay is bit-identical.
* :class:`StragglerBalancer`: cost-weighted longest-processing-time-first
  assignment of work blocks to workers from measured per-block costs.
* :func:`reshard_state`: elastic scaling of a host checkpoint onto a
  smaller or larger data axis (numpy arrays and tensors alike).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.runtime.checkpoint import CheckpointManager


class StepFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FaultTolerantRunner:
    ckpt: CheckpointManager
    ckpt_every: int = 5
    max_retries: int = 3

    def run(self, state: dict, step_fn: Callable[[dict, int], dict],
            n_steps: int, start_step: int = 0,
            fail_at: set[int] | None = None) -> tuple[dict, list[int]]:
        """Run steps ``start_step`` .. ``n_steps - 1``; ``fail_at`` injects
        one failure at each step it names (for drills and tests).

        Returns (final state, the steps replayed after each failure: from
        the restored checkpoint's step up to the failed one). More than
        ``max_retries`` failures in a row raise the last one.
        """
        fail_at = set(fail_at or ())
        replayed: list[int] = []
        step = start_step
        retries = 0
        while step < n_steps:
            try:
                if step in fail_at:
                    fail_at.discard(step)  # fail once, then heal
                    raise StepFailure(f"injected node failure at step {step}")
                state = step_fn(state, step)
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except StepFailure:
                retries += 1
                if retries > self.max_retries:
                    raise
                restored = self.ckpt.restore_latest()
                restore_step = self.ckpt.latest_step() or start_step
                if restored is not None:
                    state = restored
                # deterministic replay from the checkpointed cursor
                replayed.extend(range(restore_step, step + 1))
                step = restore_step
        return state, replayed


class StragglerBalancer:
    """Cost-weighted LPT assignment of work blocks to workers."""

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._costs: dict[int, float] = {}

    def observe(self, block_id: int, seconds: float, ema: float = 0.5):
        prev = self._costs.get(block_id)
        self._costs[block_id] = seconds if prev is None else \
            ema * seconds + (1 - ema) * prev

    def assign(self, block_ids: list[int]) -> dict[int, list[int]]:
        """Longest-processing-time-first over observed costs (1.0 default);
        ties go to the lower worker."""
        loads = [0.0] * self.n_workers
        out: dict[int, list[int]] = {w: [] for w in range(self.n_workers)}
        for b in sorted(block_ids, key=lambda b: -self._costs.get(b, 1.0)):
            w = int(np.argmin(loads))
            out[w].append(b)
            loads[w] += self._costs.get(b, 1.0)
        return out

    def imbalance(self, assignment: dict[int, list[int]]) -> float:
        loads = [sum(self._costs.get(b, 1.0) for b in bs)
                 for bs in assignment.values()]
        return max(loads) / max(min(loads), 1e-9)


def reshard_state(state: dict, old_data: int, new_data: int,
                  batch_linked: tuple[str, ...] = ()) -> dict:
    """Elastic re-shard: adapt a checkpoint to a new data-axis size.

    Model and optimizer leaves are data-parallel replicas and carry over
    unchanged. Leaves named in ``batch_linked`` (numpy arrays or tensors)
    have a leading global-batch axis tied to the data axis: they are cut
    (shrink) or tiled (grow) so the per-shard batch stays the same. The
    data cursor is kept: determinism comes from (seed, step), not from
    the worker count.
    """
    if new_data == old_data:
        return state
    out = {}
    for k, v in state.items():
        if k in batch_linked and hasattr(v, "shape") and v.ndim >= 1:
            per = v.shape[0] // old_data
            if new_data < old_data:
                out[k] = v[: per * new_data]
            else:
                reps = [new_data // old_data] + [1] * (v.ndim - 1)
                tiled = (v.repeat(*reps) if isinstance(v, torch.Tensor)
                         else np.tile(v, reps))
                out[k] = tiled[: per * new_data]
        else:
            out[k] = v
    return out
