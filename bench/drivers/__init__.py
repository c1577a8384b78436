"""The program's entry paths: one module per path, named by a
configuration's ``driver`` key. A module's ``Driver(config, traffic,
inputs, device, spans)`` builds the program's state from the benchmark's
inputs (set-up) and answers one SSSP query a ``query(source)`` call,
returning once every snapshot's answer is on the device and the program
has synced with it.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class Answer(NamedTuple):
    """One query's answers and what the program reported doing."""

    values: Sequence[torch.Tensor]  # one float32 [N] answer per snapshot
    fixpoint_s: float               # the common graph's fixpoint, host s
    hop_s: float                    # the hops to the snapshots, host s
    sweeps: int                     # fixpoint sweeps + each hop level's most
