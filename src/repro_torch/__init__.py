"""PyTorch + CUDA port of the evolving-graph query engine (``repro``).

Mirrors ``repro``'s module layout — ``graph/``, ``core/``, ``kernels/``,
``launch/`` — so each module has one reference module it is held against.
The relax sweeps run in hand-written CUDA kernels on the card
(``kernels/csrc``); CPU tensors take their plain PyTorch versions. The
package imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
