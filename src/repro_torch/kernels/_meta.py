"""The hand-written kernels on the meta device: shapes only.

On a meta tensor each kernel wrapper calls one operator of this module's
``repro_torch_meta`` library in place of its launch. The operator has
only a meta implementation: it returns empty meta tensors of the kernel's
outputs' shapes and dtypes, so a whole step runs on meta (``launch/dryrun
.py``) and an operator mode sees one call per launch, with the tensors
the kernel reads and the ones it writes. The wrappers' autograd functions
run on meta as they do on the card, so the gradients' shapes come from
the same code.

The library is defined at the first meta call, not when a module is
imported.
"""

from __future__ import annotations

import functools

import torch


def _segment_reduce(rows, perm, offsets):
    return rows.new_empty((offsets.shape[0] - 1, rows.shape[1]))


def _embedding_bag(table, ids, weights, perm, offsets):
    return table.new_empty((offsets.shape[0] - 1, table.shape[1]))


def _relax_multi(values, parent, frontier, blocks, cap, track_parents):
    lanes = values.shape[0]
    return (torch.empty_like(values),
            torch.empty_like(parent) if track_parents
            else parent.new_empty((0,)),
            torch.empty_like(frontier),
            cap.new_empty((lanes,)),
            values.new_empty((lanes,)))


@functools.cache
def _ops():
    lib = torch.library.Library("repro_torch_meta", "DEF")
    for schema, fn in (
            ("segment_reduce(Tensor rows, Tensor perm, Tensor offsets) "
             "-> Tensor", _segment_reduce),
            ("embedding_bag(Tensor table, Tensor ids, Tensor weights, "
             "Tensor perm, Tensor offsets) -> Tensor", _embedding_bag),
            ("relax_multi(Tensor values, Tensor parent, Tensor frontier, "
             "Tensor[] blocks, Tensor cap, bool track_parents) -> "
             "(Tensor, Tensor, Tensor, Tensor, Tensor)", _relax_multi)):
        lib.define(schema)
        lib.impl(schema.split("(")[0], fn, "Meta")
    return lib, torch.ops.repro_torch_meta


def segment_reduce(rows: torch.Tensor, layout) -> torch.Tensor:
    """``segment_reduce``'s launch on meta: [num_segments, D] float32."""
    return _ops()[1].segment_reduce(rows, layout.perm, layout.offsets)


def embedding_bag(table, ids, weights, layout) -> torch.Tensor:
    """``embedding_bag``'s launch on meta: [n_bags, D] float32."""
    return _ops()[1].embedding_bag(table, ids, weights, layout.perm,
                                   layout.offsets)


def relax_multi(values, parent, frontier, blocks, track_parents: bool):
    """``relax_multi``'s launch on meta: ``(values, parent, frontier,
    sweeps, work)``, the caller's ``parent`` when parents are not
    tracked. The kernel also reads a sweep cap per lane."""
    cap = torch.empty((values.shape[0],), dtype=torch.int32, device="meta")
    v, p, f, sweeps, work = _ops()[1].relax_multi(
        values, parent, frontier, [t for b in blocks for t in b], cap,
        track_parents)
    return v, p if track_parents else parent, f, sweeps, work
