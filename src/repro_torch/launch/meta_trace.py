"""A tracer of one step on the meta device: its memory, bytes and FLOPs.

``trace_step(fn, args)`` runs ``fn(*args)`` on meta tensors (shapes and
dtypes, nothing computed) under :class:`MetaTrace`, an operator mode that
sees every operator call of the step, autograd's backward included. It
gives:

* ``one_device``: the step's memory run whole on one device, from storage
  lifetimes. The arguments' storages are live from the start; each
  operator output on a storage that none of its inputs holds is an
  allocation, freed when the storage's last view dies (a finalizer on
  the storage). Views and in-place operators allocate nothing. Each
  allocation is rounded up to 512 bytes, as the CUDA caching allocator
  rounds its blocks, so the peak reads like ``torch.cuda.
  max_memory_allocated``. Left out: what exists only on the card (cuBLAS
  workspaces, a kernel's own scratch, a sort's temporary storage).
* ``flops``: every matrix product of the step, by the formulas
  ``torch.utils.flop_counter.FlopCounterMode`` counts with (its
  registry; no elementwise work).
* ``bytes_accessed``: over the step's operators, the bytes each reads
  (its input tensors' elements) and writes (its outputs'). Views and
  metadata operators, and the allocations of ``empty``, count nothing:
  what eager execution moves. A kernel on meta (``kernels/_meta.py``) is
  one operator: its inputs read once, its outputs written once.
"""

from __future__ import annotations

import time
import weakref

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.tree import tree_leaves

# the CUDA caching allocator's block granule
ALLOC_GRANULE = 512

_ALLOCATORS = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``FlopCounterMode``'s count of a batched product; its own formula
    takes ``bmm(..., out_dtype=...)``'s dtype for the output's shape."""
    return flop_counter.bmm_flop(a_shape, b_shape)


_FLOPS = {**flop_counter.flop_registry,
          torch.ops.aten.bmm: flop_counter.shape_wrapper(_bmm_flop)}
_VIEWS: dict = {}


def _is_view(func) -> bool:
    """An operator whose outputs alias an input without writing it."""
    view = _VIEWS.get(func)
    if view is None:
        view = _VIEWS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return view


class MetaTrace(TorchDispatchMode):
    """Live and peak bytes, bytes accessed and FLOPs of the operators run
    under it (see the module docstring). ``hold(tensors)`` first: their
    storages are live before the step (the arguments)."""

    def __init__(self):
        super().__init__()
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.bytes_accessed = 0
        self.flops = 0

    def hold(self, tensors) -> int:
        """Count the storages of ``tensors`` live; returns their bytes."""
        before = self.live_bytes
        for t in tensors:
            self._allocate(t.untyped_storage())
        return self.live_bytes - before

    def _allocate(self, st) -> None:
        key = id(st)
        if key in self._live:
            return
        size = _rounded(st.nbytes())
        self._live[key] = size
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_view(func):
            return out
        count = _FLOPS.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = list(_tensors(args)) + list(_tensors(kwargs.values()))
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        if func not in _ALLOCATORS:
            self.bytes_accessed += (sum(map(_nbytes, ins))
                                    + sum(map(_nbytes, outs)))
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in held:
                self._allocate(st)
        return out


def trace_step(fn, args) -> tuple:
    """``fn(*args)`` on meta tensors under :class:`MetaTrace`: ``(its
    output, {"one_device": {"peak_bytes", "argument_bytes", "temp_bytes"},
    "flops", "bytes_accessed", "trace_s"})``. The output is live
    at the end, so it counts in the peak."""
    leaves = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    if any(not t.is_meta for t in leaves):
        raise ValueError("trace_step runs on meta tensors only")
    t0 = time.perf_counter()
    tracer = MetaTrace()
    arg_bytes = tracer.hold(leaves)
    with tracer:
        out = fn(*args)
    return out, {"one_device": {"peak_bytes": tracer.peak_bytes,
                           "argument_bytes": arg_bytes,
                           "temp_bytes": tracer.peak_bytes - arg_bytes},
            "flops": tracer.flops,
            "bytes_accessed": tracer.bytes_accessed,
            "trace_s": time.perf_counter() - t0}
