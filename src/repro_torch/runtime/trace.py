"""Spans and counters inside the port, off unless a recording is on.

A recording is on inside :func:`recording` and while a ``torch.profiler``
records (the profiler's own Python flag, ``torch.autograd.profiler.
_is_profiler_enabled``). Off, :func:`span` costs one flag check and hands
back a shared no-op context: no profiler range, no clock read, no
allocation; :func:`count` and :func:`add` return at once.

On, a span reads ``time.perf_counter_ns`` at its ends and keeps, per
name, its count, its total and its self time (its total less the time of
the spans opened inside it). Under a profiler it also opens a profiler
range named ``name`` inside its clock reads (the range
``torch.profiler.record_function`` opens, through the profiler's C++
class, without that function's operator dispatch), so the program's
spans lie on the profiler's clock beside the device's kernels (a chrome
trace the profiler exports shows both), and a span's time holds the cost
of its own range. :func:`count` adds to a host integer;
:func:`add` keeps a device tensor for a counter, with no device operation
and no host read. :func:`device_span` times the device work enqueued
inside it on one device's stream, between two CUDA events kept unread,
into a counter of nanoseconds (on a CPU device, where work runs as it
is called, by the host clock). :func:`totals` sums and reads everything
once; :func:`reset` clears it.

Spans nest through one stack, so they belong to the thread that runs the
port's host loop; a span that is open when the recording ends still
closes into the totals.
"""

from __future__ import annotations

import contextlib
import time

import torch


# the profiler keeps ``_is_profiler_enabled`` for fast Python checks; the
# tests hold a span to it, so a torch that drops or stops setting it fails
_profiler = torch.autograd.profiler
# the profiler's range as a C++ context (what torch's compiled code opens
# around its kernels): ~2 us a range while the profiler records, against
# ~15 for ``record_function``; the tests hold it to the profiler's events
_range = torch._C._profiler._RecordFunctionFast
_depth = 0          # open recording() contexts
_spans: dict[str, list[int]] = {}    # name -> [count, total ns, self ns]
_counts: dict[str, int] = {}
# (name, device) -> the tensors kept for the counter, flattened; past
# _FOLD of them they are summed into one
_kept: dict[tuple, list[torch.Tensor]] = {}
_FOLD = 1024
# counter name -> (start, end) CUDA event pairs of its device spans, unread
_events: dict[str, list[tuple]] = {}
_stack: list["_Span"] = []


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "t0", "child", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the clock reads enclose the profiler's range, so that its cost
        # falls in this span's time and not in its parent's self time
        self.t0 = time.perf_counter_ns()
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _range(self.name)
            self.range.__enter__()
        self.child = 0
        _stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        ns = time.perf_counter_ns() - self.t0
        _stack.pop()
        if _stack:
            _stack[-1].child += ns
        row = _spans.get(self.name)
        if row is None:
            row = _spans[self.name] = [0, 0, 0]
        row[0] += 1
        row[1] += ns
        row[2] += ns - self.child
        return False


def active() -> bool:
    """Whether a recording is on: inside :func:`recording`, or while a
    ``torch.profiler`` records."""
    return _depth > 0 or _profiler._is_profiler_enabled


def span(name: str):
    """A context that times the code inside it under ``name`` while a
    recording is on, and does nothing otherwise."""
    if _depth > 0 or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` while a recording is on."""
    if _depth > 0 or _profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def add(name: str, value: torch.Tensor) -> None:
    """Keep the device tensor ``value`` (integral values, any shape) for
    the counter ``name`` while a recording is on: no device operation
    and no host read until :func:`totals` sums every element kept, as
    int64. ``value`` must not be written afterwards; callers build it
    only when :func:`active` says so."""
    if not (_depth > 0 or _profiler._is_profiler_enabled):
        return
    kept = _kept.setdefault((name, value.device), [])
    kept.append(value.detach().reshape(-1))
    if len(kept) > _FOLD:
        kept[:] = [_sum(kept)]


class _DeviceSpan:
    __slots__ = ("name", "device", "t0", "start")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        if self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.device.type != "cuda":
            _counts[self.name] = (_counts.get(self.name, 0)
                                  + time.perf_counter_ns() - self.t0)
            return False
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        pairs = _events.setdefault(self.name, [])
        pairs.append((self.start, end))
        if len(pairs) > _FOLD:
            _counts[self.name] = _counts.get(self.name, 0) + _read(pairs)
            pairs.clear()
        return False


def device_span(name: str, device):
    """A context that, while a recording is on, adds to the counter
    ``name`` the nanoseconds ``device`` spends on the work enqueued
    inside it on its current stream: two CUDA events recorded there,
    read at :func:`totals` (on a CPU device, where work runs as it is
    called, the host clock's time inside). Off, the shared no-op."""
    if _depth > 0 or _profiler._is_profiler_enabled:
        return _DeviceSpan(name, torch.device(device))
    return _OFF


def _read(pairs: "list[tuple]") -> int:
    """The nanoseconds between each pair's events, summed, once each end
    has been reached."""
    total = 0.0
    for start, end in pairs:
        end.synchronize()
        total += start.elapsed_time(end)
    return round(total * 1e6)


def _sum(kept: "list[torch.Tensor]") -> torch.Tensor:
    """The sum of every element of ``kept``, as an int64 tensor [1]."""
    return torch.stack([t.sum(dtype=torch.int64) for t in kept]) \
        .sum().reshape(1)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the ``with`` block, profiler or
    none. Nests; what was recorded stays until :func:`reset`."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def totals() -> dict:
    """What was recorded since the last :func:`reset`: ``spans`` (per name
    ``count``, ``total_s`` and ``self_s``) and ``counts`` (the host
    counters, the device counters' kept tensors summed and read once per
    name and device, and the device spans' nanoseconds, as ints)."""
    counts = dict(_counts)
    for (name, _), kept in _kept.items():
        counts[name] = counts.get(name, 0) + int(_sum(kept))
    for name, pairs in _events.items():
        counts[name] = counts.get(name, 0) + _read(pairs)
    return dict(spans={name: dict(count=c, total_s=t / 1e9, self_s=s / 1e9)
                       for name, (c, t, s) in _spans.items()},
                counts=counts)


def reset() -> None:
    """Forget every span, counter, kept tensor and event recorded so
    far."""
    _spans.clear()
    _counts.clear()
    _kept.clear()
    _events.clear()
