"""The traced run's instruments, all in the benchmark's own files:

* :class:`Spans`: ``record_function`` labels around the calls into the
  program's layers, on only while the profiler runs;
* :func:`labelled`: the same labels around program functions the
  drivers name (what the host was doing in a device idle gap);
* :class:`RelaxRecorder`: CUDA events around every call of the fused
  relax kernel (``repro_torch.graph.engine.relax_multi``), with the bytes
  the call's inputs need (``relax_bytes``);
* :func:`profile`: ``torch.profiler`` over a few steady queries, read into
  the device's busy seconds, its kernels by time and its idle gaps by
  label.
"""

from __future__ import annotations

import contextlib
import json
import pathlib

import torch

PEAKS = json.loads((pathlib.Path(__file__).with_name("peaks.json"))
                   .read_text())
WINDOW_LABEL = "bench.window"
TOP = 10


def peak(kind: str, what: str):
    """A published peak of the card ``kind`` (``bench/peaks.json``), or
    None for a card the table lacks."""
    return PEAKS.get(kind, {}).get(what)


class Spans:
    """``spans(name)``: a ``record_function`` range while ``on``, else
    nothing."""

    def __init__(self):
        self.on = False
        self.labels = {WINDOW_LABEL}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        self.labels.add(name)
        with torch.profiler.record_function(name):
            yield


@contextlib.contextmanager
def labelled(targets, spans: Spans):
    """Wrap each ``(module, attribute, label)`` of ``targets`` in a span
    for the duration; the originals are put back after."""
    saved = []

    def wrap(fn, label):
        def inner(*args, **kwargs):
            with spans(label):
                return fn(*args, **kwargs)
        return inner

    try:
        for module, attr, label in targets:
            fn = getattr(module, attr)
            saved.append((module, attr, fn, attr in vars(module)))
            setattr(module, attr, wrap(fn, label))
        yield
    finally:
        for module, attr, fn, own in reversed(saved):
            if own:
                setattr(module, attr, fn)
            else:       # a method of an instance: drop the wrapper
                delattr(module, attr)


def relax_bytes(blocks, frontier: torch.Tensor, track_parents: bool,
                num_nodes: int) -> torch.Tensor:
    """Bytes one relax sweep from ``frontier`` [S, N] must move, as a
    device scalar (``chip_smoke.py``'s ``relax_bytes`` arithmetic): the
    src of every real edge (padding slots not counted), the dst and w of
    each real edge whose src is on a lane's frontier (a shared block's
    once for all lanes, a stacked block's per lane), and the lanes'
    state (values, frontier, parents when tracked) read once and written
    once."""
    lanes = frontier.shape[0]
    anywhere = frontier.any(0)
    total = torch.zeros((), dtype=torch.int64, device=frontier.device)
    for src, dst, _ in blocks:
        real = dst < num_nodes
        if src.dim() == 1:
            on = anywhere.index_select(0, src) & real
        else:
            on = frontier.gather(1, src.long()) & real
        total += 4 * real.sum() + 8 * on.sum()
    state = lanes * num_nodes * (4 + 1 + (4 if track_parents else 0))
    return total + 2 * state


class RelaxRecorder:
    """While entered, every ``engine.relax_multi`` call is timed on the
    device by CUDA events around it, and its bytes (first sweep's
    frontier; the engine's fixpoints call it one sweep at a time) are
    reckoned outside the events. :meth:`totals` gives ``(device seconds,
    bytes, calls)``."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.graph import engine
        self._engine = engine
        self._inner = inner = engine.relax_multi

        def timed(values, parent, frontier, blocks, *args, **kwargs):
            nbytes = relax_bytes(blocks, frontier,
                                 kwargs.get("track_parents", True),
                                 kwargs["num_nodes"])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(values, parent, frontier, blocks, *args, **kwargs)
            end.record()
            self.calls.append((start, end, nbytes))
            return out

        engine.relax_multi = timed
        return self

    def __exit__(self, *exc):
        self._engine.relax_multi = self._inner
        return False

    def totals(self) -> tuple[float, int, int]:
        torch.cuda.synchronize()
        seconds = sum(s.elapsed_time(e) for s, e, _ in self.calls) / 1e3
        nbytes = sum(int(b) for _, _, b in self.calls)
        return seconds, nbytes, len(self.calls)


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    return fn() if fn is not None else 1000 * getattr(event, f"{what}_us")()


def _annotation(event) -> bool:
    fn = getattr(event, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_profile(events, labels) -> dict | None:
    """Busy and idle time of the device inside the ``bench.window`` range
    of a profiler's kineto ``events``: ``window_s``, ``busy_s`` (the union
    of device operations: kernels, copies, sets), ``device_ops`` (the
    operations that took most time, summed by name) and ``idle_gaps``
    (idle device time summed by the innermost label the host was in at
    the gap's middle). None without device events."""
    host, device, window = [], [], None
    for e in events:
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name == WINDOW_LABEL:
                window = (start, end)
            elif name in labels:
                host.append((start, end, name))
        elif name not in labels and not _annotation(e):
            device.append((start, end, name))
    if window is None or not device:
        return None
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device
              if b > lo and a < hi]
    busy = _union([(a, b) for a, b, _ in inside])
    by_name: dict[str, int] = {}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0) + (b - a)
    gaps: dict[str, int] = {}
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        around = [(s, n) for s, e, n in host if s <= mid < e]
        label = max(around)[1] if around else "host outside the labels"
        gaps[label] = gaps.get(label, 0) + (b - a)

    def top(d):
        return [[n, v / 1e9] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(window_s=(hi - lo) / 1e9,
                busy_s=sum(b - a for a, b in busy) / 1e9,
                device_ops=top(by_name), idle_gaps=top(gaps))


def profile(run, spans: Spans) -> dict | None:
    """Run ``run()`` under ``torch.profiler`` (host and device) inside a
    ``bench.window`` range, with the spans on; returns
    :func:`read_profile`'s reading."""
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    spans.on = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_LABEL):
                run()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        spans.on = False
    return read_profile(prof.profiler.kineto_results.events(), spans.labels)
