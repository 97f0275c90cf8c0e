"""Spans, counters and the trace of the program (the port's counterpart of
``yolo_tpu/utils/profiler.py``): its one place for what it measures of
itself.

Tracing is on exactly while a ``torch.profiler`` session is active
(``torch.autograd.profiler._is_profiler_enabled``); there is no other
switch.

- ``span(name)``: a context manager around one layer's work. Off, it is
  one shared no-op context. On, it records its name, its start and end on
  the host as ``time.time_ns()`` (the Unix-epoch clock the device trace's
  events are stamped on), the index of its parent span and that of its
  top-level span (the batch or step it belongs to), and, once CUDA is
  initialised, a pair of CUDA events on the current stream from a pool;
  it opens a ``record_function`` range of its name around the work, so
  that in a session that records host activity the span sits above the
  kernels it launched. It never synchronises.
- ``count(name, value)``: an integer is counted always (``counter(name)``
  reads the total, ``totals()`` all of them: the kernels' launches
  ``k1.launches`` ... ``k4.launches``, the calls of the int8 engine's other
  conv paths, ``grouped.calls`` and ``float_edge.calls``, and how each
  call of the int8 engine's serving step ran, ``serve.eager_calls``,
  ``serve.graph_captures`` or ``serve.graph_replays``: ``runtime.make_infer``);
  a tensor only while tracing is on, kept as it is and reduced by
  ``summary``, so that the hot path adds no kernel and no sync. What is
  counted while tracing is on is also filed under the open top-level span.
- ``summary(first=None)``: per span name its count, host seconds and device
  seconds (the CUDA events' interval; on the CPU, where every op has
  finished when it returns, the host's); per counter the sum of what was
  counted while tracing was on. It synchronises once. ``first=n`` keeps
  the first ``n`` top-level spans of each top-level name, what ran under
  them and what was counted there.
- ``records()``: the finished spans; ``reset()`` empties the store and the
  counters; ``tracing()`` says whether a session is on.
- ``trace(logdir)``: ``torch.profiler`` over the block (CPU, and CUDA when
  it is there), its Chrome trace, with the program's spans above their
  kernels, written into ``logdir``; ``summary()`` then gives the totals.

The program's spans: ``serve.infer`` (a call of ``runtime.make_infer``'s
callable) and, under it, ``engine.conv`` (with ``engine.grouped`` and
``engine.float_conv`` inside it), ``engine.shortcut``, ``engine.concat``,
``engine.se``, ``nms.decode`` and ``nms.suppress``; ``train.grad`` (with
``train.forward``, ``train.loss`` and ``train.backward``) and
``train.update``. Its traced counters: ``nms.valid`` and ``nms.slots``.

Spans are kept in memory, one stack for the process: open and close them
on one thread.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int         # index of the enclosing span, -1 at the top level
    top: int            # index of the top-level span it runs under


class _Store:
    def __init__(self):
        # [name, start_ns, end_ns, parent, top, start event, end event]
        self.spans: list[list] = []
        self.open: list[int] = []
        self.counts: list[tuple] = []   # (name, top, value), traced
        self.totals: dict[str, int] = {}
        self.free_events: list = []
        self.streams: dict = {}


_store = _Store()


def _event():
    free = _store.free_events
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _current_stream():
    """The current CUDA stream, one object a stream:
    ``torch.cuda.current_stream()`` builds a new one at each call, which
    took ~8 us of the card's host, as long as recording an event."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _store.streams.get(key)
    if stream is None:
        stream = _store.streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


class _Span:
    __slots__ = ('name', 'rec', 'handle', 'stream')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        st = _store
        # ``torch.profiler.record_function``'s own entry: the public class
        # took ~12 us a span on the card's host, this call ~3.5 us
        self.handle = torch._C._autograd._record_function_with_args_enter(
            self.name)
        i = len(st.spans)
        parent = st.open[-1] if st.open else -1
        top = st.spans[parent][4] if parent >= 0 else i
        ev = (None, None)
        if torch.cuda.is_initialized():
            self.stream = _current_stream()
            ev = (_event(), _event())
        self.rec = [self.name, time.time_ns(), 0, parent, top, *ev]
        st.spans.append(self.rec)
        st.open.append(i)
        if ev[0] is not None:
            ev[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec[6] is not None:
            rec[6].record(self.stream)
        rec[2] = time.time_ns()
        if _store.open:
            _store.open.pop()
        torch._C._autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str):
    """A span named ``name`` around the block while tracing is on, else a
    shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, value):
    """Add ``value`` to the counter ``name``: an integer always, a tensor
    (kept, reduced by ``summary``) only while tracing is on."""
    if not torch.is_tensor(value):
        _store.totals[name] = _store.totals.get(name, 0) + value
    if _autograd_profiler._is_profiler_enabled:
        st = _store
        top = st.spans[st.open[-1]][4] if st.open else -1
        st.counts.append((name, top, value))


def counter(name: str) -> int:
    """The integers counted under ``name`` since the last ``reset``."""
    return _store.totals.get(name, 0)


def totals() -> dict[str, int]:
    """Every counter's integers since the last ``reset``, by name (a copy)."""
    return dict(_store.totals)


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is on: spans record."""
    return _autograd_profiler._is_profiler_enabled


def records() -> list[Span]:
    """The finished spans, in the order they were opened."""
    return [Span(*r[:5]) for r in _store.spans if r[2]]


def reset():
    """Empty the store of spans and counts and zero every counter."""
    st = _store
    for r in st.spans:
        st.free_events += [e for e in r[5:] if e is not None]
    st.spans, st.open, st.counts, st.totals = [], [], [], {}


def summary(first: int | None = None) -> dict:
    """{'spans': {name: {'count', 'host_s', 'device_s'}}, 'counters':
    {name: total}} of the finished spans and of what was counted while
    tracing was on; ``first=n``: only the first ``n`` top-level spans of
    each top-level name and what ran or was counted under them."""
    st = _store
    keep = None
    if first is not None:
        seen: dict[str, int] = {}
        keep = set()
        for i, r in enumerate(st.spans):
            if r[3] == -1 and r[2]:
                if seen.get(r[0], 0) < first:
                    keep.add(i)
                seen[r[0]] = seen.get(r[0], 0) + 1
    picked = [r for r in st.spans
              if r[2] and (keep is None or r[4] in keep)]
    if any(r[5] is not None for r in picked):
        torch.cuda.synchronize()
    spans: dict[str, dict] = {}
    for r in picked:
        host = (r[2] - r[1]) / 1e9
        s = spans.setdefault(r[0], {'count': 0, 'host_s': 0.0,
                                    'device_s': 0.0})
        s['count'] += 1
        s['host_s'] += host
        s['device_s'] += (r[5].elapsed_time(r[6]) / 1e3 if r[5] is not None
                          else host)
    counters: dict[str, float] = {}
    for name, top, v in st.counts:
        if keep is None or top in keep:
            counters[name] = counters.get(name, 0) + (
                v.sum().item() if torch.is_tensor(v) else v)
    return {'spans': spans, 'counters': counters}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler. Its Chrome trace goes to
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
