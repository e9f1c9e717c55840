"""Per-stage timing, request spans and the device profiler hook.

Counterpart of ``semtools_tpu/utils/tracing.py``, under the same switches:

- ``SEMTOOLS_TPU_TIMINGS=1``: every :func:`stage` block records wall time,
  and a summary prints to stderr at exit (or on :func:`report`). When a
  CUDA context exists, a stage ends with ``torch.cuda.synchronize()`` so
  that work launched asynchronously is charged to the stage that launched
  it. Off, a stage costs one environment lookup. torch is not imported
  here: a command that never imports it (``parse``) has no context to wait
  for. Set when this module is imported, the switch also keeps the
  process's spans (below) in memory, the newest :data:`KEPT` of them, for
  :func:`records`: a traced benchmark run reads its window's spans there.
  They are kept as plain tuples of numbers and strings, which the garbage
  collector stops tracking, so a full pass does not walk them.
- ``SEMTOOLS_TPU_TRACE=<dir>``: wraps the command in ``torch.profiler``
  (CPU and, when present, CUDA activity), records the command's spans, and
  writes a Chrome trace to ``<dir>/trace.json`` with the spans in it on
  the profiler's clock, above the device operations.

Spans. :func:`span` marks a block of one request: a :class:`SpanRecord`
holds its name, its request's id, its own id, its parent's id, its thread
and its start and end on ``time.perf_counter_ns()``, and the counters the
block added (:meth:`_Span.count`). The parent is the span open on the same
thread (a context variable, so threads never mix); a span opened with none
open starts a request of its own, unless :func:`request` opened one. A
stage is a span too. While recording, each pass of Python's garbage
collector is a ``gc`` span (its generation and the objects it freed) under
the span open on the thread that ran it. Records stay in memory: a
:func:`record` block hands over the records made during it. Spans never
synchronise and go into no stage total. With no recorder on, :func:`span`
and :func:`request` cost one check of a module flag.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import gc
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_lock = threading.Lock()  # stages end on several threads (parse jobs, daemon readers)
_registered = False

# Spans kept under SEMTOOLS_TPU_TIMINGS: the newest this many (~60 MB).
KEPT = 1 << 18
# The instant marked in a profile to put the spans on its clock.
ANCHOR = "semtools:anchor"


class SpanRecord(NamedTuple):
    name: str
    request: int
    span: int
    parent: Optional[int]  # None at the root of a request
    thread: int  # threading.get_ident()
    start: int  # ns, time.perf_counter_ns()
    end: int
    attrs: Optional[Dict[str, int]]  # counters the block added


_on = False  # a recorder is on: spans record
_sinks: Tuple = ()  # each recorder's store of raw records
_kept: Optional[collections.deque] = None  # the SEMTOOLS_TPU_TIMINGS store
_sinks_lock = threading.Lock()
_ids = itertools.count(1)  # span and request ids
_open: contextvars.ContextVar = contextvars.ContextVar("semtools_span", default=None)
_gc_start: Optional[int] = None  # the running collection's start (collections hold the GIL)


# A record as the sinks hold it: a SpanRecord's first seven fields in a
# plain tuple, then the counters as key, value, key, value, ... It holds
# strings and numbers alone, so the collector untracks it at the first pass
# it survives (a tuple subclass, or a tuple that holds a tuple, it would
# not).
def _emit(raw: tuple) -> None:
    for sink in _sinks:
        sink.append(raw)


def _as_record(raw: tuple) -> SpanRecord:
    attrs = dict(zip(raw[7::2], raw[8::2])) if len(raw) > 7 else None
    return tuple.__new__(SpanRecord, raw[:7] + (attrs,))


class _Span:
    """An open span; :func:`span` hands it out while a recorder is on."""

    __slots__ = ("name", "request", "span", "parent", "attrs", "start", "token")

    def __init__(self, name: str):
        self.name = name
        self.attrs: Optional[Dict[str, int]] = None

    def __enter__(self) -> "_Span":
        up = _open.get()
        self.span = next(_ids)
        if up is None:
            self.request, self.parent = self.span, None
        else:
            self.request, self.parent = up.request, up.span
        self.token = _open.set(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        _open.reset(self.token)
        raw = (self.name, self.request, self.span, self.parent, threading.get_ident(),
               self.start, end)
        if self.attrs is not None:
            raw += tuple(itertools.chain(*self.attrs.items()))
        _emit(raw)

    def count(self, key: str, n: int) -> None:
        """Add ``n`` to the span's counter ``key``."""
        if self.attrs is None:
            self.attrs = {key: n}
        else:
            self.attrs[key] = self.attrs.get(key, 0) + n


class _Request:
    """An open request context: spans opened in it with none open above
    them are its roots."""

    __slots__ = ("request", "span", "token")

    def __init__(self, rid: int):
        self.request, self.span = rid, None

    def __enter__(self) -> "_Request":
        self.token = _open.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _open.reset(self.token)


class _Off:
    """What :func:`span` and :func:`request` hand out with no recorder on."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def count(self, key: str, n: int) -> None:
        return None


_OFF = _Off()


def span(name: str):
    """A block of the current request, recorded while a recorder is on."""
    if not _on:
        return _OFF
    return _Span(name)


def request(rid: Optional[int] = None):
    """A request context with id ``rid`` (a new id if None), while a
    recorder is on."""
    if not _on:
        return _OFF
    return _Request(next(_ids) if rid is None else rid)


def _on_gc(phase: str, info: dict) -> None:
    global _gc_start
    if phase == "start":
        _gc_start = time.perf_counter_ns()
        return
    start, _gc_start = _gc_start, None
    if start is None:
        return
    end = time.perf_counter_ns()
    up = _open.get()
    sid = next(_ids)
    rid, parent = (sid, None) if up is None else (up.request, up.span)
    _emit(("gc", rid, sid, parent, threading.get_ident(), start, end,
           "generation", info["generation"], "collected", info["collected"]))


def _attach(sink) -> None:
    global _sinks, _on
    with _sinks_lock:
        if not _sinks:
            gc.callbacks.append(_on_gc)
        _sinks = _sinks + (sink,)
        _on = True


def _detach(sink) -> None:
    global _sinks, _on
    with _sinks_lock:
        _sinks = tuple(s for s in _sinks if s is not sink)
        _on = bool(_sinks)
        if not _sinks:
            gc.callbacks.remove(_on_gc)


@contextlib.contextmanager
def record() -> Iterator[List[SpanRecord]]:
    """Record spans over the block; the list it gives holds them once the
    block has ended."""
    raw: List[tuple] = []
    out: List[SpanRecord] = []
    _attach(raw)
    try:
        yield out
    finally:
        _detach(raw)
        out.extend(map(_as_record, raw))


def keep(on: bool) -> None:
    """Start or stop keeping the process's spans for :func:`records` (on
    from import under SEMTOOLS_TPU_TIMINGS)."""
    global _kept
    if on and _kept is None:
        _kept = collections.deque(maxlen=KEPT)
        _attach(_kept)
    elif not on and _kept is not None:
        _detach(_kept)
        _kept = None


def records() -> List[SpanRecord]:
    """The kept spans, oldest first (none unless :func:`keep` is on)."""
    while True:
        kept = _kept
        if kept is None:
            return []
        try:
            raw = list(kept)
        except RuntimeError:  # a thread or a collection appended meanwhile
            continue
        return [_as_record(r) for r in raw]


def enabled() -> bool:
    return bool(os.environ.get("SEMTOOLS_TPU_TIMINGS"))


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a pipeline stage (no-op unless SEMTOOLS_TPU_TIMINGS is set);
    also a span while a recorder is on."""
    if not enabled():
        if not _on:
            yield
            return
        with _Span(name):
            yield
        return
    global _registered
    if not _registered:
        _registered = True
        atexit.register(report)
    with (_Span(name) if _on else _OFF):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch = sys.modules.get("torch")
            if torch is not None and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            with _lock:
                _totals[name] += time.perf_counter() - t0
                _counts[name] += 1


def timings() -> List[Tuple[str, float, int]]:
    """(stage, total_seconds, calls), slowest first."""
    return sorted(
        ((k, v, _counts[k]) for k, v in _totals.items()),
        key=lambda t: -t[1],
    )


def report(file=None) -> None:
    rows = timings()
    if not rows:
        return
    out = file or sys.stderr
    width = max(len(r[0]) for r in rows)
    print("-- semtools timings --", file=out)
    for name, total, count in rows:
        print(f"  {name:<{width}}  {total * 1e3:9.1f} ms  x{count}", file=out)


def reset() -> None:
    _totals.clear()
    _counts.clear()


def _add_spans_to_trace(path: str, spans: List[SpanRecord], anchor_ns: int) -> bool:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    (process ``semtools spans``, one row a thread) on the trace's clock:
    ``anchor_ns`` is ``perf_counter_ns()`` read inside the trace's
    :data:`ANCHOR` event. False where the trace has no anchor."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    at = next((e["ts"] for e in events if e.get("name") == ANCHOR and "ts" in e), None)
    if at is None:
        return False
    shift_us = float(at) - anchor_ns / 1e3
    for s in spans:
        args = {"request": s.request, "span": s.span, "parent": s.parent, **(s.attrs or {})}
        events.append({"ph": "X", "cat": "semtools_span", "name": s.name,
                       "pid": "semtools spans", "tid": s.thread,
                       "ts": s.start / 1e3 + shift_us, "dur": (s.end - s.start) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
    return True


@contextlib.contextmanager
def maybe_device_trace() -> Iterator[None]:
    """torch.profiler over the block when SEMTOOLS_TPU_TRACE names a
    directory, with the block's spans written into its trace."""
    trace_dir = os.environ.get("SEMTOOLS_TPU_TRACE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with record() as spans, profile(activities=activities) as prof:
        with record_function(ANCHOR):
            anchor_ns = time.perf_counter_ns()
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    if not _add_spans_to_trace(path, spans, anchor_ns):
        print(f"semtools: no {ANCHOR} in the trace; spans left out", file=sys.stderr)
    print(f"semtools: device trace written to {path}", file=sys.stderr)


keep(enabled())
