"""Per-stage timing + device profiler hook.

Counterpart of ``semtools_tpu/utils/tracing.py``, under the same switches:

- ``SEMTOOLS_TPU_TIMINGS=1``: every :func:`stage` block records wall time,
  and a summary prints to stderr at exit (or on :func:`report`). When a
  CUDA context exists, a stage ends with ``torch.cuda.synchronize()`` so
  that work launched asynchronously is charged to the stage that launched
  it. Off, a stage costs one environment lookup. torch is not imported
  here: a command that never imports it (``parse``) has no context to wait
  for.
- ``SEMTOOLS_TPU_TRACE=<dir>``: wraps the command in ``torch.profiler``
  (CPU and, when present, CUDA activity) and writes a Chrome trace to
  ``<dir>/trace.json``.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_lock = threading.Lock()  # stages end on several threads (parse jobs, daemon readers)
_registered = False


def enabled() -> bool:
    return bool(os.environ.get("SEMTOOLS_TPU_TIMINGS"))


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a pipeline stage (no-op unless SEMTOOLS_TPU_TIMINGS is set)."""
    if not enabled():
        yield
        return
    global _registered
    if not _registered:
        _registered = True
        atexit.register(report)
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


@contextlib.contextmanager
def maybe_device_trace() -> Iterator[None]:
    """torch.profiler over the block when SEMTOOLS_TPU_TRACE names a directory."""
    trace_dir = os.environ.get("SEMTOOLS_TPU_TRACE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"semtools: device trace written to {path}", file=sys.stderr)
