"""Daemon-side read coalescing: merge concurrent batched searches.

Counterpart of ``semtools_tpu/store/coalesce.py``. The daemon's reader
threads funnel concurrent :meth:`Store.search_line_embeddings_batched` calls
that arrive within a small window and address the SAME (store, path subset,
top_k, max_distance) into one batched call on the leader's store, then split
the per-query results back out: N parallel searches cost one scan (one pass
over the corpus, one set of kernel launches, one re-rank gather) instead of N.

Semantics: all merged queries are answered from one consistent scan run at
some instant inside the window, which is what each caller would have seen
had it arrived then, so read-only callers cannot tell coalesced from direct
execution. Follower errors fall back to direct execution on their own
store, so a leader failure never fails a follower.

Enabled only inside the daemon (:func:`semtools_tpu_torch.daemon.serve`
calls :func:`enable`). ``SEMTOOLS_TPU_COALESCE=0`` disables it there;
``SEMTOOLS_TPU_COALESCE_WINDOW_MS`` (default 8) sets the gather window.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

_enabled = False
_lock = threading.Lock()
_open: dict = {}  # key -> _Batch

# instrumentation: (merged batches, merged queries)
_stats = [0, 0]


def enable() -> None:
    """Turn the funnel on for this process (the daemon calls this)."""
    global _enabled
    _enabled = True


def enabled() -> bool:
    return _enabled and os.environ.get("SEMTOOLS_TPU_COALESCE", "1") != "0"


def _window_s() -> float:
    try:
        return float(os.environ.get("SEMTOOLS_TPU_COALESCE_WINDOW_MS", "8")) / 1e3
    except ValueError:
        return 0.008


class _Batch:
    __slots__ = ("qs", "starts", "closed", "done", "results", "error")

    def __init__(self) -> None:
        self.qs: List[np.ndarray] = []
        self.starts: List[int] = []
        self.closed = False
        self.done = threading.Event()
        self.results = None
        self.error: Optional[BaseException] = None


def stats():
    return tuple(_stats)


def search_batched(
    store,
    query_vecs: np.ndarray,
    subset_paths: Sequence[str],
    top_k: int,
    max_distance: Optional[float],
    impl,
):
    """Coalescing wrapper around one store's batched-search ``impl``
    (``impl(qs, paths, top_k, max_distance)``, the non-coalescing entry with
    its retry); the leader runs it once for every merged query row."""
    qs = np.asarray(query_vecs, np.float32)
    # The path tuple itself is part of the key (not its hash), so two
    # different subsets never merge.
    key = (
        str(store.dir.resolve()),
        tuple(subset_paths),
        int(top_k),
        None if max_distance is None else float(max_distance),
    )
    with _lock:
        batch = _open.get(key)
        leader = batch is None or batch.closed
        if leader:
            batch = _Batch()
            _open[key] = batch
        start = sum(q.shape[0] for q in batch.qs)
        batch.starts.append(start)
        batch.qs.append(qs)

    if leader:
        # Gather window: followers join while the leader sleeps.
        time.sleep(_window_s())
        with _lock:
            batch.closed = True
            if _open.get(key) is batch:
                del _open[key]
        merged = batch.qs[0] if len(batch.qs) == 1 else np.concatenate(batch.qs, axis=0)
        try:
            batch.results = impl(merged, subset_paths, top_k, max_distance)
            if len(batch.qs) > 1:
                with _lock:
                    _stats[0] += 1
                    _stats[1] += merged.shape[0]
        except BaseException as e:  # noqa: BLE001 - re-raised to the leader below
            batch.error = e
        finally:
            batch.done.set()
        if batch.error is not None:
            raise batch.error
        return batch.results[start : start + qs.shape[0]]

    # Follower: wait for the leader's scan (generously: the leader may be
    # paying a cold build); on its error or a timeout, run directly on this
    # caller's own store.
    if not batch.done.wait(timeout=3600.0) or batch.error is not None:
        return impl(qs, subset_paths, top_k, max_distance)
    return batch.results[start : start + qs.shape[0]]
