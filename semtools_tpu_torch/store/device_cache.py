"""Device-resident corpus cache for workspace scans.

Counterpart of ``semtools_tpu/store/device_cache.py``: recently scanned
corpora (and subset masks) stay on the device across the searches of one
process, keyed by (store path, ..., generation) — any vector mutation bumps
the generation, so stale entries are never served.

Bounded by bytes with LRU eviction. The budget is
``SEMTOOLS_TPU_DEVICE_CACHE_BYTES``, default 4 GiB as in the JAX package,
and it also sizes the store's tier ladder (``Store._device_budget_bytes``),
so both packages pick the same tier for the same store. An H100-sized
default waits for measurements (ROADMAP). Entries are torch tensors, or
objects with a ``device_nbytes`` attribute (``patch_cache.SlotCorpus``).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Hashable, Tuple

_lock = threading.Lock()
_entries: "OrderedDict[Hashable, Tuple[object, int]]" = OrderedDict()
_total_bytes = 0


def _max_bytes() -> int:
    try:
        return int(os.environ.get("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", 4 << 30))
    except ValueError:
        return 4 << 30


def _nbytes(value) -> int:
    """Bytes held by a tensor or a (possibly nested) tuple/list of them."""
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    if hasattr(value, "device_nbytes"):  # e.g. patch_cache.SlotCorpus
        return int(value.device_nbytes)
    try:
        return int(value.numel()) * int(value.element_size())
    except AttributeError:
        return 0


def _evict_over_budget() -> None:
    """Drop least-recently-used entries until the budget holds (the newest
    entry always stays). Caller holds _lock."""
    global _total_bytes
    while _total_bytes > _max_bytes() and len(_entries) > 1:
        _, (_old, old_size) = _entries.popitem(last=False)
        _total_bytes -= old_size


def peek(key: Hashable):
    """Cached value for ``key`` (refreshing LRU order), or None."""
    with _lock:
        if key in _entries:
            _entries.move_to_end(key)
            return _entries[key][0]
    return None


def replace(key: Hashable, value) -> None:
    """Insert or overwrite ``key`` (re-accounting its byte size)."""
    global _total_bytes
    size = _nbytes(value)
    with _lock:
        if key in _entries:
            _total_bytes -= _entries.pop(key)[1]
        _entries[key] = (value, size)
        _total_bytes += size
        _evict_over_budget()


def remove(key: Hashable) -> None:
    global _total_bytes
    with _lock:
        if key in _entries:
            _total_bytes -= _entries.pop(key)[1]


def get_or_put(key: Hashable, builder: Callable[[], object]):
    """Return the cached value for ``key``, building and caching on miss."""
    global _total_bytes
    with _lock:
        if key in _entries:
            _entries.move_to_end(key)
            return _entries[key][0]
    value = builder()
    size = _nbytes(value)
    if size > _max_bytes():
        return value  # too big to cache; hand it back uncached
    with _lock:
        if key not in _entries:
            _entries[key] = (value, size)
            _total_bytes += size
            _evict_over_budget()
        _entries.move_to_end(key)
        return _entries[key][0]


def invalidate() -> None:
    """Drop every entry."""
    global _total_bytes
    with _lock:
        _entries.clear()
        _total_bytes = 0
