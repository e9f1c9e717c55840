"""Portable advisory file locking for the store's cross-process writer lock.

POSIX uses flock (the reference relies on qdrant-edge's own in-process
locking; this framework coordinates multiple CLI processes on one
workspace — store.py `_write_lock`). Windows has no flock: msvcrt.locking
provides mandatory byte-range locks, so the first byte of the lock file
stands in for the whole-file lock. msvcrt has no shared mode — shared
acquisitions degrade to exclusive there, which is CORRECT (strictly more
serialized) just less concurrent; the only shared-lock user is the
line-reuse snapshot read.

msvcrt.LK_LOCK retries ~10x over 10 s then raises; the loop below keeps
blocking indefinitely to match flock(LOCK_EX) semantics.

A copy of ``semtools_tpu/utils/filelock.py``; the port also guards its
kernel builds with it (``ops/kernels.py``).
"""

from __future__ import annotations

import os

if os.name == "nt":  # pragma: no cover - exercised only on Windows CI
    import msvcrt
    import time

    def lock_exclusive(fh) -> None:
        while True:
            try:
                fh.seek(0)
                msvcrt.locking(fh.fileno(), msvcrt.LK_LOCK, 1)
                return
            except OSError:
                time.sleep(0.05)

    def lock_shared(fh) -> None:
        lock_exclusive(fh)

    def unlock(fh) -> None:
        fh.seek(0)
        msvcrt.locking(fh.fileno(), msvcrt.LK_UNLCK, 1)

else:
    import fcntl

    def lock_exclusive(fh) -> None:
        fcntl.flock(fh, fcntl.LOCK_EX)

    def lock_shared(fh) -> None:
        fcntl.flock(fh, fcntl.LOCK_SH)

    def unlock(fh) -> None:
        fcntl.flock(fh, fcntl.LOCK_UN)
