"""On-disk damage to the port's store must fail loudly (or degrade cleanly),
never crash, hang or silently serve a part of the corpus (counterpart of
``test_store_corruption.py``, the same cases, exceptions and messages).

sqlite is the source of truth for slot ranges and the vector file must cover
them (copy-on-write commits rows only after the file grew), so any shortfall
is permanent damage (``StoreDamagedError``), told apart from the retryable
stale-snapshot faults a concurrent compact causes.
"""

from __future__ import annotations

import os
import sqlite3

import numpy as np
import pytest

from semtools_tpu_torch.store.store import Store, StoreDamagedError


@pytest.fixture()
def small_store(tmp_path):
    s = Store(str(tmp_path / "ws"), dim=32, device="cpu")
    rng = np.random.default_rng(0)
    items = []
    for i in range(4):
        x = rng.standard_normal((50, 32)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        items.append((f"/doc{i}.txt", x))
    s.upsert_documents_bulk(items)
    q = rng.standard_normal((1, 32)).astype(np.float32)
    q /= np.linalg.norm(q)
    yield s, [p for p, _ in items], q
    s.close()


def _fresh(store: Store) -> Store:
    path = str(store.dir)
    store.close()
    return Store(path, dim=32, device="cpu")


def test_truncated_vector_file_raises_damage(small_store):
    s, paths, q = small_store
    vec = s.vec_path
    s = _fresh(s)
    os.truncate(vec, os.path.getsize(vec) // 2)
    with pytest.raises(StoreDamagedError, match="truncated or partially copied"):
        s.search_line_embeddings_batched(q, paths, 5)
    s.close()


def test_zero_length_vector_file_raises_damage(small_store):
    s, paths, q = small_store
    vec = s.vec_path
    s = _fresh(s)
    os.truncate(vec, 0)
    with pytest.raises(StoreDamagedError):
        s.search_line_embeddings_batched(q, paths, 5)
    s.close()


def test_damage_not_masked_by_stale_snapshot_retry(small_store):
    """StoreDamagedError must not be caught by the search's retry (it retries
    FileNotFoundError/IndexError/ValueError once): damage is permanent, and
    a second pass over it must not turn it into another exception."""
    s, paths, q = small_store
    vec = s.vec_path
    os.truncate(vec, os.path.getsize(vec) - 64)
    s._ranges_cache = None  # drop the snapshot taken by the upsert
    with pytest.raises(StoreDamagedError):
        s.search_line_embeddings_batched(q, paths, 5)
    s.close()


def test_deleted_vector_file_fails_cleanly(small_store):
    s, paths, q = small_store
    vec = s.vec_path
    s = _fresh(s)
    os.unlink(vec)
    with pytest.raises(FileNotFoundError, match="vector epoch file missing"):
        s.search_line_embeddings_batched(q, paths, 5)
    s.close()


def test_missing_hash_sidecar_degrades_to_no_reuse(small_store):
    """The lines.h64 sidecar only funds line-level reuse: without it the
    search results stay as they were."""
    s, paths, q = small_store
    before = s.search_line_embeddings_batched(q, paths, 5)
    hashes = s.hash_path
    s = _fresh(s)
    os.unlink(hashes)
    after = s.search_line_embeddings_batched(q, paths, 5)
    assert [(r.path, r.line_number) for r in after[0]] == [
        (r.path, r.line_number) for r in before[0]
    ]
    s.close()


def test_garbage_sqlite_fails_cleanly(tmp_path):
    s = Store(str(tmp_path / "ws"), dim=32, device="cpu")
    s.upsert_documents_bulk([("/d.txt", np.eye(8, 32, dtype=np.float32))])
    db_file = next(p for p in s.dir.iterdir() if p.suffix == ".sqlite")
    s.close()
    db_file.write_bytes(b"not a database at all")
    with pytest.raises(sqlite3.DatabaseError):
        s2 = Store(str(tmp_path / "ws"), dim=32, device="cpu")
        s2.search_line_embeddings_batched(np.eye(1, 32, dtype=np.float32), ["/d.txt"], 3)


def test_intact_store_unaffected_by_integrity_gate(small_store):
    s, paths, q = small_store
    res = s.search_line_embeddings_batched(q, paths, 5)
    assert len(res[0]) == 5
