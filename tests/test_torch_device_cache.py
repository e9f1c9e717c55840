"""``tests/test_device_cache.py`` on the port: the device corpus cache's LRU
semantics, ``stats()``, and the store's use of it.

Every case runs its body on both packages (the port on CPU tensors, the JAX
package on numpy and jax arrays) with the same puts, budgets and seeded
numpy rows: ``stats()`` must be equal, entries and bytes both (both count
elements x element size, and ``device_nbytes`` for a slot corpus), and
search results must have the same (path, line) lists in the same order with
distances within 1e-6 (the store files' f32 tolerance). A store's slot corpus
is the one entry whose bytes differ by design: the JAX package allocates its
capacity in buckets, the port slot for slot, so there the entry counts are
held equal and the port's bytes against its corpus tensor's elements x
element size.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

ATOL = 1e-6
PORT = SimpleNamespace(name="port", cache=device_cache, Store=Store,
                       zeros=lambda n: torch.zeros(n, dtype=torch.float32))
JAX = SimpleNamespace(name="jax", cache=jax_device_cache, Store=JaxStore,
                      zeros=lambda n: np.zeros(n, np.float32))


@pytest.fixture(autouse=True)
def clean_cache(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    for c in (device_cache, jax_device_cache):
        c.invalidate()
    yield
    for c in (device_cache, jax_device_cache):
        c.invalidate()


def _both(body, tmp_path):
    """``body(P, dir)`` on the port and on the JAX package: the port's answer,
    held equal to the JAX package's."""
    got = body(PORT, tmp_path / "port")
    want = body(JAX, tmp_path / "jax")
    _same(got, want)
    return got


def _same(got, want):
    if isinstance(want, (list, tuple)) and want and hasattr(want[0], "line_number"):
        assert [(r.path, r.line_number) for r in got] == [(r.path, r.line_number) for r in want]
        np.testing.assert_allclose([r.distance for r in got], [r.distance for r in want],
                                   atol=ATOL, rtol=0)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    else:
        assert got == want


def _store_stats(P, s, kind):
    """``stats()`` for the comparison: the entry count; on the port, its
    bytes checked against the cached slot corpus's tensor."""
    n, nbytes = P.cache.stats()
    if P is PORT:
        corpus = patch_cache.get(s, kind).corpus
        assert n == 1 and nbytes == corpus.numel() * corpus.element_size()
    return n


def test_get_or_put_caches(tmp_path):
    def body(P, _):
        calls = []

        def build():
            calls.append(1)
            return np.zeros((4, 4), np.float32) if P is JAX else torch.zeros((4, 4))

        a = P.cache.get_or_put(("k", 1), build)
        b = P.cache.get_or_put(("k", 1), build)
        assert a is b and len(calls) == 1
        return {"calls": len(calls), "stats": P.cache.stats()}

    assert _both(body, tmp_path)["stats"] == (1, 64)


def test_lru_eviction(monkeypatch, tmp_path):
    monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(3 * 64))

    def body(P, _):
        for i in range(5):
            P.cache.get_or_put(("k", i), lambda: P.zeros(16))  # 64 B
        n, total = P.cache.stats()
        assert n <= 3 and total <= 3 * 64
        full = (n, total)
        # oldest keys evicted
        calls = []
        P.cache.get_or_put(("k", 0), lambda: (calls.append(1), P.zeros(16))[1])
        assert calls == [1]
        return {"full": full, "after": P.cache.stats()}

    _both(body, tmp_path)


def test_oversized_entry_not_cached(monkeypatch, tmp_path):
    monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "8")

    def body(P, _):
        out = P.cache.get_or_put(("big", 0), lambda: P.zeros(100))
        assert tuple(out.shape) == (100,)
        assert P.cache.stats()[0] == 0
        return P.cache.stats()

    _both(body, tmp_path)


def test_store_full_scan_uses_cache_and_respects_generation(tmp_path):
    def body(P, d):
        s = P.Store(str(d / "ws"), dim=16)
        rng = np.random.default_rng(0)
        rows = rng.standard_normal((20, 16)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        s.upsert_document_lines("/a.txt", rows)

        q = rows[3]
        got1 = s.search_line_embeddings(q, ["/a.txt"], top_k=1)
        assert got1[0].line_number == 3
        n1 = _store_stats(P, s, "f32")
        assert n1 == 1

        # same generation -> cache hit (entry count unchanged)
        s.search_line_embeddings(q, ["/a.txt"], top_k=1)
        assert P.cache.stats()[0] == 1

        # mutation bumps generation -> the entry is PATCHED in place (still
        # one entry), and fresh data is served
        rows2 = rows.copy()
        rows2[5] = rows[3]
        s.upsert_document_lines("/a.txt", rows2)
        got2 = s.search_line_embeddings(q, ["/a.txt"], top_k=2)
        assert {rl.line_number for rl in got2} == {3, 5}
        assert P.cache.stats()[0] == 1
        n2 = _store_stats(P, s, "f32")
        s.close()
        return {"got1": got1, "got2": got2, "stats1": n1, "stats2": n2}

    _both(body, tmp_path)


def test_nbytes_counts_tuple_entries(monkeypatch, tmp_path):
    # store entries are (array, n_true) tuples; byte accounting must see them
    monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(2 * 64))

    def body(P, _):
        for i in range(4):
            P.cache.get_or_put(("t", i), lambda: (P.zeros(16), 16))
        n, total = P.cache.stats()
        assert n <= 2 and total <= 2 * 64
        return (n, total)

    assert _both(body, tmp_path) == (2, 128)


def test_int8_tier_env_gated(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")

    def body(P, d):
        s = P.Store(str(d / "wsq"), dim=32)
        rng = np.random.default_rng(7)
        rows = rng.standard_normal((40, 32)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        s.upsert_document_lines("/q.txt", rows)
        q = rows[11]
        got = s.search_line_embeddings(q, ["/q.txt"], top_k=3)
        assert got[0].line_number == 11
        assert got[0].distance < 1e-5  # exact rerank reports f32 distances
        # entries: one int8-keyed cache entry
        keys_hit = _store_stats(P, s, "int8")
        assert keys_hit >= 1
        # threshold mode serves exact hits
        got_t = s.search_line_embeddings(q, ["/q.txt"], top_k=5, max_distance=0.5)
        assert any(rl.line_number == 11 for rl in got_t)
        s.close()
        return {"got": got, "got_t": got_t, "stats": keys_hit}

    _both(body, tmp_path)


def test_int8_tier_multi_doc_slot_mapping(tmp_path, monkeypatch):
    # Regression: docs upserted in non-alphabetical path order produce
    # slot-ordered != path-ordered ranges; the int8 tier must map scan
    # rows back through SLOT order or it returns wrong paths/lines.
    def body(P, d):
        monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")
        s = P.Store(str(d / "wsm"), dim=32)
        rng = np.random.default_rng(8)
        rows_b = rng.standard_normal((40, 32)).astype(np.float32)
        rows_b /= np.linalg.norm(rows_b, axis=1, keepdims=True)
        rows_a = rng.standard_normal((40, 32)).astype(np.float32)
        rows_a /= np.linalg.norm(rows_a, axis=1, keepdims=True)
        s.upsert_document_lines("/b.txt", rows_b)  # slots 0-39
        s.upsert_document_lines("/a.txt", rows_a)  # slots 40-79

        q = rows_a[11]
        got = s.search_line_embeddings(q, ["/a.txt", "/b.txt"], top_k=1)
        assert (got[0].path, got[0].line_number) == ("/a.txt", 11)
        assert got[0].distance < 1e-5

        # result also matches the exact tier
        monkeypatch.delenv("SEMTOOLS_TPU_STORE_INT8")
        P.cache.invalidate()
        exact = s.search_line_embeddings(q, ["/a.txt", "/b.txt"], top_k=1)
        assert (exact[0].path, exact[0].line_number) == ("/a.txt", 11)
        s.close()
        return {"got": got, "exact": exact}

    _both(body, tmp_path)


def test_full_store_cache_order_independent(tmp_path):
    # The (dir, generation) cache key assumes a canonical gather order;
    # two full-store queries with different caller path orders must agree.
    def body(P, d):
        s = P.Store(str(d / "wso"), dim=16)
        rng = np.random.default_rng(9)
        for name in ("/z.txt", "/m.txt", "/a.txt"):
            rows = rng.standard_normal((10, 16)).astype(np.float32)
            rows /= np.linalg.norm(rows, axis=1, keepdims=True)
            s.upsert_document_lines(name, rows)
        q = np.asarray(s._mmap("r")[13])  # some stored row
        r1 = s.search_line_embeddings(q, ["/z.txt", "/m.txt", "/a.txt"], top_k=1)
        r2 = s.search_line_embeddings(q, ["/a.txt", "/z.txt", "/m.txt"], top_k=1)
        assert (r1[0].path, r1[0].line_number) == (r2[0].path, r2[0].line_number)
        assert r1[0].distance < 1e-5
        s.close()
        return {"r1": r1, "r2": r2}

    _both(body, tmp_path)
