"""The port's workspace store (semtools_tpu_torch.store) against the JAX
package's (semtools_tpu.store), on the same numpy embeddings.

Both stores receive the same documents through ``upsert_documents_bulk``
(and the same metadata, deletes and re-inserts) in separate directories,
then answer the same queries on every serving route: the whole store on the
f32, int8 and int4 tiers, path subsets on the masked slot corpus and on the
compact gather, threshold mode, ``top_k`` wider than a subset, a fragmented
store (freed zero slots) and ``SEMTOOLS_TPU_SCAN=host``. The
``(path, line_number)`` lists must be equal and in the same order. Int8- and
int4-tier distances are bit-equal (both re-rank the same candidates in
numpy); f32 distances agree within 1e-6 (matmul summation order). The
on-disk files are byte-equal, each package serves the other's workspace, and
both name the same serving tier, the sharded one included (the port's mesh
of ``SEMTOOLS_TORCH_VIRTUAL_DEVICES`` CPU shards).

Both sides pin ``SEMTOOLS_TPU_SCAN=device`` (the JAX package's link probe
would otherwise pick the host path on the CPU) and the JAX side
``SEMTOOLS_TPU_SHARDED=0`` (its test session has 8 virtual CPU devices).
"""

from __future__ import annotations

import sqlite3

import numpy as np
import pytest

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import DocMeta as JaxDocMeta
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import DocMeta, Store

DIM = 32
F32_ATOL = 1e-6
DOCS = [("/a.txt", 300), ("/b.txt", 500), ("/c.txt", 7), ("/d.txt", 190)]


def _unit(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_SUBSET_DEVICE",
                "SEMTOOLS_TPU_STORE_INT4", "SEMTOOLS_TPU_FORCE_ANN",
                "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_TPU_REDUCED_DIM"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    device_cache.invalidate()
    jax_device_cache.invalidate()
    yield
    device_cache.invalidate()
    jax_device_cache.invalidate()


def _docs(seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for path, n in DOCS:
        rows = _unit(rng, n)
        rows[n // 3] = 0.0  # an empty line
        hashes = rng.integers(1, 1 << 63, size=n, dtype=np.uint64)
        out.append((path, rows, hashes))
    out[1][1][17] = out[0][1][4]  # an exact duplicate across documents
    return out


def _fill(store, docs, meta_cls):
    store.upsert_documents_bulk(docs)
    store.upsert_document_metadata(
        [meta_cls(p, size_bytes=10 * len(r), mtime=1_700_000_000 + i)
         for i, (p, r, _) in enumerate(docs)])


def _fragment(store, seed=9):
    """Delete a document and write a smaller one into its hole, rewrite
    another: the slot space keeps freed (zero) slots."""
    rng = np.random.default_rng(seed)
    store.delete_documents(["/b.txt"])
    store.upsert_documents_bulk([
        ("/e.txt", _unit(rng, 120), rng.integers(1, 1 << 63, size=120, dtype=np.uint64)),
        ("/a.txt", _unit(rng, 260), None),
    ])


@pytest.fixture()
def stores(tmp_path):
    docs = _docs()
    j = JaxStore(str(tmp_path / "jax"), dim=DIM, model_name="m")
    t = Store(str(tmp_path / "torch"), dim=DIM, model_name="m", device="cpu")
    _fill(j, docs, JaxDocMeta)
    _fill(t, docs, DocMeta)
    yield j, t, docs
    j.close()
    t.close()


def _queries(docs, qn=3, seed=1):
    q = _unit(np.random.default_rng(seed), qn)
    q[0] = docs[0][1][4]  # exact hit with a duplicate in /b.txt
    return q


def _hits(per):
    return [[(x.path, x.line_number) for x in rows] for rows in per]


def _dists(per):
    return [np.array([x.distance for x in rows], np.float64) for rows in per]


def _assert_same(want, got, exact: bool):
    assert _hits(got) == _hits(want)
    assert any(_hits(want))
    for w, g in zip(_dists(want), _dists(got)):
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_ATOL)


def _use_tier(monkeypatch, tier):
    """Pin the whole-store tier on both sides (int4 outranks int8)."""
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1" if tier == "int8" else "0")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT4", "1" if tier == "int4" else "0")


def _search(j, t, q, subset, top_k, max_distance=None):
    return (j.search_line_embeddings_batched(q, subset, top_k, max_distance),
            t.search_line_embeddings_batched(q, subset, top_k, max_distance))


SUBSETS = {
    "all": [p for p, _ in DOCS],
    "two": ["/a.txt", "/c.txt"],
    "one": ["/b.txt"],
    "small": ["/c.txt"],  # fewer rows than the wider top_k values
}


@pytest.mark.parametrize("tier", ["f32", "int8", "int4"])
@pytest.mark.parametrize("subset", list(SUBSETS))
@pytest.mark.parametrize("subset_device", ["1", "0"])
@pytest.mark.parametrize("top_k,max_distance", [(5, None), (20, None), (10, 0.9)])
def test_search_matches_jax(stores, monkeypatch, tier, subset, subset_device, top_k,
                            max_distance):
    j, t, docs = stores
    _use_tier(monkeypatch, tier)
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", subset_device)
    want, got = _search(j, t, _queries(docs), SUBSETS[subset], top_k, max_distance)
    # the quantized tiers serve whole stores and masked subsets through the
    # numpy re-rank; the compact gather is an f32 scan
    exact = tier != "f32" and (subset == "all" or subset_device == "1")
    _assert_same(want, got, exact)
    assert patch_cache.is_warm(t, tier, t.device) == (subset == "all" or subset_device == "1")
    if subset == "all" and max_distance is None:
        assert [rows[0].distance for rows in got][0] == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("tier", ["f32", "int8", "int4"])
@pytest.mark.parametrize("subset", ["all", "two"])
def test_fragmented_store_matches_jax(stores, monkeypatch, tier, subset):
    j, t, docs = stores
    _fragment(j)
    _fragment(t)
    _use_tier(monkeypatch, tier)
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")
    live, cap = t.fragmentation()
    assert (live, cap) == j.fragmentation() and cap > live
    paths = ["/a.txt", "/c.txt", "/d.txt", "/e.txt"] if subset == "all" else SUBSETS[subset]
    for top_k, max_distance in [(8, None), (40, None), (30, 1.0)]:
        want, got = _search(j, t, _queries(docs, qn=4, seed=3), paths, top_k, max_distance)
        _assert_same(want, got, exact=tier != "f32")


def test_host_scan_matches_jax(stores, monkeypatch):
    j, t, docs = stores
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "host")
    for subset, top_k, max_distance in [("all", 7, None), ("two", 12, 0.95)]:
        want, got = _search(j, t, _queries(docs), SUBSETS[subset], top_k, max_distance)
        _assert_same(want, got, exact=True)  # both score the mmap in numpy


def test_repeated_search_uses_the_cached_corpus(stores, monkeypatch):
    j, t, docs = stores
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")
    q = _queries(docs)
    first = t.search_line_embeddings_batched(q, SUBSETS["two"], 5)
    before = patch_cache.uploaded_bytes()
    again = t.search_line_embeddings_batched(q, SUBSETS["two"], 5)
    assert patch_cache.uploaded_bytes() == before  # corpus and mask cached
    assert _hits(again) == _hits(first)
    t.upsert_documents_bulk([("/c.txt", _unit(np.random.default_rng(2), 9), None)])
    after = t.search_line_embeddings_batched(q, SUBSETS["two"], 5)
    assert patch_cache.uploaded_bytes() > before  # new generation: patched
    j.upsert_documents_bulk([("/c.txt", _unit(np.random.default_rng(2), 9), None)])
    _assert_same(j.search_line_embeddings_batched(q, SUBSETS["two"], 5), after, exact=True)


def _db_rows(store_dir):
    db = sqlite3.connect(store_dir / "store.sqlite")
    try:
        return {table: sorted(db.execute(f"SELECT * FROM {table}").fetchall())
                for table in ("meta", "docs", "free")}
    finally:
        db.close()


def test_disk_format_is_byte_equal(stores, tmp_path):
    j, t, _ = stores
    _fragment(j)
    _fragment(t)
    j.flush()
    t.flush()
    assert _db_rows(tmp_path / "jax") == _db_rows(tmp_path / "torch")
    for name in ("lines.f32", "lines.h64"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()


@pytest.mark.parametrize("tier", ["f32", "int8", "int4"])
def test_cross_reads(stores, tmp_path, monkeypatch, tier):
    """Each package serves the other's workspace with the other's results."""
    j, t, docs = stores
    _use_tier(monkeypatch, tier)
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")
    q = _queries(docs)
    t_on_jax = Store(str(tmp_path / "jax"), dim=DIM, model_name="m", device="cpu")
    j_on_torch = JaxStore(str(tmp_path / "torch"), dim=DIM, model_name="m")
    try:
        for subset in ("all", "two"):
            paths = SUBSETS[subset]
            _assert_same(j.search_line_embeddings_batched(q, paths, 6),
                         t_on_jax.search_line_embeddings_batched(q, paths, 6),
                         exact=tier != "f32")
            _assert_same(t.search_line_embeddings_batched(q, paths, 6),
                         j_on_torch.search_line_embeddings_batched(q, paths, 6),
                         exact=tier != "f32")
        assert t_on_jax.get_existing_docs(["/a.txt"]) == t.get_existing_docs(["/a.txt"])
    finally:
        t_on_jax.close()
        j_on_torch.close()


@pytest.mark.parametrize("env,tier", [
    ({}, "exact-mxu-scan"),
    ({"SEMTOOLS_TPU_STORE_INT8": "1"}, "int8-mxu-scan"),
    ({"SEMTOOLS_TPU_INT8_MIN_ROWS": "500"}, "int8-mxu-scan"),
    ({"SEMTOOLS_TPU_SCAN": "host"}, "host-mmap-scan"),
    # f32 over the device budget, int8 within it
    ({"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(997 * DIM * 2)}, "int8-mxu-scan"),
    ({"SEMTOOLS_TPU_STORE_INT4": "1"}, "int4-mxu-scan"),
    # int8 (DIM B/row) over the device budget, int4 (DIM/2 B/row) within it
    ({"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(997 * DIM * 3 // 4)}, "int4-mxu-scan"),
])
def test_serving_tier_names_match(stores, monkeypatch, env, tier):
    j, t, _ = stores
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert t.serving_tier() == j.serving_tier() == tier
    assert t.get_stats().index_type == tier
    assert t.build_ann_index() is None


@pytest.mark.parametrize("env,what", [
    ({"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(997 * 20), "SEMTOOLS_TPU_STORE_INT4": "0",
      "SEMTOOLS_TPU_REDUCED_DIM": "8"}, "reduced-8d"),
    ({"SEMTOOLS_TPU_FORCE_ANN": "1"}, "IVF-PQ"),
    ({"SEMTOOLS_TPU_SHARDED": "1"}, "sharded"),
])
def test_unported_tiers_raise(stores, monkeypatch, env, what):
    j, t, docs = stores
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if what == "reduced-8d":
        # ported since: both packages serve the rung, with the same hits
        # (distances within F32_ATOL: each re-ranks its own f32-scored pool)
        assert t.serving_tier() == j.serving_tier() == "int8-mxu-scan-reduced8d"
        for subset, top_k, max_distance in (("all", 5, None), ("two", 8, None),
                                            ("all", 10, 0.9)):
            want, got = _search(j, t, _queries(docs), SUBSETS[subset], top_k, max_distance)
            _assert_same(want, got, exact=False)
        return
    if what == "IVF-PQ":
        # ported since: without an index both packages name the device tier
        # that serves in its place; with one each serves it, with the same
        # hits (exact re-rank: distances within F32_ATOL)
        assert t.serving_tier() == j.serving_tier() != "ivf-pq"
        for s in (j, t):
            s.build_ann_index(force=True)
        assert t.serving_tier() == j.serving_tier() == "ivf-pq"
        for subset, top_k, max_distance in (("all", 5, None), ("two", 8, None),
                                            ("all", 10, 0.9)):
            want, got = _search(j, t, _queries(docs), SUBSETS[subset], top_k, max_distance)
            _assert_same(want, got, exact=False)
        return
    # sharded serving, ported since: SEMTOOLS_TPU_SHARDED=1 on a one-device
    # mesh serves the single-device tier, as the JAX package does with fewer
    # than two devices (its session has 8: SEMTOOLS_TPU_SHARDED=0 pins it to
    # one); on an 8-shard mesh both name the sharded int8 tier. Same hits on
    # both meshes (int8 re-rank: distances bit-equal).
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")
    for shards, tier in ((1, "int8-mxu-scan"), (8, "sharded-int8-scan[8]")):
        monkeypatch.setattr(torch_mesh, "_VIRTUAL", shards)
        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0" if shards == 1 else "1")
        want = [j.search_line_embeddings_batched(_queries(docs), SUBSETS[sub], k, m)
                for sub, k, m in (("all", 5, None), ("two", 8, None), ("all", 10, 0.9))]
        assert j.serving_tier() == tier  # after a search: its device count is real
        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "1")
        assert t.serving_tier() == tier
        got = [t.search_line_embeddings_batched(_queries(docs), SUBSETS[sub], k, m)
               for sub, k, m in (("all", 5, None), ("two", 8, None), ("all", 10, 0.9))]
        for w, g in zip(want, got):
            _assert_same(w, g, exact=True)
