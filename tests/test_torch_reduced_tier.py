"""The reduced-dim capacity rungs (reduced-64d, the auto-halved 32d and an
explicit sub-32 rung) of the port's store against the JAX package's and
brute force, on the same numpy embeddings.

Both packages must pick the same rung for the same budget, and serve the
same hits, top-k and threshold (``-m``), whole store and masked subset.
Distances: within 1e-6 of the JAX package's (each re-ranks, in numpy, a
candidate pool its own f32 scan selected) and within 1e-5 of brute force.
Also ported: the clustered-corpus recall regression, the residual column's
upper-bound property and its overflow rebuild, threshold completeness, and
the hard completion-margin mode (the scenarios of
``tests/test_reduced32_rung.py`` and ``tests/test_reduced_optimistic.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

JAX_ATOL = 1e-6
EXACT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SEMTOOLS_TPU_REDUCED_DIM", "SEMTOOLS_TPU_STORE_INT4", "SEMTOOLS_TPU_STORE_INT8",
                "SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", "SEMTOOLS_TPU_DEVICE_CACHE_BYTES",
                "SEMTOOLS_TPU_SUBSET_DEVICE", "SEMTOOLS_TPU_BUILD"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    device_cache.invalidate()
    jax_device_cache.invalidate()
    yield
    device_cache.invalidate()
    jax_device_cache.invalidate()


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, n_clusters, noise=0.15):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, n_clusters, n)]
    x = x + noise * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture()
def make(tmp_path):
    """make(docs) -> (JAX store, port store), both holding ``docs``
    ({path: rows}) in their own directory."""
    opened = []

    def _make(docs, dim):
        j = JaxStore(str(tmp_path / "jax"), dim=dim)
        t = Store(str(tmp_path / "torch"), dim=dim, device="cpu")
        for s in (j, t):
            s.upsert_documents_bulk(list(docs.items()))
        opened.extend((j, t))
        return j, t

    yield _make
    for s in opened:
        s.close()


def _brute(docs, paths, q, top_k, max_distance=None):
    """[(path, line)] and distances of the exact scan (ties: lower index)."""
    rows = np.concatenate([docs[p] for p in paths])
    owner = [(p, i) for p in paths for i in range(docs[p].shape[0])]
    d = 1.0 - rows @ q
    order = np.argsort(d, kind="stable")[:top_k]
    if max_distance is not None:
        order = order[d[order] < max_distance]
    return [owner[o] for o in order], d[order]


def _check(j, t, docs, paths, qs, top_k, max_distance=None):
    want = j.search_line_embeddings_batched(qs, paths, top_k, max_distance)
    got = t.search_line_embeddings_batched(qs, paths, top_k, max_distance)
    for r, (w, g) in enumerate(zip(want, got)):
        hits = [(x.path, x.line_number) for x in g]
        assert hits == [(x.path, x.line_number) for x in w], f"query {r}"
        exact_hits, exact_d = _brute(docs, sorted(paths), qs[r], top_k, max_distance)
        assert sorted(hits) == sorted(exact_hits), f"query {r}: not the exact hits"
        np.testing.assert_allclose([x.distance for x in g], [x.distance for x in w],
                                   atol=JAX_ATOL, rtol=0)
        np.testing.assert_allclose([x.distance for x in g], exact_d, atol=EXACT_ATOL, rtol=0)
    assert any(got)


def _budget(monkeypatch, store, n, bytes_per_row):
    monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(store._slot_rows(n) * bytes_per_row))


def test_rung_policy_matches_jax(make, monkeypatch):
    """Budget ladder at D = 256 (bytes per slot row): int8 256, int4 128,
    reduced-64d 65, reduced-32d 33; an explicit sub-32 rung is honored but
    never auto-halved; below every rung the IVF-PQ tier takes over (with no
    index built, both packages name the device tier that serves in its
    place)."""
    rows = _unit(np.random.default_rng(3), 64, 256)
    j, t = make({"/a.txt": rows}, 256)
    for env, per_row in (({}, 70), ({}, 48), ({}, 33), ({}, 20),
                         ({"SEMTOOLS_TPU_REDUCED_DIM": "8"}, 12),
                         ({"SEMTOOLS_TPU_REDUCED_DIM": "8"}, 4)):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        _budget(monkeypatch, t, 64, per_row)
        monkeypatch.setenv("SEMTOOLS_TPU_ANN_MIN_ROWS", "1")
        assert t._capacity_reduced_dim(64) == j._capacity_reduced_dim(64)
        assert t._use_ann_tier(64) == j._use_ann_tier(64)
        assert t.serving_tier() == j.serving_tier() != "ivf-pq"
        monkeypatch.delenv("SEMTOOLS_TPU_REDUCED_DIM", raising=False)
    _budget(monkeypatch, t, 64, 70)
    assert t.serving_tier() == "int8-mxu-scan-reduced64d"
    _budget(monkeypatch, t, 64, 48)
    assert t.serving_tier() == "int8-mxu-scan-reduced32d"


@pytest.mark.parametrize("rung,per_row,env", [
    ("reduced64d", 70, {}),
    ("reduced32d", 48, {}),
    ("reduced8d", 12, {"SEMTOOLS_TPU_REDUCED_DIM": "8"}),
    ("reduced32d", 48, {"SEMTOOLS_TPU_BUILD": "device"}),  # the torch transform
])
def test_rungs_serve_the_jax_hits(make, monkeypatch, rung, per_row, env):
    rng = np.random.default_rng(11)
    docs = {"/a.txt": _unit(rng, 300, 256), "/b.txt": _unit(rng, 200, 256),
            "/c.txt": _unit(rng, 100, 256)}
    j, t = make(docs, 256)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _budget(monkeypatch, t, 600, per_row)
    assert t.serving_tier() == j.serving_tier() == f"int8-mxu-scan-{rung}"
    qs = _unit(rng, 3, 256)
    qs[0] = docs["/b.txt"][123]
    everything = list(docs)
    _check(j, t, docs, everything, qs, 10)
    _check(j, t, docs, everything, qs, 60)
    thr = float(np.sort(1.0 - docs["/a.txt"] @ qs[1])[5])
    _check(j, t, docs, everything, qs, 1000, max_distance=thr)
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")  # the keep mask
    _check(j, t, docs, ["/a.txt", "/c.txt"], qs, 10)
    sc = patch_cache.get(t, "int8", device=torch.device("cpu"), reduced_dim=int(rung[7:-1]))
    assert sc.corpus.shape == (600, int(rung[7:-1]) + 1)


def test_fragmented_reduced_store_matches_jax(make, monkeypatch):
    """Freed (zero) slots on the reduced rung: a patch, then the same hits."""
    rng = np.random.default_rng(12)
    docs = {f"/d{i}.txt": _unit(rng, 80, 64) for i in range(8)}
    j, t = make(docs, 64)
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "16")
    _budget(monkeypatch, t, 640, 20)
    qs = _unit(rng, 4, 64)
    _check(j, t, docs, list(docs), qs, 8)
    new = _unit(rng, 30, 64)
    for s in (j, t):
        s.delete_documents(["/d2.txt"])
        s.upsert_document_lines("/d5.txt", new)
    del docs["/d2.txt"]
    docs["/d5.txt"] = new
    assert t.fragmentation()[1] > t.fragmentation()[0]
    _check(j, t, docs, list(docs), qs, 8)
    _check(j, t, docs, list(docs), qs, 40)


@pytest.mark.parametrize("per_row", [48, 300])
def test_hard_margin_mode_matches_default(make, monkeypatch, per_row):
    """SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS=hard serves the same exact results as
    the default margin, on the reduced-32d rung (48 B/row) and the full int8
    tier (300), as in the JAX package."""
    rows = _unit(np.random.default_rng(7), 200, 256)
    docs = {"/a.txt": rows}
    j, t = make(docs, 256)
    _budget(monkeypatch, t, 200, per_row)
    qs = rows[50:51]
    base = t.search_line_embeddings_batched(qs, ["/a.txt"], 7)
    device_cache.invalidate()
    jax_device_cache.invalidate()
    monkeypatch.setenv("SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", "hard")
    hard = t.search_line_embeddings_batched(qs, ["/a.txt"], 7)
    assert [x.line_number for x in hard[0]] == [x.line_number for x in base[0]]
    _check(j, t, docs, ["/a.txt"], qs, 7)


def test_clustered_corpus_beyond_rd_recall_exact(make, monkeypatch):
    """More clusters (64) than projection dims (16): every query's top-10
    equals brute force and the JAX package's."""
    rng = np.random.default_rng(42)
    d, n = 64, 12000
    rows = _clustered(rng, n, d, 64)
    docs = {f"/doc{i}.txt": rows[i * 1500 : (i + 1) * 1500] for i in range(8)}
    j, t = make(docs, d)
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "16")
    _budget(monkeypatch, t, n, 24)
    assert t.serving_tier().endswith("reduced16d")
    qs = rows[rng.integers(0, n, 8)] + 0.05 * rng.standard_normal((8, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    _check(j, t, docs, list(docs), qs, 10)


def test_residual_column_bounds_and_overflow_rebuild(make, monkeypatch):
    """(1) The stored residual column times resid_scale upper-bounds every
    live row's projection residual. (2) Rows whose residual overflows the
    column's ceiling make the next query rebuild (refit), and results stay
    exact."""
    rng = np.random.default_rng(3)
    d, n = 32, 600
    basis = rng.standard_normal((4, d)).astype(np.float32)
    rows = rng.standard_normal((n, 4)).astype(np.float32) @ basis
    rows += 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    docs = {"/a.txt": rows}
    j, t = make(docs, d)
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "8")
    _budget(monkeypatch, t, n, 12)
    _check(j, t, docs, ["/a.txt"], rows[:2], 3)
    sc = patch_cache.get(t, "int8", device=torch.device("cpu"), reduced_dim=8)
    proj = rows @ sc.rotation
    r = np.sqrt(np.maximum(np.einsum("ij,ij->i", rows, rows)
                           - np.einsum("ij,ij->i", proj, proj), 0.0))
    col = sc.corpus.numpy()[:n, 8].astype(np.float64) * sc.resid_scale
    assert np.all(col >= r - 1e-6)

    ortho = rng.standard_normal((40, d)).astype(np.float32)
    ortho -= (ortho @ np.linalg.pinv(basis)) @ basis
    ortho = (ortho / np.linalg.norm(ortho, axis=1, keepdims=True)).astype(np.float32)
    for s in (j, t):
        s.upsert_document_lines("/b.txt", ortho)
    docs["/b.txt"] = ortho
    _check(j, t, docs, ["/a.txt", "/b.txt"], ortho[7:8], 5)
    refit = patch_cache.get(t, "int8", device=torch.device("cpu"), reduced_dim=8)
    assert refit.patched_rows == 0 and refit.resid_scale > sc.resid_scale


def test_threshold_mode_complete_on_clustered_reduced(make, monkeypatch):
    rng = np.random.default_rng(9)
    d, n = 64, 6000
    rows = _clustered(rng, n, d, 48)
    docs = {"/a.txt": rows}
    j, t = make(docs, d)
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "16")
    _budget(monkeypatch, t, n, 24)
    q = rows[100] + 0.03 * rng.standard_normal(d).astype(np.float32)
    q /= np.linalg.norm(q)
    thr = float(np.sort(1.0 - rows @ q)[25])  # a cut inside the neighbour shell
    _check(j, t, docs, ["/a.txt"], q[None], 1000, max_distance=thr)
