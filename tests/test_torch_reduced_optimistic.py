"""``tests/test_reduced_optimistic.py`` on the port: the reduced tier's
residual-norm column. A clustered corpus with more cluster directions than
the projection dim must be served exactly; the stored column times
``resid_scale`` must bound every row's true residual; rows whose residual
overflows the column's ceiling must make the patch rebuild rather than serve
a stale bound; threshold mode must be complete.

The oracle is exact (numpy f32 distances, stable order). The same seeded
rows also go through the JAX package's store: served lines equal, distances
within 1e-6 (the store files' f32 tolerance), the residual column's values
equal. ``patch_cache.get`` is called by keyword (its JAX counterpart takes
``reduced_dim`` third; the port refuses a positional one).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store import patch_cache as jax_patch_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

ATOL = 1e-6
PORT = SimpleNamespace(cache=device_cache, Store=Store,
                       get=lambda s, rd: patch_cache.get(s, "int8", reduced_dim=rd))
JAX = SimpleNamespace(cache=jax_device_cache, Store=JaxStore,
                      get=lambda s, rd: jax_patch_cache.get(s, "int8", rd))


@pytest.fixture(autouse=True)
def clean_cache(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    for c in (device_cache, jax_device_cache):
        c.invalidate()
    yield
    for c in (device_cache, jax_device_cache):
        c.invalidate()


@pytest.fixture(autouse=True)
def rung_env(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.delenv("SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", raising=False)


def _clustered(rng, n, d, n_clusters, noise=0.15):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    cid = rng.integers(0, n_clusters, n)
    x = centers[cid] + noise * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _lines(res):
    return [(rl.path, rl.line_number, rl.distance) for rl in res]


def _same(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], atol=ATOL, rtol=0)


def test_clustered_corpus_beyond_rd_recall_exact(tmp_path, monkeypatch):
    """Clusters (64) >> rd (16): every query's top-10 must equal brute
    force, with exact distances."""
    rng = np.random.default_rng(42)
    d, n = 64, 24000
    rows = _clustered(rng, n, d, 64)
    per_doc = n // 8
    # in-cluster queries: perturbed corpus rows (large q_perp regime)
    qi = rng.integers(0, n, 16)
    qs = rows[qi] + 0.05 * rng.standard_normal((16, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)

    def body(P, dd):
        monkeypatch.delenv("SEMTOOLS_TPU_REDUCED_DIM", raising=False)
        monkeypatch.delenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", raising=False)
        s = P.Store(str(dd / "ws"), dim=d)
        paths = []
        for i in range(8):
            p = f"/doc{i}.txt"
            s.upsert_document_lines(p, rows[i * per_doc : (i + 1) * per_doc])
            paths.append(p)
        monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "16")
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(s._slot_rows(n) * 24))
        assert s.serving_tier(n).endswith("reduced16d")
        res = s.search_line_embeddings_batched(qs, paths, top_k=10)
        s.close()
        return res

    res = body(PORT, tmp_path / "port")
    exact = 1.0 - rows @ qs.T  # [n, Q]
    for r in range(16):
        order = np.argsort(exact[:, r], kind="stable")[:10]
        got = [int(rl.path[4:-4]) * per_doc + rl.line_number for rl in res[r]]
        assert got == list(order), f"query {r}: recall break"
        np.testing.assert_allclose([rl.distance for rl in res[r]], exact[order, r], atol=1e-5)
    for g, w in zip(res, body(JAX, tmp_path / "jax")):
        _same(_lines(g), _lines(w))


def test_residual_column_is_upper_bound_and_serving_survives_patch(tmp_path, monkeypatch):
    """(1) The stored residual column times resid_scale upper-bounds every
    live row's true projection residual. (2) Upserting rows whose residual
    overflows the column's ceiling (127*resid_scale) must NOT serve through
    a stale bound: the patch bails to a rebuild that refits, and results
    stay brute-force exact."""
    rng = np.random.default_rng(3)
    d, n = 32, 600
    # base data in a low-dim subspace + small noise: residuals tiny
    basis = rng.standard_normal((4, d)).astype(np.float32)
    coef = rng.standard_normal((n, 4)).astype(np.float32)
    rows = coef @ basis + 0.01 * rng.standard_normal((n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    # rows nearly orthogonal to the fitted subspace: residual ~1, far
    # beyond the headroom fitted on ~0.01-residual data
    ortho = rng.standard_normal((40, d)).astype(np.float32)
    ortho -= (ortho @ np.linalg.pinv(basis)) @ basis
    ortho = ortho.astype(np.float32)
    ortho /= np.linalg.norm(ortho, axis=1, keepdims=True)

    def body(P, dd):
        monkeypatch.delenv("SEMTOOLS_TPU_REDUCED_DIM", raising=False)
        monkeypatch.delenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", raising=False)
        s = P.Store(str(dd / "ws"), dim=d)
        s.upsert_document_lines("/a.txt", rows)
        monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "8")
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(s._slot_rows(n) * 12))
        assert s.serving_tier().endswith("reduced8d")
        s.search_line_embeddings(rows[0], ["/a.txt"], top_k=3)  # warm the entry

        sc = P.get(s, 8)
        assert sc is not None and sc.resid_scale is not None
        proj = rows @ sc.rotation
        r = np.sqrt(np.maximum(
            np.einsum("ij,ij->i", rows, rows)
            - np.einsum("ij,ij->i", proj, proj), 0.0))
        corpus = sc.corpus.cpu().numpy() if torch.is_tensor(sc.corpus) else np.asarray(sc.corpus)
        col = corpus[:n, 8].astype(np.float64) * sc.resid_scale
        assert np.all(col >= r - 1e-6)

        s.upsert_document_lines("/b.txt", ortho)
        all_rows = np.concatenate([rows, ortho])
        q = ortho[7]
        got = s.search_line_embeddings(q, ["/a.txt", "/b.txt"], top_k=5)
        exact = 1.0 - all_rows @ q
        order = np.argsort(exact, kind="stable")[:5]
        want = [("/b.txt", int(o - n)) if o >= n else ("/a.txt", int(o)) for o in order]
        assert [(rl.path, rl.line_number) for rl in got] == want
        for rl, o in zip(got, order):
            np.testing.assert_allclose(rl.distance, exact[o], atol=1e-5)
        s.close()
        return _lines(got), corpus[:n, 8].copy(), float(sc.resid_scale)

    got, col, scale = body(PORT, tmp_path / "port")
    want, jax_col, jax_scale = body(JAX, tmp_path / "jax")
    _same(got, want)
    np.testing.assert_array_equal(col, jax_col)
    assert scale == pytest.approx(jax_scale, rel=1e-6)


def test_residual_get_refuses_a_positional_reduced_dim(tmp_path, monkeypatch):
    """The JAX-style call ``patch_cache.get(s, "int8", 8)`` passes
    ``reduced_dim`` third; the port's signature makes everything after
    ``kind`` keyword-only, so it raises instead of reading 8 as a device."""
    s = Store(str(tmp_path / "ws"), dim=16)
    s.upsert_document_lines("/a.txt", np.eye(16, dtype=np.float32)[:4])
    with pytest.raises(TypeError):
        patch_cache.get(s, "int8", 8)
    with pytest.raises(TypeError):
        patch_cache.is_warm(s, "int8", 8)
    assert patch_cache.get(s, "int8").kind == "int8"
    assert patch_cache.is_warm(s, "int8")
    s.close()


def test_threshold_mode_complete_on_clustered_reduced(tmp_path, monkeypatch):
    """Threshold mode through the optimistic-bound scan: every
    within-threshold row must be returned."""
    rng = np.random.default_rng(9)
    d, n = 64, 6000
    rows = _clustered(rng, n, d, 48)
    q = rows[100] + 0.03 * rng.standard_normal(d).astype(np.float32)
    q /= np.linalg.norm(q)
    exact = 1.0 - rows @ q
    thr = float(np.sort(exact)[25])  # a cut inside the neighbor shell

    def body(P, dd):
        monkeypatch.delenv("SEMTOOLS_TPU_REDUCED_DIM", raising=False)
        monkeypatch.delenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", raising=False)
        s = P.Store(str(dd / "ws"), dim=d)
        s.upsert_document_lines("/a.txt", rows)
        monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "16")
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(s._slot_rows(n) * 24))
        got = s.search_line_embeddings(q, ["/a.txt"], top_k=1000, max_distance=thr)
        s.close()
        return got

    got = body(PORT, tmp_path / "port")
    want = np.nonzero(exact < thr)[0]
    assert sorted(rl.line_number for rl in got) == sorted(want.tolist())
    _same(_lines(got), _lines(body(JAX, tmp_path / "jax")))
