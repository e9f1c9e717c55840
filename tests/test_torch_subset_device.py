"""``tests/test_subset_device.py`` on the port: path-subset queries served
from the warm slot corpus with a keep mask must equal the compact path (the
subset's rows gathered and scanned exactly) on every tier, ship zero bytes
once warm, re-upload the mask after a mutation, stay compact when cold or on
the IVF-PQ tier, and never duplicate a row when top_k exceeds the subset.

Each store case runs its body on both packages with the same seeded numpy
rows: the port's served lists must equal the JAX package's, (path, line) in
order, distances within 1e-6 (the store files' f32 tolerance). The masked
scan primitives take tensors here; their numpy oracle (a stable argsort of
the exact f32 distances) is exact, and the JAX package's scans on the same
arrays must agree with it too, so the two primitive cases keep that oracle
alone.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store import patch_cache as jax_patch_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

ATOL = 1e-6


def _port_warm(s):
    kind, rd = s._device_kind(s.count_line_embeddings())
    return patch_cache.is_warm(s, kind, reduced_dim=rd)


def _jax_warm(s):
    return jax_patch_cache.is_warm(s, *s._device_kind(s.count_line_embeddings()))


PORT = SimpleNamespace(cache=device_cache, pc=patch_cache, Store=Store, warm=_port_warm)
JAX = SimpleNamespace(cache=jax_device_cache, pc=jax_patch_cache, Store=JaxStore,
                      warm=_jax_warm)


def _unit(rng, n, d=32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(autouse=True)
def _clean_cache(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "8")  # the 8 CPU devices conftest.py gives jax
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)
    for c in (device_cache, jax_device_cache):
        c.invalidate()
    yield
    for c in (device_cache, jax_device_cache):
        c.invalidate()


def _filled(P, d):
    s = P.Store(str(d / "ws"), dim=32)
    rng = np.random.default_rng(5)
    docs = {}
    for name, n in [("/a.txt", 300), ("/b.txt", 500), ("/c.txt", 7), ("/d.txt", 190)]:
        rows = _unit(rng, n)
        s.upsert_document_lines(name, rows)
        docs[name] = rows
    return s, docs


def _both(body, tmp_path):
    got = body(PORT, tmp_path / "port")
    want = body(JAX, tmp_path / "jax")
    _assert_same(got, want, atol=ATOL)
    return got


def _assert_same(a_per, b_per, atol=1e-5):
    assert len(a_per) == len(b_per)
    for a, b in zip(a_per, b_per):
        assert [(x.path, x.line_number) for x in a] == [
            (y.path, y.line_number) for y in b
        ]
        for x, y in zip(a, b):
            assert abs(x.distance - y.distance) < atol


def _compact_vs_masked(s, q, subset, top_k, max_distance, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "0")
    ref = s.search_line_embeddings_batched(q, subset, top_k, max_distance)
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")
    got = s.search_line_embeddings_batched(q, subset, top_k, max_distance)
    _assert_same(ref, got)
    return got


SUBSETS = [
    ["/a.txt", "/c.txt"],
    ["/b.txt"],
    ["/c.txt"],  # fewer rows than most top_k values
    ["/a.txt", "/b.txt", "/d.txt"],
]


@pytest.mark.parametrize("subset", SUBSETS)
@pytest.mark.parametrize("top_k,max_distance", [(5, None), (3, 1.0), (20, None)])
def test_f32_subset_matches_compact(tmp_path, monkeypatch, subset, top_k, max_distance):
    def body(P, d):
        s, docs = _filled(P, d)
        q = _unit(np.random.default_rng(1), 3)
        got = _compact_vs_masked(s, q, subset, top_k, max_distance, monkeypatch)
        s.close()
        return got

    _both(body, tmp_path)


@pytest.mark.parametrize("subset", SUBSETS)
@pytest.mark.parametrize("top_k,max_distance", [(5, None), (3, 1.0)])
def test_int8_subset_matches_compact(tmp_path, monkeypatch, subset, top_k, max_distance):
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        q = _unit(np.random.default_rng(2), 2)
        got = _compact_vs_masked(s, q, subset, top_k, max_distance, monkeypatch)
        s.close()
        return got

    _both(body, tmp_path)


@pytest.mark.parametrize("subset", [["/a.txt", "/c.txt"], ["/b.txt"]])
@pytest.mark.parametrize("top_k,max_distance", [(5, None), (3, 1.0)])
def test_reduced_subset_matches_compact(tmp_path, monkeypatch, subset, top_k, max_distance):
    # Shrink the budget so the reduced-int8 capacity tier triggers at
    # this corpus size (dim 32 -> reduced dim 8).
    monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(16 * 1024))
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "8")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT4", "0")  # pin the reduced rung

    def body(P, d):
        s, docs = _filled(P, d)
        kind, rd = s._device_kind(s.count_line_embeddings())
        assert (kind, rd) == ("int8", 8)
        q = _unit(np.random.default_rng(3), 2)
        got = _compact_vs_masked(s, q, subset, top_k, max_distance, monkeypatch)
        s.close()
        return got

    _both(body, tmp_path)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("top_k,max_distance", [(5, None), (4, 1.0)])
def test_sharded_subset_matches_compact(tmp_path, monkeypatch, int8, top_k, max_distance):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "1")
    if int8:
        monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        assert s.serving_tier().startswith("sharded-")
        q = _unit(np.random.default_rng(4), 3)
        got = _compact_vs_masked(s, q, ["/a.txt", "/d.txt"], top_k, max_distance, monkeypatch)
        s.close()
        return got

    _both(body, tmp_path)


def test_warm_subset_ships_zero_bytes(tmp_path, monkeypatch):
    """Once the slot corpus and the subset mask are resident, repeated
    subset queries must not ship a single host->device byte."""
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        q = _unit(np.random.default_rng(6), 2)
        subset = ["/a.txt", "/d.txt"]
        s.search_line_embeddings_batched(q, subset, 5)  # build + mask upload
        u0 = P.pc.uploaded_bytes()
        for _ in range(4):
            got = s.search_line_embeddings_batched(q, subset, 5)
        assert P.pc.uploaded_bytes() == u0
        s.close()
        return got

    _both(body, tmp_path)


def test_mask_reuploaded_after_mutation(tmp_path, monkeypatch):
    """A vector mutation bumps the generation: the stale mask must not be
    reused (it is keyed by generation) and results stay correct."""
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        rng = np.random.default_rng(7)
        q = _unit(rng, 2)
        subset = ["/a.txt", "/c.txt"]
        s.search_line_embeddings_batched(q, subset, 5)
        # replace /c.txt with different content (new slot range)
        s.upsert_document_lines("/c.txt", _unit(rng, 11))
        monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "0")
        ref = s.search_line_embeddings_batched(q, subset, 5)
        monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")
        got = s.search_line_embeddings_batched(q, subset, 5)
        _assert_same(ref, got)
        s.close()
        return got

    _both(body, tmp_path)


def test_cold_small_subset_stays_compact(tmp_path, monkeypatch):
    """Policy: with a cold device corpus, a small subset must NOT trigger
    a whole-store build — the compact per-call upload is cheaper."""
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "auto")

    def body(P, d):
        s, docs = _filled(P, d)
        q = _unit(np.random.default_rng(8), 1)
        assert not P.warm(s)
        got = s.search_line_embeddings_batched(q, ["/c.txt"], 3)
        assert len(got[0]) == 3
        # still cold: the subset query did not build the whole-store corpus
        assert not P.warm(s)
        s.close()
        return got

    _both(body, tmp_path)


def test_subset_top_k_exceeds_subset_rows(tmp_path, monkeypatch):
    """top_k larger than the subset's row count returns every subset row
    exactly once, no filler."""
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        q = _unit(np.random.default_rng(9), 2)
        got = s.search_line_embeddings_batched(q, ["/c.txt"], 50)
        for per in got:
            assert len(per) == 7
            assert sorted((r.path, r.line_number) for r in per) == [
                ("/c.txt", i) for i in range(7)
            ]
        s.close()
        return got

    _both(body, tmp_path)


def test_masked_topk_scan_matches_numpy(rng):
    """Unit check of the masked scan primitive against numpy."""
    import jax.numpy as jnp

    from semtools_tpu.ops.scan import topk_scan as jax_topk_scan
    from semtools_tpu_torch.ops.scan import topk_scan

    e = _unit(rng, 700, d=16)
    q = _unit(rng, 3, d=16)
    mask_np = rng.random(700) < 0.4
    mask_np[:5] = True  # ensure >= k selectable rows
    d, i = topk_scan(torch.from_numpy(q), torch.from_numpy(e), 5,
                     mask=torch.from_numpy(mask_np))
    d_j, i_j = jax_topk_scan(q, e, 5, mask=jnp.asarray(mask_np))
    sims = q @ e.T
    for r in range(3):
        dd = 1.0 - sims[r]
        dd[~mask_np] = np.inf
        order = np.argsort(dd, kind="stable")[:5]
        assert list(i[r].numpy()) == list(order) == list(np.asarray(i_j)[r])
        np.testing.assert_allclose(d[r].numpy(), dd[order], atol=1e-5)


def test_masked_batched_threshold_scan_matches_numpy(rng):
    import jax.numpy as jnp

    from semtools_tpu.ops.scan import batched_threshold_scan as jax_threshold
    from semtools_tpu_torch.ops.scan import batched_threshold_scan

    e = _unit(rng, 400, d=16)
    q = _unit(rng, 2, d=16)
    mask_np = rng.random(400) < 0.5
    per = batched_threshold_scan(torch.from_numpy(q), torch.from_numpy(e), 1.0,
                                 mask=torch.from_numpy(mask_np))
    per_j = jax_threshold(q, e, 1.0, mask=jnp.asarray(mask_np))
    sims = q @ e.T
    for r in range(2):
        dd = 1.0 - sims[r]
        keep = np.nonzero((dd < 1.0) & mask_np)[0]
        order = keep[np.argsort(dd[keep], kind="stable")]
        dists, idxs = per[r]
        assert list(idxs.numpy()) == list(order) == list(np.asarray(per_j[r][1]))
        np.testing.assert_allclose(dists.numpy(), dd[order], atol=1e-5)


def test_int8_masked_filler_does_not_duplicate(tmp_path, monkeypatch):
    """The masked int8 scan's extraction must not emit filler entries that
    repeat an already-extracted real slot when the subset's block opens the
    sub-tile: a subset at top_k > rows returns each row exactly once."""
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        q = _unit(np.random.default_rng(10), 2)
        # /a.txt occupies the store's first slots (upserted first)
        got = s.search_line_embeddings_batched(q, ["/c.txt"], 20)
        for per in got:
            keys = [(r.path, r.line_number) for r in per]
            assert len(keys) == len(set(keys)) == 7, keys
        # and the exact trigger: subset whose block starts at slot 0
        got2 = s.search_line_embeddings_batched(q, ["/a.txt"], 350)
        for per in got2:
            keys = [(r.path, r.line_number) for r in per]
            assert len(keys) == len(set(keys)) == 300, keys
        s.close()
        return got + got2

    _both(body, tmp_path)


def test_ann_scale_store_subset_stays_compact(tmp_path, monkeypatch):
    """On a store served by the ANN tier (nothing fits the device
    budget), a subset query must NOT build an over-budget device corpus
    — the compact path serves it."""
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        q = _unit(np.random.default_rng(11), 1)
        got = s.search_line_embeddings_batched(q, ["/c.txt"], 3)
        assert len(got[0]) == 3
        assert not P.warm(s)
        s.close()
        return got

    _both(body, tmp_path)
