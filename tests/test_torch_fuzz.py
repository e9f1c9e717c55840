"""Seeded property tests of the port (counterpart of ``test_fuzz.py``).

Three parts, all on the CPU with fixed seeds:

- kernels against the JAX package: random shapes through the port's scan
  entry points (each kernel wrapper runs its plain version on CPU tensors)
  against the JAX package's functions, Pallas in interpret mode: the fused
  top-k and ``topk_scan`` against ``pallas_topk_scan``, threshold against
  top-k, the int8 and int4 selections. Indices equal, distances within 1e-5;
- the port's store under random operation sequences against a brute-force
  model, at the default tier and on every tier of the soak
  (``semtools_tpu_torch.soak.campaigns.TIERS``);
- the port's store against the JAX package's store: one random operation
  sequence through both, every search the same (path, line) hits in the same
  order with distances within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu.ops import int4_scan as jax_int4
from semtools_tpu.ops import int8_scan as jax_int8
from semtools_tpu.ops.pallas_scan import pallas_topk_scan
from semtools_tpu.ops.scan import threshold_scan as jax_threshold_scan
from semtools_tpu.ops.scan import topk_scan as jax_topk_scan
from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.ops import int4_scan, int8_scan
from semtools_tpu_torch.ops.fused_scan import fused_topk_scan
from semtools_tpu_torch.ops.scan import threshold_scan, topk_scan
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.soak.campaigns import CLEAR, TIERS, tier_label
from semtools_tpu_torch.store import device_cache
from semtools_tpu_torch.store.store import Store

T = torch.from_numpy


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.where(norms > 0, norms, 1.0)


# -- kernels against the JAX package -------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_fused_and_plain_scans_match_pallas_random_shapes(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 6000))
    d = int(rng.choice([16, 64, 256]))
    k = int(rng.integers(1, 12))
    qn = int(rng.integers(1, 5))
    e = _unit(rng, n, d)
    if rng.random() < 0.3 and n > 3:
        e[rng.integers(0, n)] = 0.0  # a zero row (an empty line)
    q = _unit(rng, qn, d)
    d_ref, i_ref = pallas_topk_scan(q, e, k, interpret=True)
    for fn in (topk_scan, fused_topk_scan):
        dist, idx = fn(T(q), T(e), k)
        np.testing.assert_array_equal(idx.numpy(), i_ref)
        np.testing.assert_allclose(dist.numpy(), d_ref, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_threshold_consistent_with_topk(seed):
    # every threshold hit of rank < k is in the top-k, in order; and both
    # equal the JAX package's
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(10, 3000))
    e = _unit(rng, n, 32)
    q = _unit(rng, 1, 32)
    t = float(rng.uniform(0.5, 1.2))
    k = 8
    d_th, i_th = (x.numpy() for x in threshold_scan(T(q), T(e), t))
    d_tk, i_tk = (x.numpy() for x in topk_scan(T(q), T(e), k))
    m = min(len(i_th), min(k, n))
    np.testing.assert_array_equal(i_th[:m], i_tk[0][:m])
    assert np.all(np.diff(d_th) >= -1e-7)
    assert np.all(d_th < t)
    jd_th, ji_th = jax_threshold_scan(q, e, t)
    np.testing.assert_array_equal(i_th, ji_th)
    np.testing.assert_allclose(d_th, jd_th, atol=1e-5)
    jd_tk, ji_tk = jax_topk_scan(q, e, k)
    np.testing.assert_array_equal(i_tk, ji_tk)
    np.testing.assert_allclose(d_tk, jd_tk, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_int8_selection_exact_over_quantized_random(seed):
    rng = np.random.default_rng(400 + seed)
    n = int(rng.integers(5, 4000))
    e = _unit(rng, n, 64)
    e8, es = int8_scan.quantize_global(e)
    q = _unit(rng, int(rng.integers(1, 4)), 64)
    q8, _ = int8_scan.quantize_global(q)
    k = min(int(rng.integers(1, 8)), n)
    dist, idx = int8_scan.int8_topk_scan(T(q), T(e8), es, k)
    int_sims = q8.astype(np.int64) @ e8.astype(np.int64).T
    for qi in range(q.shape[0]):
        np.testing.assert_array_equal(idx[qi].numpy(),
                                      np.argsort(-int_sims[qi], kind="stable")[:k])
    d_ref, i_ref = jax_int8.int8_topk_scan(q, e8, es, k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), i_ref)
    np.testing.assert_allclose(dist.numpy(), d_ref, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_int4_selection_exact_over_quantized_random(seed):
    rng = np.random.default_rng(500 + seed)
    n = int(rng.integers(5, 4000))
    d = int(rng.choice([32, 64]))
    e = _unit(rng, n, d)
    p4, es = int4_scan.quantize_pack_global(e)
    q = _unit(rng, int(rng.integers(1, 4)), d)
    k = min(int(rng.integers(1, 8)), n)
    dist, idx = int4_scan.int4_topk_scan(T(q), T(p4), es, k)
    q8, _ = int8_scan.quantize_global(q)
    int_sims = q8.astype(np.int64) @ int4_scan.unpack_int4(p4).astype(np.int64).T
    for qi in range(q.shape[0]):
        np.testing.assert_array_equal(idx[qi].numpy(),
                                      np.argsort(-int_sims[qi], kind="stable")[:k])
    d_ref, i_ref = jax_int4.int4_topk_scan(q, p4, es, k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), i_ref)
    np.testing.assert_allclose(dist.numpy(), d_ref, atol=1e-5)


# -- store sequences against brute force ---------------------------------------


def _truth(model, keys, q, top_k):
    rows = np.concatenate([model[k2] for k2 in keys], axis=0)
    owner = [(k2, i) for k2 in keys for i in range(len(model[k2]))]
    order = np.argsort(1.0 - rows @ q, kind="stable")[:top_k]
    return [owner[j] for j in order]


@pytest.mark.parametrize("seed", range(3))
def test_store_random_operation_sequences(tmp_path, seed):
    """Random upserts, deletes and searches keep the port's store equal to a
    dict-of-matrices model."""
    rng = np.random.default_rng(300 + seed)
    s = Store(str(tmp_path / f"fz{seed}"), dim=16, device="cpu")
    model = {}
    paths = [f"/doc{i}.txt" for i in range(6)]
    for step in range(25):
        op = rng.random()
        p = paths[int(rng.integers(0, len(paths)))]
        if op < 0.55:  # upsert (new or replacing, random length)
            m = _unit(rng, int(rng.integers(1, 30)), 16)
            s.upsert_document_lines(p, m)
            model[p] = m
        elif op < 0.75 and model:  # delete an existing doc
            victim = list(model)[int(rng.integers(0, len(model)))]
            s.delete_line_embeddings([victim])
            del model[victim]
        elif model:
            q = _unit(rng, 1, 16)[0]
            got = s.search_line_embeddings(q, sorted(model), top_k=3)
            assert [(r.path, r.line_number) for r in got] == _truth(
                model, sorted(model), q, 3), step
        assert s.count_line_embeddings() == sum(len(m2) for m2 in model.values())
    s.close()


@pytest.fixture()
def tier_env(monkeypatch):
    for var in CLEAR:
        monkeypatch.delenv(var, raising=False)
    # the sharded tiers' mesh: 4 CPU shards, as the soak's
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "4")
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)
    device_cache.invalidate()
    yield monkeypatch
    device_cache.invalidate()


@pytest.mark.parametrize("tier", TIERS, ids=[tier_label(t) for t in TIERS])
def test_store_random_sequences_all_tiers(tmp_path, tier_env, tier):
    """The random sequences under every serving tier of the soak: int8, the
    sharded tiers, the reduced rungs, the host scan, forced IVF-PQ, int4
    (forced, sharded and by budget); zero and duplicate rows, content
    hashes (patched corpora), compaction and path subsets; every answer
    equal to brute force."""
    for k, v in tier.items():
        tier_env.setenv(k, v)
    rng = np.random.default_rng(4242)
    s = Store(str(tmp_path / "fz_tier"), dim=16, device="cpu")
    model, hash_model = {}, {}
    paths = [f"/doc{i}.txt" for i in range(6)]
    for step in range(25):
        op = rng.random()
        p = paths[int(rng.integers(0, len(paths)))]
        if op < 0.5:
            m = _unit(rng, int(rng.integers(1, 30)), 16)
            for i in range(len(m)):  # zero rows (empty lines) and duplicates (ties)
                r2 = rng.random()
                if r2 < 0.08:
                    m[i] = 0.0
                elif r2 < 0.2 and i > 0:
                    m[i] = m[int(rng.integers(0, i))]
            hashes = rng.integers(1, 1 << 62, len(m)).astype(np.uint64)
            s.upsert_document_lines(p, m, hashes)
            model[p], hash_model[p] = m, hashes
            if tier.get("SEMTOOLS_TPU_FORCE_ANN") and rng.random() < 0.7:
                s.build_ann_index(force=True)
        elif op < 0.65 and model:
            victim = list(model)[int(rng.integers(0, len(model)))]
            s.delete_line_embeddings([victim])
            del model[victim], hash_model[victim]
        elif op < 0.72:
            s.compact()
        elif model:
            keys = sorted(model)
            q = _unit(rng, 1, 16)[0]
            got = s.search_line_embeddings(q, keys, top_k=3)
            assert [(r.path, r.line_number) for r in got] == _truth(model, keys, q, 3), step
            probe = list(model)[int(rng.integers(0, len(model)))]
            hr = s.get_doc_hash_rows(probe)
            assert hr is not None
            np.testing.assert_array_equal(hr[0], hash_model[probe])
            np.testing.assert_allclose(hr[1], model[probe], atol=1e-6)
            # batched serving, on the whole store and on a path subset
            qs = np.concatenate([q[None], _unit(rng, 2, 16)], axis=0)
            sub = keys[: max(1, len(keys) // 2)] if rng.random() < 0.5 else keys
            per = s.search_line_embeddings_batched(qs, sub, 3)
            for row, rows in enumerate(per):
                assert [(rl.path, rl.line_number) for rl in rows] == _truth(
                    model, sub, qs[row], 3), (step, row)
        assert s.count_line_embeddings() == sum(len(m2) for m2 in model.values())
    s.close()


# -- the port's store against the JAX package's ----------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_store_matches_jax_store(tmp_path, monkeypatch, seed):
    """One random sequence of upserts (zero and duplicate rows), edits,
    deletes and compactions through both packages' stores; every batched
    search (random k, threshold, path subset) gives the same hits in the
    same order, distances within 1e-6."""
    for var in CLEAR:
        monkeypatch.delenv(var, raising=False)
    device_cache.invalidate()
    jax_device_cache.invalidate()
    rng = np.random.default_rng(600 + seed)
    d = 16
    j = JaxStore(str(tmp_path / "jax"), dim=d)
    t = Store(str(tmp_path / "torch"), dim=d, device="cpu")
    docs = {}
    paths = [f"/doc{i}.txt" for i in range(6)]
    searched = 0
    for step in range(30):
        op = rng.random()
        p = paths[int(rng.integers(0, len(paths)))]
        if op < 0.5:
            m = _unit(rng, int(rng.integers(1, 40)), d)
            m[rng.random(len(m)) < 0.08] = 0.0
            if len(m) > 2:
                m[-1] = m[0]
            hashes = rng.integers(1, 1 << 62, len(m)).astype(np.uint64)
            for s in (j, t):
                s.upsert_document_lines(p, m, hashes)
            docs[p] = m
        elif op < 0.62 and docs:
            victim = sorted(docs)[int(rng.integers(0, len(docs)))]
            for s in (j, t):
                s.delete_line_embeddings([victim])
            del docs[victim]
        elif op < 0.68:
            assert j.compact()["slots_reclaimed"] == t.compact()["slots_reclaimed"]
        elif docs:
            keys = sorted(docs)
            if len(keys) > 1 and rng.random() < 0.4:
                keys = keys[: int(rng.integers(1, len(keys)))]
            k = int(rng.choice([1, 3, 10, 70]))
            thr = float(rng.uniform(0.4, 1.4)) if rng.random() < 0.4 else None
            qs = _unit(rng, int(rng.choice([1, 2, 5])), d)
            want = j.search_line_embeddings_batched(qs, keys, k, thr)
            got = t.search_line_embeddings_batched(qs, keys, k, thr)
            assert len(got) == len(want) == len(qs)
            for g, w in zip(got, want):
                assert [(h.path, h.line_number) for h in g] == \
                    [(h.path, h.line_number) for h in w], (step, k, thr)
                np.testing.assert_allclose([h.distance for h in g],
                                           [h.distance for h in w], atol=1e-6)
            searched += 1
    assert searched
    j.close()
    t.close()
    device_cache.invalidate()
    jax_device_cache.invalidate()
