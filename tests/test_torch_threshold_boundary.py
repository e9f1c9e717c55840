"""``tests/test_threshold_boundary.py`` on the port: hit shells planted at
max_distance +- eps, for eps around and below the int8/int4 similarity error,
with and without freed slots ahead of the rows, must be served exactly by the
int8, int4 and reduced tiers; so must a shell far wider than the oversample
window, a dense cluster's top-k and a reduced-tier outlier.

The oracle is exact (a stable argsort of the f32 distances), so each case
holds the port against it; the same corpus (the same seeded numpy rows) also
goes through the JAX package's store, whose lines must be the port's, with
distances within 1e-6 (the store files' f32 tolerance).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.store import device_cache
from semtools_tpu_torch.store.store import Store

DIM = 64
THRESH = 0.3
ATOL = 1e-6
PORT = SimpleNamespace(cache=device_cache, Store=Store)
JAX = SimpleNamespace(cache=jax_device_cache, Store=JaxStore)


@pytest.fixture(autouse=True)
def clean_cache(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    for c in (device_cache, jax_device_cache):
        c.invalidate()
    yield
    for c in (device_cache, jax_device_cache):
        c.invalidate()


def _boundary_corpus(rng, eps_list, per_shell):
    """(query, rows): rows at exact distance THRESH + eps for each eps,
    `per_shell` rows per shell, plus 50 background rows well outside."""
    q = rng.standard_normal(DIM).astype(np.float32)
    q /= np.linalg.norm(q)
    rows = []
    for eps in eps_list:
        a = 1.0 - (THRESH + eps)  # target cosine similarity
        for _ in range(per_shell):
            o = rng.standard_normal(DIM).astype(np.float32)
            o -= (o @ q) * q
            o /= np.linalg.norm(o)
            rows.append(a * q + np.sqrt(max(1.0 - a * a, 0.0)) * o)
    for _ in range(50):
        o = rng.standard_normal(DIM).astype(np.float32)
        o -= (o @ q) * q
        o /= np.linalg.norm(o)
        rows.append(0.2 * q + np.sqrt(1 - 0.04) * o)  # distance 0.8
    rows = np.stack(rows).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return q, rows


EPS = [-2e-2, -1e-2, -1e-3, -1e-4, 1e-4, 1e-3, 1e-2, 2e-2]


def _exact_hits(q, rows, top_k):
    d = 1.0 - rows @ q
    order = np.argsort(d, kind="stable")[:top_k]
    order = order[d[order] < THRESH]
    return [(int(i), float(d[i])) for i in order]


def _fill(P, d, q, rows, junk):
    s = P.Store(str(d / "ws"), dim=DIM)
    if junk is not None:
        s.upsert_document_lines("/junk.txt", junk)
    s.upsert_document_lines("/a.txt", rows)
    if junk is not None:
        s.delete_documents(["/junk.txt"])  # 120 freed slots ahead of /a
    return s


def _corpus(rng, fragmented: bool, per_shell: int = 12):
    q, rows = _boundary_corpus(rng, EPS, per_shell=per_shell)
    junk = None
    if fragmented:
        junk = rng.standard_normal((120, DIM)).astype(np.float32)
        junk /= np.linalg.norm(junk, axis=1, keepdims=True)
    return q, rows, junk


TIERS = [
    ("int8", {"SEMTOOLS_TPU_STORE_INT8": "1"}),
    ("int4", {"SEMTOOLS_TPU_STORE_INT4": "1"}),
    ("reduced", {"SEMTOOLS_TPU_STORE_INT8": "1",
                 "SEMTOOLS_TPU_REDUCED_DIM": "16",
                 "SEMTOOLS_TPU_STORE_INT4": "0",
                 "SEMTOOLS_TPU_DEVICE_CACHE_BYTES": "small"}),
]


def _set_tier(monkeypatch, s, env):
    n = s.count_line_embeddings()
    for k, v in env.items():
        if v == "small":
            # force the reduced capacity rung at this corpus size
            v = str(s._slot_rows(n) * 32)
        monkeypatch.setenv(k, v)
    return n


def _served(P, d, monkeypatch, env, q, rows, junk, top_k, max_distance):
    """The port's or the JAX package's served [(line, distance)] over a
    fresh store of the corpus on the tier ``env`` names."""
    for k in env:
        monkeypatch.delenv(k, raising=False)
    s = _fill(P, d, q, rows, junk)
    _set_tier(monkeypatch, s, env)
    got = s.search_line_embeddings(q, ["/a.txt"], top_k=top_k, max_distance=max_distance)
    kind = s._device_kind(s.count_line_embeddings())
    s.close()
    return [(rl.line_number, rl.distance) for rl in got], kind


def _same_as_jax(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], atol=ATOL, rtol=0)


@pytest.mark.parametrize("fragmented", [False, True])
@pytest.mark.parametrize("tier,env", TIERS, ids=[t[0] for t in TIERS])
@pytest.mark.parametrize("top_k", [5, 40])
def test_threshold_boundary_matches_exact(tmp_path, monkeypatch, tier, env,
                                          fragmented, top_k):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    rng = np.random.default_rng(hash((tier, fragmented, top_k)) % 2**32)
    q, rows, junk = _corpus(rng, fragmented)
    got_pairs, kind = _served(PORT, tmp_path / "port", monkeypatch, env, q, rows, junk,
                              top_k, THRESH)
    if tier == "reduced":
        assert kind == ("int8", 16)
    want = _exact_hits(q, rows, top_k)
    assert [p[0] for p in got_pairs] == [p[0] for p in want], (
        f"{tier} fragmented={fragmented} top_k={top_k}: hit set diverged\n"
        f"got  {got_pairs}\nwant {want}"
    )
    for (gi, gd), (wi, wd) in zip(got_pairs, want):
        assert abs(gd - wd) < 1e-5
    jax_pairs, jax_kind = _served(JAX, tmp_path / "jax", monkeypatch, env, q, rows, junk,
                                  top_k, THRESH)
    assert kind == jax_kind
    _same_as_jax(got_pairs, jax_pairs)


@pytest.mark.parametrize("tier,env", TIERS, ids=[t[0] for t in TIERS])
def test_threshold_boundary_beyond_oversample(tmp_path, monkeypatch, tier, env):
    """The number of rows within quantization noise of the threshold far
    EXCEEDS the tier's calibrated oversample window (4*top_k for int8): the
    candidate pool must grow until it provably holds every within-threshold
    row, or the served top_k can swap a true hit for a noise-tied
    neighbour."""
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    rng = np.random.default_rng(99)
    q, rows, junk = _corpus(rng, fragmented=True, per_shell=100)
    top_k = 5  # oversample window = 20 << ~400 within-threshold rows
    got_pairs, _ = _served(PORT, tmp_path / "port", monkeypatch, env, q, rows, junk,
                           top_k, THRESH)
    want = _exact_hits(q, rows, top_k)
    assert [p[0] for p in got_pairs] == [p[0] for p in want], (
        f"{tier}: adversarial boundary hit set diverged\n"
        f"got  {got_pairs}\nwant {want}"
    )
    jax_pairs, _ = _served(JAX, tmp_path / "jax", monkeypatch, env, q, rows, junk,
                           top_k, THRESH)
    _same_as_jax(got_pairs, jax_pairs)


@pytest.mark.parametrize("tier,env", TIERS, ids=[t[0] for t in TIERS])
def test_dense_cluster_topk_completion(tmp_path, monkeypatch, tier, env):
    """TOP-K (no threshold) completion under quantization noise: a dense
    cluster puts far more rows within the tier's sim error of the true top-k
    than any fixed oversample window holds; the margin-bounded completion
    must grow the pool until the served set equals the exact one."""
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    rng = np.random.default_rng(4)
    # one dense cluster of 3000 rows + background
    center = rng.standard_normal(DIM).astype(np.float32)
    rows = center + 0.15 * rng.standard_normal((3000, DIM)).astype(np.float32)
    bg = rng.standard_normal((500, DIM)).astype(np.float32)
    rows = np.concatenate([rows, bg]).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    # the cluster's 3000 noise-tied rows need the completion loop
    q = rows[17] + 0.05 * rng.standard_normal(DIM).astype(np.float32)
    q /= np.linalg.norm(q)
    d = 1.0 - rows.astype(np.float64) @ q.astype(np.float64)
    want = list(np.lexsort((np.arange(len(d)), d))[:10])
    got, _ = _served(PORT, tmp_path / "port", monkeypatch, env, q, rows, None, 10, None)
    assert [g[0] for g in got] == want, f"{tier}: topk diverged"
    jax_got, _ = _served(JAX, tmp_path / "jax", monkeypatch, env, q, rows, None, 10, None)
    _same_as_jax(got, jax_got)


def test_reduced_tier_outlier_row_is_served(tmp_path, monkeypatch):
    """One rare-topic row whose residual is concentrated along a discarded
    direction, queried by a vector aligned with that direction: its
    projected rank is thousands below its exact rank. The residual-norm
    column must surface it, and the exact re-rank serve it."""
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    rng = np.random.default_rng(11)
    n, d, rd = 30000, 64, 16
    # bulk: rows inside the kept 16-dim subspace, small residual noise
    kept = rng.standard_normal((n, rd)).astype(np.float32)
    rows = np.zeros((n, d), np.float32)
    rows[:, :rd] = kept
    rows[:, rd:] = 0.03 * rng.standard_normal((n, d - rd)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    # the outlier: modest kept-space agreement + a big discarded-direction
    # component the projection throws away entirely
    u = rows[5] / np.linalg.norm(rows[5])
    outlier = 0.3 * u.copy()
    outlier[20] += 0.8
    outlier /= np.linalg.norm(outlier)
    rows[-1] = outlier
    q = 0.65 * u.copy()
    q[20] += 0.76
    q /= np.linalg.norm(q)
    dist = 1.0 - rows.astype(np.float64) @ q.astype(np.float64)
    want = list(np.lexsort((np.arange(n), dist))[:10])
    assert want[0] == n - 1  # the outlier IS the true nearest neighbor

    def body(P, dd):
        s = P.Store(str(dd / "ws"), dim=d)
        s.upsert_document_lines("/a.txt", rows)
        monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", str(rd))
        # below the int4 rung's d/2 B/row so the reduced tier serves
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(s._slot_rows(n) * 24))
        kind, got_rd = s._device_kind(n)
        assert (kind, got_rd) == ("int8", rd)
        got = s.search_line_embeddings(q, ["/a.txt"], top_k=10)
        s.close()
        return [(rl.line_number, rl.distance) for rl in got]

    got = body(PORT, tmp_path / "port")
    assert [g[0] for g in got] == want, "outlier row dropped from the served top-k"
    _same_as_jax(got, body(JAX, tmp_path / "jax"))
