"""``tests/test_reduced32_rung.py`` on the port: when the reduced-64d rung
does not fit the device budget, the policy halves to 32d before the IVF-PQ
tier takes over; an explicit rung below 32 is honoured but never reached by
halving; the 32d rung serves exact results; the hard completion margin
serves what the default margin does.

The budget bands, rungs and tier names of each case must equal the JAX
package's for the same store; served lines are held against the exact
numpy oracle, and against the JAX package's on the same seeded rows
(distances within 1e-6, the store files' f32 tolerance).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.store import device_cache
from semtools_tpu_torch.store.store import Store

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


@pytest.fixture(autouse=True)
def rung_env(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.delenv("SEMTOOLS_TPU_REDUCED_DIM", raising=False)
    monkeypatch.delenv("SEMTOOLS_TPU_STORE_INT4", raising=False)
    monkeypatch.delenv("SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", raising=False)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _mk(P, d, n=64, dim=256, seed=3):
    s = P.Store(str(d / "ws"), dim=dim)
    rows = _unit(np.random.default_rng(seed), n, dim)
    s.upsert_document_lines("/a.txt", rows)
    return s, rows


def _both(body, tmp_path):
    got = body(PORT, tmp_path / "port")
    want = body(JAX, tmp_path / "jax")
    assert [g[0] for g in got["lines"]] == [w[0] for w in want["lines"]]
    np.testing.assert_allclose([g[1] for g in got["lines"]], [w[1] for w in want["lines"]],
                               atol=ATOL, rtol=0)
    assert {k: v for k, v in got.items() if k != "lines"} == \
        {k: v for k, v in want.items() if k != "lines"}
    return got


def test_reduced_dim_halves_to_32(tmp_path, monkeypatch):
    """Budget ladder at D=256 (bytes/slot-row): int8 256, int4 128,
    reduced-64d 64, reduced-32d 32. Each budget band picks its rung; the
    33-63 B/row band is the 32d one."""
    def body(P, d):
        s, _ = _mk(P, d)
        n = 64
        slot_rows = s._slot_rows(n)
        out = {"lines": []}

        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * 70))
        assert s._capacity_reduced_dim(n) == 64
        out[70] = s.serving_tier(n)
        assert out[70] == "int8-mxu-scan-reduced64d"

        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * 48))
        assert s._capacity_reduced_dim(n) == 32
        out[48] = s.serving_tier(n)
        assert out[48] == "int8-mxu-scan-reduced32d"
        assert not s._use_ann_tier(n)

        # below the 32d rung nothing fits: ANN takes over (given min-rows)
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * 20))
        monkeypatch.setenv("SEMTOOLS_TPU_ANN_MIN_ROWS", "1")
        assert s._capacity_reduced_dim(n) is None
        out[20] = s._use_ann_tier(n)
        assert out[20]
        monkeypatch.delenv("SEMTOOLS_TPU_ANN_MIN_ROWS")
        s.close()
        return out

    _both(body, tmp_path)


def test_explicit_sub32_rung_honored_but_not_halved(tmp_path, monkeypatch):
    """An explicit SEMTOOLS_TPU_REDUCED_DIM below 32 is served as-is, but
    auto-halving never goes below 32 on its own."""
    def body(P, d):
        s, _ = _mk(P, d)
        n = 64
        slot_rows = s._slot_rows(n)
        out = {"lines": []}
        monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "8")
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * 12))
        out[12] = s._capacity_reduced_dim(n)
        assert out[12] == 8
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * 4))
        out[4] = s._capacity_reduced_dim(n)
        assert out[4] is None
        # default config: 33-63 B/row resolves to 32, never 16
        monkeypatch.delenv("SEMTOOLS_TPU_REDUCED_DIM")
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * 33))
        out[33] = s._capacity_reduced_dim(n)
        assert out[33] == 32
        s.close()
        return out

    _both(body, tmp_path)


def test_reduced32_serves_exact_results(tmp_path, monkeypatch):
    """End-to-end through the auto-halved 32d rung: top-k equals the exact
    scan with f32-exact distances (margin completion grows the pool until
    the certificate holds)."""
    def body(P, d):
        monkeypatch.delenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", raising=False)
        s, rows = _mk(P, d, n=300, seed=11)
        n = 300
        slot_rows = s._slot_rows(n)
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * 48))
        tier = s.serving_tier(n)
        assert tier.endswith("reduced32d")
        q = rows[123]
        got = s.search_line_embeddings(q, ["/a.txt"], top_k=10)
        exact = 1.0 - rows @ q
        order = np.argsort(exact, kind="stable")[:10]
        assert [rl.line_number for rl in got] == list(order)
        for rl, o in zip(got, order):
            np.testing.assert_allclose(rl.distance, exact[o], atol=1e-5)
        s.close()
        return {"lines": [(rl.line_number, rl.distance) for rl in got], "tier": tier}

    _both(body, tmp_path)


@pytest.mark.parametrize("bytes_per_row", [48, 300])
def test_hard_margin_mode_matches_default(tmp_path, monkeypatch, bytes_per_row):
    """SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS=hard widens the completion margin to
    the unconditional worst case; served results must equal the default
    statistical margin's, on the reduced-32d rung (48 B/row) and the
    full-dim int8 tier (300)."""
    def body(P, d):
        monkeypatch.delenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", raising=False)
        monkeypatch.delenv("SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", raising=False)
        s, rows = _mk(P, d, n=200, seed=7)
        n = 200
        slot_rows = s._slot_rows(n)
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(slot_rows * bytes_per_row))
        q = rows[50]
        base = s.search_line_embeddings(q, ["/a.txt"], top_k=7)
        P.cache.invalidate()
        monkeypatch.setenv("SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", "hard")
        hard = s.search_line_embeddings(q, ["/a.txt"], top_k=7)
        assert [rl.line_number for rl in hard] == [rl.line_number for rl in base]
        for a, b in zip(hard, base):
            np.testing.assert_allclose(a.distance, b.distance, atol=1e-6)
        exact = 1.0 - rows @ q
        order = np.argsort(exact, kind="stable")[:7]
        assert [rl.line_number for rl in hard] == list(order)
        tier = s.serving_tier(n)
        s.close()
        return {"lines": [(rl.line_number, rl.distance) for rl in hard], "tier": tier}

    _both(body, tmp_path)
