"""The JAX package's public names that its behavioural suites call, on the
port, each held against its JAX counterpart on the same inputs:
``ops.embed.chunk_spans`` (spans equal at the MAX_TOKENS_PER_CALL and
MAX_TEXTS_PER_CALL edges, and ``embed_token_lists`` dispatching by them),
``ops.embed.embed_token_lists_reference`` (within 1e-6),
``parallel.multihost.is_multihost_env`` (equal for each environment) and
``parallel.scan.sharded_topk_fn`` deciding the fused path by
``_use_fused_local``. ``device_cache.stats``, ``create_document_from_content``,
``sharded_threshold_scan_device`` and the lazy re-exports have theirs in
``test_torch_device_cache.py``, ``test_torch_search.py``,
``test_torch_parallel_fused.py`` and ``test_torch_search_cli.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu.ops import embed as jax_embed
from semtools_tpu.parallel import multihost as jax_multihost
from semtools_tpu_torch.ops import embed
from semtools_tpu_torch.parallel import multihost


def test_chunk_policy_constants_match():
    assert embed.MAX_TOKENS_PER_CALL == jax_embed.MAX_TOKENS_PER_CALL
    assert embed.MAX_TEXTS_PER_CALL == jax_embed.MAX_TEXTS_PER_CALL


T = embed.MAX_TOKENS_PER_CALL
N = embed.MAX_TEXTS_PER_CALL


@pytest.mark.parametrize("lengths,max_length", [
    ([], 2048),
    ([0, 0, 3], 2048),
    ([T], 1 << 30),  # one text exactly at the token limit
    ([T, 1], 1 << 30),  # the next text opens a call
    ([T - 1, 1, 1], 1 << 30),
    ([T + 5, 2], 1 << 30),  # an over-long text still goes alone
    ([5000] * 1000, 2048),  # clipped to max_length: 2048 a text
    ([1] * N, 2048),  # exactly the text limit
    ([1] * (2 * N + 3), 2048),
    ([0] * (N + 1), 2048),
])
def test_chunk_spans_match_jax(lengths, max_length):
    lists = [range(n) for n in lengths]  # only len() is read
    spans = embed.chunk_spans(lists, max_length)
    assert spans == jax_embed.chunk_spans(lists, max_length)
    bounds = [0] + [b for _, b in spans]
    assert spans == list(zip(bounds[:-1], bounds[1:])) and bounds[-1] == len(lists)


def test_embed_dispatches_by_chunk_spans(monkeypatch):
    """``embed_token_lists`` makes one call a span of ``chunk_spans``, and its
    rows equal the per-text reference across the calls' edges."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    lists = [list(rng.integers(0, 50, size=n)) for n in (7, 0, 3, 12, 1, 9)]
    monkeypatch.setattr(embed, "MAX_TOKENS_PER_CALL", 10)
    monkeypatch.setattr(embed, "MAX_TEXTS_PER_CALL", 2)
    calls = []
    real = embed._embed_chunk
    monkeypatch.setattr(embed, "_embed_chunk", lambda t, tl, *a: calls.append(len(tl))
                        or real(t, tl, *a))
    got = embed.embed_token_lists(torch.from_numpy(table), lists, max_length=8).numpy()
    spans = embed.chunk_spans(lists, 8)
    assert calls == [b - a for a, b in spans] and len(spans) > 2
    want = embed.embed_token_lists_reference(table, lists, max_length=8)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("normalize", [True, False])
def test_embed_reference_matches_jax(normalize):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((100, 16)).astype(np.float32)
    table[7] = 0.0  # a zero row: a text of only it has norm 0
    lists = [list(rng.integers(0, 100, size=n)) for n in (0, 1, 5, 40)] + [[7, 7]]
    got = embed.embed_token_lists_reference(table, lists, max_length=30, normalize=normalize)
    want = jax_embed.embed_token_lists_reference(table, lists, max_length=30,
                                                 normalize=normalize)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    port = embed.embed_token_lists(torch.from_numpy(table), lists, max_length=30,
                                   normalize=normalize).numpy()
    np.testing.assert_allclose(port, got, atol=1e-6, rtol=0)


@pytest.mark.parametrize("env", [
    {}, {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"}, {"COORDINATOR_ADDRESS": "host:1"},
    {"JAX_COORDINATOR_ADDRESS": ""}, {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "0"},
])
def test_is_multihost_env_matches_jax(monkeypatch, env):
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.is_multihost_env() == jax_multihost.is_multihost_env()
    assert multihost.is_multihost_env() == bool(
        env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS"))


def test_sharded_topk_fn_decides_by_use_fused_local(monkeypatch):
    """``fused=None`` asks ``_use_fused_local`` at each call (the shard
    size, k and the corpus's device and dtype); ``True``/``False`` force the
    path; a shard size other than the one built for is refused."""
    from semtools_tpu_torch.ops import fused_scan
    from semtools_tpu_torch.parallel import mesh as torch_mesh
    from semtools_tpu_torch.parallel import scan as pscan

    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "4")
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)
    mesh = torch_mesh.corpus_mesh(4, device="cpu")
    rng = np.random.default_rng(3)
    e = rng.standard_normal((1000, 16)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = torch.from_numpy(e[:3] + 0.01)
    es, n = torch_mesh.shard_corpus(torch.from_numpy(e), mesh)
    asked, fused_calls = [], []
    real_use = pscan._use_fused_local
    monkeypatch.setattr(pscan, "_use_fused_local",
                        lambda *a: asked.append(a) or real_use(*a))
    real_two = fused_scan.two_phase_sims
    monkeypatch.setattr(fused_scan, "two_phase_sims",
                        lambda *a: fused_calls.append(1) or real_two(*a))
    plain = pscan.sharded_topk_fn(mesh, 5, es.n_local)(q, es, n)
    assert asked == [(es.n_local, 5, mesh.first, torch.float32)] and not fused_calls
    forced = pscan.sharded_topk_fn(mesh, 5, es.n_local, fused=True)(q, es, n)
    assert fused_calls and len(asked) == 1
    for a, b in zip(plain, forced):
        assert torch.equal(a, b) if a.dtype == torch.int64 else torch.allclose(a, b, atol=1e-6)
    with pytest.raises(ValueError):
        pscan.sharded_topk_fn(mesh, 5, es.n_local + 1)(q, es, n)
