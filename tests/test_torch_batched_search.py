"""``tests/test_batched_search.py`` on the port: Q queries in one batched
call must equal Q single-query calls, on every serving tier (f32, int8,
reduced, IVF-PQ, sharded over ``SEMTOOLS_TORCH_VIRTUAL_DEVICES`` CPU shards),
in the search layer and with freed slots crowding a compressed tier.

Each case runs its body on both packages with the same seeded numpy rows (the
port on the CPU, its kernels' plain versions): the port's answers must have
the JAX package's (path, line) lists in the same order, distances within 1e-6
(the store files' f32 tolerance; the search layer's 1e-5, as
``test_torch_search_cli.py``), besides the JAX suite's own assertions.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from semtools_tpu import search as jax_search
from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch import search as torch_search
from semtools_tpu_torch.models.static_model import StaticModel
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.store import device_cache
from semtools_tpu_torch.store.store import Store

ATOL = 1e-6
SEARCH_ATOL = 1e-5
PORT = SimpleNamespace(cache=device_cache, Store=Store, search=torch_search)
JAX = SimpleNamespace(cache=jax_device_cache, Store=JaxStore, search=jax_search)


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


@pytest.fixture(scope="module")
def model():
    return StaticModel.fallback(device="cpu")


def _filled(P, d):
    s = P.Store(str(d / "ws"), dim=32)
    rng = np.random.default_rng(7)
    docs = {}
    for name, n in [("/z.txt", 41), ("/a.txt", 41), ("/m.txt", 41)]:
        rows = _unit(rng, n)
        s.upsert_document_lines(name, rows)
        docs[name] = rows
    return s, docs


def _both(body, tmp_path, atol=ATOL):
    got = body(PORT, tmp_path / "port")
    want = body(JAX, tmp_path / "jax")
    _same(got, want, atol)
    return got


def _key(r):
    return (r.path, r.line_number) if hasattr(r, "line_number") else \
        (r.filename, r.match_line, r.start, r.end, tuple(r.lines))


def _same(got, want, atol):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k], atol)
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, atol)
    elif isinstance(want, (list, tuple)):
        assert [_key(r) for r in got] == [_key(r) for r in want]
        np.testing.assert_allclose([r.distance for r in got], [r.distance for r in want],
                                   atol=atol, rtol=0)
    else:
        assert got == want


def _assert_same_lists(batched, singles):
    assert len(batched) == len(singles)
    for b_rows, s_rows in zip(batched, singles):
        assert len(b_rows) == len(s_rows)
        for x, y in zip(b_rows, s_rows):
            assert (x.path, x.line_number) == (y.path, y.line_number)
            assert abs(x.distance - y.distance) < 1e-5


def _queries(docs, rng, extra=2):
    qs = [docs["/a.txt"][3], docs["/m.txt"][10], docs["/z.txt"][40]]
    qs += [_unit(rng, 1)[0] for _ in range(extra)]
    return np.stack(qs)


def _run_both(s, docs, qs, top_k, max_distance=None, paths=None):
    paths = list(docs) if paths is None else paths
    batched = s.search_line_embeddings_batched(qs, paths, top_k, max_distance)
    singles = [
        s.search_line_embeddings(q, paths, top_k, max_distance) for q in qs
    ]
    return batched, singles


def test_batched_matches_single_f32_topk_and_threshold(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "0")

    def body(P, d):
        s, docs = _filled(P, d)
        qs = _queries(docs, np.random.default_rng(1))
        top = _run_both(s, docs, qs, top_k=4)
        thr = _run_both(s, docs, qs, top_k=4, max_distance=0.6)
        _assert_same_lists(*top)
        _assert_same_lists(*thr)
        # self-match hits land where planted
        batched, _ = _run_both(s, docs, qs, top_k=1)
        assert (batched[0][0].path, batched[0][0].line_number) == ("/a.txt", 3)
        assert (batched[2][0].path, batched[2][0].line_number) == ("/z.txt", 40)
        s.close()
        return {"top": top[0], "thr": thr[0], "one": batched}

    _both(body, tmp_path)


def test_batched_matches_single_subset(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")

    def body(P, d):
        s, docs = _filled(P, d)
        qs = _queries(docs, np.random.default_rng(2))
        subset = ["/a.txt", "/m.txt"]
        batched, singles = _run_both(s, docs, qs, top_k=3, paths=subset)
        _assert_same_lists(batched, singles)
        assert all(r.path in subset for rows in batched for r in rows)
        thr = _run_both(s, docs, qs, top_k=3, max_distance=0.5, paths=subset)
        _assert_same_lists(*thr)
        s.close()
        return {"top": batched, "thr": thr[0]}

    _both(body, tmp_path)


def test_batched_matches_single_int8_tier(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT8", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        qs = _queries(docs, np.random.default_rng(3))
        top = _run_both(s, docs, qs, top_k=3)
        thr = _run_both(s, docs, qs, top_k=3, max_distance=0.6)
        _assert_same_lists(*top)
        _assert_same_lists(*thr)
        s.close()
        return {"top": top[0], "thr": thr[0]}

    _both(body, tmp_path)


def test_batched_matches_single_reduced_tier(tmp_path, monkeypatch):
    # Budget fits the int8-reduced corpus but not f32/int8 full-dim.
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "8")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT4", "0")  # pin the reduced rung

    def body(P, d):
        s, docs = _filled(P, d)
        # slot_rows * 32 dims > budget; * 8 dims fits
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(s._slot_rows(123) * 16))
        tier = s.serving_tier()
        assert "reduced" in tier
        qs = _queries(docs, np.random.default_rng(4))
        top = _run_both(s, docs, qs, top_k=3)
        thr = _run_both(s, docs, qs, top_k=3, max_distance=0.6)
        _assert_same_lists(*top)
        _assert_same_lists(*thr)
        s.close()
        return {"tier": tier, "top": top[0], "thr": thr[0]}

    _both(body, tmp_path)


def test_batched_matches_single_ann_tier(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")

    def body(P, d):
        s, docs = _filled(P, d)
        s.build_ann_index(force=True)
        assert s.serving_tier() == "ivf-pq"
        qs = _queries(docs, np.random.default_rng(5))
        top = _run_both(s, docs, qs, top_k=3)
        thr = _run_both(s, docs, qs, top_k=3, max_distance=0.6)
        _assert_same_lists(*top)
        _assert_same_lists(*thr)
        s.close()
        return {"top": top[0], "thr": thr[0]}

    _both(body, tmp_path)


def test_batched_matches_single_sharded(tmp_path, monkeypatch):
    def body(P, d):
        s, docs = _filled(P, d)
        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "1")
        tier = s.serving_tier()
        assert tier.startswith("sharded-")
        qs = _queries(docs, np.random.default_rng(6))
        batched, _ = _run_both(s, docs, qs, top_k=3)
        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
        P.cache.invalidate()
        _, singles = _run_both(s, docs, qs, top_k=3)
        _assert_same_lists(batched, singles)

        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "1")
        P.cache.invalidate()
        batched_t, _ = _run_both(s, docs, qs, top_k=3, max_distance=0.6)
        monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
        P.cache.invalidate()
        _, singles_t = _run_both(s, docs, qs, top_k=3, max_distance=0.6)
        _assert_same_lists(batched_t, singles_t)
        s.close()
        return {"tier": tier, "top": batched, "thr": batched_t}

    assert _both(body, tmp_path)["tier"] == "sharded-exact-scan[8]"


def test_batched_mutation_then_search_stays_consistent(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")

    def body(P, d):
        s, docs = _filled(P, d)
        rng = np.random.default_rng(8)
        qs = _queries(docs, rng)
        _run_both(s, docs, qs, top_k=3)  # warm the slot cache
        new_rows = _unit(rng, 17)
        s.upsert_document_lines("/a.txt", new_rows)
        docs["/a.txt"] = new_rows
        after = _run_both(s, docs, qs, top_k=3)
        _assert_same_lists(*after)
        s.close()
        return after[0]

    _both(body, tmp_path)


def test_batched_empty_and_degenerate(tmp_path):
    def body(P, d):
        s, docs = _filled(P, d)
        qs = _unit(np.random.default_rng(9), 3)
        assert s.search_line_embeddings_batched(qs, [], 3) == [[], [], []]
        assert s.search_line_embeddings_batched(qs, list(docs), 0) == [[], [], []]
        assert s.search_line_embeddings_batched(
            np.zeros((0, 32), np.float32), list(docs), 3
        ) == []
        # 1-D query vector behaves like a batch of one
        one = s.search_line_embeddings_batched(qs[0], list(docs), 3)
        assert len(one) == 1 and len(one[0]) == 3
        s.close()
        return one

    _both(body, tmp_path)


# -- search layer -------------------------------------------------------------


def _write_two(tmp_path):
    f1 = tmp_path / "a.txt"
    f1.write_text("the quick brown fox\nan essay about databases\nneural nets\n")
    f2 = tmp_path / "b.txt"
    f2.write_text("convolutional layers\ngraph databases scale\n")
    return [str(f1), str(f2)]


def test_search_files_batched_matches_single(tmp_path, model, fallback_model):
    files = _write_two(tmp_path)
    queries = ["databases", "fox jumping", "convolution"]

    def body(P, m):
        config = P.search.SearchConfig(top_k=2, n_lines=1)
        per = P.search.search_files_batched(files, queries, m, config)
        assert len(per) == 3
        for q, got in zip(queries, per):
            want = P.search.search_files(files, q, m, config)
            assert [(r.filename, r.match_line) for r in got] == [
                (r.filename, r.match_line) for r in want
            ]
            np.testing.assert_allclose(
                [r.distance for r in got], [r.distance for r in want], atol=1e-5
            )
        assert per[0][0].lines  # context text attached

        t_config = P.search.SearchConfig(top_k=2, n_lines=0, max_distance=0.9)
        per_t = P.search.search_files_batched(files, queries, m, t_config)
        for q, got in zip(queries, per_t):
            want = P.search.search_files(files, q, m, t_config)
            assert [(r.filename, r.match_line) for r in got] == [
                (r.filename, r.match_line) for r in want
            ]
        return {"top": per, "thr": per_t}

    _same(body(PORT, model), body(JAX, fallback_model), SEARCH_ATOL)


def test_search_files_batched_ignore_case(tmp_path, model, fallback_model):
    f = tmp_path / "a.txt"
    f.write_text("DATABASES ESSAY\nunrelated line\n")

    def body(P, m):
        config = P.search.SearchConfig(top_k=1, ignore_case=True)
        per = P.search.search_files_batched([str(f)], ["databases essay"], m, config)
        assert per[0][0].match_line == 0
        assert per[0][0].lines[0] == "DATABASES ESSAY"  # original text reported
        return per

    _same(body(PORT, model), body(JAX, fallback_model), SEARCH_ATOL)


def test_zero_slots_cannot_crowd_compressed_candidates(tmp_path, monkeypatch):
    """Freed (zeroed) slots score compressed sim 0 and must not crowd real
    rows with ~0/negative compressed sims out of the candidate window on a
    fragmented store: the window grows until it holds the intended number of
    REAL rows."""
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "8")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT4", "0")  # pin the reduced rung

    def body(P, d):
        monkeypatch.delenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", raising=False)
        rng = np.random.default_rng(0)
        s = P.Store(str(d / "ws"), dim=16)

        # 200 junk rows -> deleted -> 200 zeroed slots
        s.upsert_document_lines("/junk.txt", _unit(rng, 200, 16))
        s.delete_line_embeddings(["/junk.txt"])

        # live corpus: variance lives in dims 0-7 (PCA keeps them)...
        live = np.zeros((49, 16), np.float32)
        live[:, :8] = rng.standard_normal((49, 8))
        live /= np.linalg.norm(live, axis=1, keepdims=True)
        # ...except the needle, which lives entirely in the DISCARDED dims:
        # its compressed sim is ~0, ranking at/below the 200 zero slots.
        needle = np.zeros(16, np.float32)
        needle[8:] = rng.standard_normal(8)
        needle /= np.linalg.norm(needle)
        s.upsert_document_lines("/live.txt", live)
        s.upsert_document_lines("/needle.txt", needle[None, :])

        # budget forces the reduced tier on this fragmented capacity:
        # slot_rows * 16 dims > budget, slot_rows * 8 fits
        monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", str(s._slot_rows(50) * 12))
        assert "reduced" in s.serving_tier()
        got = s.search_line_embeddings(needle, ["/live.txt", "/needle.txt"], 1)
        assert (got[0].path, got[0].line_number) == ("/needle.txt", 0)
        assert got[0].distance < 1e-5
        got_t = s.search_line_embeddings(
            needle, ["/live.txt", "/needle.txt"], 3, max_distance=0.5
        )
        assert (got_t[0].path, got_t[0].line_number) == ("/needle.txt", 0)
        s.close()
        return {"top": got, "thr": got_t}

    _both(body, tmp_path)
