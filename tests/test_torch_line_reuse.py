"""``tests/test_line_reuse.py`` on the port: line-level embedding reuse on
file edits (the ``lines.h64`` sidecar). A one-line edit embeds one line; the
reused rows equal a full re-embed; a model change disables reuse;
ignore-case hashes the folded text; duplicate novel lines embed once; the
sidecar survives a reopen and its absence degrades gracefully.

Each case runs on both packages (the port's model is its own
``StaticModel.fallback()`` on the CPU, the JAX side conftest.py's JAX model),
each under its own HOME: the encoded-line counts, the stderr reuse lines, the
hits (path, line; distances within 1e-5, the search layer's tolerance) and
the stored rows (within 1e-6) must be equal.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semtools_tpu import search as jax_search
from semtools_tpu import store as jax_store
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch import search as torch_search
from semtools_tpu_torch import store as torch_store
from semtools_tpu_torch.models.static_model import StaticModel
from semtools_tpu_torch.store.store import Store

ATOL = 1e-5
PORT = SimpleNamespace(search=torch_search, store=torch_store, Store=Store)
JAX = SimpleNamespace(search=jax_search, store=jax_store, Store=JaxStore)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")


@pytest.fixture(scope="module")
def model():
    return StaticModel.fallback(device="cpu")


def _ws(P, tmp, monkeypatch):
    """A fresh workspace named "reuse" under HOME=``tmp``."""
    tmp.mkdir(parents=True, exist_ok=True)
    monkeypatch.setenv("HOME", str(tmp))
    name = "reuse"
    W = P.store.Workspace
    W(P.store.WorkspaceConfig(name=name, root_dir=W.root_path(name))).save()
    return name


def _rows(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _CountingModel:
    """Wraps a model, counting how many lines get encoded; ``corpus_texts``
    are the texts of every call but a query's (the port embeds a query
    through ``encode``, the JAX package through ``encode_single``, which the
    wrapper does not see: the JAX suite's bounds allow for one query)."""

    def __init__(self, inner):
        self._inner = inner
        self.encoded_lines = 0
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def encode(self, texts, *a, **kw):
        self.encoded_lines += len(texts)
        self.calls.append(list(texts))
        return self._inner.encode(texts, *a, **kw)

    def corpus_texts(self, query):
        return sorted(t for c in self.calls if c not in ([query], [query.lower()]) for t in c)


def _bump_mtime(path):
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + 5))


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    elif isinstance(want, list) and want and isinstance(want[0], tuple):
        assert [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], atol=ATOL)
    else:
        assert got == want


def _both(body, tmp_path, model, fallback_model):
    got = body(PORT, tmp_path / "port", model)
    want = body(JAX, tmp_path / "jax", fallback_model)
    _same(got, want)
    return got


def test_one_line_edit_embeds_one_line(tmp_path, monkeypatch, capsys, model, fallback_model):
    def body(P, tmp, m):
        name = _ws(P, tmp, monkeypatch)
        counting = _CountingModel(m)
        f = tmp / "doc.txt"
        lines = [f"stable content line number {i}" for i in range(200)]
        f.write_text("\n".join(lines) + "\n")
        cfg = P.search.SearchConfig(top_k=3, n_lines=0)

        P.search.search_with_workspace([str(f)], "content", counting, cfg, name)
        assert counting.encoded_lines >= 200  # cold build embeds everything
        cold = counting.corpus_texts("content")
        counting.calls = []

        lines[57] = "a freshly edited line"
        f.write_text("\n".join(lines) + "\n")
        _bump_mtime(f)
        counting.encoded_lines = 0
        capsys.readouterr()
        hits = P.search.search_with_workspace([str(f)], "freshly edited", counting, cfg, name)
        # one novel line + the query itself
        assert counting.encoded_lines <= 2
        assert (hits[0].path, hits[0].line_number) == (str(f), 57)
        err = capsys.readouterr().err
        assert "reused 199 cached line embeddings" in err
        assert "embedded 1 unique new lines" in err
        reuse = [ln.replace(str(tmp), "<tmp>") for ln in err.splitlines() if "reused" in ln]
        return {"cold": cold, "warm": counting.corpus_texts("freshly edited"), "reuse": reuse,
                "hits": [(h.path.replace(str(tmp), "<tmp>"), h.line_number, h.distance)
                         for h in hits]}

    _both(body, tmp_path, model, fallback_model)


def test_reused_rows_identical_to_full_reembed(tmp_path, monkeypatch, model, fallback_model):
    def body(P, tmp, m):
        name = _ws(P, tmp, monkeypatch)
        f = tmp / "doc.txt"
        lines = [f"alpha {i}" for i in range(50)]
        f.write_text("\n".join(lines) + "\n")
        cfg = P.search.SearchConfig(top_k=1, n_lines=0)
        P.search.search_with_workspace([str(f)], "alpha", m, cfg, name)

        lines.insert(10, "inserted brand new line")  # shifts every later line
        f.write_text("\n".join(lines) + "\n")
        _bump_mtime(f)
        P.search.search_with_workspace([str(f)], "alpha", m, cfg, name)

        ws_dir = P.store.Workspace.root_path(name)
        with P.Store(ws_dir, dim=m.dim) as s:
            corpus, paths, line_nos = s.load_subset_matrix([str(f)])
        want = _rows(m.encode(lines, max_length=2048)).astype(np.float32)
        order = np.argsort(line_nos)
        np.testing.assert_allclose(np.asarray(corpus)[order], want, atol=1e-5)
        return np.asarray(corpus)[order]

    _both(body, tmp_path, model, fallback_model)


def test_version_mismatch_disables_reuse(tmp_path, monkeypatch, model, fallback_model):
    # a model change marks stored docs version=-1; their rows must NOT be
    # reused even when line hashes match
    def body(P, tmp, m):
        name = _ws(P, tmp, monkeypatch)
        f = tmp / "doc.txt"
        f.write_text("line one\nline two\n")
        cfg = P.search.SearchConfig(top_k=1, n_lines=0)
        P.search.search_with_workspace([str(f)], "one", m, cfg, name)

        ws_dir = P.store.Workspace.root_path(name)
        with P.Store(ws_dir, dim=m.dim) as s:
            s.db.execute("UPDATE docs SET version = -1")
            s.db.commit()

        counting = _CountingModel(m)
        hits = P.search.search_with_workspace([str(f)], "one", counting, cfg, name)
        assert counting.encoded_lines >= 2  # both lines re-embedded
        return {"encoded": counting.corpus_texts("one"), "hits": [h.line_number for h in hits]}

    _both(body, tmp_path, model, fallback_model)


def test_ignore_case_hashes_folded_text(tmp_path, monkeypatch, model, fallback_model):
    def body(P, tmp, m):
        name = _ws(P, tmp, monkeypatch)
        f = tmp / "doc.txt"
        f.write_text("MiXeD Case LINE\nother line\n")
        cfg = P.search.SearchConfig(top_k=1, n_lines=0, ignore_case=True)
        P.search.search_with_workspace([str(f)], "mixed", m, cfg, name)

        # same folded content, different raw case: hash matches -> reuse
        f.write_text("mixed case line\nother line\nadded line\n")
        _bump_mtime(f)
        counting = _CountingModel(m)
        hits = P.search.search_with_workspace([str(f)], "added", counting, cfg, name)
        assert counting.encoded_lines <= 2  # "added line" + query only
        assert hits[0].line_number == 2
        return {"encoded": counting.corpus_texts("added"),
                "hits": [(os.path.basename(h.path), h.line_number, h.distance) for h in hits]}

    got = _both(body, tmp_path, model, fallback_model)
    assert got["hits"][0][1] == 2


def test_duplicate_novel_lines_embed_once(tmp_path, monkeypatch, model, fallback_model):
    def body(P, tmp, m):
        name = _ws(P, tmp, monkeypatch)
        counting = _CountingModel(m)
        f1 = tmp / "a.txt"
        f2 = tmp / "b.txt"
        f1.write_text("shared boilerplate\nshared boilerplate\nuniq a\n")
        f2.write_text("shared boilerplate\nuniq b\n")
        cfg = P.search.SearchConfig(top_k=1, n_lines=0)
        P.search.search_with_workspace([str(f1), str(f2)], "uniq", counting, cfg, name)
        # 3 unique lines across both docs + 1 query
        assert counting.encoded_lines <= 4
        return counting.corpus_texts("uniq")

    _both(body, tmp_path, model, fallback_model)


def test_sidecar_survives_reopen_and_store_api(tmp_path, rng):
    rows = rng.standard_normal((4, 8)).astype(np.float32)
    hashes = np.array([11, 22, 33, 44], np.uint64)

    def body(P, d):
        s = P.Store(str(d / "ws"), dim=8)
        s.upsert_document_lines("/d.txt", rows, hashes)
        s.close()
        s = P.Store(str(d / "ws"), dim=8)
        got = s.get_doc_hash_rows("/d.txt")
        assert got is not None
        np.testing.assert_array_equal(got[0], hashes)
        np.testing.assert_allclose(got[1], rows, atol=0)
        # rows written without hashes read back as zeros (never reused)
        s.upsert_document_lines("/e.txt", rows)
        got_e = s.get_doc_hash_rows("/e.txt")
        assert got_e is not None
        np.testing.assert_array_equal(got_e[0], np.zeros(4, np.uint64))
        s.close()
        return [np.asarray(x) for x in (*got, *got_e)]

    for g, w in zip(body(PORT, tmp_path / "port"), body(JAX, tmp_path / "jax")):
        np.testing.assert_array_equal(g, w)


def test_old_store_without_sidecar_degrades_gracefully(tmp_path, rng):
    rows = rng.standard_normal((3, 8)).astype(np.float32)

    def body(P, d):
        s = P.Store(str(d / "ws"), dim=8)
        s.upsert_document_lines("/d.txt", rows, np.array([1, 2, 3], np.uint64))
        # simulate a pre-sidecar store
        s.hash_path.unlink()
        assert s.get_doc_hash_rows("/d.txt") is None
        # upserts keep working and recreate the sidecar at full capacity
        s.upsert_document_lines("/d.txt", rows, np.array([4, 5, 6], np.uint64))
        got = s.get_doc_hash_rows("/d.txt")
        assert got is not None and got[0].tolist() == [4, 5, 6]
        s.close()
        return got[0].tolist(), np.asarray(got[1])

    (h, r), (hj, rj) = body(PORT, tmp_path / "port"), body(JAX, tmp_path / "jax")
    assert h == hj
    np.testing.assert_array_equal(r, rj)
