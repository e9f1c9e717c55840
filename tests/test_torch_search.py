"""``tests/test_search.py`` on the port: the search core's ordering, top-k
and threshold semantics, context windows, ignore-case, document creation
from content (``create_document_from_content``), file search, and the
documents' rows as views of one batched encode.

The port's model is its own ``StaticModel.fallback()`` on the CPU; every
case runs the same documents and queries through the JAX package's search
core with the JAX fallback model as well: results (file, match line, start,
end, lines) must be equal and in the same order, distances within 1e-5 (as
``test_torch_search_cli.py``), documents' lines equal and their rows within
1e-6.
"""

import numpy as np
import pytest
import torch

from semtools_tpu import search as jax_search
from semtools_tpu_torch.models.static_model import StaticModel
from semtools_tpu_torch.search import (
    SearchConfig,
    create_document_from_content,
    search_documents,
    search_files,
)

ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return StaticModel.fallback(device="cpu")


def make_doc(model, filename, lines, ignore_case=False):
    return create_document_from_content(filename, "\n".join(lines), model, ignore_case)


def config(**kw):
    base = dict(n_lines=3, top_k=3, max_distance=None, ignore_case=False)
    base.update(kw)
    return SearchConfig(**base)


def _jax_results(jax_model, docs, query, **kw):
    """The JAX search core's results for the same documents and query."""
    base = dict(n_lines=3, top_k=3, max_distance=None, ignore_case=False)
    base.update(kw)
    jdocs = [jax_search.create_document_from_content(
        d["name"], "\n".join(d["lines"]), jax_model, d.get("ignore_case", False)) for d in docs]
    q = jax_model.encode_single(query)
    return jax_search.search_documents(jdocs, q, jax_search.SearchConfig(**base))


def _same(got, want):
    key = lambda r: (r.filename, r.match_line, r.start, r.end, list(r.lines))  # noqa: E731
    assert [key(r) for r in got] == [key(r) for r in want]
    np.testing.assert_allclose([r.distance for r in got], [r.distance for r in want],
                               atol=ATOL, rtol=0)


def _run(model, fallback_model, docs, query, **kw):
    port_docs = [make_doc(model, d["name"], d["lines"], d.get("ignore_case", False))
                 for d in docs]
    q = model.encode_single(query)
    results = search_documents(port_docs, q, config(**kw))
    _same(results, _jax_results(fallback_model, docs, query, **kw))
    return results


def test_search_documents_basic(model, fallback_model):
    docs = [{"name": "file1.txt", "lines": ["hello world", "goodbye world", "test line"]},
            {"name": "file2.txt", "lines": ["another test", "more content"]}]
    results = _run(model, fallback_model, docs, "test query")
    assert results
    for a, b in zip(results, results[1:]):
        assert a.distance <= b.distance


def test_max_distance_filters(model, fallback_model):
    docs = [{"name": "t.txt", "lines": ["line 1", "line 2", "line 3"]}]
    results = _run(model, fallback_model, docs, "test", max_distance=0.5)
    for r in results:
        assert r.distance < 0.5


def test_top_k_limit(model, fallback_model):
    docs = [{"name": "t.txt", "lines": [f"line {i}" for i in range(5)]}]
    results = _run(model, fallback_model, docs, "test", top_k=2)
    assert len(results) <= 2


def test_threshold_overrides_top_k(model, fallback_model):
    docs = [{"name": "t.txt", "lines": [f"totally different words {i}" for i in range(10)]}]
    results = _run(model, fallback_model, docs, "totally different words 0",
                   top_k=1, max_distance=10.0)
    # Threshold mode ignores top_k and returns every line under threshold
    assert len(results) == 10


def test_context_window_size(model, fallback_model):
    docs = [{"name": "t.txt", "lines": [f"line {i}" for i in range(6)]}]
    results = _run(model, fallback_model, docs, "test", n_lines=1)
    assert results
    r = results[0]
    if 0 < r.match_line < 5:
        assert len(r.lines) == 3


def test_context_clamped_at_boundaries(model, fallback_model):
    docs = [{"name": "small.txt", "lines": ["first", "second"]}]
    results = _run(model, fallback_model, docs, "first", n_lines=5)
    assert results
    r = results[0]
    assert r.start == 0
    assert r.end == 2
    assert len(r.lines) <= 2


def test_multiple_documents(model, fallback_model):
    docs = [{"name": "file1.txt", "lines": ["apple", "banana"]},
            {"name": "file2.txt", "lines": ["orange", "grape"]}]
    results = _run(model, fallback_model, docs, "fruit", top_k=4)
    names = {r.filename for r in results}
    assert names == {"file1.txt", "file2.txt"}


def test_empty_documents(model, fallback_model):
    q = model.encode_single("test")
    assert search_documents([], q, config()) == []
    assert jax_search.search_documents([], fallback_model.encode_single("test"),
                                       jax_search.SearchConfig()) == []


def test_ignore_case_matches(model, fallback_model):
    docs = [{"name": "mixed.txt", "lines": ["Hello World", "GOODBYE WORLD", "Test Line"],
             "ignore_case": True}]
    results = _run(model, fallback_model, docs, "hello world", ignore_case=True)
    assert results
    assert results[0].match_line == 0
    assert results[0].distance < 1e-5
    # Original casing is preserved in output
    assert results[0].lines[0] == "Hello World"


def _same_doc(doc, jdoc):
    assert (doc.filename, doc.lines) == (jdoc.filename, jdoc.lines)
    np.testing.assert_allclose(doc.embeddings.numpy(), np.asarray(jdoc.embeddings),
                               atol=1e-6, rtol=0)


def test_create_document_from_content(model, fallback_model):
    doc = create_document_from_content("t.txt", "Line 1\nLine 2\nLine 3", model, False)
    assert doc.filename == "t.txt"
    assert doc.lines == ["Line 1", "Line 2", "Line 3"]
    assert doc.embeddings.shape[0] == 3
    _same_doc(doc, jax_search.create_document_from_content(
        "t.txt", "Line 1\nLine 2\nLine 3", fallback_model, False))


def test_create_document_from_empty_content(model, fallback_model):
    assert create_document_from_content("e.txt", "", model, False) is None
    assert jax_search.create_document_from_content("e.txt", "", fallback_model, False) is None


def test_trailing_newline_does_not_add_line(model, fallback_model):
    doc = create_document_from_content("t.txt", "a\nb\n", model, False)
    assert doc.lines == ["a", "b"]
    _same_doc(doc, jax_search.create_document_from_content("t.txt", "a\nb\n", fallback_model,
                                                           False))


def test_crlf_and_formfeed_handling(model, fallback_model):
    # \r\n strips the \r; \f must NOT split a line (Rust lines() parity)
    doc = create_document_from_content("t.txt", "a\r\nb\fc\n", model, False)
    assert doc.lines == ["a", "b\fc"]
    _same_doc(doc, jax_search.create_document_from_content("t.txt", "a\r\nb\fc\n",
                                                           fallback_model, False))


def test_search_files(model, fallback_model, tmp_path):
    f1 = tmp_path / "a.txt"
    f1.write_text("the quick brown fox\njumps over\nthe lazy dog\n")
    f2 = tmp_path / "b.txt"
    f2.write_text("completely unrelated text\nabout databases\n")
    files = [str(f1), str(f2)]
    results = search_files(files, "quick brown fox", model, config(top_k=1))
    assert results[0].filename == str(f1)
    assert results[0].match_line == 0
    assert results[0].distance < 0.2
    _same(results, jax_search.search_files(files, "quick brown fox", fallback_model,
                                           jax_search.SearchConfig(n_lines=3, top_k=1)))


def test_search_files_missing_file_raises(model, fallback_model, tmp_path):
    with pytest.raises(OSError):
        search_files([str(tmp_path / "missing.txt")], "q", model, config())
    with pytest.raises(OSError):
        jax_search.search_files([str(tmp_path / "missing.txt")], "q", fallback_model,
                                jax_search.SearchConfig())


def test_exact_line_match_has_near_zero_distance(model, fallback_model):
    docs = [{"name": "t.txt", "lines": ["alpha beta gamma", "delta epsilon", "zeta eta theta"]}]
    results = _run(model, fallback_model, docs, "delta epsilon", top_k=1)
    assert results[0].match_line == 1
    assert results[0].distance < 1e-5


def test_duck_typed_model_without_host_kwarg(fallback_model):
    """``create_documents_from_contents`` takes any model whose ``encode``
    takes ``max_length`` and returns rows (the JAX package's ``host``
    keyword has no counterpart: the port's rows are tensors on the model's
    device). Its documents' rows equal the JAX package's host copies."""
    from semtools_tpu_torch.search import create_documents_from_contents

    class OldModel:
        dim = 4

        def encode(self, texts, max_length=2048):
            return torch.ones((len(texts), 4), dtype=torch.float32)

        def encode_single(self, text):
            return torch.ones(4, dtype=torch.float32)

    docs = create_documents_from_contents([("/a.txt", "one\ntwo\n")], OldModel(), False)
    assert len(docs) == 1
    assert isinstance(docs[0].embeddings, torch.Tensor)
    assert tuple(docs[0].embeddings.shape) == (2, 4)

    class JaxOldModel(OldModel):
        def encode(self, texts, max_length=2048):
            import jax.numpy as jnp

            return jnp.ones((len(texts), 4), jnp.float32)

    jdocs = jax_search.create_documents_from_contents(
        [("/a.txt", "one\ntwo\n")], JaxOldModel(), False, host=True)
    np.testing.assert_array_equal(docs[0].embeddings.numpy(), jdocs[0].embeddings)


def test_row_slice_views_share_one_parent(model, fallback_model):
    """The per-document split of a batched encode must not launch one device
    op per document: documents hold views of one encode's rows (one
    storage), and the corpus assembly hands the scan their rows in order."""
    from semtools_tpu_torch.search import _corpus_of, create_documents_from_contents

    items = [("a", "l1\nl2\nl3"), ("b", "l4\nl5")]
    docs = create_documents_from_contents(items, model, False)
    assert all(d.embeddings._base is not None for d in docs)
    assert docs[0].embeddings.untyped_storage().data_ptr() == \
        docs[1].embeddings.untyped_storage().data_ptr()
    assert tuple(docs[0].embeddings.shape) == (3, model.dim)
    assert len(docs[1].embeddings) == 2

    corpus, starts = _corpus_of(docs)
    assert list(starts) == [0, 3, 5]  # each document's first row
    assert corpus.shape[0] == 5
    # adjacent views of one encode: the corpus is a view of their rows, no copy
    assert corpus.data_ptr() == docs[0].embeddings.data_ptr()
    assert corpus._base is docs[0].embeddings._base

    # a filtered subset takes only its own rows
    corpus2, _ = _corpus_of([docs[1]])
    assert corpus2.shape[0] == 2
    np.testing.assert_allclose(corpus2.numpy(), corpus.numpy()[3:5], atol=0)
    np.testing.assert_allclose(docs[0].embeddings.numpy(), corpus.numpy()[:3], atol=0)

    jdocs = jax_search.create_documents_from_contents(items, fallback_model, False)
    jcorpus, _ = jax_search._corpus_of(jdocs)
    np.testing.assert_allclose(corpus.numpy(), np.asarray(jcorpus), atol=1e-6, rtol=0)


def _views(rows, bounds):
    return [rows[a:b] for a, b in bounds]


# Layouts of the documents' rows: one encode's five rows -> (each document's
# embeddings, whether the corpus is a view of them). Only adjacent contiguous
# row views of one tensor, in order, are handed over as a view; a document
# with no lines holds no rows and breaks no adjacency.
_LAYOUTS = {
    "reversed": lambda rows: (_views(rows, [(3, 5), (0, 3)]), False),
    "gap": lambda rows: (_views(rows, [(0, 2), (3, 5)]), False),
    "two_encodes": lambda rows: ([rows[0:3], rows[3:5].clone()[0:2]], False),
    # the next bytes in memory, but not a view of the same tensor (as two
    # allocations side by side would be)
    "adjacent_other_base": lambda rows: (
        [rows[0:3], torch.empty(0).set_(rows.untyped_storage(), 3 * rows.shape[1],
                                        (2, rows.shape[1]), (rows.shape[1], 1))], False),
    "non_contiguous": lambda rows: ([rows[0:2], rows[2:5:2]], False),
    "unaligned": lambda rows: (
        _views(torch.cat([torch.zeros(1), rows.flatten()])[1:].view(rows.shape),
               [(0, 3), (3, 5)]), False),
    "empty_between": lambda rows: (
        [rows[0:3], torch.zeros((0, rows.shape[1])), rows[3:5]], True),
    "adjacent": lambda rows: (_views(rows, [(0, 3), (3, 5)]), True),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_corpus_is_a_view_only_of_adjacent_rows(model, layout):
    """Every layout gives the rows ``torch.cat`` gives, row for row and bit
    for bit, with each document's first row; only adjacent views in order
    are handed over uncopied."""
    from semtools_tpu_torch.search import Document, _corpus_of

    rows = model.encode([f"line {i} of the shared encode" for i in range(5)])
    mats, view = _LAYOUTS[layout](rows)
    docs = [Document(f"d{i}", [f"l{j}" for j in range(len(m))], m) for i, m in enumerate(mats)]
    corpus, starts = _corpus_of(docs)
    assert torch.equal(corpus, torch.cat(mats, dim=0))
    assert list(starts) == list(np.cumsum([0] + [len(m) for m in mats]))
    shared = corpus.untyped_storage().data_ptr() == mats[0].untyped_storage().data_ptr()
    assert shared is view
    assert corpus.is_contiguous()


@pytest.mark.parametrize("threshold", [None, 1.5])
def test_view_and_separate_documents_give_the_same_results(model, threshold):
    """The same rows as views of one encode and as separate clones: equal
    results, distances to the bit, top-k and threshold."""
    from semtools_tpu_torch.search import (
        Document,
        create_documents_from_contents,
        search_documents_batched,
    )

    items = [("a", "alpha beta\ngamma delta\nalpha"), ("b", "beta\nalpha beta"),
             ("c", "epsilon\nalpha beta\nzeta\ngamma")]
    views = create_documents_from_contents(items, model, False)
    clones = [Document(d.filename, d.lines, d.embeddings.clone()) for d in views]
    q = model.encode(["alpha beta", "gamma"])
    cfg = config(n_lines=1, top_k=4, max_distance=threshold)
    got = search_documents_batched(views, q, cfg)
    want = search_documents_batched(clones, q, cfg)
    assert got and all(got)
    for g, w in zip(got, want):
        assert [(r.filename, r.match_line, r.start, r.end, r.lines, r.distance) for r in g] == \
            [(r.filename, r.match_line, r.start, r.end, r.lines, r.distance) for r in w]
