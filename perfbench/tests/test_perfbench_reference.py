"""The plain reference agrees with the port at a CPU size."""

import numpy as np
import pytest
import torch

from perfbench import reference
from semtools_tpu_torch import search
from semtools_tpu_torch.models.static_model import StaticModel
from semtools_tpu_torch.models.tokenizer import HashTokenizer
from semtools_tpu_torch.utils.text import split_lines

TEXTS = ["the quick brown fox", "", "Jumps over the LAZY dog!", "a b c", "naïve café au lait",
         "databases and indexes, again and again", "x"]


def test_tokenizer_rule_matches_the_port():
    port = HashTokenizer(vocab_size=50021, ngram_min=3, ngram_max=4)
    for text in TEXTS:
        ids = [i for w in reference.WORD_RE.findall(text.lower())
               for i in reference.word_ids(w, 50021, 3, 4)]
        assert ids == [int(x) for x in port.encode(text)]


def test_split_and_context_match_the_port():
    for content in ["a\nb\r\nc\n", "", "\n\n", "one", "x\ny\n\nz"]:
        assert reference.split_lines(content) == split_lines(content)
    doc = search.Document("f", [str(i) for i in range(9)], torch.zeros((9, 4)))
    for line in range(9):
        got = search._result_for_line(doc, line, 0.5, 3)
        assert (got.start, got.end, got.lines) == reference.context(doc.lines, line, 3)


@pytest.fixture
def model_and_texts():
    gen = torch.Generator().manual_seed(7)
    table = torch.randn((3001, 32), generator=gen)
    words = ["w%d" % i for i in range(200)] + ["alpha", "beta", "gamma"]
    rng = np.random.default_rng(3)
    texts = [" ".join(rng.choice(words, rng.integers(0, 9))) for _ in range(400)]
    texts += texts[:20]  # twins
    model = StaticModel(table, HashTokenizer(vocab_size=3001), name="t")
    return table, model, texts


def test_embeddings_match_the_port(model_and_texts):
    table, model, texts = model_and_texts
    got = model.encode(texts)
    want = reference.embed_texts(texts, table, reference.Tokenizer(3001, 3, 4), 2048)
    assert torch.allclose(got, want, atol=2e-6, rtol=0)


def test_topk_and_threshold_match_the_port(model_and_texts):
    table, model, texts = model_and_texts
    docs = search.create_documents_from_contents(
        [("a", "\n".join(texts[:150])), ("b", "\n".join(texts[150:]))], model, False)
    e = torch.cat([d.embeddings for d in docs])
    q = model.encode(texts[:5] + ["alpha beta", "gamma w1 w2"])
    for per, (dd, ii) in zip(search.search_documents_batched(docs, q, search.SearchConfig(
            n_lines=2, top_k=7)), zip(*reference.topk(q, e, 7))):
        assert [(r.filename, r.match_line) for r in per] == \
            [("a", i) if i < 150 else ("b", i - 150) for i in ii.tolist()]
        assert np.allclose([r.distance for r in per], dd.numpy(), atol=1e-6)
    thr = search.search_documents_batched(docs, q, search.SearchConfig(top_k=3, max_distance=0.5))
    for per, (dd, ii) in zip(thr, reference.threshold(q, e, 0.5)):
        assert len(per) == len(ii)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12])
    assert reference.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0]


def test_twins():
    e = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    group, rank = reference.twin_ranks(e)
    assert rank.tolist() == [0, 0, 1, 2, 1]
    assert group[0] == group[2] == group[3] and group[1] == group[4] != group[0]
    g2, r2 = reference.twin_ranks_of_keys(["a", "b", "a", "a", "b"], "cpu")
    assert r2.tolist() == rank.tolist()


def test_order_holds_twins_to_the_lower_row_and_lets_rounding_ties_be():
    from perfbench import compare

    # rows 0 and 2 are twins (the same text); rows 1 and 3 tie only in value
    e = torch.tensor([[1.0, 0.0], [0.6, 0.8], [1.0, 0.0], [0.6, 0.8]])
    texts = ["a b", "c d", "a b", "d c"]
    layout = reference.Layout.of(["f"], [texts])
    twins = reference.twin_ranks_of_keys(texts, "cpu")
    q = torch.tensor([[0.6, 0.8]])
    d = reference.distances_of(q.expand(4, 2), e).tolist()

    def order(rows):
        res = [[reference.answers(layout, [d[r]], [r], 0)[0] for r in rows]]
        return compare.judge(res, q, e, layout, 0, len(rows), None, twins)["order"]

    assert order([1, 3, 0, 2]) == 0
    assert order([3, 1, 0, 2]) == 0  # equal distances, rows that are no twins
    assert order([1, 3, 2, 0]) == 1  # twins, the higher row first
    assert order([0, 1]) == 1  # a larger distance first
    assert order([1, 1]) == 1  # a row twice
