"""The generators make the same inputs from the same seed."""

import json

import numpy as np
import torch

from perfbench import inputs, textgen
from conftest import REPO, SEED, shrink


def _configs(tmp_path):
    import shutil

    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(tmp_path)
    pb = tmp_path / "perfbench"
    load = lambda kind, name: json.loads((pb / kind / f"{name}.json").read_text())  # noqa: E731
    return load("configs", "arxiv-1k"), load("configs", "lines10m"), load("traffic", "eval1k"), \
        load("traffic", "single")


def test_text_corpus_and_queries_repeat_for_a_seed(tmp_path):
    text_cfg, _, eval_tr, _ = _configs(tmp_path)
    a, b = inputs.text_corpus(text_cfg, SEED), inputs.text_corpus(text_cfg, SEED)
    assert a.contents == b.contents and a.filenames == b.filenames
    assert a.rows == text_cfg["corpus"]["lines"] == sum(len(x) for x in a.lines)
    assert inputs.text_queries(text_cfg, eval_tr, a, SEED) == \
        inputs.text_queries(text_cfg, eval_tr, b, SEED)
    c = inputs.text_corpus(text_cfg, SEED + 1)
    assert c.contents != a.contents
    # every seed does the same work: the same document sizes in the same order
    assert list(map(len, c.lines)) == list(map(len, a.lines))


def test_vector_corpus_and_queries_repeat_for_a_seed(tmp_path):
    _, vec_cfg, _, single_tr = _configs(tmp_path)
    a = inputs.vector_corpus_rows(vec_cfg, SEED, "cpu")
    assert torch.equal(a, inputs.vector_corpus_rows(vec_cfg, SEED, "cpu"))
    assert not torch.equal(a, inputs.vector_corpus_rows(vec_cfg, SEED + 1, "cpu"))
    assert torch.allclose(torch.linalg.vector_norm(a, dim=1), torch.ones(len(a)), atol=1e-5)
    dup = int(len(a) * vec_cfg["corpus"]["duplicate_share"])
    assert len(a) - len(torch.unique(a, dim=0)) == dup
    q1 = inputs.vector_queries(single_tr, a, SEED)
    assert torch.equal(q1, inputs.vector_queries(single_tr, a, SEED))
    assert q1.shape == (single_tr["pool_requests"], single_tr["queries_per_request"], a.shape[1])
    t1 = inputs.vector_corpus_text(vec_cfg, SEED)
    assert t1.lines == inputs.vector_corpus_text(vec_cfg, SEED).lines


def test_render_joins_words_and_keeps_empty_lines():
    v = textgen.Vocabulary({"words": 300, "zipf_s": 1.07, "seed": 3})
    rng = np.random.default_rng(5)
    per = np.array([3, 0, 1, 0, 2])
    ids = v.sample(rng, int(per.sum()))
    got = v.render(ids, per)
    want, at = [], 0
    for n in per:
        want.append(" ".join(v.words[i] for i in ids[at:at + n]))
        at += n
    assert got == want


def test_zipf_sampler_is_the_inverse_cdf():
    v = textgen.Vocabulary({"words": 5000, "zipf_s": 1.07, "seed": 3})
    u = np.random.default_rng(9).random(20000)
    got = v.sample(np.random.default_rng(9), 20000)
    assert np.array_equal(got, np.searchsorted(v.cdf, u, side="right"))
    assert (v.sample(np.random.default_rng(1), 1000, min_rank=100) >= 100).all()


def test_heavy_tailed_counts_sum_exactly():
    c = textgen.heavy_tailed_counts(1000, 1_000_000, 1.0)
    assert c.sum() == 1_000_000 and c.min() >= 1 and c.max() > 10 * np.median(c)
