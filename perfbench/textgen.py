"""Seeded text: a Zipf vocabulary, lines of words, documents and queries.

A rewritten copy of the pattern of ``semtools_tpu_torch/probes/gen_corpus.py``
(lines of 4-24 words of academic-looking prose), with a vocabulary large
enough that the embedding table's gather does not sit in a cache: a fixed
vocabulary of lower-case ASCII words, shorter words at the frequent ranks,
drawn with Zipf's law. Everything is numpy, so a million lines take about a
second. Same arguments, same text.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np

_LETTERS = "abcdefghijklmnopqrstuvwxyz"
_BUCKETS = 1 << 22


def vocabulary(n_words: int, seed: int) -> List[str]:
    """``n_words`` distinct words; the word at rank r has about
    1.5 + 0.6 ln(r + 1) letters, so the frequent words are short."""
    rng = random.Random(seed)
    words: List[str] = []
    seen = set()
    rank = 0
    while len(words) < n_words:
        mean = 1.5 + 0.6 * np.log(rank + 1)
        length = max(1, min(16, int(round(rng.gauss(mean, 1.5)))))
        w = "".join(rng.choice(_LETTERS) for _ in range(length))
        if w not in seen:
            seen.add(w)
            words.append(w)
            rank += 1
    return words


class Vocabulary:
    """The vocabulary as byte arrays, with its Zipf sampler."""

    def __init__(self, spec: Dict):
        words = vocabulary(int(spec["words"]), int(spec["seed"]))
        self.words = words
        self.lengths = np.fromiter((len(w) for w in words), np.int64, len(words))
        self._pieces = np.array([w + " " for w in words] + [w + "\n" for w in words] + ["\n"],
                                dtype=object)
        p = 1.0 / np.power(np.arange(1, len(words) + 1, dtype=np.float64), float(spec["zipf_s"]))
        self.cdf = np.cumsum(p / p.sum())
        self.cdf[-1] = 1.0
        # guide table: the first word whose cdf passes each of 2^22 buckets
        self._guide = np.searchsorted(self.cdf, np.arange(_BUCKETS) / _BUCKETS, side="right")

    def sample(self, rng: np.random.Generator, n: int, min_rank: int = 0) -> np.ndarray:
        """``n`` word ids by Zipf's law over the ranks from ``min_rank`` on:
        the first word whose cdf passes a uniform draw (the guide table's
        bucket, then a few steps on)."""
        lo = self.cdf[min_rank - 1] if min_rank > 0 else 0.0
        u = lo + (1.0 - lo) * rng.random(n)
        w = self._guide[(u * _BUCKETS).astype(np.int64)]
        while True:
            step = self.cdf[w] <= u
            if not step.any():
                return w
            w[step] += 1

    def render(self, word_ids: np.ndarray, words_per_line: np.ndarray) -> List[str]:
        """Lines of the given words (``words_per_line`` of them each, in
        order), one space between words; a line of zero words is empty."""
        per = np.asarray(words_per_line, np.int64)
        if len(per) == 0:
            return []
        v = len(self.words)
        # Pieces: word + " " (id), word + "\n" (id + v, a line's last word),
        # a lone "\n" (2v, an empty line).
        items = np.maximum(per, 1)
        first = np.zeros(len(per), np.int64)
        np.cumsum(items[:-1], out=first[1:])
        piece = np.full(int(items.sum()), 2 * v, np.int64)
        within = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
        piece[np.repeat(first, per) + within] = word_ids
        last = first[per > 0] + per[per > 0] - 1
        piece[last] += v
        return "".join(self._pieces[piece]).split("\n")[:-1]


def lines(vocab: Vocabulary, rng: np.random.Generator, n: int, words: Sequence[int],
          empty_share: float = 0.0, min_rank: int = 0) -> List[str]:
    """``n`` lines of ``words[0]..words[1]`` words each, a share of them
    empty, the words from rank ``min_rank`` on."""
    per = rng.integers(int(words[0]), int(words[1]) + 1, n)
    if empty_share:
        per[rng.random(n) < empty_share] = 0
    return vocab.render(vocab.sample(rng, int(per.sum()), min_rank), per)


def heavy_tailed_counts(n_docs: int, total: int, sigma: float) -> np.ndarray:
    """Lines per document: log-normal quantiles at (i + 1/2) / n_docs scaled
    to sum to ``total`` exactly, at least one each. The same for every seed,
    so every seed does the same amount of work (the caller fixes their order
    too)."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n_docs) for i in range(n_docs)])
    w = np.exp(sigma * z)
    counts = np.maximum(1, np.floor(w / w.sum() * total).astype(np.int64))
    short = total - int(counts.sum())
    order = np.argsort(-w, kind="stable")
    counts[order[: abs(short)]] += 1 if short > 0 else -1
    return counts
