"""A cell's inputs, made from ``--seed``: the corpus, the model's table and
the pool of request queries. Each is made twice from the same seed: for the
program before the window, and for the reference after it, once the
program's state is freed.

Corpus kinds (``config["corpus"]["kind"]``):

- ``text``: documents of generated lines that the program embeds in set-up
  (``create_documents_from_contents``) with a hashed-tokenizer model whose
  table is made on the device from the seed;
- ``vectors``: one [lines, dim] float32 tensor of unit rows around seeded
  centroids, made on the device, of which each document's embeddings are a
  view, as ``create_documents_from_contents`` lays them out; a share of
  rows are copies of others. Its lines' text (for the context of a hit)
  comes from a pool of generated lines, reused.

Query kinds (``traffic["query"]["kind"]``): ``text`` (generated lines, a
share of them copies of corpus lines) and ``vector`` (a corpus row plus
seeded noise, renormalised).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from . import reference
from . import textgen


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``seed``."""
    return int(np.random.SeedSequence([int(seed) & ((1 << 128) - 1), *tags])
               .generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


_CORPUS, _TABLE, _QUERIES, _DOCS = 1, 2, 3, 4
# The order of the documents' sizes, the same for every seed: ``torch.cat``
# copies its inputs in batches whose cost follows the largest input of each
# batch, so a seed's own order of the same sizes would change the work.
_LAYOUT_SEED = 0x5EED_1A70


def _generator(device, seed: int, tag: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


@dataclass
class Corpus:
    filenames: List[str]
    lines: List[List[str]]
    contents: Optional[List[str]]  # text corpora: each document's text
    rows: int


def text_corpus(config: dict, seed: int) -> Corpus:
    c = config["corpus"]
    vocab = textgen.Vocabulary(config["vocabulary"])
    rng = np.random.default_rng(sub_seed(seed, _CORPUS))
    counts = textgen.heavy_tailed_counts(int(c["documents"]), int(c["lines"]),
                                         float(c["lines_per_document_sigma"]))
    counts = counts[np.random.default_rng(_LAYOUT_SEED).permutation(len(counts))]
    all_lines = textgen.lines(vocab, rng, int(c["lines"]), c["words_per_line"],
                              float(c["empty_line_share"]))
    repeated = textgen.lines(vocab, rng, int(c["repeated_lines"]), c["words_per_line"])
    where = np.nonzero(rng.random(len(all_lines)) < float(c["repeated_line_share"]))[0]
    which = rng.integers(0, len(repeated), len(where))
    for i, j in zip(where.tolist(), which.tolist()):
        all_lines[i] = repeated[j]
    lines, filenames, at = [], [], 0
    for d, n in enumerate(counts.tolist()):
        lines.append(all_lines[at:at + n])
        filenames.append(f"papers/{d:04d}.txt")
        at += n
    contents = ["\n".join(x) + "\n" for x in lines]
    return Corpus(filenames, lines, contents, at)


def vector_corpus_text(config: dict, seed: int) -> Corpus:
    """The lines of a ``vectors`` corpus: slices of a pool of generated
    lines, one seeded offset a document."""
    c = config["corpus"]
    vocab = textgen.Vocabulary(config["vocabulary"])
    rng = np.random.default_rng(sub_seed(seed, _DOCS))
    per = int(c["lines_per_document"])
    pool = textgen.lines(vocab, rng, int(c["text_pool_lines"]), c["words_per_line"],
                         float(c["empty_line_share"]))
    pool = pool + pool[:per]
    offsets = rng.integers(0, int(c["text_pool_lines"]), int(c["documents"]))
    lines = [pool[o:o + per] for o in offsets.tolist()]
    filenames = [f"chunks/{d:05d}.txt" for d in range(len(lines))]
    return Corpus(filenames, lines, None, per * len(lines))


def vector_corpus_rows(config: dict, seed: int, device) -> torch.Tensor:
    """[documents * lines_per_document, dim] float32 unit rows on ``device``:
    seeded centroids, each row a centroid plus Gaussian noise of norm
    ``spread`` (about), renormalised; then ``duplicate_share`` of the rows
    overwritten by copies of other rows."""
    c = config["corpus"]
    n = int(c["documents"]) * int(c["lines_per_document"])
    dim = int(c["dim"])
    g = _generator(device, seed, _CORPUS)
    cent = torch.randn((int(c["centroids"]), dim), generator=g, device=device)
    cent /= torch.linalg.vector_norm(cent, dim=1, keepdim=True)
    assign = torch.randint(0, cent.shape[0], (n,), generator=g, device=device)
    e = torch.empty((n, dim), dtype=torch.float32, device=device)
    e.normal_(generator=g)
    scale = float(c["spread"]) / dim ** 0.5
    for s in range(0, n, reference.ROW_BLOCK):
        blk = e[s:s + reference.ROW_BLOCK]
        blk.mul_(scale).add_(cent[assign[s:s + reference.ROW_BLOCK]])
        blk /= torch.linalg.vector_norm(blk, dim=1, keepdim=True)
    m = int(n * float(c["duplicate_share"]))
    if m:
        perm = torch.randperm(n, generator=g, device=device)[:2 * m]
        e[perm[m:]] = e[perm[:m]]
    return e


def model_table(config: dict, seed: int, device) -> torch.Tensor:
    """The static model's [rows, dim] float32 table, on ``device``."""
    m = config["model"]
    g = _generator(device, seed, _TABLE)
    t = torch.randn((int(m["table_rows"]), int(m["dim"])), generator=g, device=device)
    return t.mul_(1.0 / int(m["dim"]) ** 0.5)


def tokenizer_of(config: dict) -> reference.Tokenizer:
    m = config["model"]
    return reference.Tokenizer(int(m["table_rows"]), int(m["ngram_min"]), int(m["ngram_max"]))


def text_queries(config: dict, traffic: dict, corpus: Corpus, seed: int) -> List[List[str]]:
    """``pool_requests`` requests of ``queries_per_request`` query texts of
    words from rank ``min_rank`` on (content words, not the most frequent);
    a ``known_item_share`` of them are copies of non-empty corpus lines."""
    q = traffic["query"]
    vocab = textgen.Vocabulary(config["vocabulary"])
    rng = np.random.default_rng(sub_seed(seed, _QUERIES))
    per = int(traffic["queries_per_request"])
    total = per * int(traffic["pool_requests"])
    texts = textgen.lines(vocab, rng, total, q["words"], min_rank=int(q["min_rank"]))
    flat = [ln for doc in corpus.lines for ln in doc if ln]
    known = np.nonzero(rng.random(total) < float(q["known_item_share"]))[0]
    for i, j in zip(known.tolist(), rng.integers(0, len(flat), len(known)).tolist()):
        texts[i] = flat[j]
    return [texts[a:a + per] for a in range(0, total, per)]


def vector_queries(traffic: dict, rows: torch.Tensor, seed: int) -> torch.Tensor:
    """[pool_requests, queries_per_request, dim] float32 on the rows' device:
    random corpus rows plus Gaussian noise of norm ``noise`` (about),
    renormalised."""
    q = traffic["query"]
    g = _generator(rows.device, seed, _QUERIES)
    shape = (int(traffic["pool_requests"]), int(traffic["queries_per_request"]))
    base = torch.randint(0, rows.shape[0], shape, generator=g, device=rows.device)
    out = torch.randn((*shape, rows.shape[1]), generator=g, device=rows.device)
    out.mul_(float(q["noise"]) / rows.shape[1] ** 0.5).add_(rows[base])
    return out / torch.linalg.vector_norm(out, dim=2, keepdim=True)
