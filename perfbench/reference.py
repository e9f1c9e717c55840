"""The plain reference of line search: plain PyTorch, no kernel of the
program, nothing imported from it.

Frozen copies of what the answer depends on:

- the hashed tokenizer's rule (words are ``[\\w]+|[^\\w\\s]`` of the
  lower-cased text; a word gives the FNV-1a 64 hash of its UTF-8 bytes
  modulo the vocabulary, and a word longer than ``ngram_min`` letters also
  gives the hash of ``"#" + gram`` for every character n-gram of
  ``"<word>"``, n from ``ngram_min`` to ``ngram_max``);
- the embedding: the mean of the first ``max_length`` ids' table rows,
  divided by its norm where the norm is positive, zero for no ids;
- Rust's ``str::lines()`` split, and the context of a hit: ``n_lines``
  lines either side, clamped to the file;
- the search: cosine distance ``1 - q . e`` over unit-or-zero rows in
  float32 with TF32 off, the k nearest ascending with ties to the lower
  row, or every row strictly under ``max_distance``.

The embedding sums in float64 and rounds to float32 once. With
``tf32=True`` every distance is taken with both operands rounded to TF32
(10 mantissa bits, round to nearest even), as the tensor cores would: the
lower precision that the control uses.
"""

from __future__ import annotations

import re
from array import array
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK64 = (1 << 64) - 1
WORD_RE = re.compile(r"[\w]+|[^\w\s]", re.UNICODE)
# Rows of the corpus in one distance block, and queries in one block.
ROW_BLOCK = 1 << 20
QUERY_BLOCK = 1024
# Words of the corpus summed into their lines in one step.
WORD_BLOCK = 1 << 20


def fnv1a_64(data: bytes) -> int:
    h = FNV_OFFSET
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & MASK64
    return h


def word_ids(word: str, vocab: int, ngram_min: int, ngram_max: int) -> List[int]:
    ids = [fnv1a_64(word.encode("utf-8")) % vocab]
    if len(word) > ngram_min:
        marked = f"<{word}>"
        for n in range(ngram_min, ngram_max + 1):
            for i in range(len(marked) - n + 1):
                ids.append(fnv1a_64(("#" + marked[i:i + n]).encode("utf-8")) % vocab)
    return ids


def split_lines(content: str) -> List[str]:
    """Rust's ``str::lines()``: only ``\\n`` ends a line, a ``\\r`` before it
    is dropped, a trailing newline makes no empty last line."""
    if not content:
        return []
    parts = content.split("\n")
    if parts[-1] == "":
        parts.pop()
    return [p[:-1] if p.endswith("\r") else p for p in parts]


def context(lines: Sequence[str], line: int, n_lines: int) -> Tuple[int, int, List[str]]:
    """(start, end, lines[start:end]) of a hit at ``line``."""
    start = max(0, line - n_lines)
    end = min(len(lines), line + n_lines + 1)
    return start, end, list(lines[start:end])


class _Ids(dict):
    def __missing__(self, key):
        value = self[key] = len(self)
        return value


@dataclass
class Tokenizer:
    vocab: int
    ngram_min: int
    ngram_max: int


def embed_texts(texts: Sequence[str], table: torch.Tensor, tok: Tokenizer,
                max_length: int, normalize: bool = True) -> torch.Tensor:
    """[len(texts), D] float32 embeddings on the table's device."""
    words = _Ids()
    flat = array("q")
    per_text = np.zeros(len(texts), np.int64)
    for i, t in enumerate(texts):
        ws = WORD_RE.findall(t.lower())
        flat.extend(map(words.__getitem__, ws))
        per_text[i] = len(ws)
    dev = table.device
    d = table.shape[1]
    out = torch.zeros((len(texts), d), dtype=torch.float64, device=dev)
    # each distinct word's ids once: its sum of table rows and its count
    w_ids = [word_ids(w, tok.vocab, tok.ngram_min, tok.ngram_max) for w in words]
    w_len = np.fromiter((len(x) for x in w_ids), np.int64, len(w_ids))
    w_sum = torch.zeros((len(w_ids), d), dtype=torch.float64, device=dev)
    if w_ids:
        ids = torch.from_numpy(np.fromiter((i for x in w_ids for i in x), np.int64,
                                           int(w_len.sum()))).to(dev)
        owner = torch.repeat_interleave(torch.arange(len(w_ids), device=dev),
                                        torch.from_numpy(w_len).to(dev))
        w_sum.index_add_(0, owner, table[ids].double())
    flat_np = np.frombuffer(flat, np.int64) if len(flat) else np.zeros(0, np.int64)
    counts = np.bincount(np.repeat(np.arange(len(texts)), per_text),
                         weights=w_len[flat_np], minlength=len(texts)).astype(np.int64)
    flat_t = torch.from_numpy(flat_np.copy()).to(dev)
    line_of = torch.repeat_interleave(torch.arange(len(texts), device=dev),
                                      torch.from_numpy(per_text).to(dev))
    for a in range(0, len(flat_np), WORD_BLOCK):
        out.index_add_(0, line_of[a:a + WORD_BLOCK], w_sum[flat_t[a:a + WORD_BLOCK]])
    for i in np.nonzero(counts > max_length)[0].tolist():  # clip by ids
        a = int(per_text[:i].sum())
        ids_i = [x for w in flat_np[a:a + per_text[i]].tolist() for x in w_ids[w]][:max_length]
        out[i] = table[torch.tensor(ids_i, device=dev)].double().sum(0)
        counts[i] = max_length
    mean = out / torch.from_numpy(np.maximum(counts, 1)).to(dev).double()[:, None]
    if normalize:
        norm = torch.linalg.vector_norm(mean, dim=1, keepdim=True)
        mean = torch.where(norm > 0, mean / norm.clamp(min=1e-300), mean)
    return mean.float()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def distances(q: torch.Tensor, e: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[Q, N] cosine distances in float32, TF32 off; ``tf32`` rounds both
    operands to TF32 first (the products are then exact in float32)."""
    if tf32:
        q, e = round_tf32(q), round_tf32(e)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return 1.0 - q.float() @ e.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def distances_of(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """[M] float32 distances of query row i to corpus row i."""
    return 1.0 - (q.float() * e.float()).sum(dim=1)


def topk(q: torch.Tensor, e: torch.Tensor, k: int, tf32: bool = False):
    """([Q, k'] distances ascending, [Q, k'] int64 rows), k' = min(k, N),
    ties to the lower row: blocks of rows, a stable sort each, merged with
    the best so far first."""
    n = e.shape[0]
    k = min(k, n)
    outs_d, outs_i = [], []
    for a in range(0, q.shape[0], QUERY_BLOCK):
        qb = q[a:a + QUERY_BLOCK]
        best_d = best_i = None
        for s in range(0, n, ROW_BLOCK):
            d = distances(qb, e[s:s + ROW_BLOCK], tf32)
            d, i = torch.sort(d, dim=1, stable=True)
            d, i = d[:, :k], i[:, :k] + s
            if best_d is not None:
                d, pos = torch.sort(torch.cat([best_d, d], 1), dim=1, stable=True)
                i = torch.cat([best_i, i], 1).gather(1, pos)
                d, i = d[:, :k], i[:, :k]
            best_d, best_i = d, i
        outs_d.append(best_d)
        outs_i.append(best_i)
    return torch.cat(outs_d), torch.cat(outs_i)


def threshold(q: torch.Tensor, e: torch.Tensor, max_distance: float,
              tf32: bool = False) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per query, every row with distance strictly under ``max_distance``:
    (distances ascending, int64 rows), ties to the lower row."""
    per: List[List[Tuple[torch.Tensor, torch.Tensor]]] = [[] for _ in range(q.shape[0])]
    for a in range(0, q.shape[0], QUERY_BLOCK):
        qb = q[a:a + QUERY_BLOCK]
        for s in range(0, e.shape[0], ROW_BLOCK):
            d = distances(qb, e[s:s + ROW_BLOCK], tf32)
            qi, ri = torch.nonzero(d < max_distance, as_tuple=True)
            vals = d[qi, ri]
            counts = torch.bincount(qi, minlength=qb.shape[0]).tolist()
            for j, (dv, rv) in enumerate(zip(vals.split(counts), ri.split(counts))):
                if len(dv):
                    per[a + j].append((dv, rv + s))
    out = []
    for parts in per:
        if not parts:
            z = torch.zeros(0, device=e.device)
            out.append((z, z.long()))
            continue
        d = torch.cat([p[0] for p in parts])
        r = torch.cat([p[1] for p in parts])
        d, pos = torch.sort(d, stable=True)  # rows arrive ascending
        out.append((d, r[pos]))
    return out


def twin_ranks(e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group, rank) of every row: rows with the same bits share a group,
    and a row's rank is the number of its twins at lower rows. Twins score
    alike against every query, so a search that returns a row must return
    each of its lower twins."""
    bits = e.contiguous().view(torch.int32).long()
    gen = torch.Generator(device="cpu").manual_seed(0x7E57)
    weights = torch.randint(1, 1 << 62, (e.shape[1],), generator=gen).to(e.device) | 1
    h = torch.zeros(e.shape[0], dtype=torch.int64, device=e.device)
    for s in range(0, e.shape[0], ROW_BLOCK):
        h[s:s + ROW_BLOCK] = (bits[s:s + ROW_BLOCK] * weights).sum(1)
    _, group = torch.unique(h, return_inverse=True)
    n = e.shape[0]
    order = torch.argsort(group * n + torch.arange(n, device=e.device))
    g_sorted = group[order]
    first = torch.ones(n, dtype=torch.bool, device=e.device)
    first[1:] = g_sorted[1:] != g_sorted[:-1]
    start = torch.cummax(torch.where(first, torch.arange(n, device=e.device), 0), 0).values
    rank = torch.empty(n, dtype=torch.int64, device=e.device)
    rank[order] = torch.arange(n, device=e.device) - start
    return group, rank


def twin_ranks_of_keys(keys: Sequence, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`twin_ranks` where rows are twins when their keys are equal
    (the same line of text embeds alike)."""
    first: Dict[object, int] = {}
    seen: Dict[object, int] = {}
    group = np.empty(len(keys), np.int64)
    rank = np.empty(len(keys), np.int64)
    for i, k in enumerate(keys):
        g = first.setdefault(k, len(first))
        group[i] = g
        rank[i] = seen.get(k, 0)
        seen[k] = rank[i] + 1
    return torch.from_numpy(group).to(device), torch.from_numpy(rank).to(device)


@dataclass
class Layout:
    """Which document and line each corpus row is."""

    filenames: List[str]
    lines: List[List[str]]
    starts: np.ndarray  # [docs + 1] first row of each document

    @classmethod
    def of(cls, filenames: Sequence[str], lines: Sequence[Sequence[str]]) -> "Layout":
        starts = np.zeros(len(lines) + 1, np.int64)
        np.cumsum([len(x) for x in lines], out=starts[1:])
        return cls(list(filenames), [list(x) for x in lines], starts)

    def locate(self, row: int) -> Tuple[int, int]:
        doc = int(np.searchsorted(self.starts, row, side="right")) - 1
        return doc, row - int(self.starts[doc])

    def row(self, filename_index: Dict[str, int], filename: str, line: int) -> int:
        doc = filename_index.get(filename)
        if doc is None or not 0 <= line < len(self.lines[doc]):
            return -1
        return int(self.starts[doc]) + line


def answers(layout: Layout, dists: Sequence[float], rows: Sequence[int], n_lines: int):
    """The reference's results for one query: (filename, lines, start, end,
    match_line, distance) a hit."""
    out = []
    for dist, row in zip(dists, rows):
        doc, line = layout.locate(int(row))
        start, end, ctx = context(layout.lines[doc], line, n_lines)
        out.append((layout.filenames[doc], ctx, start, end, line, float(dist)))
    return out
