"""Similarity scan: ``q @ E^T`` + exact top-k or threshold selection.

Counterpart of ``semtools_tpu/ops/scan.py``. Vectors are stored
L2-normalized (or zero), so cosine similarity is a dot product and
``distance = 1 - sim``; an empty line embeds to the zero vector and sits at
distance 1.0.

Small batches of queries (Q <= 32, k <= 64) over an f32 or bf16 CUDA
corpus of at least two tiles, with no row mask, go to the fused kernels
(:mod:`semtools_tpu_torch.ops.fused_scan`); everything else (an int8
corpus scored unscaled, as the JAX package's XLA path does, and masked
scans, which are XLA there too) is a plain matmul + stable sort in
fixed-size row chunks merged as a running top-k. A row ``mask`` (bool or
uint8 keep vector) reads the rows where it is 0 as +inf distance: they are
never selected and surface only as +inf filler when fewer than k rows are
kept. Results are tensors on the corpus device, ascending by distance,
ties toward the lower corpus index.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from semtools_tpu_torch.ops import fused_scan

# Row-chunk length of the plain scan: bounds the [Q, chunk] distance block.
SCAN_CHUNK = 1 << 20


def cosine_distances(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] cosine distances (inputs unit-or-zero)."""
    return 1.0 - q.float() @ e.float().T


def _topk_chunk(q, e, base: int, n_true: int, k: int, mask=None):
    """One chunk's top-k distances with global indices; rows with global
    index >= n_true, or where ``mask`` (aligned with the chunk) is 0, never
    win."""
    d = cosine_distances(q, e)
    col = torch.arange(e.shape[0], device=e.device) + base
    drop = col >= n_true
    if mask is not None:
        drop |= mask == 0
    d = d.masked_fill(drop, float("inf"))
    d, i = torch.sort(d, dim=1, stable=True)
    return d[:, :k], i[:, :k] + base


def _use_fused(n: int, k: int, qn: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> bool:
    """Fused kernels for CLI-scale query counts over multi-tile f32/bf16
    CUDA corpora (the JAX package's _use_pallas limits; the H100 crossovers
    are not measured yet). The per-tile extraction unrolls k rounds and the
    rescan re-reads Q*k sub-tiles, so large k or Q take the plain path; an
    int8 corpus takes it too (its kernels are ops.int8_scan's, which
    quantize the queries)."""
    if device.type != "cuda" or dtype not in (torch.float32, torch.bfloat16):
        return False
    if k > fused_scan.MAX_K or qn > fused_scan.MAX_QUERIES:
        return False
    return n >= 2 * fused_scan.SUB_ROWS


def _aligned(q: torch.Tensor, e: torch.Tensor):
    """``q`` and ``e`` with zero columns up to the kernels' 16-byte rows: a
    padded copy when ``e``'s rows are not aligned (the store's slot corpus is
    kept padded, so only a gathered corpus pays it). Dot products are
    unchanged."""
    per = 16 // e.element_size()
    pad = -e.shape[1] % per
    if not pad:
        return q, e
    return F.pad(q, (0, pad)), F.pad(e, (0, pad))


def topk_scan(
    q: torch.Tensor, e: torch.Tensor, k: int, n_true: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows for each query row.

    q: [Q, D] (unit-or-zero rows); e: [N, D] (unit-or-zero rows), rows at
    index >= ``n_true`` are padding and never selected; so are rows where
    the optional [N] keep ``mask`` is 0 (+inf filler past the kept rows).
    Returns (distances [Q, k'], int64 indices [Q, k']) with k' =
    min(k, n_true), ascending by distance; ties keep corpus order.
    """
    n = e.shape[0] if n_true is None else min(n_true, e.shape[0])
    qn = q.shape[0]
    k_eff = min(k, n)
    if k_eff == 0:
        return (torch.zeros((qn, 0), dtype=torch.float32, device=e.device),
                torch.zeros((qn, 0), dtype=torch.int64, device=e.device))
    q = q.to(e.device)
    if mask is None and _use_fused(n, k_eff, qn, e.device, e.dtype):
        return fused_scan.fused_topk_scan(*_aligned(q, e), k_eff, n_true=n)

    # Running merge over row chunks: each step merges [Q, <= 2k], and the
    # best-so-far sits before the new chunk, so a stable sort keeps ties
    # toward the lower corpus index.
    best_d = best_i = None
    for start in range(0, n, SCAN_CHUNK):
        stop = min(start + SCAN_CHUNK, n)
        chunk = e[start:stop]
        d, i = _topk_chunk(q, chunk, start, n, min(k_eff, chunk.shape[0]),
                           None if mask is None else mask[start:stop])
        if best_d is not None:
            d, pos = torch.sort(torch.cat([best_d, d], dim=1), dim=1, stable=True)
            i = torch.cat([best_i, i], dim=1).gather(1, pos)
            d, i = d[:, :k_eff], i[:, :k_eff]
        best_d, best_i = d, i
    return best_d, best_i


def batched_threshold_scan(
    q: torch.Tensor, e: torch.Tensor, max_distance: float,
    n_true: Optional[int] = None, mask: Optional[torch.Tensor] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Threshold mode for a batch of queries: per query row, every corpus
    row with distance strictly below ``max_distance`` (unbounded hit
    count; the threshold overrides top-k). Rows where the optional keep
    ``mask`` is 0 are neither counted nor returned. Returns a list of
    (distances [M_i], int64 indices [M_i]), ascending, ties toward the
    lower index."""
    n = e.shape[0] if n_true is None else min(n_true, e.shape[0])
    qn = q.shape[0]
    if n == 0 or qn == 0:
        empty = (torch.zeros(0, dtype=torch.float32, device=e.device),
                 torch.zeros(0, dtype=torch.int64, device=e.device))
        return [empty] * qn
    d = cosine_distances(q.to(e.device), e[:n])
    if mask is not None:
        d = d.masked_fill(mask[:n] == 0, float("inf"))
    counts = (d < max_distance).sum(dim=1).tolist()
    d, idx = torch.sort(d, dim=1, stable=True)
    return [(d[r, :c], idx[r, :c]) for r, c in enumerate(counts)]


def threshold_scan(
    q: torch.Tensor, e: torch.Tensor, max_distance: float,
    n_true: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All corpus rows with distance strictly below ``max_distance`` for a
    single query row: (distances [M], int64 indices [M]), ascending."""
    if q.shape[0] != 1:
        raise ValueError("threshold_scan expects a single query row")
    return batched_threshold_scan(q, e, max_distance, n_true)[0]
