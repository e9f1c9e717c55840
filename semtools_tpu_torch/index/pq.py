"""Product quantization: codebook fit, encoding, and ADC scans.

Counterpart of ``semtools_tpu/index/pq.py``. A D-dim f32 vector becomes M
bytes (M subspaces x 256 centroids each). A query scores codes by
asymmetric distance computation (ADC): an [M, 256] table of partial dot
products against the codebooks, then a code-indexed gather-sum. The fit and
the encode run on the device of their input; the tables are host work (the
index's query side is on the host, as in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from semtools_tpu_torch.index.kmeans import as_f32, kmeans_fit


@dataclass
class PQCodebook:
    """codebooks: [M, 256, dsub] float32 — M subspaces over D = M*dsub."""

    codebooks: np.ndarray

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def pq_fit(x, m: int = 32, ksub: int = 256, iters: int = 8, seed: int = 0) -> PQCodebook:
    """Fit per-subspace codebooks with k-means, on the device of ``x``."""
    x = as_f32(x)
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} subspaces")
    dsub = d // m
    ksub = min(ksub, n)
    books = torch.empty((m, ksub, dsub), dtype=torch.float32, device=x.device)
    for j in range(m):
        books[j], _ = kmeans_fit(
            x[:, j * dsub : (j + 1) * dsub].contiguous(), ksub, iters=iters, seed=seed + j
        )
    if ksub < 256:
        # Keep the table layout fixed at 256 rows so scans have one shape.
        books = torch.cat([books, books[:, :1].expand(m, 256 - ksub, dsub)], dim=1)
    return PQCodebook(books.cpu().numpy())


def _encode(resh: torch.Tensor, books: torch.Tensor, cb_norm_half: torch.Tensor) -> torch.Tensor:
    """resh [N, M, dsub], books [M, 256, dsub], cb_norm_half [M, 256] ->
    codes [N, M] uint8: per subspace, argmax x.c - |c|^2/2 over 256."""
    sims = torch.bmm(resh.transpose(0, 1), books.transpose(1, 2))  # [M, N, 256]
    return torch.argmax(sims - cb_norm_half[:, None, :], dim=2).T.to(torch.uint8).contiguous()


def pq_encode(x, pq: PQCodebook) -> np.ndarray:
    """Codes [N, M] uint8 of ``x``, computed on its device."""
    x = as_f32(x)
    books = torch.from_numpy(pq.codebooks).to(x.device)
    resh = x.reshape(x.shape[0], pq.m, pq.dsub)
    return _encode(resh, books, 0.5 * (books * books).sum(dim=2)).cpu().numpy()


def adc_tables(q, codebooks: np.ndarray) -> np.ndarray:
    """Per-query partial-dot tables: q [Q, D] -> [Q, M, 256] f32 (host)."""
    qt = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))
    books = torch.from_numpy(np.ascontiguousarray(codebooks, dtype=np.float32))
    qm = qt.reshape(qt.shape[0], books.shape[0], -1)  # [Q, M, dsub]
    return torch.bmm(qm.transpose(0, 1), books.transpose(1, 2)).transpose(0, 1).numpy()


def adc_scan(q, codes: np.ndarray, pq: PQCodebook, k: Optional[int] = None):
    """Approximate top-k by ADC over every row: the plain ``[Q, N]`` gather.
    Returns distances ``1 - approx_sim`` [Q, N], or with ``k`` (distances
    [Q, k], indices [Q, k]), ties to the lower index."""
    tables = torch.from_numpy(adc_tables(q, pq.codebooks))  # [Q, M, 256]
    codes_t = torch.from_numpy(np.array(codes, dtype=np.int64))  # [N, M]
    sims = tables[:, torch.arange(pq.m)[None, :], codes_t].sum(dim=2)  # [Q, N]
    if k is None:
        return (1.0 - sims).numpy()
    k = min(k, codes.shape[0])
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return (1.0 - vals[:, :k]).numpy(), idx[:, :k].numpy()
