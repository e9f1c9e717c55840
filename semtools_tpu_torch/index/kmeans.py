"""Batched Lloyd k-means in torch: the IVF coarse quantizer and the PQ
sub-codebooks.

Counterpart of ``semtools_tpu/index/kmeans.py``. One Lloyd step is a matmul
and a segment sum:

    assignment:  argmin_j ||x - c_j||^2 = argmax_j (x . c_j - ||c_j||^2 / 2)
    update:      c_j <- mean of the rows assigned to j

Everything runs on the device of the input, in f32 (TF32 off: see
``ivf_pq.IvfPqIndex.build``). The init is the JAX package's numpy draw, so
both packages start from the same centroids. The segment sum is a one-hot
matmul per chunk of rows, added chunk after chunk: the BLAS sums in a fixed
order, so two fits of the same rows on one device are byte-equal (a float
``index_add_`` on CUDA adds in an order that changes from run to run). Empty
clusters keep their centroid. The data-parallel step of the JAX package
(``make_sharded_kmeans_step``) waits for the port's ``parallel/``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# One-hot elements per chunk of the segment sum (256 MB of f32).
_SUM_CHUNK = 1 << 26


def init_indices(n: int, k: int, seed: int) -> np.ndarray:
    """The rows that seed the centroids: distinct, drawn as the JAX package
    draws them."""
    return np.random.Generator(np.random.Philox(seed)).choice(n, size=k, replace=False)


def as_f32(x) -> torch.Tensor:
    """``x`` as an f32 tensor (numpy goes to the CPU; a tensor stays on its
    device)."""
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids (int64) via the dot-product form."""
    sims = x @ centroids.T
    norms = 0.5 * (centroids * centroids).sum(dim=1)
    return torch.argmax(sims - norms[None, :], dim=1)


def _segment_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """([k, D] sums, [k] counts) of the rows by assignment, in a fixed order."""
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    ids = torch.arange(k, device=x.device)
    step = max(1, _SUM_CHUNK // k)
    for s in range(0, x.shape[0], step):
        onehot = (assign[s : s + step, None] == ids[None, :]).to(x.dtype)
        sums += onehot.T @ x[s : s + step]
    counts = torch.bincount(assign, minlength=k).to(x.dtype)
    return sums, counts


def kmeans_step(x: torch.Tensor, centroids: torch.Tensor, k: int):
    """One Lloyd iteration: (new centroids, assignments of ``centroids``).
    Empty clusters keep their previous centroid."""
    assign = _assign(x, centroids)
    sums, counts = _segment_sums(x, assign, k)
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centroids), assign


def kmeans_fit(x, k: int, iters: int = 10, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit k centroids on the device of ``x``; returns (centroids [k, D] f32,
    assignments [N] int64), both there.

    Init: distinct rows of ``x`` (:func:`init_indices`)."""
    x = as_f32(x)
    n = x.shape[0]
    k = min(k, n)
    idx = torch.from_numpy(init_indices(n, k, seed)).to(x.device)
    centroids = x[idx]
    for _ in range(iters):
        centroids, _ = kmeans_step(x, centroids, k)
    return centroids, _assign(x, centroids)
