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
clusters keep their centroid. :func:`make_sharded_kmeans_step` is the
data-parallel step over a mesh (``parallel/mesh.py``): rows sharded, each
shard's sums and counts added on the mesh's first device (and across
processes), the update replicated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from semtools_tpu_torch.parallel import multihost
from semtools_tpu_torch.parallel.mesh import Mesh, ShardedRows

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
    return _update(sums, counts, centroids), assign


def _update(sums, counts, centroids):
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, centroids)


def make_sharded_kmeans_step(mesh: Mesh, k: int):
    """Data-parallel Lloyd step: ``step(x, centroids)`` with ``x`` a
    :class:`ShardedRows` on ``mesh`` and ``centroids`` replicated returns (new
    centroids on the mesh's first device, [rows] int64 assignments of
    ``centroids`` in global row order). Each shard assigns its rows and sums
    them; the sums and counts are added on the first device (and across
    processes), as ``psum`` adds them in the JAX package."""
    first = mesh.first

    def step(x: ShardedRows, centroids: torch.Tensor):
        sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=first)
        counts = torch.zeros(k, dtype=torch.float32, device=first)
        assigns = []
        for shard in x.shards:
            a = _assign(shard, centroids.to(shard.device))
            s, c = _segment_sums(shard, a, k)
            sums += s.to(first)
            counts += c.to(first)
            assigns.append(a.to(first))
        sums, counts = multihost.all_sum(sums), multihost.all_sum(counts)
        return (_update(sums, counts, centroids.to(first)),
                multihost.all_gather(torch.cat(assigns), dim=0))

    return step


def kmeans_fit(x, k: int, iters: int = 10, seed: int = 0,
               mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit k centroids on the device of ``x`` (on ``mesh``'s first device
    with a mesh); returns (centroids [k, D] f32, assignments [N] int64), both
    there.

    Init: distinct rows of ``x`` (:func:`init_indices`). With ``mesh`` the
    rows are padded with copies of the first row to a multiple of the mesh
    size, as in the JAX package, and the assignments are those of the last
    step."""
    x = as_f32(x)
    n = x.shape[0]
    k = min(k, n)
    idx = torch.from_numpy(init_indices(n, k, seed)).to(x.device)
    centroids = x[idx]
    if mesh is not None:
        pad = (-n) % mesh.size
        xs = ShardedRows(mesh, (n + pad) // mesh.size, (x.shape[1],), torch.float32)
        xs.narrow(0, 0, n).copy_(x)
        xs.narrow(0, n, pad).copy_(x[:1].expand(pad, -1))
        step = make_sharded_kmeans_step(mesh, k)
        centroids = centroids.to(mesh.first)
        assign = None
        for _ in range(iters):
            centroids, assign = step(xs, centroids)
        if assign is None:  # iters == 0
            assign = _assign(x.to(mesh.first), centroids)
        return centroids, assign[:n]
    for _ in range(iters):
        centroids, _ = kmeans_step(x, centroids, k)
    return centroids, _assign(x, centroids)
