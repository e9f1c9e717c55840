"""Mesh-sharded similarity scans: each shard's candidates, merged.

Counterpart of ``semtools_tpu/parallel/scan.py``. Each JAX ``shard_map`` body
is a loop over the shards of a :class:`~semtools_tpu_torch.parallel.mesh.
ShardedRows` that calls the port's single-device scans on each shard's real
rows (its ``local_true`` rows; padding rows are never read, so they cannot
displace real rows with negative similarities, and an all-padding shard is
skipped). Candidates go to the mesh's first device in shard order, are
gathered across processes (:mod:`~semtools_tpu_torch.parallel.multihost`)
and merged with ties to the lower global row. Per-shard top-k candidates
preserve the exact global top-k: no shard can hold more than k winners.

On a CUDA mesh each shard runs the kernels of its format: the fused f32 scan
(``fused_tilemax``, ``select_subtiles``, ``fused_rescan_topk``) where
:func:`_use_fused_local` says so, the int8 two-phase scan (``int8_tilemax``,
``select_subtiles``, ``int8_rescan_topk``) and the int4 deep-candidate sweep
(``int4_sims_max[_masked]``) with its selection (``select_subtiles``,
``int4_cutoff_counts``, ``int4_extract_above``), so each launches once per
shard (and per 32 queries). Masked top-k and the threshold scans are plain
torch, as they are plain XLA in the JAX package. Results are tensors on the
mesh's first device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from semtools_tpu_torch.ops import fused_scan
from semtools_tpu_torch.ops.fused_scan import MAX_QUERIES, SUB_ROWS, merge_candidates
from semtools_tpu_torch.parallel import multihost
from semtools_tpu_torch.parallel.mesh import Mesh, ShardedRows, corpus_mesh, shard_corpus

_NEG_INF = float("-inf")


def _local_trues(e: ShardedRows, n_true: int) -> List[Tuple[int, int]]:
    """(first global row, real rows) of each shard this process holds."""
    g0s = [(e.mesh.offset + j) * e.n_local for j in range(e.mesh.local)]
    return [(g0, max(0, min(n_true - g0, e.n_local))) for g0 in g0s]


def _per_query_chunk(fn, q: torch.Tensor):
    """``fn`` over at most MAX_QUERIES queries at a time (the kernels' limit),
    its tensor outputs concatenated along the queries."""
    if q.shape[0] <= MAX_QUERIES:
        return fn(q)
    parts = [fn(q[s:s + MAX_QUERIES]) for s in range(0, q.shape[0], MAX_QUERIES)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _gathered(parts: List[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """Shard blocks [Q, c] on ``dev`` side by side, then every process's."""
    return multihost.all_gather(torch.cat([p.to(dev) for p in parts], dim=1))


def _drop_sentinels(d: torch.Tensor, i: torch.Tensor, n_true: int, k: int):
    """Drop candidates at rows >= n_true (pad and mask sentinels), keeping
    the rows rectangular (the JAX package's rule: the narrowest row's width)."""
    valid = i < n_true
    if bool(valid.all()):
        return d[:, :k], i[:, :k]
    keep = [(d[r][valid[r]][:k], i[r][valid[r]][:k]) for r in range(d.shape[0])]
    width = min(min(len(ri) for _, ri in keep), k)
    return (torch.stack([rd[:width] for rd, _ in keep]),
            torch.stack([ri[:width] for _, ri in keep]))


def _empty(qn: int, dev):
    return (torch.zeros((qn, 0), dtype=torch.float32, device=dev),
            torch.zeros((qn, 0), dtype=torch.int64, device=dev))


# -- f32 top-k ----------------------------------------------------------------


def _use_fused_local(n_local: int, k: int, device: torch.device, dtype: torch.dtype) -> bool:
    """Fused kernels on each shard: a CUDA mesh, an f32/bf16 corpus, k <= 64
    and shards of two tiles or more (the port's tile is SUB_ROWS rows, as in
    ``ops.scan._use_fused``). No query limit: the queries go 32 at a time."""
    return (device.type == "cuda" and dtype in (torch.float32, torch.bfloat16)
            and k <= fused_scan.MAX_K and n_local >= 2 * SUB_ROWS)


def sharded_topk_scan(q, corpus, k: int, mesh: Optional[Mesh] = None):
    """Exact top-k of ``q`` against ``corpus`` [N, D] sharded across ``mesh``
    (default: :func:`corpus_mesh` of the corpus's device): (distances
    [Q, k'], int64 global rows [Q, k']), k' = min(k, N), ascending; the
    single-device ``ops.scan.topk_scan`` answer up to cross-shard near-ties."""
    if mesh is None:
        mesh = corpus_mesh(device=corpus.device if torch.is_tensor(corpus) else None)
    if not torch.is_tensor(corpus):
        corpus = np.asarray(corpus, np.float32)
    e, n = shard_corpus(corpus, mesh)
    return sharded_topk_scan_device(q, e, n, k, mesh)


def sharded_topk_fn(mesh: Mesh, k: int, n_local: int, fused: Optional[bool] = None):
    """The sharded top-k scan for one mesh, k and shard size, called as
    ``fn(q, e_sharded, n_true, mask=None)`` over rows sharded ``n_local`` a
    shard (the JAX package's factory; there is nothing to compile, so nothing
    is cached). ``fused`` forces the fused kernels on each shard (True) or
    the plain per-shard scan (False); None decides by :func:`_use_fused_local`
    at each call. A mask always takes the plain scan. On CPU tensors the
    kernels' wrappers run their plain versions."""

    def fn(q, e_sharded: ShardedRows, n_true: int, mask: Optional[ShardedRows] = None):
        if e_sharded.n_local != n_local:
            raise ValueError(f"built for {n_local} rows a shard, given {e_sharded.n_local}")
        return _sharded_topk(q, e_sharded, n_true, k, mesh, mask, fused)

    return fn


def sharded_topk_scan_device(q, e: ShardedRows, n_true: int, k: int,
                             mesh: Optional[Mesh] = None, mask: Optional[ShardedRows] = None,
                             fused: Optional[bool] = None):
    """Like :func:`sharded_topk_scan` over rows already sharded; rows at
    global index >= ``n_true`` are padding and never read. ``mask`` (sharded
    like ``e``, uint8 or bool) keeps the rows where it is nonzero: masked
    rows never surface (path-subset serving). ``fused`` as in
    :func:`sharded_topk_fn`, which this calls."""
    mesh = mesh or e.mesh
    return sharded_topk_fn(mesh, k, e.n_local, fused)(q, e, n_true, mask=mask)


def _sharded_topk(q, e: ShardedRows, n_true: int, k: int, mesh: Mesh,
                  mask: Optional[ShardedRows], fused: Optional[bool]):
    dev = mesh.first
    q = torch.as_tensor(q, dtype=torch.float32)
    qn = q.shape[0]
    k_eff = min(k, n_true)
    if k_eff == 0:
        return _empty(qn, dev)
    k_local = min(k_eff, e.n_local)
    if mask is not None:
        fused = False
    elif fused is None:
        fused = _use_fused_local(e.n_local, k_eff, dev, e.dtype)
    sentinel = e.n_local * mesh.size
    dists, rows = [], []
    for j, (g0, lt) in enumerate(_local_trues(e, n_true)):
        shard = e.shards[j]
        d = torch.full((qn, k_local), float("inf"), device=shard.device)
        i = torch.full((qn, k_local), sentinel, dtype=torch.int64, device=shard.device)
        if lt:
            kk = min(k_local, lt)
            qd = q.to(shard.device).contiguous()
            if fused:
                s, ii = _per_query_chunk(lambda qc: fused_scan.two_phase_sims(qc, shard, lt, kk), qd)
                dd = 1.0 - s
            else:
                from semtools_tpu_torch.ops.scan import topk_scan

                dd, ii = topk_scan(qd, shard, kk, n_true=lt,
                                   mask=None if mask is None else mask.shards[j][:lt])
            d[:, :kk] = dd
            i[:, :kk] = torch.where(torch.isfinite(dd), ii + g0, sentinel)
        dists.append(d)
        rows.append(i)
    neg, idx = merge_candidates(-_gathered(dists, dev), _gathered(rows, dev),
                                min(k_eff, mesh.size * k_local))
    return _drop_sentinels(-neg, idx, n_true, k_eff)


# -- int8 top-k ---------------------------------------------------------------


def sharded_int8_topk_scan(q, e8, e_scale: float, k: int, mesh: Optional[Mesh] = None):
    """Top-k over a global-scale int8 corpus ``e8`` [N, D] (scale
    ``e_scale``) sharded across ``mesh``: (distances [Q, k'] f32, int64
    global rows [Q, k']) ascending, distance = 1 - int_sim * q_scale *
    e_scale; integer similarities are comparable across shards because the
    scale is global, so the merge is exact over the quantized values."""
    if mesh is None:
        mesh = corpus_mesh(device=e8.device if torch.is_tensor(e8) else None)
    e8s, n = shard_corpus(e8 if torch.is_tensor(e8) else np.asarray(e8, np.int8), mesh)
    return sharded_int8_topk_scan_device(q, e8s, e_scale, k, n, mesh)


def sharded_int8_topk_scan_device(q, e8: ShardedRows, e_scale: float, k: int, n_true: int,
                                  mesh: Optional[Mesh] = None):
    """Like :func:`sharded_int8_topk_scan` over an int8 corpus already
    sharded; rows at global index >= ``n_true`` are padding. Each shard runs
    ``int8_two_phase`` (the query quantized once, with the global scale);
    the merge sorts (sim desc, index asc)."""
    from semtools_tpu_torch.ops.int8_scan import int8_two_phase, quantize_global

    mesh = mesh or e8.mesh
    dev = mesh.first
    q8, q_scale = quantize_global(torch.as_tensor(q, dtype=torch.float32).to(dev))
    qn = q8.shape[0]
    k_eff = min(k, n_true)
    if k_eff == 0:
        return _empty(qn, dev)
    k_local = min(k_eff, e8.n_local)
    sentinel = e8.n_local * mesh.size
    sims, rows = [], []
    for j, (g0, lt) in enumerate(_local_trues(e8, n_true)):
        shard = e8.shards[j]
        s = torch.full((qn, k_local), -float(1 << 30), device=shard.device)
        i = torch.full((qn, k_local), sentinel, dtype=torch.int64, device=shard.device)
        if lt:
            kk = min(k_local, lt)
            ss, ii = _per_query_chunk(
                lambda qc: int8_two_phase(qc, shard, lt, kk), q8.to(shard.device).contiguous())
            s[:, :kk], i[:, :kk] = ss, ii + g0
        sims.append(s)
        rows.append(i)
    best, idx = merge_candidates(_gathered(sims, dev), _gathered(rows, dev),
                                 min(k_eff, mesh.size * k_local))
    return _drop_sentinels(1.0 - best * (q_scale * e_scale), idx, n_true, k_eff)


# -- int4 deep candidates ----------------------------------------------------------


def sharded_int4_deep_candidates_device(
    q, p4: ShardedRows, n_true: int, mesh: Optional[Mesh] = None,
    mask: Optional[ShardedRows] = None, k_cut: int = 10, margin_sigmas: Optional[float] = None,
) -> torch.Tensor:
    """Mesh-sharded ``ops.int4_scan.int4_deep_candidates`` over a packed
    corpus already sharded: [Q, M] int64 global rows (entries >= ``n_true``
    are sentinels; shard-major, unordered). Each shard sweeps with
    ``int4_sims_max`` and offers its ``k_cut`` best (from its candidate
    blocks; -inf fill on a shard of fewer rows); the global ``k_cut``-th best
    minus the noise margin is the cutoff (-3e38 when it is -inf), the
    per-query maximum over shards of the counts above it sizes the
    extraction, and each shard extracts its rows above it from the marks of
    its count (its hit blocks' sims read once under the cap). The cutoff is the
    single-device one, so the candidate set is too. On a card every step
    after the sweeps is ``select_subtiles`` or a kernel of
    ``csrc/select_above.cu``, and the counts' maxima are the one host read
    (after ``multihost.all_max`` across processes)."""
    from semtools_tpu_torch.ops.int4_scan import (
        SIMS_ROWS, batch_maxima, block_tops, candidate_sizes, counts_above, margin_on_device,
        select_above, sims_max, tops_cutoff,
    )
    from semtools_tpu_torch.ops.int8_scan import quantize_on_device

    mesh = mesh or p4.mesh
    dev = mesh.first
    q8 = quantize_on_device(torch.as_tensor(q, dtype=torch.float32).to(dev))[0].contiguous()
    qn = q8.shape[0]
    if n_true == 0 or qn == 0:
        return torch.zeros((qn, 0), dtype=torch.int64, device=dev)
    margin = margin_on_device(q8, margin_sigmas)
    held = {}  # global row 0 -> (real rows, sims, block maxima) of each shard with rows
    tops = []
    for j, (g0, lt) in enumerate(_local_trues(p4, n_true)):
        if not lt:
            tops.append(torch.full((qn, k_cut), _NEG_INF, device=dev))
            continue
        shard, ddev = p4.shards[j], p4.shards[j].device
        m = None if mask is None else mask.shards[j]
        nb = -(-lt // SIMS_ROWS)
        sims = torch.empty((qn, nb * SIMS_ROWS), dtype=torch.float32, device=ddev)
        bmax = torch.empty((qn, nb), dtype=torch.float32, device=ddev)
        qd = q8.to(ddev)
        for c in range(0, qn, MAX_QUERIES):
            sl = slice(c, c + MAX_QUERIES)
            sims_max(qd[sl], shard, lt, m, out=(sims[sl], bmax[sl]))
        tops.append(block_tops(sims, bmax, k_cut))
        held[g0] = (lt, sims, bmax)
    cutoff = tops_cutoff(_gathered(tops, dev), margin, k_cut)
    count = torch.zeros(qn, dtype=torch.int64, device=dev)
    n_blocks = torch.zeros(qn, dtype=torch.int64, device=dev)
    shard_counts, shard_marks = {}, {}
    for g0, (_, sims, bmax) in held.items():
        shard_counts[g0], shard_blocks, shard_marks[g0] = counts_above(
            sims, bmax, cutoff.to(sims.device))
        count = torch.maximum(count, shard_counts[g0].to(dev))
        n_blocks = torch.maximum(n_blocks, shard_blocks.to(dev))
    max_count, max_nb = batch_maxima(multihost.all_max(count), multihost.all_max(n_blocks))
    if max_count == 0:
        return torch.zeros((qn, 0), dtype=torch.int64, device=dev)
    n_local = p4.n_local
    cap, n_b = candidate_sizes(max_count, max_nb, n_true, -(-n_local // SIMS_ROWS))
    cap = min(cap, n_local)
    sentinel = n_local * mesh.size
    ids = []
    for g0, _ in _local_trues(p4, n_true):
        if g0 not in held:
            ids.append(torch.full((qn, cap), sentinel, dtype=torch.int64, device=dev))
            continue
        lt, sims, bmax = held[g0]
        loc = select_above(sims, bmax, cutoff.to(sims.device), shard_counts[g0], shard_marks[g0],
                           n_b=n_b, cap=cap, max_count=max_count)
        ids.append(torch.where(loc < lt, loc + g0, sentinel))
    return _gathered(ids, dev)


# -- threshold scans ----------------------------------------------------------------


def sharded_batched_threshold_scan_device(q, e: ShardedRows, n_true: int, max_distance: float,
                                          mesh: Optional[Mesh] = None,
                                          mask: Optional[ShardedRows] = None):
    """Threshold mode for a batch of queries over rows already sharded: per
    query (distances [M_i], int64 global rows [M_i]), every row with distance
    strictly below ``max_distance``, ascending, ties to the lower row. Two
    phases over one distance block per shard: the largest per-shard hit
    count (over shards and processes) sizes the buffers, then each shard's
    ``cap`` nearest rows are gathered and filtered. ``mask`` as in
    :func:`sharded_topk_scan_device`."""
    from semtools_tpu_torch.ops.scan import cosine_distances

    mesh = mesh or e.mesh
    dev = mesh.first
    q = torch.as_tensor(q, dtype=torch.float32)
    qn = int(q.shape[0])
    empty = (torch.zeros(0, dtype=torch.float32, device=dev),
             torch.zeros(0, dtype=torch.int64, device=dev))
    if n_true == 0 or qn == 0:
        return [empty] * qn
    blocks = []
    most = torch.zeros((), dtype=torch.int64, device=dev)
    for j, (g0, lt) in enumerate(_local_trues(e, n_true)):
        if not lt:
            blocks.append(None)
            continue
        shard = e.shards[j]
        d = cosine_distances(q.to(shard.device), shard[:lt])
        if mask is not None:
            d = d.masked_fill(mask.shards[j][:lt] == 0, float("inf"))
        most = torch.maximum(most, (d < max_distance).sum(dim=1).max().to(dev))
        blocks.append((g0, d))
    most = int(multihost.all_max(most))
    if most == 0:
        return [empty] * qn
    cap = min(1 << (most - 1).bit_length(), e.n_local)
    vals, rows = [], []
    for block in blocks:
        v = torch.full((qn, cap), float("inf"), device=dev)
        i = torch.full((qn, cap), n_true, dtype=torch.int64, device=dev)
        if block is not None:
            g0, d = block
            dd, ii = torch.sort(d, dim=1, stable=True)
            c = min(cap, d.shape[1])
            v[:, :c] = dd[:, :c]
            i[:, :c] = torch.where(torch.isfinite(dd[:, :c]), ii[:, :c] + g0, n_true)
        vals.append(v)
        rows.append(i)
    vals = _gathered(vals, dev).cpu().numpy()
    rows = _gathered(rows, dev).cpu().numpy()
    out = []
    for r in range(qn):
        keep = vals[r] < max_distance
        v, i = vals[r][keep], rows[r][keep]
        order = np.lexsort((i, v))  # distance asc, index asc on ties
        out.append((torch.from_numpy(v[order]).to(dev), torch.from_numpy(i[order]).to(dev)))
    return out


def sharded_batched_threshold_scan(q, corpus, max_distance: float, mesh: Optional[Mesh] = None):
    """Host- or device-corpus wrapper for
    :func:`sharded_batched_threshold_scan_device`."""
    if mesh is None:
        mesh = corpus_mesh(device=corpus.device if torch.is_tensor(corpus) else None)
    if not torch.is_tensor(corpus):
        corpus = np.asarray(corpus, np.float32)
    e, n = shard_corpus(corpus, mesh)
    return sharded_batched_threshold_scan_device(q, e, n, max_distance, mesh)


def sharded_threshold_scan(q, corpus, max_distance: float, mesh: Optional[Mesh] = None):
    """All rows with distance < ``max_distance`` for one query row over a
    sharded corpus: (distances [M], int64 rows [M]), ascending."""
    if q.shape[0] != 1:
        raise ValueError("sharded_threshold_scan expects a single query row")
    if mesh is None:
        mesh = corpus_mesh(device=corpus.device if torch.is_tensor(corpus) else None)
    if not torch.is_tensor(corpus):
        corpus = np.asarray(corpus, np.float32)
    e, n = shard_corpus(corpus, mesh)
    return sharded_threshold_scan_device(q, e, n, max_distance, mesh)


def sharded_threshold_scan_device(q, e_sharded: ShardedRows, n_true: int, max_distance: float,
                                  mesh: Optional[Mesh] = None):
    """Threshold mode for one query row over rows already sharded: a batch of
    one through :func:`sharded_batched_threshold_scan_device`."""
    if q.shape[0] != 1:
        raise ValueError("sharded_threshold_scan expects a single query row")
    return sharded_batched_threshold_scan_device(q, e_sharded, n_true, max_distance, mesh)[0]
