"""Int4-packed scans, the store's capacity rung: wrappers of the CUDA kernels
in ``csrc/int4_scan.cu`` and their plain PyTorch versions.

Counterpart of ``semtools_tpu/ops/int4_scan.py``, whose on-disk contracts it
keeps byte for byte (each package serves the other's workspaces):

- the SPLIT-HALF biased layout: byte column j of a packed [N, D/2] row holds
  element j + 8 (in [0, 15]) in its low nibble and element j + D/2 (two's
  complement, in [-8, 7]) in its high nibble;
- freed slots of a packed slot corpus hold :data:`PACKED_ZERO_BYTE` (0x08),
  the packing of the zero vector.

Queries stay int8 (``int8_scan.quantize_global``). The kernels and plain
versions compute BIASED integer similarities,
``(p & 15) . q[:D/2] + (p >> 4) . q[D/2:] = sims_true + 8 * sum(q[:D/2])``,
a per-query constant shift that no per-query selection sees; they are exact
(|sim| < 2^24), so kernel and plain version agree bit for bit.

Two selection paths share the packed corpus:

- :func:`int4_deep_candidates` (the store's serving path; kernel
  ``int4_sims_max[_masked]``, replacing ``_sims_max_kernel[_masked]``): one
  sweep writes every row's sim and every 512-row block's max, then
  :func:`cutoff_counts` takes each query's exact ``k_cut``-th best minus a
  noise margin and :func:`extract_above` returns every row at or above it,
  up to a cap;
- :func:`int4_topk_scan` (exact top-k over the quantized sims; kernels
  ``int4_tilemax``, ``select_subtiles`` and ``int4_rescan_topk``, and the
  masked variants, replacing K5a-d and the XLA steps between and after
  them): the two-phase scan of :mod:`int8_scan` on packed rows.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version (``*_reference``), which the tests hold
against the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from semtools_tpu_torch.ops import kernels
from semtools_tpu_torch.ops.fused_scan import (
    MAX_QUERIES,
    _sort_desc,
    _stream,
    top_subtiles,
)
from semtools_tpu_torch.ops import int8_scan
from semtools_tpu_torch.ops.int8_scan import (
    _REF_CHUNK,
    _check_n_true,
    _keep_rows,
    _kernel_name,
    _on_cpu,
    launch_rescan_topk,
    launch_tilemax,
    quantize_global,
)
from semtools_tpu_torch.utils.env import env_int

# pack_int4 of the zero vector: low nibble biased (+8), high nibble 0. A raw
# 0x00 byte decodes to (lo=-8, hi=0) and scores biased sim 0, while real rows
# carry the +8*sum(q_lo) bias: for queries with a negative low-half sum a
# 0x00 row would outrank every real row. 0x08 rows score exactly the bias
# (true sim 0, distance 1.0), as zero rows do on the f32 and int8 tiers.
PACKED_ZERO_BYTE = 8

# Rows per block of the deep-candidate sweep: the JAX package's SUB_N. The
# extraction ranks these blocks by their max, so the same block size gives
# the same candidate set when a query has more candidates than the cap.
SIMS_ROWS = 512

_NEG_INF = float("-inf")
_QUANT_CHUNK_ELEMS = 1 << 24  # bounds quantize temporaries to ~64 MB f32


# -- host side: packing and the tier's knobs ----------------------------------


def pack_int4(q: np.ndarray) -> np.ndarray:
    """[N, D] int8 values in [-8, 7] -> [N, D/2] packed int8 (split-half,
    low nibble biased by +8)."""
    q = np.asarray(q, np.int8)
    d = q.shape[1]
    lo = (q[:, : d // 2].astype(np.int16) + 8).astype(np.uint8) & 0xF
    hi = q[:, d // 2 :].astype(np.uint8) & 0xF
    return (lo | (hi << 4)).astype(np.int8)


def unpack_int4(p: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4` (host side)."""
    p32 = np.asarray(p).astype(np.int32)
    lo = (p32 & 15) - 8
    hi = p32 >> 4
    return np.concatenate([lo, hi], axis=1).astype(np.int8)


def quantize_pack_global(x: np.ndarray) -> Tuple[np.ndarray, float]:
    """Symmetric 4-bit quantization with one global scale, split-half
    packed: ([N, D/2] int8, scale) with x ~= unpack(packed) * scale. Values
    clip to [-7, 7]; an all-zero input packs to :data:`PACKED_ZERO_BYTE`."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d % 2:
        raise ValueError(f"int4 packing needs an even dim, got {d}")
    rows_per_chunk = max(_QUANT_CHUNK_ELEMS // d, 1)
    amax = 0.0
    for i in range(0, n, rows_per_chunk):
        blk = x[i : i + rows_per_chunk]
        if blk.size:
            amax = max(amax, float(np.max(np.abs(blk))))
    scale = amax / 7.0
    if scale == 0.0:
        return np.full((n, d // 2), PACKED_ZERO_BYTE, np.int8), 0.0
    out = np.empty((n, d // 2), np.int8)
    for i in range(0, n, rows_per_chunk):
        q = np.clip(np.rint(x[i : i + rows_per_chunk] / scale), -7, 7).astype(np.int8)
        out[i : i + rows_per_chunk] = pack_int4(q)
    return out, scale


def int4_margin_sigmas() -> float:
    """Noise margin of the deep-candidate cutoff, in per-query sim-error
    standard deviations (``SEMTOOLS_TPU_INT4_MARGIN_SIGMAS``, default 6):
    the corpus rounding error of one biased sim has std ||q8|| / sqrt(12)."""
    try:
        return float(os.environ.get("SEMTOOLS_TPU_INT4_MARGIN_SIGMAS", "") or 6.0)
    except ValueError:
        return 6.0


def int4_candidate_cap(n_rows: int) -> int:
    """Ceiling on the per-query candidate count: n/128 rounded up to a power
    of two, at least 4096 and at most 2^17 rows (``SEMTOOLS_TPU_INT4_CAP``
    overrides). Past it the extraction keeps the cap's best-ranked rows."""
    env = env_int("SEMTOOLS_TPU_INT4_CAP", 0)
    if env > 0:
        return min(env, max(n_rows, 1))
    target = max(4096, n_rows >> 7)
    return min(1 << (target - 1).bit_length(), 1 << 17, max(n_rows, 1))


# -- plain versions -----------------------------------------------------------


def unpack_f32(p4: torch.Tensor) -> torch.Tensor:
    """Packed rows [..., D/2] -> [..., D] f32 of (biased low, signed high)
    nibbles: the kernels' operand, so q8 . unpack_f32(p4) is the biased sim."""
    return torch.cat([p4 & 15, p4 >> 4], dim=-1).float()


def tilemax_reference(q8, p4, n_true: int, mask=None) -> torch.Tensor:
    """[Q, ceil(n_true / SUB_ROWS)] per-sub-tile max biased sims; rows
    >= n_true, and rows where ``mask`` is 0, read as -inf."""
    return int8_scan.tilemax_reference(q8, p4, n_true, mask, widen=unpack_f32)


def rescan_reference(q8, p4, n_true: int, sub_ids, k: int, mask=None):
    """Each query's top-k biased sims inside each of its sub-tiles
    ``sub_ids`` [Q, kt] -> ([Q, kt, k] sims, [Q, kt, k] int64 rows)."""
    return int8_scan.rescan_reference(q8, p4, n_true, sub_ids, k, mask, widen=unpack_f32)


def rescan_topk_reference(q8, p4, n_true: int, sub_ids, k: int, mask=None):
    """Each query's top-k biased sims of the rows of its sub-tiles ``sub_ids``
    [Q, kt] -> ([Q, k] sims desc, [Q, k] int64 rows); for k above SUB_ROWS
    every sub-tile is taken whole."""
    return int8_scan.rescan_topk_reference(q8, p4, n_true, sub_ids, k, mask, widen=unpack_f32)


def _num_sims_blocks(n_true: int) -> int:
    return -(-n_true // SIMS_ROWS)


def sims_max_reference(q8, p4, n_true: int, mask=None):
    """([Q, n_pad] biased sims, [Q, n_pad / SIMS_ROWS] block maxima), n_pad =
    SIMS_ROWS * ceil(n_true / SIMS_ROWS); rows >= n_true and rows where
    ``mask`` is 0 read as -inf. Unpacks in row chunks."""
    nb = _num_sims_blocks(n_true)
    qf = q8.float()
    keep = _keep_rows(mask, n_true, p4.device)
    sims = torch.full((q8.shape[0], nb * SIMS_ROWS), _NEG_INF, device=p4.device)
    for start in range(0, n_true, _REF_CHUNK):
        stop = min(start + _REF_CHUNK, n_true)
        sims[:, start:stop] = (qf @ unpack_f32(p4[start:stop]).T).masked_fill(
            ~keep[start:stop], _NEG_INF)
    return sims, sims.view(q8.shape[0], nb, SIMS_ROWS).amax(dim=2)


# -- kernel wrappers ------------------------------------------------------------


def tilemax(q8, p4, n_true: int, mask=None) -> torch.Tensor:
    """Phase 1 (kernel ``int4_tilemax[_masked]``): see :func:`tilemax_reference`."""
    if _on_cpu(q8, p4, mask, "int4"):
        return tilemax_reference(q8, p4, n_true, mask)
    return launch_tilemax("int4", q8, p4, n_true, mask)


def rescan_topk(q8, p4, n_true: int, sub_ids, k: int, mask=None):
    """Phase 2 and the merge (kernel ``int4_rescan_topk[_masked]``): see
    :func:`rescan_topk_reference`."""
    if _on_cpu(q8, p4, mask, "int4"):
        return rescan_topk_reference(q8, p4, n_true, sub_ids, k, mask)
    return launch_rescan_topk("int4", q8, p4, n_true, sub_ids, k, mask)


def sims_max(q8, p4, n_true: int, mask=None, out=None):
    """The deep-candidate sweep (kernel ``int4_sims_max[_masked]``): see
    :func:`sims_max_reference`. ``out`` = (sims, maxima) tensors to fill,
    e.g. row slices of one buffer for a larger query batch."""
    if _on_cpu(q8, p4, mask, "int4"):
        res = sims_max_reference(q8, p4, n_true, mask)
        if out is None:
            return res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return out
    _check_n_true(p4, mask, n_true)
    qn, nb = q8.shape[0], _num_sims_blocks(n_true)
    if out is None:
        out = (torch.empty((qn, nb * SIMS_ROWS), dtype=torch.float32, device=p4.device),
               torch.empty((qn, nb), dtype=torch.float32, device=p4.device))
    sims, block_max = out
    for t, shape in ((sims, (qn, nb * SIMS_ROWS)), (block_max, (qn, nb))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != p4.device
                or not t.is_contiguous()):
            raise ValueError(f"sims_max output {tuple(t.shape)} {t.dtype} on {t.device}: "
                             f"needs a contiguous f32 {shape} on {p4.device}")
    code = kernels.library().semtools_int4_sims_max(
        q8.data_ptr(), p4.data_ptr(), None if mask is None else mask.data_ptr(),
        qn, q8.shape[1], n_true, sims.data_ptr(), block_max.data_ptr(), nb, _stream(),
    )
    kernels.check(code, _kernel_name("int4", "sims_max", mask))
    return out


# -- the deep-candidate extraction (plain torch, as XLA in the JAX package) ---


def _gather_blocks(sims: torch.Tensor, bids: torch.Tensor) -> torch.Tensor:
    """[Q, len(bids) * SIMS_ROWS]: each query's blocks ``bids`` in order."""
    qn = sims.shape[0]
    blocks = sims.view(qn, -1, SIMS_ROWS)
    return blocks.gather(1, bids[:, :, None].expand(-1, -1, SIMS_ROWS)).reshape(qn, -1)


def cutoff_counts(sims, block_max, margin: torch.Tensor, k_cut: int):
    """(cutoff [Q] f32, count [Q], n_blocks [Q]): cutoff = the exact
    ``k_cut``-th best biased sim minus ``margin`` (an f32 tensor; -3e38 when
    fewer than ``k_cut`` rows are selectable), count = rows at or above it,
    n_blocks = blocks whose max is at or above it. The ``k_cut`` best blocks
    hold the ``k_cut`` best rows (a block ranks by its best row)."""
    kb = min(k_cut, block_max.shape[1])
    cand = _gather_blocks(sims, _sort_desc(block_max, kb)[1])
    t = _sort_desc(cand, min(k_cut, cand.shape[1]))[0][:, -1]
    cutoff = torch.where(torch.isfinite(t), t - margin, torch.full_like(t, -3e38))
    count = (sims >= cutoff[:, None]).sum(dim=1)
    n_blocks = (block_max >= cutoff[:, None]).sum(dim=1)
    return cutoff, count, n_blocks


def extract_above(sims, block_max, cutoff, *, n_b: int, cap: int) -> torch.Tensor:
    """[Q, cap] int64 rows with sims >= cutoff (unordered), filled with
    n_pad = sims.shape[1] (always >= the corpus rows) past each query's count.

    ``n_b`` bounds every query's count of blocks at or above the cutoff, so
    its ``n_b`` best blocks hold every candidate; the values are chosen among
    those blocks' rows only. Both choices are stable descending sorts, so ties
    keep JAX's ``lax.top_k`` order (block max desc, block id asc, then row):
    past the cap the same rows are kept."""
    n_pad = sims.shape[1]
    kb = min(n_b, block_max.shape[1])
    bids = _sort_desc(block_max, kb)[1]
    k_in = min(cap, kb * SIMS_ROWS)
    vals, pos = _sort_desc(_gather_blocks(sims, bids), k_in)
    rows = bids.gather(1, pos // SIMS_ROWS) * SIMS_ROWS + pos % SIMS_ROWS
    ids = torch.where(vals >= cutoff[:, None], rows, n_pad)
    return F.pad(ids, (0, cap - k_in), value=n_pad)


def select_candidates(q8, sims, block_max, n_rows: int, *,
                      margin_sigmas: Optional[float] = None, k_cut: int = 10) -> torch.Tensor:
    """The extraction half of :func:`int4_deep_candidates`, on a sweep's
    ([Q, n_pad] sims, [Q, n_pad / SIMS_ROWS] block maxima) of ``n_rows``
    rows for the int8 queries ``q8``.

    One margin for the batch, from the largest query int norm (float64, then
    f32); ``cap`` and ``n_b`` from the whole batch's counts, rounded up to
    powers of two, as in the JAX package."""
    if margin_sigmas is None:
        margin_sigmas = int4_margin_sigmas()
    sigma = float(np.max(np.linalg.norm(q8.cpu().numpy().astype(np.float64), axis=1))) \
        / np.sqrt(12.0)
    margin = torch.tensor(np.float32(margin_sigmas * sigma), device=sims.device)
    cutoff, count, n_blocks = cutoff_counts(sims, block_max, margin, k_cut)
    max_count, max_nb = int(count.max()), int(n_blocks.max())
    cap = min(1 << max((max_count - 1).bit_length(), 4), int4_candidate_cap(n_rows))
    n_b = min(1 << max((max_nb - 1).bit_length(), 2), block_max.shape[1])
    return extract_above(sims, block_max, cutoff, n_b=n_b, cap=cap)


def int4_deep_candidates(
    q, p4: torch.Tensor, *, n_true: Optional[int] = None, mask=None,
    margin_sigmas: Optional[float] = None, k_cut: int = 10,
) -> torch.Tensor:
    """The serving tier's candidate generator: every row whose biased int4
    sim is within the noise margin of the query's exact ``k_cut``-th best, as
    [Q, cap] int64 rows on the corpus device (unordered; entries >= the
    corpus rows are sentinels). ``q`` is f32 [Q, D] (numpy or tensor),
    quantized here; rows >= ``n_true`` and rows where ``mask`` is 0 are
    never candidates. Batches above 32 queries sweep in chunks of 32 into
    one [Q, n_pad] buffer; :func:`select_candidates` extracts from it."""
    dev = p4.device
    q8, _ = quantize_global(torch.as_tensor(q, dtype=torch.float32).to(dev))
    q8 = q8.contiguous()
    qn = q8.shape[0]
    n = p4.shape[0] if n_true is None else min(n_true, p4.shape[0])
    if n == 0:
        return torch.zeros((qn, 0), dtype=torch.int64, device=dev)
    if mask is not None:
        mask = mask.to(device=dev, dtype=torch.uint8).contiguous()
    nb = _num_sims_blocks(n)
    sims = torch.empty((qn, nb * SIMS_ROWS), dtype=torch.float32, device=dev)
    block_max = torch.empty((qn, nb), dtype=torch.float32, device=dev)
    for q0 in range(0, qn, MAX_QUERIES):
        q1 = min(q0 + MAX_QUERIES, qn)
        sims_max(q8[q0:q1], p4, n, mask, out=(sims[q0:q1], block_max[q0:q1]))
    return select_candidates(q8, sims, block_max, n, margin_sigmas=margin_sigmas, k_cut=k_cut)


# -- the exact two-phase top-k --------------------------------------------------


def int4_two_phase(q8, p4, n_true: int, k: int, mask=None):
    """Exact top-k biased sims of at most 32 queries: ([Q, k] sims desc,
    [Q, k] int64 rows), ties toward the lower row; -inf filler when fewer
    than k rows are kept. For k above SUB_ROWS every chosen sub-tile is taken
    whole, which keeps it exact."""
    sub_max = tilemax(q8, p4, n_true, mask)
    return rescan_topk(q8, p4, n_true, top_subtiles(sub_max, min(k, sub_max.shape[1])), k, mask)


def int4_topk_scan(
    q, p4: torch.Tensor, e_scale: float, k: int, *,
    n_true: Optional[int] = None, mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a globally scaled int4-packed corpus ``p4`` [N, D/2] (scale
    ``e_scale``); ``q`` is f32 [Q, D] (numpy or tensor), quantized here.

    Same contract as :func:`int8_scan.int8_topk_scan`: rows >= ``n_true`` are
    not read, rows where ``mask`` is 0 are never selected; returns
    (distances [Q, k'] f32, int64 rows [Q, k']) on the corpus device,
    ascending, k' = min(k, n_true), +inf filler when fewer rows are kept.
    distance = 1 - (sims - 8 * sum(q8[:D/2])) * (q_scale * e_scale), in
    float64 then f32, as the JAX package computes it. Any Q and k: queries
    go through the kernels 32 at a time."""
    dev = p4.device
    q8, q_scale = quantize_global(torch.as_tensor(q, dtype=torch.float32).to(dev))
    q8 = q8.contiguous()
    qn = q8.shape[0]
    n = p4.shape[0] if n_true is None else min(n_true, p4.shape[0])
    k_eff = min(k, n)
    if k_eff == 0:
        return (torch.zeros((qn, 0), dtype=torch.float32, device=dev),
                torch.zeros((qn, 0), dtype=torch.int64, device=dev))
    if mask is not None:
        mask = mask.to(device=dev, dtype=torch.uint8).contiguous()
    parts = [int4_two_phase(q8[q0 : q0 + MAX_QUERIES], p4, n, k_eff, mask)
             for q0 in range(0, qn, MAX_QUERIES)]
    sims = torch.cat([v for v, _ in parts])
    idx = torch.cat([i for _, i in parts])
    bias = 8.0 * q8[:, : p4.shape[1]].double().sum(dim=1, keepdim=True)
    return (1.0 - (sims.double() - bias) * (q_scale * e_scale)).float(), idx
