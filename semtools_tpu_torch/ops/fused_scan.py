"""Fused cosine scan + exact top-k: wrappers of the CUDA kernels in
``csrc/fused_scan.cu`` and their plain PyTorch versions.

Counterpart of ``semtools_tpu/ops/pallas_scan.py``. Three kernels:

- :func:`tilemax` (phase 1 of the two-phase scan, replaces ``_tilemax_kernel``):
  each query's max similarity over every ``SUB_ROWS``-row sub-tile;
- :func:`rescan` (phase 2, replaces ``_rescan_kernel``): for each (query,
  chosen sub-tile), that query's exact top-k of the sub-tile;
- :func:`scan_candidates` (single phase, replaces ``_scan_kernel``): each
  tile's exact top-k for every query.

The steps between them (selecting each query's sub-tiles, merging the
candidates) are plain torch, as they are XLA in the JAX package. Ties go to
the lower corpus index everywhere, which is what makes the two-phase scan
exact (KERNELS.md "Two-phase kernel").

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version (``*_reference``), which the tests hold
against the JAX package. The main path on a CUDA device never runs a plain
version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from semtools_tpu_torch.ops import kernels

# Rows per sub-tile (phases 1 and 2) and per tile (single phase): the
# kernels' block of 128 threads, one row each (csrc/fused_scan.cu "Sizes").
SUB_ROWS = 128
# Routing limits of the fused scan (kept from the JAX package's
# _use_pallas until H100 crossovers are measured).
MAX_QUERIES = 32
MAX_K = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = float("-inf")


def _num_blocks(n_true: int) -> int:
    return -(-n_true // SUB_ROWS)


def _sort_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First k of the last dim by (value desc, position asc)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _sims(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return q.float() @ e.float().T


# -- plain versions -----------------------------------------------------------


def tilemax_reference(q, e, n_true: int) -> torch.Tensor:
    """[Q, ceil(n_true / SUB_ROWS)] per-sub-tile max sims; rows >= n_true
    read as -inf."""
    s = _num_blocks(n_true)
    sims = F.pad(_sims(q, e[:n_true]), (0, s * SUB_ROWS - n_true), value=_NEG_INF)
    return sims.view(q.shape[0], s, SUB_ROWS).amax(dim=2)


def rescan_reference(q, e, n_true: int, sub_ids, k: int):
    """Each query's top-k inside each of its sub-tiles ``sub_ids`` [Q, kt]
    -> ([Q, kt, k] sims, [Q, kt, k] int64 corpus rows)."""
    rows = sub_ids[..., None] * SUB_ROWS + torch.arange(SUB_ROWS, device=e.device)
    valid = rows < n_true
    blocks = e[rows.clamp(max=n_true - 1)].float()  # [Q, kt, SUB, D]
    sims = torch.einsum("qd,qtsd->qts", q.float(), blocks)
    vals, pos = _sort_desc(sims.masked_fill(~valid, _NEG_INF), k)
    return vals, rows.gather(-1, pos)


def scan_candidates_reference(q, e, n_true: int, k: int):
    """Each SUB_ROWS-row tile's top-k for every query -> ([T, Q, k] sims,
    [T, Q, k] int64 corpus rows), T = ceil(n_true / SUB_ROWS)."""
    t = _num_blocks(n_true)
    sims = F.pad(_sims(q, e[:n_true]), (0, t * SUB_ROWS - n_true), value=_NEG_INF)
    vals, pos = _sort_desc(sims.view(q.shape[0], t, SUB_ROWS), k)
    idx = pos + (torch.arange(t, device=e.device) * SUB_ROWS)[:, None]
    return vals.transpose(0, 1).contiguous(), idx.transpose(0, 1).contiguous()


# -- kernel wrappers ------------------------------------------------------------


def _on_cpu(q, e) -> bool:
    if q.device.type == "cpu" and e.device.type == "cpu":
        return True
    if q.device != e.device or e.device.type != "cuda":
        raise ValueError(
            f"fused scan operands must share one CUDA device (or both lie on "
            f"the CPU); got q on {q.device}, e on {e.device}"
        )
    if q.dtype != torch.float32 or e.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"fused scan takes f32 queries and an f32/bf16 corpus; got "
            f"{q.dtype}, {e.dtype}"
        )
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, e {tuple(e.shape)}")
    if not (1 <= q.shape[0] <= MAX_QUERIES):
        raise ValueError(f"{q.shape[0]} queries; the kernels take 1..{MAX_QUERIES}")
    if not (q.is_contiguous() and e.is_contiguous()):
        raise ValueError("fused scan operands must be contiguous")
    if (e.shape[1] * e.element_size()) % 16 or e.data_ptr() % 16:
        raise ValueError("corpus rows must be 16-byte aligned (D * itemsize % 16 == 0)")
    return False


def _check_n_true(e, n_true: int) -> None:
    if not (1 <= n_true <= e.shape[0]):
        raise ValueError(f"n_true={n_true} outside 1..{e.shape[0]}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def tilemax(q, e, n_true: int) -> torch.Tensor:
    """Phase 1 (kernel ``fused_tilemax``): see :func:`tilemax_reference`."""
    if _on_cpu(q, e):
        return tilemax_reference(q, e, n_true)
    _check_n_true(e, n_true)
    s = _num_blocks(n_true)
    out = torch.empty((q.shape[0], s), dtype=torch.float32, device=e.device)
    code = kernels.library().semtools_fused_tilemax(
        q.data_ptr(), e.data_ptr(), _DTYPE_CODES[e.dtype], q.shape[0], e.shape[1],
        n_true, out.data_ptr(), s, _stream(),
    )
    kernels.check(code, "fused_tilemax")
    return out


def rescan(q, e, n_true: int, sub_ids, k: int):
    """Phase 2 (kernel ``fused_rescan``): see :func:`rescan_reference`."""
    if _on_cpu(q, e):
        return rescan_reference(q, e, n_true, sub_ids, k)
    _check_n_true(e, n_true)
    qn, kt = sub_ids.shape
    if qn != q.shape[0] or not (1 <= k <= SUB_ROWS):
        raise ValueError(f"sub_ids {tuple(sub_ids.shape)} / k={k} do not fit q {tuple(q.shape)}")
    if sub_ids.device != e.device or sub_ids.dtype != torch.int64:
        raise TypeError("sub_ids must be int64 on the corpus device")
    sub_ids = sub_ids.contiguous()
    vals = torch.empty((qn, kt, k), dtype=torch.float32, device=e.device)
    idx = torch.empty((qn, kt, k), dtype=torch.int64, device=e.device)
    code = kernels.library().semtools_fused_rescan(
        q.data_ptr(), e.data_ptr(), _DTYPE_CODES[e.dtype], qn, e.shape[1], n_true,
        sub_ids.data_ptr(), kt, k, vals.data_ptr(), idx.data_ptr(), _stream(),
    )
    kernels.check(code, "fused_rescan")
    return vals, idx


def scan_candidates(q, e, n_true: int, k: int):
    """Single phase (kernel ``fused_scan_candidates``): see
    :func:`scan_candidates_reference`."""
    if _on_cpu(q, e):
        return scan_candidates_reference(q, e, n_true, k)
    _check_n_true(e, n_true)
    if not (1 <= k <= SUB_ROWS):
        raise ValueError(f"k={k} outside 1..{SUB_ROWS}")
    t = _num_blocks(n_true)
    qn = q.shape[0]
    vals = torch.empty((t, qn, k), dtype=torch.float32, device=e.device)
    idx = torch.empty((t, qn, k), dtype=torch.int64, device=e.device)
    code = kernels.library().semtools_fused_scan_candidates(
        q.data_ptr(), e.data_ptr(), _DTYPE_CODES[e.dtype], qn, e.shape[1], n_true, k,
        vals.data_ptr(), idx.data_ptr(), t, _stream(),
    )
    kernels.check(code, "fused_scan_candidates")
    return vals, idx


# -- the steps between (plain torch, as XLA in the JAX package) ---------------


def select_subtiles(sub_max: torch.Tensor, k_tiles: int) -> torch.Tensor:
    """[Q, S] sub-tile maxima -> [Q, k_tiles] int64 ids of each query's best
    sub-tiles; ties prefer the lower sub-tile (the exactness proof needs it)."""
    return _sort_desc(sub_max, k_tiles)[1]


def merge_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """[Q, C] candidates in any order -> ([Q, k] sims desc, [Q, k] rows),
    ties toward the lower corpus index (two-key sort)."""
    order = torch.argsort(idx, dim=1, stable=True)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    best, pos = _sort_desc(vals, k)
    return best, idx.gather(1, pos)


def _two_phase_topk(q, e, n_true: int, k: int):
    """Exact top-k (distances asc) via sub-tile-max sweep + rescan."""
    sub_max = tilemax(q, e, n_true)
    sub_ids = select_subtiles(sub_max, min(k, sub_max.shape[1]))
    vals, idx = rescan(q, e, n_true, sub_ids, k)
    best, ids = merge_candidates(vals.flatten(1), idx.flatten(1), k)
    return 1.0 - best, ids


def _single_phase_topk(q, e, n_true: int, k: int):
    """Exact top-k (distances asc) via per-tile candidates + merge."""
    vals, idx = scan_candidates(q, e, n_true, k)
    best, ids = merge_candidates(
        vals.transpose(0, 1).flatten(1), idx.transpose(0, 1).flatten(1), k
    )
    return 1.0 - best, ids


def fused_topk_scan(q, e, k: int, n_true: Optional[int] = None):
    """Exact top-k cosine-distance scan through the fused kernels.

    Same contract as :func:`semtools_tpu_torch.ops.scan.topk_scan`:
    unit-or-zero rows in, (distances [Q, k'], int64 indices [Q, k']) out on
    the corpus device, ascending distance, ties in corpus order, k' =
    min(k, n_true). Rows at index >= ``n_true`` are padding.
    """
    n = e.shape[0] if n_true is None else min(n_true, e.shape[0])
    qn = q.shape[0]
    k_eff = min(k, n)
    if k_eff == 0:
        return (torch.zeros((qn, 0), dtype=torch.float32, device=e.device),
                torch.zeros((qn, 0), dtype=torch.int64, device=e.device))
    if qn > MAX_QUERIES or k_eff > SUB_ROWS:
        raise ValueError(
            f"fused_topk_scan takes <= {MAX_QUERIES} queries and k <= "
            f"{SUB_ROWS}; batched workloads use the plain scan (see topk_scan)"
        )
    q = q.to(device=e.device, dtype=torch.float32).contiguous()
    num_tiles = _num_blocks(n)
    # Two-phase pays one extra sub-tile read per (query, candidate sub-tile);
    # it wins once that rescan is small next to the per-tile extraction it
    # removes (the JAX package's rule, pallas_scan.py:439).
    if num_tiles > 2 * qn * min(k_eff, num_tiles):
        return _two_phase_topk(q, e, n, k_eff)
    return _single_phase_topk(q, e, n, k_eff)
