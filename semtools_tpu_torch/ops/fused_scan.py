"""Fused cosine scan + exact top-k: wrappers of the CUDA kernels in
``csrc/fused_scan.cu`` and their plain PyTorch versions.

Counterpart of ``semtools_tpu/ops/pallas_scan.py``. The kernels:

- :func:`tilemax` (phase 1 of the two-phase scan, replaces ``_tilemax_kernel``):
  each query's max similarity over every ``SUB_ROWS``-row sub-tile;
- :func:`top_subtiles` (kernel ``select_subtiles``, replaces the
  ``lax.top_k`` between the phases, XLA in the JAX package; shared with the
  int8 and int4 scans): each query's best sub-tiles by their maxima;
- :func:`rescan_topk` (phase 2 and the merge, replaces ``_rescan_kernel`` and
  ``merge_candidates_sorted``): each query's exact top-k of the rows of its
  chosen sub-tiles, in one launch;
- :func:`scan_candidates` (single phase, replaces ``_scan_kernel``): each
  tile's exact top-k for every query, merged by :func:`merge_candidates`.

So on the card phase 1 is followed by two launches and no torch op until
the ``[Q, k]`` answer. Ties go to the lower corpus index everywhere, which is
what makes the two-phase scan exact (KERNELS.md "Two-phase kernel").

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
# Sub-tile maxima per block of the selection kernel (csrc/select.cu); a
# row of more is cut into chunks whose best go to the query's last block.
SELECT_CHUNK = 4096
# Most keys a query's selection holds (csrc/topk.cuh MAX_SELECT): the k of
# the rescan and the k_tiles of the selection on the card.
MAX_SELECT = 16384

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


def rescan_topk_reference(q, e, n_true: int, sub_ids, k: int):
    """Each query's top-k of the rows of its sub-tiles ``sub_ids`` [Q, kt]
    -> ([Q, k] sims desc, [Q, k] int64 rows), ties toward the lower row:
    :func:`rescan_reference` (whole sub-tiles for k above SUB_ROWS) merged
    by :func:`merge_candidates`."""
    vals, idx = rescan_reference(q, e, n_true, sub_ids, min(k, SUB_ROWS))
    return merge_candidates(vals.flatten(1), idx.flatten(1), k)


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


def check_subtile_ids(sub_ids, qn: int, k: int, device) -> int:
    """Raise unless ``sub_ids`` is each of the ``qn`` queries' int64 sub-tile
    ids on ``device``, enough rows for k; returns the ids per query."""
    if sub_ids.dim() != 2 or sub_ids.shape[0] != qn:
        raise ValueError(f"sub_ids {tuple(sub_ids.shape)} do not fit {qn} queries")
    kt = sub_ids.shape[1]
    if not (1 <= k <= min(kt * SUB_ROWS, MAX_SELECT)):
        raise ValueError(f"k={k} outside 1..{min(kt * SUB_ROWS, MAX_SELECT)} for {kt} sub-tiles")
    if sub_ids.device != device or sub_ids.dtype != torch.int64 or not sub_ids.is_contiguous():
        raise TypeError("sub_ids must be contiguous int64 on the corpus device")
    return kt


def rescan_scratch(qn: int, kt: int, device) -> torch.Tensor:
    """The 64-bit candidate keys a rescan_topk launch passes between its
    blocks (csrc/topk.cuh): at most every row of every chosen sub-tile."""
    return torch.empty(qn * kt * SUB_ROWS, dtype=torch.int64, device=device)


def rescan_topk(q, e, n_true: int, sub_ids, k: int):
    """Phase 2 and the merge (kernel ``fused_rescan_topk``): see
    :func:`rescan_topk_reference`."""
    if _on_cpu(q, e):
        return rescan_topk_reference(q, e, n_true, sub_ids, k)
    _check_n_true(e, n_true)
    qn = q.shape[0]
    kt = check_subtile_ids(sub_ids, qn, k, e.device)
    vals = torch.empty((qn, k), dtype=torch.float32, device=e.device)
    idx = torch.empty((qn, k), dtype=torch.int64, device=e.device)
    # held until the launch returns: freed earlier, another thread's
    # allocation could take the block before the kernel writes it
    scratch = rescan_scratch(qn, kt, e.device)
    code = kernels.library().semtools_fused_rescan_topk(
        q.data_ptr(), e.data_ptr(), _DTYPE_CODES[e.dtype], qn, e.shape[1], n_true,
        sub_ids.data_ptr(), kt, k, scratch.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), _stream(),
    )
    kernels.check(code, "fused_rescan_topk")
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


# -- the sub-tile selection (XLA in the JAX package) and the merge ------------


def select_subtiles(sub_max: torch.Tensor, k_tiles: int) -> torch.Tensor:
    """[Q, S] sub-tile maxima -> [Q, k_tiles] int64 ids of each query's best
    sub-tiles; ties prefer the lower sub-tile (the exactness proof needs it).
    The plain version of :func:`top_subtiles`."""
    return _sort_desc(sub_max, k_tiles)[1]


def top_subtiles(sub_max: torch.Tensor, k_tiles: int) -> torch.Tensor:
    """The sub-tile selection of every two-phase scan (kernel
    ``select_subtiles``): see :func:`select_subtiles`."""
    if sub_max.device.type == "cpu":
        return select_subtiles(sub_max, k_tiles)
    if sub_max.device.type != "cuda" or sub_max.dtype != torch.float32 or sub_max.dim() != 2 \
            or not sub_max.is_contiguous():
        raise TypeError(f"sub-tile maxima must be a contiguous 2-d f32 CUDA or CPU tensor; "
                        f"got {sub_max.dtype} {tuple(sub_max.shape)} on {sub_max.device}")
    qn, s = sub_max.shape
    if not (1 <= qn <= MAX_QUERIES and 1 <= k_tiles <= min(s, MAX_SELECT)):
        raise ValueError(f"k_tiles={k_tiles} of {s} sub-tiles for {qn} queries: the kernel "
                         f"takes 1..{MAX_QUERIES} queries and 1..{MAX_SELECT} sub-tiles")
    ids = torch.empty((qn, k_tiles), dtype=torch.int64, device=sub_max.device)
    chunks = -(-s // SELECT_CHUNK)
    scratch = None if chunks == 1 else torch.empty(
        qn * chunks * min(k_tiles, SELECT_CHUNK), dtype=torch.int64, device=sub_max.device)
    code = kernels.library().semtools_select_subtiles(
        sub_max.data_ptr(), qn, s, k_tiles, SELECT_CHUNK, ids.data_ptr(),
        None if scratch is None else scratch.data_ptr(), _stream(),
    )
    kernels.check(code, "select_subtiles")
    return ids


def merge_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """[Q, C] candidates in any order -> ([Q, k] sims desc, [Q, k] rows),
    ties toward the lower corpus index (two-key sort)."""
    order = torch.argsort(idx, dim=1, stable=True)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    best, pos = _sort_desc(vals, k)
    return best, idx.gather(1, pos)


def two_phase_sims(q, e, n_true: int, k: int):
    """Exact top-k ([Q, k] sims desc, [Q, k] rows) via sub-tile-max sweep,
    selection and rescan."""
    sub_max = tilemax(q, e, n_true)
    return rescan_topk(q, e, n_true, top_subtiles(sub_max, min(k, sub_max.shape[1])), k)


def _two_phase_topk(q, e, n_true: int, k: int):
    """Exact top-k (distances asc) via :func:`two_phase_sims`."""
    best, ids = two_phase_sims(q, e, n_true, k)
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
