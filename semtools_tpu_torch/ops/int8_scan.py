"""Int8-quantized exact top-k scan: wrappers of the CUDA kernels in
``csrc/int8_scan.cu`` and their plain PyTorch versions.

Counterpart of ``semtools_tpu/ops/int8_scan.py``. One global scale
quantizes the whole corpus (and one the query batch): ``x ~= q8 * scale``.
Integer similarities ``q8 . e8`` are exact and monotonic in the quantized
similarity, so selection over them is exact; the scalar factor turns them
into distances once at the end, ``1 - sims * (q_scale * e_scale)``.

The scan is the two-phase structure of :mod:`fused_scan` over int8 rows:

- :func:`tilemax` (phase 1, replaces ``_tilemax_kernel`` /
  ``_tilemax_kernel_masked``): each query's max integer sim over every
  ``SUB_ROWS``-row sub-tile;
- :func:`fused_scan.top_subtiles` (the format-independent selection kernel,
  replacing the ``lax.top_k`` between the phases): each query's best
  sub-tiles;
- :func:`rescan_topk` (phase 2 and the merge, replaces ``_rescan_kernel`` /
  ``_rescan_kernel_masked`` and ``merge_candidates_sorted``): each query's
  exact top-k of the rows of its chosen sub-tiles, in one launch.

With ``mask`` (a uint8/bool keep vector over the rows), rows where it is 0
read as -inf in both phases: path-subset serving on the store's slot
corpus. Ties go to the lower corpus index everywhere.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version (``*_reference``), which the tests hold
against the JAX package. The launchers and plain phases take the row format
(int8 rows here, packed int4 rows for :mod:`int4_scan`, whose kernels share
``csrc/int_scan.cuh`` with these).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from semtools_tpu_torch.ops import kernels
from semtools_tpu_torch.ops.fused_scan import (
    MAX_QUERIES,
    SUB_ROWS,
    _num_blocks,
    _sort_desc,
    _stream,
    check_subtile_ids,
    merge_candidates,
    rescan_scratch,
    top_subtiles,
)

_NEG_INF = float("-inf")
_QUANT_CHUNK = 1 << 24  # elements; bounds temporaries to ~64 MB f32
# Rows per step of the plain phase 1 (a SUB_ROWS multiple): bounds the
# widened [rows, D] f32 copy of the corpus.
_REF_CHUNK = 1 << 20


# -- quantization -------------------------------------------------------------


def _quantize_numpy(x: np.ndarray) -> Tuple[np.ndarray, float]:
    """``semtools_tpu.ops.int8_scan.quantize_global``, as it is."""
    x = np.asarray(x, np.float32)
    if x.size <= _QUANT_CHUNK:
        amax = float(np.max(np.abs(x))) if x.size else 0.0
        scale = amax / 127.0
        if scale == 0.0:
            return np.zeros(x.shape, np.int8), 0.0
        q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        return q, scale
    row_elems = max(1, int(np.prod(x.shape[1:], dtype=np.int64)))
    step = max(1, _QUANT_CHUNK // row_elems)
    amax = 0.0
    for i in range(0, x.shape[0], step):
        blk = x[i : i + step]
        if blk.size:
            amax = max(amax, float(np.max(np.abs(blk))))
    scale = amax / 127.0
    if scale == 0.0:
        return np.zeros(x.shape, np.int8), 0.0
    q = np.empty(x.shape, np.int8)
    for i in range(0, x.shape[0], step):
        q[i : i + step] = np.clip(np.rint(x[i : i + step] / scale), -127, 127)
    return q, scale


def quantize_on_device(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The numpy version's arithmetic on a tensor, bit for bit, with the amax
    and the scale kept on ``x``'s device (nothing is read to the host):
    (int8 q, the scale as a 0-d float64 tensor). The amax is exact, ``amax /
    127`` is a division of float64 tensors (IEEE, as Python's), and each
    element is divided by the scale's f32 rounding as a tensor operand
    (CUDA's division by a host scalar multiplies by its reciprocal, which
    can round differently), rounded half to even and clipped; a zero amax
    divides the (zero) elements by 1."""
    x = x.to(torch.float32)
    if not x.numel():
        return (torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                torch.zeros((), dtype=torch.float64, device=x.device))
    scale = x.abs().amax().double() / torch.full((), 127.0, dtype=torch.float64, device=x.device)
    s = scale.float()
    s = torch.where(scale == 0, torch.ones_like(s), s)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    step = max(1, _QUANT_CHUNK // max(1, x[0].numel())) if x.dim() > 1 else x.shape[0]
    for i in range(0, x.shape[0], step):
        out[i : i + step] = torch.round(x[i : i + step] / s).clamp_(-127, 127)
    return out, scale


def quantize_global(x: Union[np.ndarray, torch.Tensor]):
    """Symmetric int8 quantization with one global scale: x ~= q * scale.
    Numpy in, numpy out; a tensor in, a tensor on its device out. Both give
    the JAX package's ``q8`` and scale exactly."""
    if isinstance(x, torch.Tensor):
        q, scale = quantize_on_device(x)
        return q, float(scale)
    return _quantize_numpy(x)


# -- plain versions -----------------------------------------------------------


def _keep_rows(mask, n_true: int, device) -> torch.Tensor:
    if mask is None:
        return torch.ones(n_true, dtype=torch.bool, device=device)
    return mask[:n_true] != 0


def _widen_int8(e8: torch.Tensor) -> torch.Tensor:
    return e8.float()


def tilemax_reference(q8, e8, n_true: int, mask=None, *, widen=_widen_int8) -> torch.Tensor:
    """[Q, ceil(n_true / SUB_ROWS)] per-sub-tile max integer sims; rows
    >= n_true, and rows where ``mask`` is 0, read as -inf.

    ``widen`` turns stored rows into f32 rows of the model width (int8 rows
    as they are; the int4 scan passes its unpacking). The products are exact:
    |sim| < 2^24 and each f32 product and partial sum is an integer below it
    (TF32 is off: see utils.platform.resolve_device)."""
    keep = _keep_rows(mask, n_true, e8.device)
    qf = q8.float()
    parts = []
    for start in range(0, n_true, _REF_CHUNK):
        stop = min(start + _REF_CHUNK, n_true)
        sims = (qf @ widen(e8[start:stop]).T).masked_fill(~keep[start:stop], _NEG_INF)
        pad = _num_blocks(stop - start) * SUB_ROWS - (stop - start)
        sims = F.pad(sims, (0, pad), value=_NEG_INF)
        parts.append(sims.view(q8.shape[0], -1, SUB_ROWS).amax(dim=2))
    return torch.cat(parts, dim=1)


def rescan_reference(q8, e8, n_true: int, sub_ids, k: int, mask=None, *, widen=_widen_int8):
    """Each query's top-k integer sims inside each of its sub-tiles
    ``sub_ids`` [Q, kt] -> ([Q, kt, k] sims, [Q, kt, k] int64 rows); rows not
    kept read as -inf."""
    rows = sub_ids[..., None] * SUB_ROWS + torch.arange(SUB_ROWS, device=e8.device)
    clamped = rows.clamp(max=n_true - 1)
    valid = (rows < n_true) & _keep_rows(mask, n_true, e8.device)[clamped]
    blocks = widen(e8[clamped])  # [Q, kt, SUB, D]
    sims = torch.einsum("qd,qtsd->qts", q8.float(), blocks)
    vals, pos = _sort_desc(sims.masked_fill(~valid, _NEG_INF), k)
    return vals, rows.gather(-1, pos)


def rescan_topk_reference(q8, e8, n_true: int, sub_ids, k: int, mask=None, *,
                          widen=_widen_int8):
    """Each query's top-k integer sims of the rows of its sub-tiles
    ``sub_ids`` [Q, kt] -> ([Q, k] sims desc, [Q, k] int64 rows), ties toward
    the lower row, -inf filler (rows not kept, lowest first) when fewer than
    k are kept: :func:`rescan_reference` (whole sub-tiles for k above
    SUB_ROWS) merged by :func:`fused_scan.merge_candidates`."""
    vals, idx = rescan_reference(q8, e8, n_true, sub_ids, min(k, SUB_ROWS), mask, widen=widen)
    return merge_candidates(vals.flatten(1), idx.flatten(1), k)


# -- kernel wrappers ------------------------------------------------------------


def _on_cpu(q8, e8, mask, fmt: str = "int8") -> bool:
    """True when every operand lies on the CPU (the plain versions run);
    else checks what the ``fmt`` ("int8" or "int4") kernels take and raises
    on anything else."""
    what = f"{fmt} scan"
    tensors = [q8, e8] + ([mask] if mask is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if any(t.device != e8.device for t in tensors) or e8.device.type != "cuda":
        raise ValueError(
            f"{what} operands must share one CUDA device (or all lie on the "
            f"CPU); got {[str(t.device) for t in tensors]}"
        )
    if q8.dtype != torch.int8 or e8.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 queries and corpus; got {q8.dtype}, {e8.dtype}")
    if mask is not None and (mask.dtype != torch.uint8 or mask.dim() != 1
                             or not mask.is_contiguous()):
        raise TypeError("the keep mask must be a contiguous 1-d uint8 tensor")
    pack = 2 if fmt == "int4" else 1  # model width per stored byte
    if q8.dim() != 2 or e8.dim() != 2 or q8.shape[1] != pack * e8.shape[1]:
        raise ValueError(f"shape mismatch: q8 {tuple(q8.shape)}, corpus {tuple(e8.shape)}")
    if not (1 <= q8.shape[0] <= MAX_QUERIES):
        raise ValueError(f"{q8.shape[0]} queries; the kernels take 1..{MAX_QUERIES}")
    if not (q8.is_contiguous() and e8.is_contiguous()):
        raise ValueError(f"{what} operands must be contiguous")
    if e8.shape[1] % 16 or e8.data_ptr() % 16 or q8.data_ptr() % 16:
        raise ValueError(f"{fmt} rows must be 16-byte aligned (D % {16 * pack} == 0)")
    return False


def _check_n_true(e8, mask, n_true: int) -> None:
    if not (1 <= n_true <= e8.shape[0]):
        raise ValueError(f"n_true={n_true} outside 1..{e8.shape[0]}")
    if mask is not None and mask.shape[0] < n_true:
        raise ValueError(f"mask has {mask.shape[0]} rows, fewer than n_true={n_true}")


def _kernel_name(fmt: str, phase: str, mask) -> str:
    return f"{fmt}_{phase}" + ("" if mask is None else "_masked")


def launch_tilemax(fmt: str, q8, rows, n_true: int, mask=None) -> torch.Tensor:
    """Phase 1 on the card: kernel ``{fmt}_tilemax[_masked]``."""
    _check_n_true(rows, mask, n_true)
    s = _num_blocks(n_true)
    out = torch.empty((q8.shape[0], s), dtype=torch.float32, device=rows.device)
    code = getattr(kernels.library(), f"semtools_{fmt}_tilemax")(
        q8.data_ptr(), rows.data_ptr(), None if mask is None else mask.data_ptr(),
        q8.shape[0], q8.shape[1], n_true, out.data_ptr(), s, _stream(),
    )
    kernels.check(code, _kernel_name(fmt, "tilemax", mask))
    return out


def launch_rescan_topk(fmt: str, q8, rows, n_true: int, sub_ids, k: int, mask=None):
    """Phase 2 and the merge on the card: kernel ``{fmt}_rescan_topk[_masked]``."""
    _check_n_true(rows, mask, n_true)
    qn = q8.shape[0]
    kt = check_subtile_ids(sub_ids, qn, k, rows.device)
    vals = torch.empty((qn, k), dtype=torch.float32, device=rows.device)
    idx = torch.empty((qn, k), dtype=torch.int64, device=rows.device)
    scratch = rescan_scratch(qn, kt, rows.device)  # held until the launch returns
    code = getattr(kernels.library(), f"semtools_{fmt}_rescan_topk")(
        q8.data_ptr(), rows.data_ptr(), None if mask is None else mask.data_ptr(),
        qn, q8.shape[1], n_true, sub_ids.data_ptr(), kt, k,
        scratch.data_ptr(), vals.data_ptr(), idx.data_ptr(), _stream(),
    )
    kernels.check(code, _kernel_name(fmt, "rescan_topk", mask))
    return vals, idx


def tilemax(q8, e8, n_true: int, mask=None) -> torch.Tensor:
    """Phase 1 (kernel ``int8_tilemax``, or ``int8_tilemax_masked`` with a
    mask): see :func:`tilemax_reference`."""
    if _on_cpu(q8, e8, mask):
        return tilemax_reference(q8, e8, n_true, mask)
    return launch_tilemax("int8", q8, e8, n_true, mask)


def rescan_topk(q8, e8, n_true: int, sub_ids, k: int, mask=None):
    """Phase 2 and the merge (kernel ``int8_rescan_topk``, or
    ``int8_rescan_topk_masked`` with a mask): see :func:`rescan_topk_reference`."""
    if _on_cpu(q8, e8, mask):
        return rescan_topk_reference(q8, e8, n_true, sub_ids, k, mask)
    return launch_rescan_topk("int8", q8, e8, n_true, sub_ids, k, mask)


def int8_two_phase(q8, e8, n_true: int, k: int, mask=None):
    """Exact top-k integer sims: ([Q, k] sims desc, [Q, k] int64 rows),
    ties toward the lower row; -inf filler when fewer than k rows are kept."""
    sub_max = tilemax(q8, e8, n_true, mask)
    return rescan_topk(q8, e8, n_true, top_subtiles(sub_max, min(k, sub_max.shape[1])), k, mask)


def int8_topk_scan(
    q, e8: torch.Tensor, e_scale: float, k: int, *,
    n_true: Optional[int] = None, mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a globally scaled int8 corpus ``e8`` (scale ``e_scale``);
    ``q`` is f32 (numpy or tensor) and is quantized here.

    Rows at index >= ``n_true`` are not read. ``mask`` is an optional
    uint8/bool keep vector; rows where it is 0 are never selected. Returns
    (distances [Q, k'], int64 rows [Q, k']) on the corpus device, ascending,
    k' = min(k, n_true); distance = 1 - int_sim * (q_scale * e_scale), +inf
    for filler when fewer than k' rows are kept.
    """
    q = torch.as_tensor(q, dtype=torch.float32).to(e8.device)
    q8, q_scale = quantize_global(q)
    n = e8.shape[0] if n_true is None else min(n_true, e8.shape[0])
    k_eff = min(k, n)
    if k_eff == 0:
        qn = q8.shape[0]
        return (torch.zeros((qn, 0), dtype=torch.float32, device=e8.device),
                torch.zeros((qn, 0), dtype=torch.int64, device=e8.device))
    if mask is not None:
        mask = mask.to(device=e8.device, dtype=torch.uint8).contiguous()
    sims, idx = int8_two_phase(q8.contiguous(), e8, n, k_eff, mask)
    return 1.0 - sims * (q_scale * e_scale), idx
