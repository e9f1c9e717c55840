"""The scan's probes: wrappers of the CUDA kernels in ``csrc/stream.cu`` and
``csrc/probe_tilemax.cu`` and their plain PyTorch versions.

Counterparts of the JAX package's own probes of its scan (the Pallas
kernels of ``benchmarks/quantitative/bench_stream_sweep.py``,
``bench_kernel_variants.py``, ``bench_int8_phase1.py``,
``bench_int4_sweep.py`` and ``scripts/probe_int4_opt.py`` /
``probe_int4_opt2.py``). They lie on no serving path: they measure what the
card's memory and units give the scan (``semtools_tpu_torch.probes``).

- :func:`stream_tiles` (kernel ``stream_tiles``, replaces ``auto_stream``):
  the int32 column sums of every whole ``tile``-row tile of an int8
  ``[N, 256]`` corpus, plus a salt; rows past the last whole tile are
  dropped, as the TPU grid drops them.
- :func:`stream_ring` (kernel ``stream_ring``, replaces ``manual_stream``):
  the int32 column sums of the first ``n_use`` rows, plus the salt, through
  a ring of ``stages`` shared-memory stages of ``stage_rows`` rows.
- :func:`tilemax_probe` (kernel ``probe_tilemax``, replaces the tile-max
  and unpack probes): the maxima of ``q . e`` over every ``sub_rows``-row
  sub-tile of every ``tile``-row tile, ``[T, Q, tile / sub_rows]`` f32
  (``sub_rows=1``: every row's sims), for a storage format and a recipe
  (the unit that does the dot); or, with ``reduce="sum"``, each tile's sums
  of the first Q columns, ``[T, Q, 1]``.

A wrapper given CPU tensors runs the plain version (``*_reference``), which
the tests hold against the JAX probes; given CUDA tensors it launches its
kernel or raises. Every launch is counted (``kernels.launch_counts()``):
the stream kernels under their own names, the tile-max probe under one name
per (storage, recipe, reduce), :data:`VARIANTS`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from semtools_tpu_torch.ops import kernels

DIM = 256  # the model width every probe runs at (the kernels are written for it)
HALF = DIM // 2
MAX_QUERIES = 8  # the n = 8 side of the kernels' mma tiles
_NEG_INF = float("-inf")
_REF_ROWS = 1 << 20  # rows per step of the plain versions: bounds the f32 copy

# Storage format: (stored dtype, stored bytes per row). The int4 formats
# hold two dims a byte, split by halves (dim j in the low nibble of byte j,
# dim j + 128 in the high) except ``int4_native`` (dims 2j and 2j + 1 in
# byte j's low and high nibble); their names give the unpack:
#   int4_u8     uint8 bytes, both nibbles sign-extended (bench_int4_sweep.py)
#   int4_shift  int8 bytes, low nibble sign-extended, high = byte >> 4
#               (probe_int4_opt.py sims_shift; unbiased packing)
#   int4_floor  int8 bytes, float unpack hi = floor(f / 16), lo = f - 16 hi
#               (probe_int4_opt2.py sims_floor; biased packing, lo + 8)
#   int4_and15  int8 bytes, lo = byte & 15 raw, hi = byte >> 4 (sims_and over
#               the biased packing; sims_mask, probe_int4_opt.py's throughput
#               placeholder, is the same unpack over the unbiased one)
#   int4_native int8 bytes, interleaved nibbles, both sign-extended
STORAGES = {
    "bf16": (torch.bfloat16, 2 * DIM),
    "int8": (torch.int8, DIM),
    "int4_u8": (torch.uint8, HALF),
    "int4_shift": (torch.int8, HALF),
    "int4_floor": (torch.int8, HALF),
    "int4_and15": (torch.int8, HALF),
    "int4_native": (torch.int8, HALF),
}
# (storage, recipe, reduce) -> (kernel instance, launch counter). Recipes
# name the unit of the dot: ``plain`` bf16 rows and ``convert_bf16`` (int
# values made bf16) on the bf16 tensor cores (mma m16n8k16), ``int_dot`` on
# the int8 tensor cores (mma m16n8k32), ``f32_dot`` (int values made f32) on
# the TF32 tensor cores (mma m16n8k8; exact: |v| <= 127 fits tf32). The
# ``convert_bf16`` instances of ``int4_u8`` and ``int4_native`` keep their
# probes' recipe name but run on the int8 tensor cores, with no conversion a
# value: the nibbles biased to 0..15 as s8 bytes, 8 sum(q) taken off the
# int32 sums (the same function, exactly). With
# ``reduce="sum"`` there is no dot: ``convert_bf16`` sums bf16-converted
# values in f32 (k_convsum), ``plain`` sums the int8 values in int32
# (k_stream). The kernel instance numbers are csrc/probe_tilemax.cu's.
VARIANTS = {
    ("bf16", "plain", "max"): (0, "tilemax_bf16_plain"),
    ("int8", "convert_bf16", "max"): (1, "tilemax_int8_convert_bf16"),
    ("int8", "int_dot", "max"): (2, "tilemax_int8_int_dot"),
    ("int8", "f32_dot", "max"): (3, "tilemax_int8_f32_dot"),
    ("int8", "convert_bf16", "sum"): (4, "colsum_int8_convert_bf16"),
    ("int8", "plain", "sum"): (5, "colsum_int8"),
    ("int4_u8", "convert_bf16", "max"): (6, "tilemax_int4_u8"),
    ("int4_shift", "convert_bf16", "max"): (7, "tilemax_int4_shift"),
    ("int4_and15", "convert_bf16", "max"): (8, "tilemax_int4_and15"),
    ("int4_floor", "convert_bf16", "max"): (9, "tilemax_int4_floor"),
    ("int4_native", "convert_bf16", "max"): (10, "tilemax_int4_native"),
}
# Stages a ring can have (csrc/stream.cu instantiates these) and the most
# shared memory a block can take on the card.
RING_STAGES = (2, 3, 4, 8)
MAX_SMEM = 232_448
RING_RESERVED = 8 * DIM * 4  # the ring kernel's static reduction buffer


# -- packings (copies of the probes' own) -------------------------------------


def pack_int4(x: np.ndarray, scale: float) -> np.ndarray:
    """``bench_int4_sweep.pack_int4``: [N, 256] f32 -> [N, 128] uint8, dims
    0-127 in the low nibbles and 128-255 in the high, each ``rint(x /
    scale)`` clipped to [-7, 7] in two's complement."""
    q = np.clip(np.rint(x / scale), -7, 7).astype(np.int8)
    lo = q[:, :HALF] & 0xF
    hi = q[:, HALF:] & 0xF
    return (lo | (hi << 4)).astype(np.uint8)


def pack_split_half(qv: torch.Tensor, biased: bool) -> torch.Tensor:
    """``probe_int4_opt.gen_chunk`` (unbiased) and ``probe_int4_opt2.gen_chunk``
    (``biased``: the low nibble holds lo + 8): integer values [N, 256] in
    [-7, 7] -> [N, 128] int8 bytes on their device."""
    qv = qv.to(torch.int32)
    lo = (qv[:, :HALF] + (8 if biased else 0)) & 0xF
    hi = qv[:, HALF:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def pack_interleaved(qv: torch.Tensor) -> torch.Tensor:
    """A native int4 array's bytes: dim 2j in the low nibble of byte j and
    dim 2j + 1 in the high, two's complement -> [N, 128] int8."""
    qv = qv.to(torch.int32)
    return ((qv[:, 0::2] & 0xF) | ((qv[:, 1::2] & 0xF) << 4)).to(torch.uint8).view(torch.int8)


def _sext4(v: torch.Tensor) -> torch.Tensor:
    return ((v & 0xF) ^ 8) - 8


def unpack_rows(e: torch.Tensor, storage: str) -> torch.Tensor:
    """Stored rows -> the f32 values [n, 256] each probe's kernel dots (for
    ``int4_floor`` and ``int4_and15`` the raw low nibble, in [0, 15])."""
    if storage in ("bf16", "int8"):
        return e.float()
    b = e.to(torch.int32)  # uint8 bytes in [0, 255]; int8 bytes sign-extended
    if storage == "int4_u8":
        lo, hi = _sext4(b), _sext4(b >> 4)
    elif storage in ("int4_shift", "int4_native"):
        lo, hi = _sext4(b), b >> 4
    else:  # int4_floor, int4_and15
        lo, hi = b & 0xF, b >> 4
    if storage == "int4_native":
        return torch.stack((lo, hi), dim=2).flatten(1).float()
    return torch.cat((lo, hi), dim=1).float()


# -- plain versions -----------------------------------------------------------


def stream_tiles_reference(e: torch.Tensor, tile: int, salt: int) -> torch.Tensor:
    """[N // tile, 256] int32: each whole tile's column sums plus ``salt``."""
    t = e.shape[0] // tile
    return e[: t * tile].view(t, tile, e.shape[1]).sum(1, dtype=torch.int32) + salt


def stream_ring_reference(e: torch.Tensor, salt: int, n_use: int) -> torch.Tensor:
    """[1, 256] int32: the column sums of the first ``n_use`` rows plus ``salt``."""
    return e[:n_use].sum(0, keepdim=True, dtype=torch.int32) + salt


def tilemax_probe_reference(q, e, n_true: Optional[int] = None, *, tile: int, storage: str,
                            masked: bool = False, reduce: str = "max",
                            sub_rows: Optional[int] = None) -> torch.Tensor:
    """The tile-max probe's function (see :func:`tilemax_probe`; every
    recipe computes the same one), in f32 matmuls of the unpacked rows:
    exact for integer values (every product and partial sum an integer below
    2^24; TF32 off), within summation order for bf16 rows."""
    sub_rows = tile if sub_rows is None else sub_rows
    rows, qn = e.shape[0], q.shape[0]
    limit = _limit(rows, n_true, masked)
    num_tiles = -(-rows // tile)
    qf = q.float()
    step = tile * max(1, _REF_ROWS // tile)
    parts = []
    for start in range(0, num_tiles * tile, step):
        stop = min(start + step, num_tiles * tile)
        vals = unpack_rows(e[start:min(stop, rows)], storage)
        keep = torch.arange(start, start + vals.shape[0], device=e.device) < limit
        pad = stop - start - vals.shape[0]
        if reduce == "sum":
            cols = torch.cat((vals[:, :qn] * keep[:, None],
                              vals.new_zeros((pad, qn))))
            parts.append(cols.view(-1, tile, qn).sum(1)[..., None])  # [t, Q, 1]
        else:
            sims = (vals @ qf.T).masked_fill(~keep[:, None], _NEG_INF)
            sims = torch.cat((sims, sims.new_full((pad, qn), _NEG_INF)))
            sims = sims.view(-1, tile // sub_rows, sub_rows, qn).amax(2)  # [t, S, Q]
            parts.append(sims.transpose(1, 2))
    return torch.cat(parts).contiguous()


# -- kernel wrappers ------------------------------------------------------------


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _limit(rows: int, n_true: Optional[int], masked: bool) -> int:
    if not masked:
        return rows
    if n_true is None or not (0 <= n_true <= rows):
        raise ValueError(f"masked: n_true={n_true} outside 0..{rows}")
    return n_true


def _on_cpu(tensors, what: str) -> bool:
    """True when every operand lies on the CPU (the plain version runs);
    raises unless they all lie on one CUDA device, contiguous and 16-byte
    aligned."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[-1].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} operands must share one CUDA device (or all lie on the "
                         f"CPU); got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{what} operands must be contiguous and 16-byte aligned")
    return False


def _check_stream_corpus(e: torch.Tensor) -> None:
    if e.dtype != torch.int8 or e.dim() != 2 or e.shape[1] != DIM:
        raise TypeError(f"the stream probes take an int8 [N, {DIM}] corpus; got "
                        f"{e.dtype} {tuple(e.shape)}")


def stream_tiles(e: torch.Tensor, tile: int, salt: int = 0) -> torch.Tensor:
    """Kernel ``stream_tiles``: see :func:`stream_tiles_reference`."""
    _check_stream_corpus(e)
    if tile < 1 or e.shape[0] < tile:
        raise ValueError(f"tile={tile} for {e.shape[0]} rows: no whole tile")
    if _on_cpu([e], "stream_tiles"):
        return stream_tiles_reference(e, tile, salt)
    num_tiles = e.shape[0] // tile
    out = torch.empty((num_tiles, DIM), dtype=torch.int32, device=e.device)
    code = kernels.library().semtools_stream_tiles(e.data_ptr(), tile, num_tiles, salt,
                                                   out.data_ptr(), _stream())
    kernels.check(code, "stream_tiles")
    return out


def ring_smem(stage_rows: int, stages: int) -> int:
    """Shared memory of one ring block: its stages and the reduction buffer."""
    return stages * stage_rows * DIM + RING_RESERVED


def stream_ring(e: torch.Tensor, salt: int = 0, *, stage_rows: int, stages: int,
                n_use: Optional[int] = None) -> torch.Tensor:
    """Kernel ``stream_ring``: see :func:`stream_ring_reference`. ``n_use``
    defaults to the rows of whole stages (the TPU probe's ``n_use``)."""
    _check_stream_corpus(e)
    n_use = e.shape[0] // stage_rows * stage_rows if n_use is None else n_use
    if stages not in RING_STAGES or stage_rows < 1 or stage_rows % 16:
        raise ValueError(f"stages {stages} (one of {RING_STAGES}), stage_rows {stage_rows} "
                         f"(a multiple of 16)")
    if ring_smem(stage_rows, stages) > MAX_SMEM:
        raise ValueError(f"{stages} stages of {stage_rows} rows exceed {MAX_SMEM} bytes "
                         f"of shared memory")
    if not (1 <= n_use <= e.shape[0]):
        raise ValueError(f"n_use={n_use} outside 1..{e.shape[0]}")
    if _on_cpu([e], "stream_ring"):
        return stream_ring_reference(e, salt, n_use)
    out = torch.full((1, DIM), salt, dtype=torch.int32, device=e.device)  # the salt, once
    code = kernels.library().semtools_stream_ring(e.data_ptr(), n_use, stage_rows, stages,
                                                  out.data_ptr(), _stream())
    kernels.check(code, "stream_ring")
    return out


def _span_rows(sub_rows: int) -> int:
    """Rows one warp of the tile-max kernel takes at a time: a multiple of
    64 that divides the sub-tile (a column sum's sub-tile is its tile), at
    most 1,024; 64 when writing every row's sims (``sub_rows=1``), so that
    the rows spread over the card."""
    return 64 if sub_rows == 1 else 16 * math.gcd(sub_rows // 16, 64)


def _check_probe(q, e, storage, recipe, reduce, tile, sub_rows):
    key = (storage, recipe, reduce)
    if key not in VARIANTS:
        raise ValueError(f"no tile-max probe for storage {storage!r}, recipe {recipe!r}, "
                         f"reduce {reduce!r}; one of {sorted(VARIANTS)}")
    dtype, width = STORAGES[storage]
    if e.dtype != dtype or e.dim() != 2 or e.shape[1] * e.element_size() != width:
        raise TypeError(f"{storage} rows are {dtype} [N, {width // dtype.itemsize}]; got "
                        f"{e.dtype} {tuple(e.shape)}")
    q_dtype = torch.bfloat16 if storage == "bf16" else torch.int8
    if q.dtype != q_dtype or q.dim() != 2 or q.shape[1] != DIM:
        raise TypeError(f"{storage} queries are {q_dtype} [Q, {DIM}]; got {q.dtype} "
                        f"{tuple(q.shape)}")
    if not (1 <= q.shape[0] <= MAX_QUERIES):
        raise ValueError(f"{q.shape[0]} queries; the probe takes 1..{MAX_QUERIES}")
    if e.shape[0] < 1 or tile < 64 or tile % 64:
        raise ValueError(f"tile={tile} (a multiple of 64) over {e.shape[0]} rows")
    if reduce == "sum" and sub_rows != tile:
        raise ValueError("a column sum is per tile: sub_rows must equal tile")
    if sub_rows != 1 and (sub_rows % 64 or tile % sub_rows):
        raise ValueError(f"sub_rows={sub_rows}: 1, or a multiple of 64 that divides the tile")


def tilemax_probe(q, e, n_true: Optional[int] = None, *, tile: int, storage: str,
                  recipe: str, masked: bool = False, reduce: str = "max",
                  sub_rows: Optional[int] = None) -> torch.Tensor:
    """The tile-max probe (kernel ``probe_tilemax``, counted under the
    variant's name in :data:`VARIANTS`).

    ``q`` [Q <= 8, 256] (bf16 for bf16 rows, int8 otherwise); ``e`` rows in
    ``storage``. Tiles of ``tile`` rows, the last one ragged; rows past the
    stored ones do not exist, and with ``masked`` rows >= ``n_true`` read as
    -inf too (they add nothing to a sum). Returns [T, Q, tile / sub_rows]
    f32, T = ceil(N / tile): each query's max over each sub-tile (-inf where
    no row counts; ``sub_rows=1``: every row's sims), or with
    ``reduce="sum"`` [T, Q, 1], each tile's sums of columns 0..Q-1."""
    sub_rows = tile if sub_rows is None else sub_rows
    _check_probe(q, e, storage, recipe, reduce, tile, sub_rows)
    limit = _limit(e.shape[0], n_true, masked)
    if _on_cpu([q, e], "tilemax probe"):
        return tilemax_probe_reference(q, e, n_true, tile=tile, storage=storage, masked=masked,
                                       reduce=reduce, sub_rows=sub_rows)
    instance, counter = VARIANTS[(storage, recipe, reduce)]
    num_tiles, qn = -(-e.shape[0] // tile), q.shape[0]
    span = _span_rows(sub_rows)
    shape = (num_tiles, qn, tile // sub_rows)
    atomic = reduce == "sum" or (sub_rows > 1 and span < sub_rows)
    if reduce == "sum":
        out = torch.zeros(shape, dtype=torch.float32, device=e.device)
    elif atomic:
        out = torch.full(shape, _NEG_INF, dtype=torch.float32, device=e.device)
    else:  # every output written once
        out = torch.empty(shape, dtype=torch.float32, device=e.device)
    code = kernels.library().semtools_probe_tilemax(
        instance, q.data_ptr(), e.data_ptr(), qn, e.shape[0], limit, tile, sub_rows, span,
        int(atomic), 0, out.data_ptr(), _stream())
    kernels.check(code, counter)
    return out
