"""Slot-space device corpus of a workspace store, kept across mutations.

Counterpart of ``semtools_tpu/store/patch_cache.py``. The corpus sits on the
store's device in SLOT space: device row == mmap slot, freed slots are zero
rows, so a scan's row index is a slot and the store's layout maps it to
(path, line). Zero rows score similarity 0 (cosine distance 1.0), so they can
only outrank real rows whose similarity is negative; callers oversample by
``_SLACK``, drop invalid slots on the host and fall back to the compact gather
path when the slack was not enough, so results stay exact.

Serving kinds: "f32" (exact scan), "int8" (one global scale, served with an
exact f32 re-rank), reduced int8 (``reduced_dim`` set: the rows projected by
an uncentered-PCA ``rotation`` to ``[capacity, rd + 1]``, the last column each
row's ceil-quantized residual norm, see ``ops/reduce.py``) and "int4" (one
global scale, split-half packed ``[capacity, D/2]``). Zero rows of the int4
corpus, freed slots included, hold ``PACKED_ZERO_BYTE`` (0x08), the packing of
the zero vector. The corpus has no tile padding: the kernels read only
``n_true = capacity`` rows. Its rows are padded with zero columns to the
kernels' 16-byte rows (:func:`padded_dim`: a store of any dim is served
through the kernels), and :meth:`SlotCorpus.query_rows` lays the queries out
alike. With a mesh (mesh-sharded serving) the corpus is
a :class:`~semtools_tpu_torch.parallel.mesh.ShardedRows` of
``bucket_rows(capacity)`` rows, the rows past the capacity holding the zero
encoding; builds and patches write through its row ranges, so the code below
serves both.

:func:`get` returns, in this order of preference, the cached corpus at the
store's current generation; the cached corpus patched to it (:func:`_patch`:
freed ranges filled with the zero encoding, rows whose content hash survives
in the entry's snapshot moved on the device, only novel rows uploaded); or a
fresh build (:func:`_build`). A build streams the slot rows from the mmap in
1M-row chunks; the int8, int4 and reduced kinds are quantized (projected,
packed) on the corpus device when it is a CUDA device
(``SEMTOOLS_TPU_BUILD=auto``; ``host`` keeps the host transform, ``device``
forces the torch transform on any device). A device error raises: there is no
host fallback.

A patch writes a NEW tensor (a device-side copy of the old corpus, then the
changes) and publishes a new :class:`SlotCorpus`; a published entry and its
tensor are never written again. So a reader that holds an entry (a daemon
thread mid-search) keeps a consistent snapshot while another thread patches,
and readers never wait for a patch; the cost is one corpus copy at device
bandwidth and, for the time of the patch, the memory of two corpora.
:func:`get` itself is serialized per cache key (two threads never build or
patch the same corpus at once).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from semtools_tpu_torch.ops.int4_scan import PACKED_ZERO_BYTE, pack_int4
from semtools_tpu_torch.parallel.mesh import Mesh, ShardedRows, bucket_rows
from semtools_tpu_torch.store import device_cache
from semtools_tpu_torch.utils.tracing import stage

_SLACK = 16  # extra candidates to absorb zero-slot wins

# Residual-scale headroom for the reduced kind: resid_scale is fitted so the
# build's largest residual quantizes to ~85 of 127, leaving room for later
# patched rows with larger residuals before a rebuild refit is forced (ceil
# quantization keeps the stored value an upper bound either way).
_RESID_HEADROOM = 1.5

_BUILD_CHUNK_ROWS = 1 << 20  # 1 GB of f32 at D=256 per streamed chunk

# Model columns per 16-byte vector of a stored row, by kind: the kernels
# (csrc/*.cu) read rows of whole 16-byte vectors. The reduced kind is scored
# by the plain scan and keeps its rd + 1 columns.
_ALIGN = {"f32": 4, "int8": 16, "int4": 32}

# Bytes shipped host -> device by corpus builds and patches (instrumentation).
_uploaded = [0]


def uploaded_bytes() -> int:
    return _uploaded[0]


@dataclass
class SlotCorpus:
    kind: str  # "f32" | "int8" | "int4" (int8 with ``rotation``: the reduced kind)
    generation: int
    capacity: int  # slot count = the scans' n_true (= rows of an unsharded ``corpus``)
    # [cap, D] f32/int8, [cap, rd + 1] reduced, [cap, D/2] int4 (ShardedRows with a mesh)
    corpus: object
    scale: Optional[float]
    layout: Dict[str, Tuple[int, int, int]]  # path -> (slot_start, n, vec_rev)
    rotation: Optional[np.ndarray] = None  # [D, rd] f32, reduced kind only
    # Residual-norm column scale (reduced kind only): column rd holds
    # ceil(||x_perp|| / resid_scale), so the augmented query
    # [q_r, q_perp * resid_scale / scale] scores an upper bound on q.x.
    resid_scale: Optional[float] = None
    # Max over rows of sum(|stored int8 value|): turns the int8 kernel's query
    # quantization error into a hard bound (0.5 * q_scale * scale *
    # max_row_int_l1). int8 kinds only.
    max_row_int_l1: float = 0.0
    # Per-slot content hashes AT THIS ENTRY'S GENERATION (uint64, 0 = unknown;
    # None when the store has no lines.h64 sidecar): the patch matches a
    # changed document's new hashes against its old block here and moves the
    # unchanged rows on the device instead of uploading them.
    hashes: Optional[np.ndarray] = None
    # Embedding provenance at snapshot time: hash-matched moves are trusted
    # only while the store's model and the document's version are unchanged.
    model: Optional[str] = None
    doc_versions: Optional[Dict[str, int]] = None
    # Rows written by patches since scale and rotation were fitted; a lossy
    # entry refuses patches once this passes a quarter of the corpus.
    patched_rows: int = 0
    mesh: Optional[Mesh] = None  # set when the corpus is row-sharded
    starts: np.ndarray = field(default=None)  # slot-ordered range starts
    ends: np.ndarray = field(default=None)
    paths: List[str] = field(default=None)

    @property
    def device_nbytes(self) -> int:
        """Bytes on each mesh device (a sharded corpus holds 1/size of its
        rows on each; the budget approves corpora up to budget x size)."""
        total = int(self.corpus.numel()) * int(self.corpus.element_size())
        return total // (self.mesh.size if self.mesh is not None else 1)

    def refresh_lookup(self) -> None:
        items = sorted(self.layout.items(), key=lambda kv: kv[1][0])
        self.paths = [p for p, _ in items]
        self.starts = np.array([v[0] for _, v in items], np.int64)
        self.ends = np.array([v[0] + v[1] for _, v in items], np.int64)

    def query_rows(self, qs: np.ndarray) -> np.ndarray:
        """[Q, D] f32 queries laid out as the corpus's rows (the zero columns
        of :func:`pad_columns`). The reduced kind's queries are projected by
        the caller instead."""
        if self.rotation is not None:
            return qs
        return pad_columns(qs, self.kind, padded_dim(self.kind, qs.shape[1]))

    def slot_owners(self, slots: np.ndarray):
        """(valid mask, range index, line number) for scan-result slots."""
        ris = np.searchsorted(self.starts, slots, side="right") - 1
        ris_c = np.clip(ris, 0, len(self.starts) - 1)
        valid = (ris >= 0) & (slots < self.ends[ris_c]) & (slots >= self.starts[ris_c])
        return valid, ris_c, slots - self.starts[ris_c]


def padded_dim(kind: str, dim: int) -> int:
    """Model columns of a stored row of ``kind`` ("f32", "int8" or "int4")
    for a store of ``dim``: ``dim`` rounded up to the kernels' 16-byte rows
    (f32 to a multiple of 4, int8 of 16, int4 of 32: 16 packed bytes)."""
    a = _ALIGN[kind]
    return -(-dim // a) * a


def pad_columns(x, kind: str, width: int):
    """[N, D] rows (numpy or tensor) -> [N, width] with zero columns: at the
    end, or for int4 at the end of each half, so the split-half packing keeps
    the unpadded row's bytes first and packs the padding to
    ``PACKED_ZERO_BYTE``. Zero columns leave every dot product and the global
    amax, so the int8 and int4 quantization, bit-equal. ``x`` itself when
    ``width`` is its own."""
    d = x.shape[1]
    if d == width:
        return x
    if isinstance(x, torch.Tensor):
        out = x.new_zeros((x.shape[0], width))
    else:
        out = np.zeros((x.shape[0], width), x.dtype)
    if kind == "int4":
        h, w2 = d // 2, width // 2
        out[:, :h] = x[:, :h]
        out[:, w2 : w2 + h] = x[:, h:]
    else:
        out[:, :d] = x
    return out


def _stored_width(kind: str, dim: int, reduced_dim: Optional[int]) -> int:
    """Columns of a stored row: the reduced kind's rd + 1, else the padded
    model width (halved for int4's packed bytes)."""
    if reduced_dim:
        return reduced_dim + 1
    w = padded_dim(kind, dim)
    return w // 2 if kind == "int4" else w


def _fill_byte(kind: str) -> int:
    """Freed-slot fill: the encoding of the zero VECTOR for this kind."""
    return PACKED_ZERO_BYTE if kind == "int4" else 0


def _padded_rows(cap: int, mesh: Optional[Mesh]) -> int:
    """Device rows for a capacity: the capacity itself on one device; with a
    mesh a bucketed multiple of its size (``bucket_rows``), so capacity
    growth keeps the padded shape across many mutations."""
    return cap if mesh is None else bucket_rows(cap, mesh.size)


def _alloc(cap: int, width: int, dtype: torch.dtype, device: torch.device,
           mesh: Optional[Mesh], fill: int):
    """An uninitialized corpus of ``cap`` slots: a tensor on ``device``, or
    with a mesh the shards of ``_padded_rows`` rows, padding set to ``fill``."""
    if mesh is None:
        return torch.empty((cap, width), dtype=dtype, device=device)
    rows = ShardedRows(mesh, _padded_rows(cap, mesh) // mesh.size, (width,), dtype)
    rows.narrow(0, cap, rows.shape[0] - cap).fill_(fill)
    return rows


def _resid_bytes(r: np.ndarray, resid_scale) -> np.ndarray:
    """Residual norms -> ceil-quantized column bytes (upper bounds)."""
    if not resid_scale:
        return np.zeros(r.shape, np.int8)
    return np.clip(np.ceil(r / resid_scale), 0, 127).astype(np.int8)


def _residual_norms(rows: np.ndarray, proj: np.ndarray) -> np.ndarray:
    return np.sqrt(np.maximum(
        np.einsum("ij,ij->i", rows, rows) - np.einsum("ij,ij->i", proj, proj), 0.0,
    ))


def _transform(rows: np.ndarray, kind: str, rotation=None, scale=None,
               resid_scale=None) -> np.ndarray:
    """A chunk of f32 slot rows in the kind's stored form (host numpy), padded
    to :func:`_stored_width`."""
    rows = np.asarray(rows, np.float32)
    if rotation is None:
        rows = pad_columns(rows, kind, padded_dim(kind, rows.shape[1]))
    else:
        proj = rows @ rotation
        q = (np.clip(np.rint(proj / scale), -127, 127).astype(np.int8)
             if scale else np.zeros(proj.shape, np.int8))
        resid = _resid_bytes(_residual_norms(rows, proj), resid_scale)
        return np.concatenate([q, resid[:, None]], axis=1)
    if kind == "int8":
        if not scale:
            return np.zeros(rows.shape, np.int8)
        return np.clip(np.rint(rows / scale), -127, 127).astype(np.int8)
    if kind == "int4":
        if not scale:
            return np.full((rows.shape[0], rows.shape[1] // 2), PACKED_ZERO_BYTE, np.int8)
        return pack_int4(np.clip(np.rint(rows / scale), -7, 7).astype(np.int8))
    return rows


def _occupied_slot_chunks(mm, ranges, chunk_rows: int):
    """Yield (slot_start, [rows, D] f32 slot-space block) covering
    [0, cap) in ``chunk_rows`` steps: occupied slots copied from the
    mmap, unoccupied slots zero."""
    cap = mm.shape[0]
    spans = sorted((s, s + n) for _, s, n, _rev in ranges if n)
    si = 0
    for c0 in range(0, cap, chunk_rows):
        c1 = min(c0 + chunk_rows, cap)
        block = np.zeros((c1 - c0, mm.shape[1]), np.float32)
        while si < len(spans) and spans[si][1] <= c0:
            si += 1
        j = si
        while j < len(spans) and spans[j][0] < c1:
            s, e = max(spans[j][0], c0), min(spans[j][1], c1)
            block[s - c0 : e - c0] = mm[s:e]
            j += 1
        yield c0, block


def _sample_occupied(mm, ranges, sample_rows: int, seed: int = 0) -> np.ndarray:
    """Up to ``sample_rows`` occupied rows for the rotation fit, drawn as the
    JAX package draws them (so both fit the same rotation). The second-moment
    fit is row-order invariant, so taking every occupied row in slot order
    equals a full-buffer fit (zero slots add nothing to an uncentered
    moment)."""
    spans = sorted((s, s + n) for _, s, n, _rev in ranges if n)
    total = sum(e - s for s, e in spans)
    if total <= sample_rows:
        return np.concatenate([np.asarray(mm[s:e]) for s, e in spans]) \
            if spans else np.zeros((0, mm.shape[1]), np.float32)
    rng = np.random.default_rng(seed)
    starts = np.array([s for s, _ in spans], np.int64)
    lens = np.array([e - s for s, e in spans], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    # Sampling without replacement by rejection keeps memory O(sample)
    # (replace=False would permute the whole population).
    chosen: set = set()
    while len(chosen) < sample_rows:
        need = sample_rows - len(chosen)
        for v in rng.integers(0, total, size=need + need // 8 + 16).tolist():
            if len(chosen) >= sample_rows:
                break
            chosen.add(v)
    picks = np.sort(np.fromiter(chosen, np.int64, len(chosen)))
    span_of = np.searchsorted(offs, picks, side="right") - 1
    slots = starts[span_of] + (picks - offs[span_of])
    return np.asarray(mm[slots])


def _use_device_build(kind: str, device: torch.device) -> bool:
    """Where a cold build quantizes (``SEMTOOLS_TPU_BUILD=device|host|auto``):
    ``auto`` is the corpus device when it is a CUDA device; ``device`` forces
    the torch transform on any device (the CPU tests run it so); ``host``
    keeps the numpy transform. The f32 kind has no transform."""
    mode = os.environ.get("SEMTOOLS_TPU_BUILD", "auto").lower()
    if kind == "f32" or mode == "host":
        return False
    return mode == "device" or device.type == "cuda"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_build_corpus(mm, ranges, cap: int, kind: str, rotation, device, mesh=None):
    """The transform on ``device``: f32 slot chunks streamed up twice (pass 1
    takes the global amax, of the projection for the reduced kind, and the
    largest residual norm; pass 2 quantizes, packs or projects and appends
    the residual column into one preallocated tensor). Returns (corpus
    [cap, D'] int8, scale, resid_scale, max_row_int_l1).

    Byte-equal to the host transform for int8 and int4: amax is exact, the
    division is by a device tensor (a CPU scalar divisor makes CUDA multiply
    by its reciprocal, which can flip a rint at .5), and torch.round rounds
    half to even like np.rint. The reduced kind's projection sums in another
    order than numpy's, so its values may differ by one unit."""
    w = torch.from_numpy(rotation).to(device) if rotation is not None else None

    def chunks():
        # At most two chunks in flight: every chunk allocates 1 GB on the
        # device (a 60M-row store is 61 GB of f32).
        for ci, (c0, block) in enumerate(_occupied_slot_chunks(mm, ranges, _BUILD_CHUNK_ROWS)):
            _uploaded[0] += block.nbytes
            yield c0, torch.from_numpy(block).to(device)
            if ci % 2 == 1:
                _sync(device)

    def residual(x, proj):
        return torch.sqrt(torch.clamp((x * x).sum(1) - (proj * proj).sum(1), min=0.0))

    amax = torch.zeros((), dtype=torch.float32, device=device)
    max_r = torch.zeros((), dtype=torch.float32, device=device)
    for _, x in chunks():
        if w is not None:
            proj = x @ w
            max_r = torch.maximum(max_r, residual(x, proj).max())
            x = proj
        amax = torch.maximum(amax, x.abs().max())
    scale = float(amax) / (127.0 if kind == "int8" else 7.0)
    resid_scale = float(max_r) * _RESID_HEADROOM / 127.0 if w is not None else None

    d = mm.shape[1]
    out_dim = _stored_width(kind, d, w.shape[1] if w is not None else None)
    corpus = _alloc(cap, out_dim, torch.int8, device, mesh, _fill_byte(kind))
    if scale == 0.0:
        corpus.narrow(0, 0, cap).fill_(_fill_byte(kind))
        return corpus, 0.0, resid_scale, 0.0
    scale_t = torch.tensor(scale, dtype=torch.float32, device=device)
    rscale_t = torch.tensor(resid_scale or 1.0, dtype=torch.float32, device=device)
    lim = 127 if kind == "int8" else 7
    l1 = torch.zeros((), dtype=torch.int64, device=device)
    for c0, x in chunks():
        y = x @ w if w is not None else pad_columns(x, kind, padded_dim(kind, d))
        q = torch.div(y, scale_t).round_().clamp_(-lim, lim)
        rows = pack_int4(q) if kind == "int4" else q.to(torch.int8)
        if w is not None:
            resid = torch.ceil(residual(x, y) / rscale_t).clamp_(0, 127).to(torch.int8)
            rows = torch.cat([rows, resid[:, None]], dim=1)
        if kind == "int8":
            l1 = torch.maximum(l1, rows.to(torch.int32).abs().sum(1).max())
        corpus.narrow(0, c0, rows.shape[0]).copy_(rows)
    return corpus, scale, resid_scale, float(l1)


def _build(store, kind: str, device: torch.device, reduced_dim: Optional[int] = None,
           gen: int = 0, mesh: Optional[Mesh] = None) -> Optional[SlotCorpus]:
    """A fresh slot corpus. ``gen`` was read BEFORE the layout and the mmap:
    a writer landing in between leaves the entry stamped with the older
    generation, so the next query patches it; stale data is never marked
    current. Host memory stays O(chunk)."""
    ranges = store._layout_with_rev()
    cap = store._capacity()
    if cap == 0 or not ranges:
        return None
    mm = store._mmap("r")
    if mm is None:
        return None

    rotation = None
    if reduced_dim:
        from semtools_tpu_torch.ops.reduce import fit_rotation

        rotation = fit_rotation(_sample_occupied(mm, ranges, 1 << 17), reduced_dim)

    scale = resid_scale = None
    max_l1 = 0.0
    if _use_device_build(kind, device):
        corpus, scale, resid_scale, max_l1 = _device_build_corpus(
            mm, ranges, cap, kind, rotation, device, mesh)
    else:
        if kind in ("int8", "int4"):
            # Global amax over occupied rows (projected for the reduced kind);
            # zero slots never contribute. The same pass measures the largest
            # residual norm, which fixes the residual column's scale.
            amax = max_r = 0.0
            for _, block in _occupied_slot_chunks(mm, ranges, _BUILD_CHUNK_ROWS):
                if rotation is not None:
                    proj = block @ rotation
                    r2 = np.maximum(np.einsum("ij,ij->i", block, block)
                                    - np.einsum("ij,ij->i", proj, proj), 0.0)
                    if r2.size:
                        max_r = max(max_r, float(np.sqrt(np.max(r2))))
                    block = proj
                if block.size:
                    amax = max(amax, float(np.max(np.abs(block))))
            scale = amax / (127.0 if kind == "int8" else 7.0)
            if rotation is not None:
                resid_scale = max_r * _RESID_HEADROOM / 127.0
        width = _stored_width(kind, store.dim, reduced_dim if rotation is not None else None)
        dtype = torch.float32 if kind == "f32" else torch.int8
        corpus = _alloc(cap, width, dtype, device, mesh, _fill_byte(kind))
        for c0, block in _occupied_slot_chunks(mm, ranges, _BUILD_CHUNK_ROWS):
            q = _transform(block, kind, rotation, scale, resid_scale)
            if kind == "int8" and q.size:
                max_l1 = max(max_l1, float(np.abs(q.astype(np.int32)).sum(axis=1).max()))
            corpus.narrow(0, c0, q.shape[0]).copy_(torch.from_numpy(q))
            _uploaded[0] += q.nbytes
    del mm

    # Snapshot the hash sidecar at this generation (funds the row-level
    # patch diff; None when the store predates lines.h64).
    hashes = None
    hm = store._hash_mmap("r")
    if hm is not None:
        hashes = np.zeros(cap, np.uint64)
        for _, s, n, _rev in ranges:
            hashes[s : s + n] = hm[s : s + n]
        del hm
    sc = SlotCorpus(
        kind=kind,
        generation=gen,
        capacity=cap,
        corpus=corpus,
        scale=scale,
        layout={p: (s, n, rev) for p, s, n, rev in ranges},
        rotation=rotation,
        resid_scale=resid_scale,
        max_row_int_l1=max_l1,
        hashes=hashes,
        model=_store_model(store),
        doc_versions=_doc_versions(store),
        mesh=mesh,
    )
    sc.refresh_lookup()
    return sc


def _store_model(store) -> Optional[str]:
    row = store.db.execute("SELECT value FROM meta WHERE key='model'").fetchone()
    return row[0] if row else None


def _doc_versions(store) -> Dict[str, int]:
    return {
        r[0]: (r[1] if r[1] is not None else 0)
        for r in store.db.execute("SELECT path, version FROM docs")
    }


def _move_runs(src: np.ndarray, dst: np.ndarray):
    """Split an index-aligned move into maximal contiguous runs (both src and
    dst advancing by 1). A line edit moves two long runs; an interleaved
    shuffle degenerates to many short ones."""
    if not len(src):
        return []
    brk = np.nonzero((np.diff(src) != 1) | (np.diff(dst) != 1))[0] + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(src)]])
    return [(int(src[a]), int(dst[a]), int(b - a)) for a, b in zip(starts, ends)]


def _write_rows(arr, rows_np: np.ndarray, start: int) -> None:
    """Upload rows and write them at [start, start + n)."""
    _uploaded[0] += rows_np.nbytes
    arr.narrow(0, start, rows_np.shape[0]).copy_(torch.from_numpy(rows_np))


def _upload_index(slots: np.ndarray, device: torch.device) -> torch.Tensor:
    """Slot indices on ``device`` as the int64 that ``index_copy_`` takes,
    crossing the bus as int32 (the JAX package's index traffic) unless a
    slot needs more; the bytes are counted."""
    wide = len(slots) and int(np.max(slots)) >= 2**31
    host = np.ascontiguousarray(slots, np.int64 if wide else np.int32)
    _uploaded[0] += host.nbytes
    return torch.from_numpy(host).to(device).to(torch.int64)


def _scatter_upload(arr, rows_np: np.ndarray, dst: np.ndarray) -> None:
    """Upload rows and write them at arbitrary slots (index bytes counted)."""
    idx = _upload_index(dst, arr.device)
    _uploaded[0] += rows_np.nbytes
    arr.index_copy_(0, idx, torch.from_numpy(np.ascontiguousarray(rows_np)).to(arr.device))


def _patch(store, sc: SlotCorpus, gen: int) -> Optional[SlotCorpus]:
    """``sc`` brought to generation ``gen`` (read before the layout; see
    :func:`_build`) as a NEW entry with a new tensor, or None when a patch is
    not worthwhile and the caller rebuilds. ``sc`` is left as it was.

    The JAX package's decisions, in its order: a zero scale, a model swap,
    more than half of the live rows novel, cumulative lossy drift over a
    quarter of the live rows, or a new row whose residual overflows the
    reduced kind's column -> rebuild. Otherwise: freed ranges take the kind's
    zero encoding, rows whose content hash survives in the entry's snapshot
    (same model and document version) move on the device (slice copies for
    long runs, ``index_select``/``index_copy_`` for fragments), and only the
    novel rows are transformed on the host and uploaded.
    """
    # A zero quantization scale (an all-zero corpus at build time) cannot
    # encode real rows. A process of a multi-process mesh holds only its own
    # shards, so it cannot move rows between shards: it rebuilds.
    if sc.kind in ("int8", "int4") and not sc.scale:
        return None
    if sc.mesh is not None and sc.mesh.world > 1:
        return None
    # A model swap re-embeds unchanged lines into different vectors with the
    # same content hashes: nothing resident can be trusted.
    if _store_model(store) != sc.model:
        return None
    vers_now = _doc_versions(store)
    new_layout = {p: (s, n, rev) for p, s, n, rev in store._layout_with_rev()}
    # Diff on (start, n, vec_rev): the allocator can hand a rewritten
    # document the range it held before.
    changed = [(p, v[0], v[1]) for p, v in new_layout.items() if sc.layout.get(p) != v]
    removed = [(v[0], v[1]) for p, v in sc.layout.items() if new_layout.get(p) != v]
    total = sum(v[1] for v in new_layout.values())
    if total == 0:
        return None

    # Row-level diff plan: match a changed document's new line hashes against
    # its OLD block's hashes in the entry's snapshot (the mmap's old block may
    # already be freed and reused); matched rows move on the device, only
    # novel rows upload.
    hm = store._hash_mmap("r") if changed else None
    plans = []  # (slot_start, n, src, dst, novel_idx, new hashes)
    novel_total = 0
    for p, s, n in changed:
        old = sc.layout.get(p)
        h_new = np.asarray(hm[s : s + n]) if hm is not None else None
        src = dst = novel = None
        prov_ok = sc.doc_versions is not None and vers_now.get(p) == sc.doc_versions.get(p)
        if prov_ok and sc.hashes is not None and h_new is not None and old is not None:
            s_old, n_old = old[0], old[1]
            h_old = sc.hashes[s_old : s_old + n_old]
            order = np.argsort(h_old, kind="stable")
            sorted_h = h_old[order]
            at = np.searchsorted(sorted_h, h_new)
            at_c = np.clip(at, 0, max(len(sorted_h) - 1, 0))
            found = (len(sorted_h) > 0) & (sorted_h[at_c] == h_new) & (h_new != 0)
            # The indexed path pays index bytes; take it only when it avoids
            # most of the row payload.
            if int(found.sum()) > max(32, n // 2):
                src = (s_old + order[at_c[found]]).astype(np.int64)
                dst = (s + np.nonzero(found)[0]).astype(np.int64)
                novel = np.nonzero(~found)[0]
        novel_total += n if novel is None else len(novel)
        plans.append((s, n, src, dst, novel, h_new))

    # Rebuild when the patch would upload more than half the live corpus.
    delta = sum(n for _, _, n in changed) + sum(n for _, n in removed)
    if novel_total > total // 2:
        return None
    # Drift bound: lossy entries (global scale, rotation) encode new content
    # under build-time statistics; once novel + deleted rows pass a quarter
    # of the live corpus, rebuild to refit. Moves do not age the transform.
    lossy = sc.scale is not None or sc.rotation is not None
    removed_gone = sum(v[1] for p, v in sc.layout.items() if p not in new_layout)
    aged = novel_total + removed_gone
    if lossy and sc.patched_rows + aged > total // 4:
        return None

    # Novel rows, transformed on the host. A row whose projection residual
    # exceeds the column's ceiling (127 * resid_scale) cannot carry a valid
    # bound: rebuild, which refits. int8 row L1 maxima stay monotone.
    new_max_l1 = sc.max_row_int_l1
    uploads = []  # (plan, stored rows)
    if changed:
        mm = store._mmap("r")
        if mm is None:
            return None
        for plan in plans:
            s, n, src, _, novel, _ = plan
            if src is not None and not len(novel):
                continue
            raw = np.array(mm[s : s + n] if src is None else mm[s + novel])
            rows = _transform(raw, sc.kind, sc.rotation, sc.scale, sc.resid_scale)
            if sc.rotation is not None and raw.size and np.any(
                    _residual_norms(raw, raw @ sc.rotation)
                    > 127.0 * float(sc.resid_scale or 0.0)):
                return None
            if sc.kind == "int8" and rows.size:
                new_max_l1 = max(new_max_l1, float(
                    np.abs(rows.astype(np.int32)).sum(axis=1).max()))
            uploads.append((plan, rows))
        del mm

    cap = store._capacity()
    old = sc.corpus
    fill = _fill_byte(sc.kind)
    arr = _alloc(cap, old.shape[1], old.dtype, old.device, sc.mesh, fill)
    keep = min(cap, sc.capacity)
    arr.narrow(0, 0, keep).copy_(old.narrow(0, 0, keep))
    arr.narrow(0, keep, cap - keep).fill_(fill)
    # Freed ranges first: the allocator may have handed part of one to a
    # changed document, whose rows below must win.
    for s, n in removed:
        if s < cap:
            arr.narrow(0, s, min(s + n, cap) - s).fill_(fill)
    # Moves read the old tensor, which nothing writes.
    for _, _, src, dst, _, _ in plans:
        if src is None or not len(src):
            continue
        runs = _move_runs(src, dst)
        if len(src) >= 64 * len(runs):
            for s0, d0, length in runs:
                arr.narrow(0, d0, length).copy_(old.narrow(0, s0, length))
        else:
            src_t = _upload_index(src, old.device)
            dst_t = _upload_index(dst, old.device)
            arr.index_copy_(0, dst_t, old.index_select(0, src_t))
    for (s, _, src, _, novel, _), rows in uploads:
        if src is None:
            _write_rows(arr, rows, s)
        else:
            _scatter_upload(arr, rows, s + novel)

    hashes = None
    if sc.hashes is not None:
        hashes = np.zeros(cap, np.uint64)
        hashes[: min(cap, len(sc.hashes))] = sc.hashes[:cap]
        for s, n in removed:
            hashes[s : s + n] = 0
        for s, n, _, _, _, h_new in plans:
            hashes[s : s + n] = h_new if h_new is not None else 0

    fresh = dataclasses.replace(
        sc, corpus=arr, capacity=cap, generation=gen, layout=new_layout, hashes=hashes,
        max_row_int_l1=new_max_l1,
        # changed docs were moved or uploaded under current provenance;
        # unchanged docs cannot have changed version without a rev bump
        doc_versions=vers_now if sc.doc_versions is not None else None,
        patched_rows=sc.patched_rows + (aged if lossy else delta),
    )
    fresh.refresh_lookup()
    return fresh


def _key(store, kind: str, device: torch.device, reduced_dim: Optional[int],
         mesh: Optional[Mesh]) -> tuple:
    return (str(store.dir), "slot", kind, reduced_dim or 0, str(device),
            mesh.size if mesh is not None else 0)


def is_warm(store, kind: str, *, device: Optional[torch.device] = None,
            reduced_dim: Optional[int] = None, mesh: Optional[Mesh] = None) -> bool:
    """True when a corpus of this kind for ``store`` (on ``device``, default
    the store's; sharded over ``mesh`` when given) is resident (any
    generation: a stale one is one patch away). Never builds. Every argument
    after ``kind`` is keyword-only, as in :func:`get`."""
    device = store.device if device is None else device
    return isinstance(device_cache.peek(_key(store, kind, device, reduced_dim, mesh)),
                      SlotCorpus)


# get() builds and patches under one lock per cache key: two daemon threads
# never build the same corpus twice or patch one entry at once. Readers hold
# published entries, which no one writes, so scans need no lock.
_get_locks_guard = threading.Lock()
_get_locks: Dict[tuple, threading.Lock] = {}


def _key_lock(key: tuple) -> threading.Lock:
    with _get_locks_guard:
        lk = _get_locks.get(key)
        if lk is None:
            lk = _get_locks[key] = threading.Lock()
        return lk


def get(store, kind: str, *, device: Optional[torch.device] = None,
        reduced_dim: Optional[int] = None, mesh: Optional[Mesh] = None) -> Optional[SlotCorpus]:
    """The slot corpus of ``store`` at its current generation on ``device``
    (default the store's; row-sharded over ``mesh`` when given): a cache
    hit, else the cached entry patched (the ``slot_corpus_patch`` stage),
    else a full build (``slot_corpus_build``). Every argument after
    ``kind`` is keyword-only: the JAX package's third parameter is
    ``reduced_dim``, so a positional one is refused, never read as a
    device."""
    device = store.device if device is None else device
    key = _key(store, kind, device, reduced_dim, mesh)
    with _key_lock(key):
        gen = store.generation()
        cached = device_cache.peek(key)
        if isinstance(cached, SlotCorpus):
            if cached.generation == gen:
                return cached
            try:
                with stage("slot_corpus_patch"):
                    patched = _patch(store, cached, gen)
            except Exception:  # noqa: BLE001 - a failed patch rebuilds below
                patched = None
            if patched is not None:
                device_cache.replace(key, patched)
                return patched
        device_cache.remove(key)  # free the stale corpus before building
        with stage("slot_corpus_build"):
            fresh = _build(store, kind, device, reduced_dim, gen, mesh)
        if fresh is not None:
            device_cache.replace(key, fresh)
        return fresh
