"""Slot-space device corpus of a workspace store.

Counterpart of ``semtools_tpu/store/patch_cache.py`` (build and get; not
yet its in-place patching). The corpus sits on the store's device in SLOT
space: device row == mmap slot, freed slots are zero rows, so a scan's row
index is a slot and the store's layout maps it to (path, line).

Zero rows score similarity 0 (cosine distance 1.0), so they can only
outrank real rows whose similarity is negative. Callers oversample by
``_SLACK``, drop invalid slots on the host (the layout is known), and fall
back to the compact gather path in the rare case the slack was not enough;
results stay exact in all cases.

Serving kinds ported: "f32" (exact scan), "int8" (one global scale,
served with an exact f32 re-rank) and "int4" (one global scale, split-half
packed ``[capacity, D/2]``, served through the deep-candidate extraction and
the same re-rank). Zero rows of the int4 corpus, freed slots included, hold
``PACKED_ZERO_BYTE`` (0x08), the packing of the zero vector, as in the JAX
package. The corpus has no tile padding: the port's kernels read only
``n_true = capacity`` rows.

:func:`get` returns the cached corpus at the store's current generation,
else builds a new one (streamed from the mmap in 1M-row chunks, one global
amax pass for int8 and int4, each chunk quantized, and packed for int4, on
the host and copied into the device tensor). Quantizing and packing on the
device (the JAX package's ``_device_build_corpus``) is not ported yet.
Patching a cached corpus in place after a mutation (the JAX package's
``_patch``) waits for the daemon, the one long-lived process that keeps a
corpus across mutations (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from semtools_tpu_torch.ops.int4_scan import PACKED_ZERO_BYTE, pack_int4
from semtools_tpu_torch.store import device_cache
from semtools_tpu_torch.utils.tracing import stage

_SLACK = 16  # extra candidates to absorb zero-slot wins

_BUILD_CHUNK_ROWS = 1 << 20  # 1 GB of f32 at D=256 per streamed chunk

# Bytes shipped host -> device by corpus builds (test instrumentation).
_uploaded = [0]


def uploaded_bytes() -> int:
    return _uploaded[0]


@dataclass
class SlotCorpus:
    kind: str  # "f32" | "int8" | "int4"
    generation: int
    capacity: int  # slot count = rows of ``corpus`` = the scans' n_true
    corpus: torch.Tensor  # [capacity, D] f32 or int8, or [capacity, D/2] packed int4
    scale: Optional[float]
    layout: Dict[str, Tuple[int, int, int]]  # path -> (slot_start, n, vec_rev)
    # Max over rows of sum(|int8 value|): turns the int8 kernel's query
    # quantization error into a hard bound (0.5 * q_scale * scale *
    # max_row_int_l1). int8 only.
    max_row_int_l1: float = 0.0
    starts: np.ndarray = field(default=None)  # slot-ordered range starts
    ends: np.ndarray = field(default=None)
    paths: List[str] = field(default=None)

    @property
    def device_nbytes(self) -> int:
        return int(self.corpus.numel()) * int(self.corpus.element_size())

    def refresh_lookup(self) -> None:
        items = sorted(self.layout.items(), key=lambda kv: kv[1][0])
        self.paths = [p for p, _ in items]
        self.starts = np.array([v[0] for _, v in items], np.int64)
        self.ends = np.array([v[0] + v[1] for _, v in items], np.int64)

    def slot_owners(self, slots: np.ndarray):
        """(valid mask, range index, line number) for scan-result slots."""
        ris = np.searchsorted(self.starts, slots, side="right") - 1
        ris_c = np.clip(ris, 0, len(self.starts) - 1)
        valid = (ris >= 0) & (slots < self.ends[ris_c]) & (slots >= self.starts[ris_c])
        return valid, ris_c, slots - self.starts[ris_c]


def _transform(rows: np.ndarray, kind: str, scale) -> np.ndarray:
    """A chunk of f32 slot rows in the kind's stored form."""
    rows = np.asarray(rows, np.float32)
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


def _build(store, kind: str, device: torch.device, gen: int) -> Optional[SlotCorpus]:
    """A fresh slot corpus. ``gen`` was read BEFORE the layout and the
    mmap: a writer landing in between leaves the entry stamped with the
    older generation, so the next query rebuilds; stale data is never
    marked current. Host memory stays O(chunk)."""
    ranges = store._layout_with_rev()
    cap = store._capacity()
    if cap == 0 or not ranges:
        return None
    mm = store._mmap("r")
    if mm is None:
        return None

    scale = None
    max_l1 = 0.0
    if kind in ("int8", "int4"):
        # Global amax over occupied rows; zero slots never contribute.
        amax = 0.0
        for _, block in _occupied_slot_chunks(mm, ranges, _BUILD_CHUNK_ROWS):
            if block.size:
                amax = max(amax, float(np.max(np.abs(block))))
        scale = amax / (127.0 if kind == "int8" else 7.0)

    dtype = torch.float32 if kind == "f32" else torch.int8
    width = store.dim // 2 if kind == "int4" else store.dim
    corpus = torch.empty((cap, width), dtype=dtype, device=device)
    for c0, block in _occupied_slot_chunks(mm, ranges, _BUILD_CHUNK_ROWS):
        q = _transform(block, kind, scale)
        if kind == "int8" and q.size:
            max_l1 = max(max_l1, float(np.abs(q.astype(np.int32)).sum(axis=1).max()))
        corpus[c0 : c0 + q.shape[0]].copy_(torch.from_numpy(q))
        _uploaded[0] += q.nbytes
    del mm

    sc = SlotCorpus(
        kind=kind,
        generation=gen,
        capacity=cap,
        corpus=corpus,
        scale=scale,
        max_row_int_l1=max_l1,
        layout={p: (s, n, rev) for p, s, n, rev in ranges},
    )
    sc.refresh_lookup()
    return sc


def _key(store, kind: str, device: torch.device) -> tuple:
    return (str(store.dir), "slot", kind, str(device))


def is_warm(store, kind: str, device: torch.device) -> bool:
    """True when a corpus of this kind for ``store`` is resident (any
    generation). Never builds."""
    return isinstance(device_cache.peek(_key(store, kind, device)), SlotCorpus)


def get(store, kind: str, device: torch.device) -> Optional[SlotCorpus]:
    """The slot corpus of ``store`` at its current generation: a cache hit,
    else a full build (timed as the ``slot_corpus_build`` stage)."""
    key = _key(store, kind, device)
    gen = store.generation()
    cached = device_cache.peek(key)
    if isinstance(cached, SlotCorpus) and cached.generation == gen:
        return cached
    device_cache.remove(key)  # free the stale corpus before building
    with stage("slot_corpus_build"):
        fresh = _build(store, kind, device, gen)
    if fresh is not None:
        device_cache.replace(key, fresh)
    return fresh
