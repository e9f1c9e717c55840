"""Persistent line-embedding store backing ``semtools workspace``.

Counterpart of ``semtools_tpu/store/store.py``. The host side is carried
over as it is, so the two packages read and write the same workspace:

- vectors live in an mmap file ``lines.f32`` (``lines.eN.f32`` after a
  compaction by the JAX package) shaped [capacity, D]; a document's lines
  occupy a contiguous slot range, so ``line_number = slot - slot_start``;
- ``lines.h64`` holds one uint64 content hash per slot (line-level reuse);
- document metadata (path, size, mtime, version, slot range, vec_rev) and
  the free-range list live in sqlite (``store.sqlite``), with the same
  schema, copy-on-write upserts, generation counter and flock-based
  writer lock;
- the IVF-PQ capacity tier lives in ``ann.npz`` (the index) and
  ``ann_meta.npz`` (build generation, slots, build-time layout), published
  as a pair tied by a build token; either package reads the other's.

The serving side runs on one torch device (:attr:`Store.device`, resolved
lazily: ``cuda`` unless ``cpu`` is asked for; ``workspace status`` never
touches it). Whole-store and path-subset queries are served from the
store's slot-space device corpus (``patch_cache``, patched in place across
mutations) on the tier the JAX package's policy names (``serving_tier``):
the exact f32 scan (fused kernels ``csrc/fused_scan.cu``); the int8 tier
(two-phase int8 kernels ``csrc/int8_scan.cu``, plain and masked) with an
exact f32 re-rank in numpy on the host, grown until the margin certificate
proves the top-k complete; the int4 capacity rung (the deep-candidate sweep
of ``csrc/int4_scan.cu``, plain and masked: every row within a noise margin
of each query's quantized ``k_cut``-th best) with the same re-rank; or the
reduced-64d/32d rungs (``ops/reduce.py``: the rows projected to int8 with a
residual-norm column, scored through the plain scan by the per-row
optimistic bound, with the same growth and re-rank). A whole-store query on
the IVF-PQ tier (a corpus no device rung fits, or
``SEMTOOLS_TPU_FORCE_ANN=1``) with a current index is served by the index
(``index/ivf_pq.py``: the probe and the exact re-rank on the host), its
mutations since the build reconciled as tombstones and a delta segment; the
index is built on :attr:`Store.device` (``SEMTOOLS_TPU_ANN_BUILD=host``
builds it on the CPU).
Other path subsets gather their rows and scan them on the device (the
compact path). ``SEMTOOLS_TPU_SCAN=host`` scores on the host from the mmap;
``auto`` means the device (the JAX package's link-probe placement is not
ported). On a mesh of two shards or more (every card, or
``SEMTOOLS_TORCH_VIRTUAL_DEVICES`` shards of one device: ``parallel/mesh.py``)
the JAX package's sharding policy (:func:`_sharded_enabled`) serves the
whole store and path subsets from a row-sharded slot corpus through the
sharded scans of ``parallel/scan.py``.
:meth:`Store.compact` rewrites the slot space densely into the next epoch of
the vector file, byte for byte as the JAX package does, and remaps a fresh
IVF-PQ index in place.
"""

from __future__ import annotations

import contextlib
import os
import re
import sqlite3
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from semtools_tpu_torch.ops.scan import batched_threshold_scan, topk_scan
from semtools_tpu_torch.utils.env import env_int as _env_int
from semtools_tpu_torch.utils.hashing import doc_id
from semtools_tpu_torch.utils.text import read_file_text
from semtools_tpu_torch.utils.tracing import stage

CURRENT_EMBEDDING_VERSION = 2
LINE_EMBEDDING_SIZE = 256

_VECTORS_FILE = "lines.f32"
_HASH_FILE = "lines.h64"
_DB_FILE = "store.sqlite"
_ANN_FILE = "ann.npz"
_ANN_META_FILE = "ann_meta.npz"


def _int8_tier_enabled(n_rows: int) -> bool:
    """Compressed serving tier policy (automatic; SEMTOOLS_TPU_STORE_INT8
    overrides: 1=always, 0=never). The JAX package's policy, kept as it is
    so both packages pick the same tier.

    Whole-store scans then run on a device-cached int8 copy of the corpus
    (4x less device memory and corpus traffic than f32) with an exact f32
    re-rank of the oversampled top candidates, so reported distances stay
    exact; the approximation only affects which candidates reach the
    re-rank (int8 sim error ~1e-2). Below the threshold the f32 exact scan
    keeps reported = computed distances.
    """
    v = os.environ.get("SEMTOOLS_TPU_STORE_INT8")
    if v == "1":
        return True
    if v == "0":
        return False
    return n_rows >= _env_int("SEMTOOLS_TPU_INT8_MIN_ROWS", 262_144)


def _int4_tier_enabled(n_rows: int) -> bool:
    """Half-byte packed serving tier SIZE policy (SEMTOOLS_TPU_STORE_INT4
    overrides: 1=always, 0=never; SEMTOOLS_TPU_INT4_MIN_ROWS=N opts into
    automatic size-based selection above N rows). The JAX package's
    policy, kept as it is so both packages pick the same tier: int4 is a
    capacity rung that engages when int8 does not fit the device budget (see
    Store._device_kind).
    """
    v = os.environ.get("SEMTOOLS_TPU_STORE_INT4")
    if v == "1":
        return True
    if v == "0":
        return False
    min_rows = _env_int("SEMTOOLS_TPU_INT4_MIN_ROWS", 0)
    return min_rows > 0 and n_rows >= min_rows


def _sharded_enabled(n_rows: int, n_devices: int) -> bool:
    """Mesh-sharded serving policy on a mesh of ``n_devices`` shards (the
    JAX package's, so both packages name the same tier): never below two
    shards; SEMTOOLS_TPU_SHARDED=0 never, =1 at any size; else from
    ``SEMTOOLS_TPU_SHARDED_MIN_ROWS`` (8,192) rows. Tiny corpora stay on one
    device: the merge adds fixed latency a one-tile scan does not earn back.
    """
    v = os.environ.get("SEMTOOLS_TPU_SHARDED")
    if v in ("0", "off"):
        return False
    if n_devices < 2:
        return False
    if v in ("1", "on"):
        return True
    return n_rows >= _sharded_min_rows()


def _sharded_min_rows() -> int:
    return _env_int("SEMTOOLS_TPU_SHARDED_MIN_ROWS", 8_192)


def _ann_min_rows() -> int:
    """Floor below which the IVF-PQ tier is never auto-built or served.

    Override with SEMTOOLS_TPU_ANN_MIN_ROWS.
    """
    return _env_int("SEMTOOLS_TPU_ANN_MIN_ROWS", 200_000)


def _to_i64(u: int) -> int:
    """Map an unsigned 64-bit id into sqlite's signed integer domain."""
    return u - (1 << 64) if u >= (1 << 63) else u


@dataclass
class DocMeta:
    path: str
    size_bytes: int
    mtime: int
    _version: int = CURRENT_EMBEDDING_VERSION

    def id(self) -> int:
        return doc_id(self.path)


@dataclass
class DocumentInfo:
    filename: str
    content: str
    meta: DocMeta
    # stored rows' embedding version before this change (None for new
    # docs) — the line-reuse path only trusts current-version rows
    prev_version: Optional[int] = None


@dataclass
class DocumentState:
    """Tagged union mirroring the reference's enum (store.rs:62-67)."""

    kind: str  # "unchanged" | "changed" | "new"
    path: str
    info: Optional[DocumentInfo] = None

    @classmethod
    def unchanged(cls, path: str) -> "DocumentState":
        return cls("unchanged", path)

    @classmethod
    def changed(cls, info: DocumentInfo) -> "DocumentState":
        return cls("changed", info.filename, info)

    @classmethod
    def new(cls, info: DocumentInfo) -> "DocumentState":
        return cls("new", info.filename, info)


@dataclass
class LineEmbedding:
    path: str
    line_number: int
    embedding: np.ndarray


@dataclass
class RankedLine:
    path: str
    line_number: int
    distance: float


@dataclass
class WorkspaceStats:
    total_documents: int
    has_index: bool
    index_type: Optional[str]
    total_lines: int = 0


class StoreDamagedError(RuntimeError):
    """The workspace's on-disk state is inconsistent (e.g. the vector
    file is shorter than its committed slot ranges — truncation, partial
    copy, disk fault). Deliberately NOT a subclass of the stale-snapshot
    fault types (FileNotFoundError/IndexError/ValueError): damage is
    permanent, so the search funnel's retry must not mask it."""


class Store:
    """Open (creating if needed) the store under ``workspace_dir``;
    ``device`` is where it serves (see :attr:`device`)."""

    def __init__(
        self,
        workspace_dir: str,
        dim: int = LINE_EMBEDDING_SIZE,
        model_name: str = "",
        device=None,
    ):
        self.dir = Path(workspace_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._device_name = device
        self._device: Optional[torch.device] = None
        # Cross-PROCESS writer lock (see _write_lock): sqlite's implicit
        # per-statement transactions do not make the multi-statement
        # allocator atomic, and the mmap writes sit outside sqlite
        # entirely. flock releases on process death.
        self._lock_fh = open(self.dir / ".write.lock", "a")
        self._lock_depth = 0
        self.db = sqlite3.connect(self.dir / _DB_FILE)
        self.db.execute("PRAGMA journal_mode=WAL")
        self.db.execute("PRAGMA busy_timeout=30000")
        self._init_schema()
        self.dim = self._resolve_dim(dim)
        self._check_model(model_name)
        # The vector file + hash sidecar are EPOCH-versioned: compact()
        # writes a new epoch and retires the old one, so their current
        # names live in the db (meta key 'vec_epoch'), not in code.
        self._refresh_vec_paths()
        if not self.vec_path.exists():
            self.vec_path.touch()
        # IVF-PQ state: (meta mtime, loaded index) from disk, (meta mtime,
        # light meta), (generation, reconciled serving state)
        self._ann_disk_cache = None
        self._ann_meta_cache = None
        self._ann_cache = None

    @property
    def device(self) -> torch.device:
        """The serving device, resolved at first use
        (:func:`semtools_tpu_torch.utils.platform.resolve_device`: raises
        when CUDA is asked for and absent)."""
        if self._device is None:
            from semtools_tpu_torch.utils.platform import resolve_device

            self._device = resolve_device(self._device_name)
        return self._device

    # -- schema ------------------------------------------------------------

    def _init_schema(self) -> None:
        self.db.executescript(
            """
            CREATE TABLE IF NOT EXISTS meta (
              key TEXT PRIMARY KEY, value TEXT NOT NULL);
            CREATE TABLE IF NOT EXISTS docs (
              id INTEGER PRIMARY KEY,
              path TEXT UNIQUE NOT NULL,
              size_bytes INTEGER,
              mtime INTEGER,
              version INTEGER,
              slot_start INTEGER,
              n_lines INTEGER,
              vec_rev INTEGER);
            CREATE TABLE IF NOT EXISTS free (
              start INTEGER PRIMARY KEY, length INTEGER NOT NULL);
            """
        )
        # Migration for stores created before vec_rev existed. The column
        # records the generation at which a document's VECTORS were last
        # written — the device patch diff keys on it, because a freed slot
        # range can be re-allocated to the same path with identical
        # (start, n) while holding different bytes.
        cols = {r[1] for r in self.db.execute("PRAGMA table_info(docs)")}
        if "vec_rev" not in cols:
            try:
                self.db.execute("ALTER TABLE docs ADD COLUMN vec_rev INTEGER")
            except sqlite3.OperationalError:
                pass  # concurrent opener won the migration race
        self.db.commit()

    def _resolve_dim(self, dim: int) -> int:
        row = self.db.execute("SELECT value FROM meta WHERE key='dim'").fetchone()
        if row is None:
            self.db.execute("INSERT INTO meta VALUES ('dim', ?)", (str(dim),))
            self.db.commit()
            return dim
        return int(row[0])

    def _check_model(self, model_name: str) -> None:
        """Invalidate every stored row if the embedding model changed."""
        if not model_name:
            return
        row = self.db.execute("SELECT value FROM meta WHERE key='model'").fetchone()
        if row is None:
            self.db.execute("INSERT INTO meta VALUES ('model', ?)", (model_name,))
            self.db.commit()
        elif row[0] != model_name:
            self.db.execute("UPDATE docs SET version = -1")
            self.db.execute(
                "UPDATE meta SET value = ? WHERE key='model'", (model_name,)
            )
            self.db.commit()

    # -- cross-process writer lock ----------------------------------------

    def _write_lock(self):
        """Reentrant EXCLUSIVE flock held across every mutation.

        Two concurrent CLI processes updating one workspace could
        otherwise both claim the same free range (_alloc_range's SELECT
        then DELETE are separate implicit transactions) and clobber each
        other's mmap bytes. Readers take no lock: copy-on-write upserts
        keep committed ranges intact until after commit.
        """
        from contextlib import contextmanager

        from semtools_tpu_torch.utils import filelock

        @contextmanager
        def _held():
            if self._lock_depth:
                self._lock_depth += 1
                try:
                    yield
                finally:
                    self._lock_depth -= 1
                return
            filelock.lock_exclusive(self._lock_fh)
            self._lock_depth = 1
            # another process may have compacted since we last looked:
            # mutations must land in the CURRENT epoch's files
            self._refresh_vec_paths()
            try:
                yield
            finally:
                self._lock_depth = 0
                filelock.unlock(self._lock_fh)

        return _held()

    def _read_lock(self):
        """SHARED flock for reads that must not observe a concurrent
        writer's slot reuse mid-read. Ordinary searches skip this (a torn
        read there is transient staleness); the line-reuse snapshot must
        not be torn — copied rows are PERSISTED as the new embeddings.
        No-op when this process already holds the exclusive lock."""
        from contextlib import contextmanager

        from semtools_tpu_torch.utils import filelock

        @contextmanager
        def _held():
            if self._lock_depth:
                yield
                return
            filelock.lock_shared(self._lock_fh)
            self._refresh_vec_paths()  # compact (exclusive) cannot be mid-swap
            try:
                yield
            finally:
                filelock.unlock(self._lock_fh)

        return _held()

    # -- vector file -------------------------------------------------------
    #
    # Epoch versioning: ``lines.f32``/``lines.h64`` are epoch 0; each
    # compact() writes the next epoch (``lines.e{N}.f32``/``.h64``) and
    # repoints the db's 'vec_epoch' key in the same transaction that
    # rewrites slot_starts. Committed epochs are IMMUTABLE once
    # superseded, so a lock-free reader that opened the old epoch's mmap
    # keeps a frozen consistent snapshot (POSIX keeps unlinked mappings
    # alive); only upserts mutate the CURRENT epoch in place (the
    # pre-existing, accepted transient-staleness window).

    def _vec_epoch(self) -> int:
        row = self.db.execute(
            "SELECT value FROM meta WHERE key='vec_epoch'"
        ).fetchone()
        return int(row[0]) if row else 0

    def _epoch_paths(self, epoch: int) -> Tuple[Path, Path]:
        if epoch == 0:
            return self.dir / _VECTORS_FILE, self.dir / _HASH_FILE
        return self.dir / f"lines.e{epoch}.f32", self.dir / f"lines.e{epoch}.h64"

    def _refresh_vec_paths(self) -> None:
        self.vec_path, self.hash_path = self._epoch_paths(self._vec_epoch())

    def _capacity(self) -> int:
        """Capacity of the CURRENT epoch's file, self-healing: re-reads
        the epoch when this instance's file was retired by a concurrent
        compact. Only for callers with no slot state in hand (stats,
        tier sizing, allocation under the write lock)."""
        if not self.vec_path.exists():
            self._refresh_vec_paths()
        size = self.vec_path.stat().st_size if self.vec_path.exists() else 0
        return size // (4 * self.dim)

    def _capacity_pinned(self) -> int:
        """Capacity of the epoch file this instance is pinned to — does
        NOT re-point to a newer epoch. Callers holding slot ranges must
        fail loudly when their epoch's file was retired: silently
        refreshing would pair pre-compact slots with the post-compact
        dense file, and any stale slot below the new live-row count
        reads the WRONG row with no exception — the stale-snapshot
        retry (search_line_embeddings_batched) only heals faults."""
        try:
            return self.vec_path.stat().st_size // (4 * self.dim)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"vector epoch file missing: {self.vec_path} (retired by "
                f"a concurrent compact — healed by the search retry — or "
                f"deleted from disk, in which case re-index the workspace)"
            ) from None

    def _grow_to(self, slots: int) -> None:
        mode = "r+b" if self.vec_path.exists() else "w+b"
        with open(self.vec_path, mode) as f:
            f.truncate(slots * 4 * self.dim)
        if self.hash_path.exists():
            with open(self.hash_path, "r+b") as f:
                f.truncate(slots * 8)

    def _mmap(self, mode: str = "r") -> Optional[np.ndarray]:
        cap = self._capacity_pinned()
        if cap == 0:
            return None
        return np.memmap(self.vec_path, dtype=np.float32, mode=mode, shape=(cap, self.dim))

    # -- line-hash sidecar -------------------------------------------------
    #
    # ``lines.h64`` holds one uint64 content hash per slot (0 = unknown),
    # written alongside the vectors on upsert. It funds LINE-LEVEL REUSE:
    # when a changed file is re-embedded, lines whose hash already exists
    # in the document's old block copy their stored vector instead of
    # re-tokenizing + re-embedding (search._workspace_update). Metadata
    # stays O(documents); the sidecar is slot-aligned bulk data like the
    # vectors themselves (8 B/line).

    def _hash_mmap(self, mode: str = "r") -> Optional[np.ndarray]:
        cap = self._capacity_pinned()
        if cap == 0:
            return None
        if not self.hash_path.exists() or self.hash_path.stat().st_size != cap * 8:
            if mode == "r":
                return None  # absent/stale sidecar (older store): no reuse
            with open(self.hash_path, "ab+") as f:
                f.truncate(cap * 8)  # sparse zeros = unknown
        return np.memmap(self.hash_path, dtype=np.uint64, mode=mode, shape=(cap,))

    def get_doc_hash_rows(
        self, path: str
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(line hashes, stored f32 rows) for a document's CURRENT block,
        or None when the doc has no vectors or the store predates the
        hash sidecar. Callers read this BEFORE upserting the replacement
        (copy-on-write keeps the old block intact until commit)."""
        with self._read_lock():
            row = self.db.execute(
                "SELECT slot_start, n_lines FROM docs WHERE path = ?", (path,)
            ).fetchone()
            if row is None or row[0] is None or not row[1]:
                return None
            hm = self._hash_mmap("r")
            mm = self._mmap("r")
            if hm is None or mm is None:
                return None
            s, n = int(row[0]), int(row[1])
            hashes = np.asarray(hm[s : s + n])
            rows = np.asarray(mm[s : s + n])
            del hm, mm
            return hashes, rows

    # -- free-range allocator ---------------------------------------------

    def _free_range(self, start: int, length: int) -> None:
        if length <= 0:
            return
        # Merge with adjacent free ranges.
        prev = self.db.execute(
            "SELECT start, length FROM free WHERE start + length = ?", (start,)
        ).fetchone()
        nxt = self.db.execute(
            "SELECT start, length FROM free WHERE start = ?", (start + length,)
        ).fetchone()
        if prev:
            self.db.execute("DELETE FROM free WHERE start = ?", (prev[0],))
            start, length = prev[0], prev[1] + length
        if nxt:
            self.db.execute("DELETE FROM free WHERE start = ?", (nxt[0],))
            length += nxt[1]
        self.db.execute("INSERT INTO free VALUES (?, ?)", (start, length))

    def _alloc_range(self, length: int) -> int:
        if length <= 0:
            return 0
        row = self.db.execute(
            "SELECT start, length FROM free WHERE length >= ? ORDER BY length LIMIT 1",
            (length,),
        ).fetchone()
        if row is not None:
            start, flen = row
            self.db.execute("DELETE FROM free WHERE start = ?", (start,))
            if flen > length:
                self.db.execute("INSERT INTO free VALUES (?, ?)", (start + length, flen - length))
            return start
        start = self._capacity()
        self._grow_to(start + length)
        return start

    # -- upserts -----------------------------------------------------------

    def upsert_document_lines(
        self, path: str, embeddings: np.ndarray, line_hashes=None
    ) -> None:
        """Replace a document's line vectors with a new contiguous block."""
        self.upsert_documents_bulk([(path, embeddings, line_hashes)])

    def upsert_documents_bulk(
        self, items: Sequence[Tuple[str, np.ndarray]]
    ) -> None:
        """Replace many documents' vectors in one transaction.

        One mmap open + one flush + one sqlite commit + one generation bump
        for the whole batch — per-document commits and msyncs made a
        500-document workspace build pay 500 fsync round-trips.
        """
        if not items:
            return
        # Last write wins for duplicate paths within one batch — staging
        # the same path twice would free its old range twice (the docs row
        # only updates at commit). Items are (path, embeddings) or
        # (path, embeddings, line_hashes) — hashes feed the reuse sidecar.
        deduped = {it[0]: it[1:] for it in items}
        # Validate and coerce EVERYTHING before mutating anything so the
        # write loop below cannot fail on caller input.
        checked = []
        for path, rest in deduped.items():
            embeddings = np.ascontiguousarray(rest[0], dtype=np.float32)
            if embeddings.ndim != 2 or (
                embeddings.shape[0] and embeddings.shape[1] != self.dim
            ):
                raise ValueError(
                    f"embeddings for {path!r} have shape {embeddings.shape}; "
                    f"expected [n, {self.dim}]"
                )
            hashes = rest[1] if len(rest) > 1 and rest[1] is not None else None
            if hashes is not None:
                hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
                if hashes.shape != (embeddings.shape[0],):
                    raise ValueError(
                        f"line_hashes for {path!r} have shape {hashes.shape}; "
                        f"expected ({embeddings.shape[0]},)"
                    )
            checked.append((path, embeddings, hashes))

        # Copy-on-write ordering: allocate fresh ranges WITHOUT freeing the
        # live ones, write+flush the mmap, commit the docs rows, and only
        # then release the replaced ranges. A crash anywhere in between
        # leaves either the old consistent state (docs rows roll back;
        # orphaned bytes sit in space sqlite still considers free) or the
        # new consistent state (old ranges simply leak until the post-
        # commit free, which the next upsert batch re-merges). Freeing
        # before the commit could let one batch member's fresh allocation
        # overwrite another member's still-committed vectors.
        with self._write_lock():
            staged = []  # (path, start, n, embeddings, hashes)
            replaced = []  # (old_start, old_len) released only after commit
            for path, embeddings, hashes in checked:
                n = embeddings.shape[0]
                row = self.db.execute(
                    "SELECT slot_start, n_lines FROM docs WHERE path = ?", (path,)
                ).fetchone()
                if row is not None and row[0] is not None:
                    replaced.append((int(row[0]), int(row[1])))
                start = self._alloc_range(n)
                staged.append((path, start, n, embeddings, hashes))

            if any(n for _, _, n, _, _ in staged):
                mm = self._mmap("r+")
                for _, start, n, embeddings, _ in staged:
                    if n:
                        mm[start : start + n] = embeddings
                mm.flush()
                del mm
                hm = self._hash_mmap("r+")
                if hm is not None:
                    for _, start, n, _, hashes in staged:
                        if n:
                            hm[start : start + n] = (
                                hashes if hashes is not None else 0
                            )
                    hm.flush()
                    del hm
            # vec_rev = the generation this write lands in: even if the
            # allocator hands a path the exact (start, n) range it held
            # before, the revision proves the bytes changed.
            next_rev = self.generation() + 1
            self.db.executemany(
                """INSERT INTO docs (id, path, slot_start, n_lines, vec_rev)
                   VALUES (?, ?, ?, ?, ?)
                   ON CONFLICT(path) DO UPDATE SET
                     slot_start = ?, n_lines = ?, vec_rev = ?""",
                [
                    (_to_i64(doc_id(path)), path, start, n, next_rev,
                     start, n, next_rev)
                    for path, start, n, _, _ in staged
                ],
            )
            self._bump_generation()
            self.db.commit()
            for old_start, old_len in replaced:
                self._free_range(old_start, old_len)
            if replaced:
                self.db.commit()

    def upsert_line_embeddings(self, line_embeddings: Sequence[LineEmbedding]) -> None:
        """Group by path and replace each document's block (one bulk
        transaction for the whole batch).

        The public write path always supplies complete documents (lines
        0..n-1, src/search/mod.rs:170-182), which this enforces.
        """
        if not line_embeddings:
            return
        by_path: Dict[str, List[LineEmbedding]] = {}
        for le in line_embeddings:
            by_path.setdefault(le.path, []).append(le)
        bulk = []
        for path, les in by_path.items():
            les.sort(key=lambda le: le.line_number)
            nums = [le.line_number for le in les]
            if nums != list(range(len(les))):
                raise ValueError(
                    f"upsert for {path!r} must cover lines 0..n-1, got {nums[:5]}..."
                )
            bulk.append((path, np.stack([np.asarray(le.embedding, np.float32) for le in les])))
        self.upsert_documents_bulk(bulk)

    def upsert_document_metadata(self, metas: Sequence[DocMeta]) -> None:
        with self._write_lock():
            for meta in metas:
                self.db.execute(
                    """INSERT INTO docs (id, path, size_bytes, mtime, version)
                       VALUES (?, ?, ?, ?, ?)
                       ON CONFLICT(path) DO UPDATE SET
                         size_bytes = ?, mtime = ?, version = ?""",
                    (
                        _to_i64(meta.id()),
                        meta.path,
                        meta.size_bytes,
                        meta.mtime,
                        meta._version,
                        meta.size_bytes,
                        meta.mtime,
                        meta._version,
                    ),
                )
            self.db.commit()

    # -- reads -------------------------------------------------------------

    def get_existing_docs(self, paths: Sequence[str]) -> Dict[str, DocMeta]:
        out: Dict[str, DocMeta] = {}
        for i in range(0, len(paths), 1000):
            chunk = list(paths[i : i + 1000])
            q = ",".join("?" for _ in chunk)
            rows = self.db.execute(
                f"""SELECT path, size_bytes, mtime, version FROM docs
                    WHERE path IN ({q}) AND size_bytes IS NOT NULL""",
                chunk,
            ).fetchall()
            for path, size_bytes, mtime, version in rows:
                out[path] = DocMeta(path, size_bytes, mtime, version)
        return out

    def get_all_document_paths(self) -> List[str]:
        rows = self.db.execute(
            "SELECT path FROM docs WHERE size_bytes IS NOT NULL"
        ).fetchall()
        return [r[0] for r in rows]

    def count_documents(self) -> int:
        return self.db.execute(
            "SELECT COUNT(*) FROM docs WHERE size_bytes IS NOT NULL"
        ).fetchone()[0]

    def count_line_embeddings(self) -> int:
        return self.db.execute(
            "SELECT COALESCE(SUM(n_lines), 0) FROM docs WHERE slot_start IS NOT NULL"
        ).fetchone()[0]

    def get_stats(self) -> WorkspaceStats:
        return WorkspaceStats(
            total_documents=self.count_documents(),
            has_index=True,
            index_type=self.serving_tier(),
            total_lines=self.count_line_embeddings(),
        )

    def _mesh_size(self) -> int:
        """Shards of the serving device's mesh (``parallel.mesh.mesh_size``;
        the device is not resolved, so a tier report creates no CUDA
        context)."""
        from semtools_tpu_torch.parallel.mesh import mesh_size

        return mesh_size(self._device if self._device is not None else self._device_name)

    def _sharded(self, n_rows: int) -> bool:
        return _sharded_enabled(n_rows, self._mesh_size())

    def _serving_mesh(self, n_rows: int):
        """The mesh a store of ``n_rows`` live rows serves on, or None (one
        device)."""
        if not self._sharded(n_rows):
            return None
        from semtools_tpu_torch.parallel.mesh import corpus_mesh

        return corpus_mesh(device=self.device)

    def _device_budget_bytes(self, n_rows: int) -> int:
        """The device cache's byte budget, times the mesh size when the store
        shards (the JAX package's rule: each shard holds 1/size of the
        rows)."""
        from semtools_tpu_torch.store import device_cache

        budget = device_cache._max_bytes()
        if self._sharded(n_rows):
            budget *= self._mesh_size()
        return budget

    def _slot_rows(self, n_rows: int) -> int:
        """Rows the slot-space device corpus actually allocates: the mmap
        CAPACITY (freed/fragmented slots included), never less than the
        live row count — budget fits must measure this, or a fragmented
        store gets approved far over budget."""
        return max(self._capacity(), n_rows)

    def _capacity_reduced_dim(self, n_rows: int) -> Optional[int]:
        """Projection dim for the reduced-int8 capacity tier, or None.

        None when the plain int8 corpus already fits the device budget
        (no reduction needed), when the tier is disabled
        (SEMTOOLS_TPU_REDUCED_DIM=0), or when even the reduced corpus
        would not fit (the ANN tier takes over).

        When the configured rung does not fit, HALVE it down to 32 before
        surrendering to the host IVF-PQ tier (at the 4 GiB default budget,
        reduced-64d holds ~67M rows and the 32d rung ~134M). Explicit
        sub-32 values are honored as-is but never auto-halved further.
        The JAX package's policy, kept so both packages name the same
        tier.
        """
        rd = _env_int("SEMTOOLS_TPU_REDUCED_DIM", 64)
        if rd <= 0 or rd >= self.dim:
            return None
        budget = self._device_budget_bytes(n_rows)
        slot_rows = self._slot_rows(n_rows)
        if slot_rows * self.dim <= budget:
            return None
        if self._int4_fits(slot_rows, budget):
            return None  # the int4 rung (dim/2 B/row) serves this size
        while True:
            # rd+1: the stored corpus is [rows, rd+1] int8 — the extra
            # column is each row's residual norm (optimistic-bound
            # serving, see patch_cache._build).
            if slot_rows * (rd + 1) <= budget:
                return rd
            if rd <= 32:
                return None
            rd = max(rd // 2, 32)

    def _int4_fits(self, slot_rows: int, budget: int) -> bool:
        """True when the int4 capacity rung is available for this size:
        the packed corpus (dim/2 bytes/row) fits the device budget and
        the tier isn't disabled. Packing needs an even dim (always true
        for served models; defensive for exotic ones)."""
        return (
            os.environ.get("SEMTOOLS_TPU_STORE_INT4") != "0"
            and self.dim % 2 == 0
            and slot_rows * (self.dim // 2) <= budget
        )

    def _use_ann_tier(self, n_rows: int) -> bool:
        """IVF-PQ is the LAST capacity tier: it serves only when the
        corpus cannot live on-device even in reduced-int8 form, or when
        forced with SEMTOOLS_TPU_FORCE_ANN=1. Everything smaller gets a
        device scan with exact re-ranking, where served distances are
        exact and the top-k pool is certified by the completion margin
        (6-sigma by default, unconditional under
        SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS=hard — see _topk_margin and
        ARCHITECTURE.md's guaranteed/not-guaranteed split).
        """
        if os.environ.get("SEMTOOLS_TPU_FORCE_ANN") == "1":
            return True
        if n_rows < _ann_min_rows():
            return False
        budget = self._device_budget_bytes(n_rows)
        slot_rows = self._slot_rows(n_rows)
        if slot_rows * self.dim <= budget:
            return False
        if self._int4_fits(slot_rows, budget):
            # int8 over budget but the packed rung still serves on-device
            # (exact re-rank, margin-certified pool). Found by the capacity-
            # ladder policy sweep: _capacity_reduced_dim returns None when
            # int4 fits, which this check misread as "nothing fits" and
            # handed an int4-sized corpus to IVF-PQ.
            return False
        return self._capacity_reduced_dim(n_rows) is None

    def _device_kind(self, n_rows: int) -> Tuple[str, Optional[int]]:
        """('f32' | 'int8' | 'int4', reduced_dim) for whole-store device
        serving.

        The compressed kinds are chosen by the size policies OR because
        the wider tier would not fit the device budget — the budget check
        must measure the bytes of the tier actually served. Capacity
        ladder (B/row at D=256): f32 1024 -> int8 256 -> int4 128 ->
        reduced-64d 64 -> IVF-PQ (host).
        """
        rd = self._capacity_reduced_dim(n_rows)
        if rd:
            return "int8", rd
        budget = self._device_budget_bytes(n_rows)
        slot_rows = self._slot_rows(n_rows)
        if slot_rows * self.dim > budget and self._int4_fits(slot_rows, budget):
            # int8 would blow the device budget; the packed corpus fits —
            # the capacity rung between full int8 and reduced-64d.
            return "int4", None
        if _int4_tier_enabled(n_rows) and self._int4_fits(slot_rows, budget):
            return "int4", None
        if _int8_tier_enabled(n_rows):
            return "int8", None
        if (
            os.environ.get("SEMTOOLS_TPU_STORE_INT8") != "0"
            and slot_rows * 4 * self.dim > budget
        ):
            # f32 would blow the device budget; int8 fits. An explicit
            # SEMTOOLS_TPU_STORE_INT8=0 still wins ('0=never') — the user
            # accepts the memory cost.
            return "int8", None
        return "f32", None

    def serving_tier(self, n_rows: Optional[int] = None) -> str:
        """Name of the tier a whole-store query would use right now
        (``workspace status`` reports this); the JAX package's names."""
        if n_rows is None:
            n_rows = self.count_line_embeddings()
        if os.environ.get("SEMTOOLS_TPU_SCAN", "").lower() == "host":
            return "host-mmap-scan"
        if self._use_ann_tier(n_rows) and self._ann_available():
            return "ivf-pq"
        kind, rd = self._device_kind(n_rows)
        suffix = f"-reduced{rd}d" if rd else ""
        if self._sharded(n_rows):
            name = kind if kind in ("int8", "int4") else "exact"
            return f"sharded-{name}-scan[{self._mesh_size()}]{suffix}"
        if kind == "f32":
            return "exact-mxu-scan"
        return f"{kind}-mxu-scan{suffix}"

    # -- ANN tier (IVF-PQ) -------------------------------------------------
    #
    # The last capacity rung: the exact device tiers serve by default and
    # IVF-PQ takes over for corpora no device rung fits. The index is keyed
    # to the store's generation counter; mutations since the build are
    # reconciled at query time (tombstones + a delta segment) up to the
    # drift bound, past which the exact tiers serve until a rebuild. The
    # on-disk pair and every rule below are the JAX package's, so either
    # package serves, reconciles and compacts the other's index.

    def _ann_paths(self) -> Tuple[Path, Path]:
        return self.dir / _ANN_FILE, self.dir / _ANN_META_FILE

    def _sweep_ann_tmp_files(self) -> None:
        """Unlink ``*.tmp<pid>.npz`` ANN build leftovers whose building
        process is gone — a crash between tmp creation and the atomic
        rename orphans an index-sized file that nothing else cleans
        (the epoch sweep only globs ``lines.*``). Live builds' tmps
        (concurrent build from another process) are left alone."""
        pat = re.compile(r"\.tmp(\d+)\.npz$")
        for ann_or_meta in self._ann_paths():
            for t in self.dir.glob(ann_or_meta.stem + ".tmp*.npz"):
                m = pat.search(t.name)
                if not m:
                    continue
                pid = int(m.group(1))
                if pid == os.getpid():
                    continue
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    with contextlib.suppress(OSError):
                        t.unlink()
                except OSError:
                    pass  # EPERM: pid exists under another uid — leave it

    def _ann_generation_matches(self) -> bool:
        """Cheap freshness probe: reads only the generation scalar (npz
        members load lazily), never the codes/slots arrays."""
        ann_path, meta_path = self._ann_paths()
        if not (ann_path.exists() and meta_path.exists()):
            return False
        try:
            with np.load(meta_path) as meta:
                return int(meta["generation"]) == self.generation()
        except Exception:
            return False

    # Rebuild once cumulative changed+removed rows exceed this fraction of
    # the indexed corpus — below it, mutations serve through the delta.
    _ANN_DRIFT_DENOM = 4

    def _ann_layout_diff(self, build_layout: Dict[str, Tuple[int, int, int]]):
        """(changed ranges, removed ranges, drift rows) between the
        index's build-time layout and the store's CURRENT layout. Cheap:
        one sqlite read + dict compares — no row I/O, no encoding."""
        new_layout = {p: (s, n, r) for p, s, n, r in self._layout_with_rev()}
        changed = [
            (p, v[0], v[1]) for p, v in new_layout.items()
            if build_layout.get(p) != v
        ]
        removed = [
            (v[0], v[1]) for p, v in build_layout.items()
            if new_layout.get(p) != v
        ]
        # Drift counts what incremental serving pays for: DELTA rows
        # (ADC-scored per query) plus rows of documents gone entirely. A
        # rewritten document's freed old range is a tombstone (one range
        # bisect per probe), not per-row work.
        drift = sum(n for _, _, n in changed) + sum(
            v[1] for p, v in build_layout.items() if p not in new_layout
        )
        return changed, removed, drift

    def _ann_load_meta(self):
        """(index, build generation, slots, build layout) from disk,
        instance-cached keyed on the meta file's mtime — another process
        rebuilding the index on disk must be picked up (PQ codes for a
        big corpus cost real I/O, so the cache matters)."""
        ann_path, meta_path = self._ann_paths()
        if not (ann_path.exists() and meta_path.exists()):
            return None
        try:
            mtime = meta_path.stat().st_mtime_ns
        except OSError:
            return None
        cached = self._ann_disk_cache
        if cached is not None and cached[0] == mtime:
            return cached[1]
        # Order matters: read the small meta npz and check the build token
        # BEFORE loading the PQ codes, and cache a torn pair as a NEGATIVE
        # result keyed on the same mtime — a crash between the paired
        # renames leaves the mismatch on disk until the next rebuild, and
        # every query must not re-read the codes to re-discover it.
        try:
            with np.load(meta_path, allow_pickle=False) as meta:
                m = {k: meta[k] for k in meta.files}
        except Exception:
            self._ann_disk_cache = (mtime, None)
            return None
        if not self._ann_tokens_match(ann_path, m):
            self._ann_disk_cache = (mtime, None)
            return None  # torn publish: index and meta from different builds
        try:
            from semtools_tpu_torch.index.ivf_pq import IvfPqIndex

            index = IvfPqIndex.load(str(ann_path))
        except Exception:
            self._ann_disk_cache = (mtime, None)
            return None
        if "lay_paths" in m:
            layout = {
                str(p): (int(s), int(n), int(r))
                for p, s, n, r in zip(
                    m["lay_paths"], m["lay_starts"], m["lay_lens"], m["lay_revs"]
                )
            }
        else:
            layout = None  # pre-incremental meta: exact-generation only
        state = (index, int(m["generation"]), m["slots"], layout)
        self._ann_disk_cache = (mtime, state)
        return state

    @staticmethod
    def _ann_tokens_match(ann_path: Path, meta: Dict) -> bool:
        """True when the index and meta files carry the same build token
        (or both predate tokens). Reading one scalar member of the index
        npz touches the zip directory plus a few bytes — never the codes."""
        meta_tok = meta.get("build_token")
        try:
            with np.load(ann_path, allow_pickle=False) as z:
                ann_tok = z["build_token"] if "build_token" in z.files else None
        except Exception:
            return False
        if meta_tok is None and ann_tok is None:
            return True  # legacy pair (pre-token builds)
        return (
            meta_tok is not None
            and ann_tok is not None
            and int(meta_tok) == int(ann_tok)
        )

    def _ann_meta_light(self):
        """(build generation, build layout|None, indexed row count) from
        the meta npz WITHOUT touching the PQ codes — `workspace status`
        on a 10M-row store must not read hundreds of MB to name a tier.
        Cached keyed on the meta file's mtime."""
        ann_path, meta_path = self._ann_paths()
        if not (ann_path.exists() and meta_path.exists()):
            return None
        try:
            mtime = meta_path.stat().st_mtime_ns
        except OSError:
            return None
        cached = self._ann_meta_cache
        if cached is not None and cached[0] == mtime:
            return cached[1]
        try:
            with np.load(meta_path, allow_pickle=False) as meta:
                gen = int(meta["generation"])
                tok = (
                    {"build_token": meta["build_token"]}
                    if "build_token" in meta.files else {}
                )
                if "lay_paths" in meta.files:
                    lens = meta["lay_lens"]
                    layout = {
                        str(p): (int(s), int(n), int(r))
                        for p, s, n, r in zip(
                            meta["lay_paths"], meta["lay_starts"],
                            lens, meta["lay_revs"],
                        )
                    }
                    n_rows = int(lens.sum())
                else:
                    layout = None
                    n_rows = int(meta["slots"].shape[0])
        except Exception:
            return None
        if not self._ann_tokens_match(ann_path, tok):
            return None  # torn publish mid-rebuild: not servable
        out = (gen, layout, n_rows)
        self._ann_meta_cache = (mtime, out)
        return out

    def _ann_available(self) -> bool:
        """Cheap serving-tier probe: an index exists and is either at the
        current generation or within the incremental drift bound (judged
        against the INDEXED row count from the meta, not the live count).
        Never reads the PQ codes."""
        light = self._ann_meta_light()
        if light is None:
            return False
        build_gen, layout, indexed_rows = light
        if build_gen == self.generation():
            return True
        if layout is None:
            return False
        _, _, drift = self._ann_layout_diff(layout)
        return drift <= indexed_rows // self._ANN_DRIFT_DENOM

    def _ann_current(self):
        """The ANN serving state reconciled to the CURRENT generation, or
        None (no index, or drift past the rebuild bound).

        Instead of staling the whole index on any mutation, the build-time
        layout is diffed against the current one: removed build rows
        become TOMBSTONE ranges (filtered from probe candidates), and
        changed/new rows are ADC-encoded under the frozen quantizers into a
        DELTA segment scored alongside the probe. Nothing is persisted: a
        reconcile always diffs build->current, so a cold process needs no
        delta journal, and the per-generation instance cache keeps warm
        serving free. The state is ``(index, slots, rm_starts, rm_ends,
        delta_slots, delta_lists, delta_codes)``.
        """
        gen = self.generation()
        cached = self._ann_cache
        if cached is not None and cached[0] == gen:
            return cached[1]
        loaded = self._ann_load_meta()
        if loaded is None:
            return None
        index, build_gen, slots, layout = loaded
        if build_gen == gen:
            state = (index, slots,
                     np.zeros(0, np.int64), np.zeros(0, np.int64),  # rm ranges
                     np.zeros(0, np.int64),                          # delta slots
                     np.zeros(0, np.int64),                          # delta lists
                     np.zeros((0, index.pq.m), np.uint8))            # delta codes
            self._ann_cache = (gen, state)
            return state
        if layout is None:
            return None
        changed, removed, drift = self._ann_layout_diff(layout)
        if drift > len(slots) // self._ANN_DRIFT_DENOM:
            return None
        rm = sorted((int(s), int(s) + int(n)) for s, n in removed)
        rm_starts = np.array([a for a, _ in rm], np.int64)
        rm_ends = np.array([b for _, b in rm], np.int64)
        d_slots: List[np.ndarray] = []
        d_lists: List[np.ndarray] = []
        d_codes: List[np.ndarray] = []
        if changed:
            mm = self._mmap("r")
            if mm is None:
                return None
            for _, s, n in changed:
                lists, codes = index.encode_rows(np.asarray(mm[s : s + n]))
                d_slots.append(np.arange(s, s + n, dtype=np.int64))
                d_lists.append(lists)
                d_codes.append(codes)
            del mm
        state = (
            index, slots, rm_starts, rm_ends,
            np.concatenate(d_slots) if d_slots else np.zeros(0, np.int64),
            np.concatenate(d_lists) if d_lists else np.zeros(0, np.int64),
            np.concatenate(d_codes) if d_codes else np.zeros((0, index.pq.m), np.uint8),
        )
        self._ann_cache = (gen, state)
        return state

    @staticmethod
    def _ann_nlist(n_rows: int) -> int:
        """Coarse-list count: ~4*sqrt(n), a power of two, capped at 4096
        (the JAX package's rule, so both packages build the same shape)."""
        return int(min(
            4096, max(16, 1 << int(np.log2(max(4 * np.sqrt(n_rows), 16))))
        ))

    def _gen_layout_snapshot(self) -> Tuple[int, List[Tuple[str, int, int, int]]]:
        """(generation, layout) read in ONE sqlite transaction, so a
        writer in another process cannot land between the two reads (WAL
        gives the transaction snapshot isolation). The ANN build stamps
        this pair into its meta — they must describe the same instant."""
        try:
            self.db.execute("BEGIN")
        except sqlite3.OperationalError:
            # already inside a transaction: reads share its snapshot
            return self.generation(), self._layout_with_rev()
        try:
            return self.generation(), self._layout_with_rev()
        finally:
            self.db.commit()

    class _SlotRows:
        """Lazy row gather over (mmap, slots): the build touches one chunk
        at a time, so a 10M-row corpus never materializes in RAM."""

        def __init__(self, mm, slots):
            self._mm, self._slots = mm, slots

        @property
        def shape(self):
            return (len(self._slots), self._mm.shape[1])

        def __getitem__(self, idx):
            return np.asarray(self._mm[self._slots[idx]])

        def __array__(self, dtype=None, copy=None):
            out = np.asarray(self._mm[self._slots])
            return out.astype(dtype) if dtype is not None else out

    def _ann_build_device(self) -> torch.device:
        """Where the index is built: the store's device, or the CPU under
        ``SEMTOOLS_TPU_ANN_BUILD=host`` (or ``cpu``), the variable the JAX
        package reads. Nothing moves to the CPU on its own."""
        mode = os.environ.get("SEMTOOLS_TPU_ANN_BUILD", "auto").lower()
        return torch.device("cpu") if mode in ("host", "cpu") else self.device

    def build_ann_index(self, force: bool = False, verbose: bool = False):
        """Build (or refresh) the IVF-PQ capacity tier over all stored
        vectors, on :meth:`_ann_build_device`.

        Returns the index, or None when the corpus would not be served by
        the ANN tier (it fits on-device — see :meth:`_use_ann_tier`) and
        ``force`` is unset. Safe to call repeatedly — a fresh index is a
        no-op, and so, unless ``force`` is set, is one that mutations left
        within the drift bound: it serves through the reconcile (the JAX
        package rebuilds it; the answers are the same). Memory stays
        O(chunk + codes) on the host, whatever the corpus size. A device
        error raises (the tmp files are unlinked).
        """
        if self._ann_generation_matches():
            loaded = self._ann_load_meta()
            if loaded is not None:
                return loaded[0]
        n = self.count_line_embeddings()
        if n == 0 or (not force and not self._use_ann_tier(n)):
            return None
        if not force and self._ann_available():
            loaded = self._ann_load_meta()
            if loaded is not None:
                return loaded[0]
        from semtools_tpu_torch.index.ivf_pq import IvfPqIndex

        # Snapshot (generation, layout) BEFORE the build and stamp exactly
        # this snapshot into the meta: a mutation landing mid-build then
        # reads as build->current drift and serves through tombstones + the
        # delta (_ann_current). Re-reading the generation at save time would
        # mark a mid-build mutation exactly-fresh and serve its pre-mutation
        # rows indefinitely.
        build_gen, lay = self._gen_layout_snapshot()
        slots = np.concatenate(
            [np.arange(s, s + ln, dtype=np.int64) for _, s, ln, _ in lay]
        )
        mm = self._mmap("r")
        x = self._SlotRows(mm, slots)
        dev = self._ann_build_device()
        progress = None
        if verbose:
            import sys

            backend = "cpu" if dev.type == "cpu" else "device"
            print(
                f"Building IVF-PQ index over {n} lines ({backend} backend)...",
                file=sys.stderr,
            )

            def progress(msg: str) -> None:
                # a 10M-row build runs for a while: silence reads as a hang
                print(f"  {msg}", file=sys.stderr, flush=True)
        nlist = self._ann_nlist(n)
        # PQ subspaces must divide the dim: 32 at the production dim 256
        # (8 dims a byte); other dims take their largest divisor <= 32.
        m = max(j for j in range(1, min(32, self.dim) + 1) if self.dim % j == 0)
        index = IvfPqIndex.build(
            x, nlist=nlist, m=m, keep_vectors=False, progress=progress, device=dev
        )
        del mm
        ann_path, meta_path = self._ann_paths()
        # Atomic paired publish: each file lands via tmp+rename, and a
        # shared random token ties the pair together — a reader between the
        # two renames (new index, old meta) sees a token mismatch and keeps
        # serving the exact tiers instead of pairing slots/layout from a
        # different build.
        token = int.from_bytes(os.urandom(8), "big", signed=True)
        # pid-unique tmp names: builds hold no write lock (writers must not
        # wait on a build), so two concurrent builds must not write over
        # each other's tmp files. Dead processes' tmps are swept here; our
        # own are unlinked on any failure below (a no-op after replace()).
        self._sweep_ann_tmp_files()
        tmp_ann = ann_path.with_suffix(f".tmp{os.getpid()}.npz")
        tmp_meta = meta_path.with_suffix(f".tmp{os.getpid()}.npz")
        try:
            with stage("ann_publish"):
                index.save(str(tmp_ann), extra={"build_token": np.int64(token)})
                tmp_ann.replace(ann_path)
                # the build-time LAYOUT funds incremental serving (see
                # _ann_current)
                np.savez(
                    tmp_meta, generation=build_gen, build_token=np.int64(token),
                    slots=slots,
                    lay_paths=np.array([p for p, _, _, _ in lay]),
                    lay_starts=np.array([s2 for _, s2, _, _ in lay], np.int64),
                    lay_lens=np.array([n2 for _, _, n2, _ in lay], np.int64),
                    lay_revs=np.array([r2 for _, _, _, r2 in lay], np.int64),
                )
                tmp_meta.replace(meta_path)
        finally:
            for t in (tmp_ann, tmp_meta):
                with contextlib.suppress(OSError):
                    t.unlink()
        self._ann_disk_cache = None
        self._ann_meta_cache = None
        self._ann_cache = None
        return index

    @staticmethod
    def _ranked_from_slots(ranges, cand_slots, distances, order) -> List[RankedLine]:
        """Map selected candidate slots back to (path, line, distance).

        ``ranges`` must be slot-ordered (path, slot_start, n_lines) rows;
        a slot's document is found by bisecting the starts.
        """
        starts = np.array([s2 for _, s2, _ in ranges], dtype=np.int64)
        out: List[RankedLine] = []
        for oi in order:
            slot = int(cand_slots[oi])
            ri = int(np.searchsorted(starts, slot, side="right")) - 1
            path, s2, _ = ranges[ri]
            out.append(
                RankedLine(path=path, line_number=slot - s2, distance=float(distances[oi]))
            )
        return out

    @staticmethod
    def _ann_candidate_depth(top_k: int, n: int, nlist: int, nprobe: int) -> int:
        """ADC-cut depth for the exact re-rank, scaled with the PROBED
        candidate pool: the 64x-k floor holds at small scale, and a cut of
        >= pool/64 keeps the cut fraction constant as the corpus (and with
        nlist capped at 4096, the probed pool) grows — a fixed cut loses
        recall to ADC-cut victims inside probed lists."""
        pool = n * nprobe // max(nlist, 1)
        return max(64 * top_k, 256, pool // 64)

    def _search_ann_batched(
        self,
        state,
        query_vecs: np.ndarray,
        top_k: int,
        max_distance: Optional[float],
    ) -> List[List[RankedLine]]:
        """Whole-store queries through the index: one probe call for all
        queries and ONE mmap open for all exact re-ranks. ``state`` is
        :meth:`_ann_current`'s reconciled view: probe candidates from
        removed (tombstoned) build ranges are dropped, and delta rows —
        scored approximately under the same coarse+residual decomposition —
        join the exact re-rank."""
        index, slots, rm_starts, rm_ends, d_slots, d_lists, d_codes = state
        qs = np.asarray(query_vecs, np.float32)
        # Probe enough lists that the EXPECTED pool holds 64x-k rows: the
        # nlist/16 floor alone visits a fixed fraction of the corpus, so a
        # top_k comparable to the corpus would miss rows in unprobed lists.
        avg_list = max(index.n // max(index.nlist, 1), 1)
        nprobe = min(
            max(16, index.nlist // 16, -(-64 * top_k // avg_list)),
            index.nlist,
        )
        if index.n <= (1 << 16):
            # Tiny corpus (forced/test configurations): probe EVERY list. On
            # unclustered data the true nearest row's list can rank below
            # any partial probe cut, and an exhaustive ADC scan of <= 65k
            # rows costs about a millisecond.
            nprobe = index.nlist
        env_nprobe = os.environ.get("SEMTOOLS_TPU_ANN_NPROBE")
        if env_nprobe:
            # explicit recall/latency knob (the faiss/qdrant convention)
            try:
                nprobe = min(max(1, int(env_nprobe)), index.nlist)
            except ValueError:
                pass
        oversample = self._ann_candidate_depth(top_k, index.n, index.nlist, nprobe)
        _, ids = index.search(qs, k=min(oversample, index.n), nprobe=nprobe)
        delta_top = None
        if len(d_slots):
            d_approx = index.score_rows(qs, d_codes, d_lists)  # [Q, Dn]
            kd = min(oversample, len(d_slots))
            delta_top = np.argpartition(-d_approx, kd - 1, axis=1)[:, :kd]
        ranges = self._valid_ranges_cached()
        mm = self._mmap("r")
        if mm is None:
            return [[] for _ in range(qs.shape[0])]
        out: List[List[RankedLine]] = []
        for r in range(qs.shape[0]):
            idr = ids[r]
            idr = idr[idr >= 0]  # drop padding entries from under-filled probes
            cand_slots = slots[idr]
            if rm_starts.size:
                # tombstoned build rows (their doc was removed or
                # re-written): the build-time codes are stale
                pos = np.searchsorted(rm_starts, cand_slots, side="right") - 1
                pos_c = np.clip(pos, 0, len(rm_starts) - 1)
                dead = (pos >= 0) & (cand_slots < rm_ends[pos_c])
                cand_slots = cand_slots[~dead]
            if delta_top is not None:
                cand_slots = np.concatenate(
                    [cand_slots, d_slots[delta_top[r]]]
                )
            # slot-sorted unique candidates: the stable exact re-rank then
            # breaks ties toward the lower slot = lower corpus position,
            # matching the exact tiers
            cand_slots = np.unique(cand_slots)
            rows = np.asarray(mm[cand_slots])
            exact = 1.0 - (rows @ qs[r])
            order = np.argsort(exact, kind="stable")[:top_k]
            if max_distance is not None:
                order = order[exact[order] < max_distance]
            out.append(self._ranked_from_slots(ranges, cand_slots, exact, order))
        del mm
        return out

    # -- generation and layout ---------------------------------------------

    def _bump_generation(self) -> None:
        self.db.execute(
            """INSERT INTO meta (key, value) VALUES ('generation', '1')
               ON CONFLICT(key) DO UPDATE SET value = CAST(value AS INTEGER) + 1"""
        )

    def generation(self) -> int:
        row = self.db.execute("SELECT value FROM meta WHERE key='generation'").fetchone()
        return int(row[0]) if row else 0

    def _valid_ranges(self) -> List[Tuple[str, int, int]]:
        """(path, slot_start, n_lines) for every stored document, in slot
        order, skipping docs whose vectors were deleted."""
        rows = self.db.execute(
            """SELECT path, slot_start, n_lines FROM docs
               WHERE slot_start IS NOT NULL AND n_lines > 0
               ORDER BY slot_start"""
        ).fetchall()
        return [(r[0], int(r[1]), int(r[2])) for r in rows]

    def _layout_with_rev(self) -> List[Tuple[str, int, int, int]]:
        """(path, slot_start, n_lines, vec_rev) in slot order — the device
        patch diff's view of the store (vec_rev distinguishes re-written
        content in a re-used slot range)."""
        rows = self.db.execute(
            """SELECT path, slot_start, n_lines, COALESCE(vec_rev, 0) FROM docs
               WHERE slot_start IS NOT NULL AND n_lines > 0
               ORDER BY slot_start"""
        ).fetchall()
        return [(r[0], int(r[1]), int(r[2]), int(r[3])) for r in rows]

    def _valid_ranges_cached(self) -> List[Tuple[str, int, int]]:
        """Generation-keyed cache of :meth:`_valid_ranges` — repeated
        searches (daemon / agent batches) pay one meta-row read instead of
        a full docs table scan per query.

        The refresh re-reads (generation, ranges, vector-file epoch) in
        ONE sqlite transaction, so slot ranges are always paired with the
        file they index into — a concurrent compact cannot slip its epoch
        swap between the two reads."""
        gen = self.generation()
        cached = getattr(self, "_ranges_cache", None)
        if cached is not None and cached[0] == gen:
            return cached[1]
        began = False
        try:
            self.db.execute("BEGIN")
            began = True
        except sqlite3.OperationalError:
            pass  # already inside a transaction: reads share its snapshot
        try:
            gen = self.generation()
            ranges = self._valid_ranges()
            epoch = self._vec_epoch()
        finally:
            if began:
                self.db.commit()
        self.vec_path, self.hash_path = self._epoch_paths(epoch)
        if ranges:
            # Integrity gate: committed ranges must lie inside the epoch
            # file (copy-on-write grows+writes the file BEFORE committing
            # rows, so under every legal interleaving end <= capacity).
            # A shorter file is real damage — truncation, a partial copy,
            # a disk fault — and must fail loudly here rather than let a
            # slot read index past the mmap (or silently serve a partial
            # corpus).
            end = ranges[-1][1] + ranges[-1][2]  # slot-ordered, disjoint
            if end > self._capacity_pinned():
                raise StoreDamagedError(
                    f"workspace vector file {self.vec_path} holds "
                    f"{self._capacity_pinned()} slots but the store has "
                    f"committed rows through slot {end}: the file was "
                    f"truncated or partially copied. Embeddings are "
                    f"derived data — delete the workspace directory "
                    f"({self.dir}) and re-run your search to re-index."
                )
        self._ranges_cache = (gen, ranges)
        return ranges

    # -- change detection --------------------------------------------------

    def analyze_document_states(self, file_paths: Sequence[str]) -> List[DocumentState]:
        existing = self.get_existing_docs(file_paths)
        states: List[DocumentState] = []
        for path in file_paths:
            try:
                st = os.stat(path)
            except OSError:
                continue  # missing files are skipped (store.rs:613-616)
            current = DocMeta(
                path=path,
                size_bytes=st.st_size,
                mtime=int(st.st_mtime),
                _version=CURRENT_EMBEDDING_VERSION,
            )
            prev = existing.get(path)
            if prev is None:
                states.append(
                    DocumentState.new(DocumentInfo(path, read_file_text(path), current))
                )
            elif (
                prev.size_bytes != current.size_bytes
                or prev.mtime != current.mtime
                or prev._version != CURRENT_EMBEDDING_VERSION
            ):
                states.append(
                    DocumentState.changed(DocumentInfo(
                        path, read_file_text(path), current,
                        prev_version=prev._version,
                    ))
                )
            else:
                states.append(DocumentState.unchanged(path))
        return states

    # -- search ------------------------------------------------------------

    def _subset_slots(self, subset_paths: Sequence[str]) -> List[Tuple[str, int, int]]:
        """(path, slot_start, n_lines) for stored docs in the subset.

        Paths are deduped first: the same path in different IN chunks would
        return duplicate ranges (duplicated results, and a subset query
        misclassified as full-store by the count heuristic).
        """
        subset_paths = list(dict.fromkeys(subset_paths))
        out: List[Tuple[str, int, int]] = []
        for i in range(0, len(subset_paths), 1000):
            chunk = list(subset_paths[i : i + 1000])
            q = ",".join("?" for _ in chunk)
            rows = self.db.execute(
                f"""SELECT path, slot_start, n_lines FROM docs
                    WHERE path IN ({q}) AND slot_start IS NOT NULL AND n_lines > 0""",
                chunk,
            ).fetchall()
            out.extend(rows)
        return out

    def search_line_embeddings(
        self,
        query_vec: np.ndarray,
        subset_paths: Sequence[str],
        top_k: int,
        max_distance: Optional[float] = None,
    ) -> List[RankedLine]:
        """Exact filtered scan. Workspace-mode semantics: a score threshold
        still truncates to top_k (store.rs:517,538-543).

        Delegates to the batched implementation with a batch of one —
        the tier ladder lives in ONE place (a review found the earlier
        single/batched copies already drifting)."""
        if not subset_paths or top_k == 0:
            return []
        per = self.search_line_embeddings_batched(
            np.asarray(query_vec, np.float32).reshape(1, -1),
            subset_paths, top_k, max_distance,
        )
        return per[0] if per else []

    def search_line_embeddings_batched(
        self,
        query_vecs: np.ndarray,
        subset_paths: Sequence[str],
        top_k: int,
        max_distance: Optional[float] = None,
    ) -> List[List[RankedLine]]:
        """Batched search: Q query rows against the same path subset. In the
        daemon, concurrent calls of the same shape coalesce into one scan
        (``store/coalesce.py``)."""
        from semtools_tpu_torch.store import coalesce

        if coalesce.enabled():
            return coalesce.search_batched(
                self, query_vecs, subset_paths, top_k, max_distance,
                self._search_batched_retry,
            )
        return self._search_batched_retry(query_vecs, subset_paths, top_k, max_distance)

    def _search_batched_retry(
        self,
        query_vecs: np.ndarray,
        subset_paths: Sequence[str],
        top_k: int,
        max_distance: Optional[float] = None,
    ) -> List[List[RankedLine]]:
        """Batched search with a stale-snapshot retry: if a concurrent
        compact() swaps the vector-file epoch between this query's layout
        read and its row access, the row gather can fault (file retired:
        FileNotFoundError; new epoch smaller than a stale slot: IndexError;
        mmap/file size disagreement: ValueError). All state is re-readable,
        so drop the snapshot and re-run once — the retry reads the
        post-compact state consistently."""
        try:
            return self._search_batched_impl(
                query_vecs, subset_paths, top_k, max_distance
            )
        except (FileNotFoundError, IndexError, ValueError):
            self._ranges_cache = None
            self._ann_disk_cache = None
            self._ann_meta_cache = None
            self._ann_cache = None
            self._refresh_vec_paths()
            return self._search_batched_impl(
                query_vecs, subset_paths, top_k, max_distance
            )

    def _search_batched_impl(
        self,
        query_vecs: np.ndarray,
        subset_paths: Sequence[str],
        top_k: int,
        max_distance: Optional[float] = None,
    ) -> List[List[RankedLine]]:
        """Q queries against the same path subset. Per-query results match
        the single-query method on every serving tier; threshold mode
        still truncates to ``top_k`` (store.rs:517,538-543).

        Routes: ``SEMTOOLS_TPU_SCAN=host`` -> the host scan of the mmap
        (it outranks every tier, the IVF-PQ one included); the whole store
        on the IVF-PQ tier with a current index -> the index; the whole
        store -> its slot corpus on the device; a path subset -> the same
        corpus under a keep mask when that pays (see
        :meth:`_search_subset_device`), else its rows gathered and scanned
        on the device (the compact path).
        """
        qs = np.asarray(query_vecs, np.float32)
        if qs.ndim == 1:
            qs = qs[None]
        qn = int(qs.shape[0])
        if not subset_paths or top_k == 0 or qn == 0:
            return [[] for _ in range(qn)]
        # Subset ranges are FILTERED from the cached full layout rather
        # than read in a separate db query: _valid_ranges_cached pairs
        # (generation, ranges, vector-file epoch) in one transaction, so
        # the slots gathered below always index the file they were
        # committed against.
        valid = self._valid_ranges_cached()
        wanted = set(subset_paths)
        ranges = [r for r in valid if r[0] in wanted]
        if not ranges:
            return [[] for _ in range(qn)]
        full_store = len(ranges) == len(valid)
        if full_store:
            ranges = valid
        n_rows = sum(n for _, _, n in ranges)

        if os.environ.get("SEMTOOLS_TPU_SCAN", "").lower() == "host":
            hits = self._search_host(ranges, qs, top_k, max_distance)
            if hits is not None:
                return hits

        if full_store and self._use_ann_tier(n_rows):
            state = self._ann_current()
            if state is not None:
                return self._search_ann_batched(state, qs, top_k, max_distance)

        if full_store:
            hits = self._search_slot_cached_batched(
                qs, top_k, max_distance, n_rows, self._serving_mesh(n_rows))
            if hits is not None:
                return hits
        else:
            hits = self._search_subset_device(qs, ranges, valid, top_k, max_distance)
            if hits is not None:
                return hits

        # compact path: gather the rows and scan them on the device
        mm = self._mmap("r")
        if mm is None:
            return [[] for _ in range(qn)]
        slot_blocks = [np.arange(s, s + n, dtype=np.int64) for _, s, n in ranges]
        corpus = torch.from_numpy(np.asarray(mm[np.concatenate(slot_blocks)])).to(self.device)
        del mm
        q_dev = torch.from_numpy(qs).to(self.device)

        if max_distance is not None:
            per = batched_threshold_scan(q_dev, corpus, float(max_distance))
            return [
                self._ranked_from_scan_rows(
                    ranges,
                    idxs[:top_k].cpu().numpy().astype(np.int64),
                    dists[:top_k].cpu().numpy(),
                )
                for dists, idxs in per
            ]
        d, i = topk_scan(q_dev, corpus, top_k)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        return [
            self._ranked_from_scan_rows(ranges, i[r].astype(np.int64), d[r])
            for r in range(qn)
        ]

    @staticmethod
    def _scan_rows_to_slots(ranges, rows: np.ndarray):
        """Map scan rows (positions in the range-concatenated corpus) to
        (range index, line-in-doc, slot) via cumulative line counts —
        O(candidates), never materializing an O(total_lines) owner array.
        ``ranges`` must be concatenated in the same order the corpus was
        gathered."""
        cum = np.cumsum([ln for _, _, ln in ranges])
        ris = np.searchsorted(cum, rows, side="right")
        starts = np.array([s for _, s, _ in ranges], dtype=np.int64)
        line_in_doc = rows - np.where(ris > 0, cum[ris - 1], 0)
        return ris, line_in_doc, starts[ris] + line_in_doc

    def _ranked_from_scan_rows(self, ranges, rows, dists) -> List[RankedLine]:
        ris, line_in_doc, _ = self._scan_rows_to_slots(ranges, rows)
        return [
            RankedLine(
                path=ranges[int(ri)][0],
                line_number=int(line),
                distance=float(dist),
            )
            for ri, line, dist in zip(ris, line_in_doc, dists)
        ]

    @staticmethod
    def _int8_oversample(top_k: int, reduced: bool, n: int) -> int:
        """INITIAL candidate count for the exact re-rank — a warm start,
        not a recall guarantee: the serving loop grows the pool until the
        margin-bounded top-k completion criterion proves no outside row
        can displace a served one (_search_slot_cached_batched). The
        reduced tier starts deep (corpus-size-scaled, see
        ops.reduce.reduced_oversample) because its projection error usually
        needs it; the full-dim int8 tier's ~1e-2 sim error rarely grows
        past 4*k."""
        if reduced:
            from semtools_tpu_torch.ops.reduce import reduced_oversample

            return reduced_oversample(n, top_k)
        return min(max(4 * top_k, 16), n)

    def _tier_bytes_per_row(self, kind: str, reduced_dim: Optional[int]) -> int:
        """Bytes/row the chosen device tier would upload for a cold build."""
        if kind == "int4":
            return self.dim // 2
        if kind == "int8":
            # +1: the reduced corpus carries a per-row residual-norm
            # column (the optimistic-bound augmentation, patch_cache).
            return (reduced_dim + 1) if reduced_dim else self.dim
        return self.dim * 4

    _HOST_SCAN_CHUNK = 1 << 18  # mmap rows scored per host step

    def _search_host(
        self,
        ranges,
        qs: np.ndarray,
        top_k: int,
        max_distance: Optional[float],
    ) -> Optional[List[List[RankedLine]]]:
        """Exact scoring straight off the mmap, chunked so a 10M-row
        corpus never materializes in RAM. Same semantics as the device
        tiers: top_k nearest per query (stable ties toward the lower
        corpus position), then the strict threshold filter."""
        mm = self._mmap("r")
        if mm is None:
            return None
        with stage("host_scan"):
            qn = qs.shape[0]
            need = min(top_k, sum(n for _, _, n in ranges))
            cand_d = [[] for _ in range(qn)]
            cand_r = [[] for _ in range(qn)]
            slot_blocks = [np.arange(s, s + n, dtype=np.int64) for _, s, n in ranges]
            slots = np.concatenate(slot_blocks)
            for start in range(0, len(slots), self._HOST_SCAN_CHUNK):
                block = slots[start : start + self._HOST_SCAN_CHUNK]
                rows = np.asarray(mm[block])
                # bound the [block, q_chunk] score matrix: a 1000-query
                # batch against a 256k-row block would otherwise spike ~1 GB
                for q0 in range(0, qn, 64):
                    d = 1.0 - rows @ qs[q0 : q0 + 64].T  # [block, <=64]
                    take = min(need, d.shape[0])
                    for rr in range(d.shape[1]):
                        r = q0 + rr
                        part = np.argpartition(d[:, rr], take - 1)[:take]
                        cand_d[r].append(d[part, rr])
                        cand_r[r].append(part + start)
            del mm
            out: List[List[RankedLine]] = []
            for r in range(qn):
                dd = np.concatenate(cand_d[r])
                rr = np.concatenate(cand_r[r])
                order = np.lexsort((rr, dd))[:top_k]
                dd, rr = dd[order], rr[order]
                if max_distance is not None:
                    keep = dd < max_distance
                    dd, rr = dd[keep], rr[keep]
                out.append(self._ranked_from_scan_rows(ranges, rr, dd))
            return out

    # -- path-subset device serving ---------------------------------------
    #
    # A path subset is served by the whole-store slot corpus under a
    # per-slot keep mask when that corpus is warm (or worth building): the
    # mask costs 1 byte/slot next to the 256-1024 B/slot the scan reads,
    # is uploaded once per (generation, subset) and cached. Masked slots
    # read as -inf similarity, so freed-slot crowding cannot occur and
    # results equal the compact gather path's (exact f32 re-rank on the
    # int8 tier). Ref contract: filtered search,
    # src/workspace/store.rs:481-546.

    def _search_subset_device(
        self, qs, subset_ranges, valid_ranges, top_k, max_distance
    ) -> Optional[List[List[RankedLine]]]:
        """Masked slot-corpus serving for an explicit path subset, or None
        when the compact path is the better call.

        Policy (SEMTOOLS_TPU_SUBSET_DEVICE=auto|1|0): serve masked when
        the whole-store corpus is already warm for the tier the store
        would pick; when cold, build it only if a SINGLE compact upload
        of the subset would already cost as much as the build (the build
        amortizes over every later query, full-store or subset).
        """
        from semtools_tpu_torch.store import patch_cache

        mode = os.environ.get("SEMTOOLS_TPU_SUBSET_DEVICE", "auto").lower()
        if mode in ("0", "off"):
            return None
        total_rows = sum(n for _, _, n in valid_ranges)
        if total_rows == 0:
            return None
        if self._use_ann_tier(total_rows):
            # ANN-scale store: no device tier fits the budget, so there
            # is no whole-store corpus to mask — the compact path serves.
            return None
        mesh = self._serving_mesh(total_rows)
        kind, rd = self._device_kind(total_rows)
        if mode not in ("1", "on") and not patch_cache.is_warm(self, kind, reduced_dim=rd, mesh=mesh):
            subset_rows = sum(n for _, _, n in subset_ranges)
            build_bytes = self._slot_rows(total_rows) * self._tier_bytes_per_row(kind, rd)
            if subset_rows * 4 * self.dim < build_bytes:
                return None
        return self._search_slot_cached_batched(
            qs, top_k, max_distance, total_rows, mesh, subset_ranges=subset_ranges,
        )

    def _subset_mask(self, sc, subset_ranges):
        """uint8 keep mask over the corpus rows (1 = slot in the subset),
        sharded like a sharded corpus, cached per (store, generation, subset
        digest, device, mesh, rows) — a repeated subset query re-uploads
        nothing."""
        import hashlib

        from semtools_tpu_torch.parallel.mesh import shard_rows
        from semtools_tpu_torch.store import device_cache, patch_cache

        digest = hashlib.sha1(
            "\0".join(sorted(p for p, _, _ in subset_ranges)).encode()
        ).hexdigest()
        n_dev = sc.mesh.size if sc.mesh is not None else 0
        key = (str(self.dir), "mask", sc.generation, digest, str(self.device), n_dev,
               sc.corpus.shape[0])

        def build():
            m = np.zeros(sc.capacity, np.uint8)
            for _, s, n in subset_ranges:
                m[s : s + n] = 1
            patch_cache._uploaded[0] += m.nbytes
            if sc.mesh is not None:
                return shard_rows(m, sc.mesh)
            return torch.from_numpy(m).to(self.device)

        return device_cache.get_or_put(key, build)

    @staticmethod
    def _range_owners(ranges):
        """(owners fn, slot-ordered paths) for a list of (path, start, n)
        ranges — same contract as ``SlotCorpus.slot_owners`` but over an
        arbitrary subset of the layout."""
        rs = sorted(ranges, key=lambda r: r[1])
        paths = [p for p, _, _ in rs]
        starts = np.array([s for _, s, _ in rs], np.int64)
        ends = np.array([s + n for _, s, n in rs], np.int64)

        def owners(slots):
            slots = np.asarray(slots, np.int64)
            ris = np.searchsorted(starts, slots, side="right") - 1
            ris_c = np.clip(ris, 0, max(len(starts) - 1, 0))
            valid = (
                (ris >= 0) & (slots < ends[ris_c]) & (slots >= starts[ris_c])
            )
            return valid, ris_c, slots - starts[ris_c]

        return owners, paths

    def _search_slot_cached_batched(
        self, query_vecs: np.ndarray, top_k: int,
        max_distance: Optional[float], n_rows: int, mesh=None, subset_ranges=None,
    ) -> Optional[List[List[RankedLine]]]:
        """Q query rows through the slot corpus of the tier the policy
        picks (row-sharded over ``mesh`` when given). Returns None (the
        caller takes the exact compact path, for every query) when any
        query's zero-slot slack is exhausted.

        ``n_rows`` is always the WHOLE store's live row count (it picks
        the tier the cached corpus was built as). With ``subset_ranges``
        the scan applies the subset's slot keep mask."""
        from semtools_tpu_torch.ops.int4_scan import int4_deep_candidates
        from semtools_tpu_torch.ops.int8_scan import int8_topk_scan, quantize_global
        from semtools_tpu_torch.parallel import scan as sharded
        from semtools_tpu_torch.store import patch_cache

        kind, reduced_dim = self._device_kind(n_rows)
        sc = patch_cache.get(self, kind, reduced_dim=reduced_dim, mesh=mesh)
        if sc is None:
            return None
        qs = np.asarray(query_vecs, np.float32)
        qn = int(qs.shape[0])
        # laid out as the corpus's rows (zero columns to the kernels' 16-byte rows)
        q_dev = torch.from_numpy(sc.query_rows(qs)).to(self.device)
        mask = None
        owners, paths = sc.slot_owners, sc.paths
        sel_rows = n_rows
        if subset_ranges is not None:
            mask = self._subset_mask(sc, subset_ranges)
            owners, paths = self._range_owners(subset_ranges)
            sel_rows = sum(n for _, _, n in subset_ranges)
        need = min(top_k, sel_rows)

        def _ranked_rows(slots, dists) -> List[RankedLine]:
            valid, ris, lines = owners(np.asarray(slots, np.int64))
            return [
                RankedLine(paths[int(r)], int(line), float(dv))
                for ok, r, line, dv in zip(valid, ris, lines, np.asarray(dists))
                # non-finite = masked filler from a top_k wider than the
                # selectable row count
                if ok and np.isfinite(dv)
            ]

        def _topk(k_scan, q_scan=q_dev):
            if mesh is not None:
                d, i = sharded.sharded_topk_scan_device(
                    q_scan, sc.corpus, sc.capacity, k_scan, mesh, mask=mask)
            else:
                d, i = topk_scan(q_scan, sc.corpus, k_scan, n_true=sc.capacity, mask=mask)
            return d.cpu().numpy(), i.cpu().numpy()

        if kind == "f32":
            if max_distance is not None:
                if mesh is not None:
                    per = sharded.sharded_batched_threshold_scan_device(
                        q_dev, sc.corpus, sc.capacity, float(max_distance), mesh, mask=mask)
                else:
                    per = batched_threshold_scan(
                        q_dev, sc.corpus, float(max_distance), n_true=sc.capacity,
                        mask=mask,
                    )
                return [
                    _ranked_rows(idxs.cpu().numpy(), dists.cpu().numpy())[:top_k]
                    for dists, idxs in per
                ]
            k_scan = min(top_k + patch_cache._SLACK, sc.capacity)
            d, i = _topk(k_scan)
            out = []
            for r in range(qn):
                rows = _ranked_rows(i[r], d[r])
                if len(rows) < need:
                    return None  # zero-slot slack exhausted: exact fallback
                out.append(rows[:top_k])
            return out

        if kind == "int4":
            # The packed tier serves through the margin-bounded deep
            # extraction: one corpus sweep yields every row within a noise
            # margin of each query's exact quantized k_cut-th best, sized to
            # the corpus's local density, so no growth loop is needed. Freed
            # slots (0x08 rows) score true sim 0 and enter the pool only below
            # the margin; the re-rank drops unowned slots and falls back to the
            # exact path if fewer than `need` real rows remain.
            with stage("tier_pool"):
                if mesh is not None:
                    ids = sharded.sharded_int4_deep_candidates_device(
                        q_dev, sc.corpus, sc.capacity, mesh, mask=mask, k_cut=max(need, 10))
                else:
                    ids = int4_deep_candidates(
                        q_dev, sc.corpus, n_true=sc.capacity, mask=mask, k_cut=max(need, 10),
                    )
                ids = ids.cpu().numpy()
            with stage("tier_rerank"):
                return self._rerank_candidates(
                    ids, qs, owners, paths, need, top_k, max_distance,
                )

        oversample = self._int8_oversample(top_k, reduced_dim is not None, sel_rows)

        q_r = q_aug = None
        if reduced_dim:
            # Optimistic-bound augmentation: the stored corpus is
            # [cap, rd+1] with each row's ceil-quantized residual norm in the
            # last column; scoring [q_r, q_perp * resid_scale / scale] with
            # the same matmul yields (after the global rescale)
            # q_r.x_r + q_perp*r_i, an UPPER bound on q.x for every row, so
            # 1 - it is a per-row lower bound on the exact distance (up to
            # the int8 rounding of the projection columns).
            q_r = qs @ sc.rotation
            q_perp = np.linalg.norm(qs - q_r @ sc.rotation.T, axis=1)
            aug = (q_perp * (float(sc.resid_scale or 0.0) / sc.scale)
                   if sc.scale else np.zeros(qn, np.float32))
            q_aug = torch.from_numpy(
                np.concatenate([q_r, aug[:, None]], axis=1).astype(np.float32)
            ).to(self.device)

        def _fused(k_now: int) -> bool:
            # The int8 kernels take CLI-scale batches (the JAX package's
            # routing limits); larger ones, the reduced corpus and a masked
            # query on a mesh (the sharded int8 scan takes no mask, as in the
            # JAX package) score the unscaled int corpus through the plain
            # scan (int8 rows widened, ranking unchanged).
            return (not reduced_dim and k_now <= 64 and qn <= 32
                    and (mask is None or mesh is None))

        def _candidates(k_sel: int):
            """([Q, k_sel] candidate slots, [Q, k_sel] TRUE-SCALE quantized
            distances ascending). The distances feed the completion
            criteria below."""
            if reduced_dim:
                d, i = _topk(k_sel, q_aug)
                dq = 1.0 - (1.0 - d) * (sc.scale or 0.0)
            elif _fused(k_sel):
                if mesh is not None:
                    d, i = sharded.sharded_int8_topk_scan_device(
                        q_dev, sc.corpus, sc.scale, k_sel, sc.capacity, mesh)
                else:
                    d, i = int8_topk_scan(
                        q_dev, sc.corpus, sc.scale, k_sel, n_true=sc.capacity, mask=mask,
                    )
                dq = d.cpu().numpy()  # already true-scale
                i = i.cpu().numpy()
            else:
                d, i = _topk(k_sel)
                dq = 1.0 - (1.0 - d) * (sc.scale or 0.0)
            return np.asarray(i, np.int64), dq

        def _threshold_margin() -> np.ndarray:
            """[Q] hard bound on |quantized - exact| distance per query.

            Corpus rounding error is <= scale/2 per element, so the sim
            error is <= 0.5*scale*||q||_1. The int8 kernels also quantize
            the query: + 0.5*q_scale*||e||_1, with true ||e||_1 bounded by
            the corpus's measured max int-L1 (+0.5/element rounding) when
            available — the sqrt(D) fallback assumes unit rows. Used ONLY
            to prove threshold-mode pool completeness — a pool whose worst
            member's quantized distance clears max_distance + margin
            provably contains every within-threshold row. On the reduced
            tier the scored value is already the optimistic bound, so only
            the projection columns' rounding remains.
            """
            if reduced_dim:
                return 0.5 * (sc.scale or 0.0) * np.abs(q_r).sum(1)
            m = 0.5 * (sc.scale or 0.0) * np.abs(qs).sum(axis=1)
            _, q_scale = quantize_global(qs)
            if sc.max_row_int_l1:
                e_l1 = (sc.scale or 0.0) * (
                    float(sc.max_row_int_l1) + 0.5 * self.dim
                )
            else:
                e_l1 = np.sqrt(self.dim)
            return m + 0.5 * q_scale * e_l1

        # Freed (zeroed) slots score a compressed similarity of exactly 0,
        # so on a fragmented store they can CROWD real rows with negative
        # compressed sims out of a fixed-size candidate window. Grow the
        # window until it holds the intended number of REAL candidates per
        # query. (Masked subset scans exclude freed slots by construction,
        # so their first pass always satisfies the target.)
        def _unique_valid(slots) -> int:
            """Count DISTINCT owned slots (filler entries from a pool wider
            than the kept rows are not owned, or repeat an owned slot in
            the JAX package's kernels)."""
            valid, _, _ = owners(slots)
            return len(np.unique(slots[valid]))

        def _topk_margin(k_now: int) -> np.ndarray:
            """[Q] bound (K sigmas, or hard) on |quantized - exact|
            distance per query, for TOP-K completion.

            The default 6-sigma margin is STATISTICAL, not hard: a
            corpus whose per-element rounding errors align with a query
            can beat it (probability ~1e-9 per comparison under the
            uniform-rounding model, but not zero). Set
            ``SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS=hard`` for the worst-case
            bound — 0.5*scale*||q||_1 corpus rounding, ~4-5x wider at
            D=256, which makes the completion certificate unconditional
            at the cost of deeper re-rank pools.

            Error sources: corpus int8 rounding (uniform +-scale/2 per
            element -> sigma = scale*||q||_2/sqrt(12)); and query-side
            rounding as a HARD term, only on the kernel path that
            actually quantizes the query (0.5*q_scale*||e||_1 with
            ||e||_1 bounded by the corpus's measured max int-L1). The
            reduced tier has no residual term: its scan scores the per-row
            optimistic bound, which covers the projection residual."""
            env = os.environ.get("SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", "6")
            hard_mode = env.strip().lower() == "hard"
            sigmas = 0.0 if hard_mode else float(env)
            q_eff = q_r if reduced_dim else qs
            sig_c = (sc.scale or 0.0) * np.linalg.norm(q_eff, axis=1) / np.sqrt(12.0)
            hard_q = 0.0
            if _fused(k_now):
                _, q_scale = quantize_global(qs)
                # true ||e||_1 <= scale * (int_l1 + 0.5*D) per row
                hard_q = 0.5 * q_scale * (sc.scale or 0.0) * (
                    float(sc.max_row_int_l1) + 0.5 * self.dim
                )
            if hard_mode:
                # Worst case: every element's rounding error aligns with
                # the query.
                hard_c = 0.5 * (sc.scale or 0.0) * np.abs(q_eff).sum(axis=1)
                return hard_c + hard_q + 1e-6
            # 1e-6: f32 arithmetic slack in the scan/re-rank dots
            return sigmas * sig_c + hard_q + 1e-6

        k_target = min(oversample, sel_rows)
        k_sel = min(oversample + patch_cache._SLACK, sc.capacity)
        t_margin = _threshold_margin() if max_distance is not None else None
        while True:
            with stage("tier_pool"):  # one pass of the pool's growth
                i, dq = _candidates(k_sel)
            min_valid = min(_unique_valid(i[r]) for r in range(qn))
            # Threshold-mode completion: every row OUTSIDE the pool has
            # quantized distance >= the pool's worst member; once that
            # worst clears max_distance + the tier's quantization-error
            # bound, no within-threshold row can exist outside the pool.
            # +inf worsts are masked fillers (the pool already holds every
            # selectable row); a NaN must NOT certify completion, it grows
            # to capacity and serves the full re-rank.
            complete = True
            if t_margin is not None and k_sel < sc.capacity and dq.shape[1]:
                worst = dq[:, -1]
                complete = bool(np.all(
                    np.isposinf(worst)
                    | (worst > float(max_distance) + t_margin)
                ))
            if (min_valid >= k_target and complete) or k_sel >= sc.capacity:
                with stage("tier_rerank"):
                    res = self._rerank_candidates(
                        i, qs, owners, paths, need, top_k, max_distance
                    )
                if res is None or k_sel >= sc.capacity:
                    return res
                if max_distance is not None:
                    return res  # threshold mode: t_margin already proved it
                # TOP-K completion: every row outside the pool scores a
                # quantized distance >= the pool's worst; once that worst
                # clears the served k-th EXACT distance by the tier's
                # error margin, no outside row can displace a served one
                # (up to the margin's confidence, see _topk_margin).
                # Growth re-runs the scan and re-rank for the whole batch.
                worst = dq[:, -1] if dq.shape[1] else np.full(qn, -np.inf)
                kth = np.array([
                    per[min(top_k, len(per)) - 1].distance if per else np.inf
                    for per in res
                ])
                if bool(np.all(
                    np.isposinf(worst) | (worst >= kth + _topk_margin(k_sel))
                )):
                    return res
            k_sel = min(
                max(2 * k_sel, k_sel + (k_target - min_valid) + patch_cache._SLACK),
                sc.capacity,
            )

    def _rerank_candidates(
        self, i: np.ndarray, qs: np.ndarray, owners, paths,
        need: int, top_k: int, max_distance: Optional[float],
    ) -> Optional[List[List[RankedLine]]]:
        """Exact f32 re-rank of per-query candidate slots [Q, C]: one mmap
        open + one gather of the UNION of candidate slots, then per-query
        scoring against the f32 originals. Returns None (exact-path
        fallback) when any query's valid candidates fall below ``need``.
        Shared by the int8/reduced oversample path and the int4 deep-
        candidate path."""
        qn = int(qs.shape[0])
        mm = self._mmap("r")
        if mm is None:
            return None
        uniq = np.unique(i.reshape(-1))
        # -inf filler from a masked top_k wider than the subset (and the
        # int4 extraction's sentinels) can carry indices in the padded
        # region past the mmap; they are invalid (no owner) and never
        # re-ranked, so drop them before the gather.
        uniq = uniq[uniq < mm.shape[0]]
        uniq_rows = np.asarray(mm[uniq])
        del mm
        out = []
        for r in range(qn):
            slots = i[r]
            valid, ris, lines = owners(slots)
            slots, ris, lines = slots[valid], ris[valid], lines[valid]
            # Drop duplicate candidates, keeping the first (best-ranked)
            # occurrence — see _unique_valid for why they exist.
            _, first = np.unique(slots, return_index=True)
            keep = np.zeros(len(slots), bool)
            keep[first] = True
            slots, ris, lines = slots[keep], ris[keep], lines[keep]
            if len(slots) < need:
                return None
            # Candidate order is tier-dependent (quantized rank for the
            # oversample path, UNORDERED for the int4 extraction); put
            # candidates in slot order first so the stable distance sort
            # breaks exact-distance ties toward the lower corpus position
            # — the exact tiers' contract (ops.scan ties -> lower index).
            by_slot = np.argsort(slots, kind="stable")
            slots, ris, lines = slots[by_slot], ris[by_slot], lines[by_slot]
            rows = uniq_rows[np.searchsorted(uniq, slots)]
            exact = 1.0 - rows @ qs[r]
            order = np.argsort(exact, kind="stable")[:top_k]
            if max_distance is not None:
                order = order[exact[order] < max_distance]
            out.append([
                RankedLine(paths[int(ris[o])], int(lines[o]), float(exact[o]))
                for o in order
            ])
        return out

    def load_subset_matrix(
        self, subset_paths: Sequence[str]
    ) -> Tuple[np.ndarray, List[str], np.ndarray]:
        """(rows [M, D] f32, each row's path, each row's line number) of the
        subset's documents, from the vector file (the JAX package's name,
        for tests and benchmarks that need the raw matrix)."""
        ranges = self._subset_slots(subset_paths)
        mm = self._mmap("r")
        if not ranges or mm is None:
            return np.zeros((0, self.dim), np.float32), [], np.zeros(0, np.int64)
        slots = np.concatenate([np.arange(s, s + n, dtype=np.int64) for _, s, n in ranges])
        corpus = np.asarray(mm[slots])
        paths = [path for path, _, n in ranges for _ in range(n)]
        lines = np.concatenate([np.arange(n, dtype=np.int64) for _, _, n in ranges])
        return corpus, paths, lines

    # -- deletes -----------------------------------------------------------

    def delete_line_embeddings(self, paths: Sequence[str]) -> None:
        with self._write_lock():
            for path in paths:
                row = self.db.execute(
                    "SELECT slot_start, n_lines FROM docs WHERE path = ?", (path,)
                ).fetchone()
                if row and row[0] is not None:
                    self._free_range(row[0], row[1])
                    self.db.execute(
                        "UPDATE docs SET slot_start = NULL, n_lines = NULL WHERE path = ?",
                        (path,),
                    )
            self._bump_generation()
            self.db.commit()
            self._drop_empty_rows()

    def delete_document_metadata(self, paths: Sequence[str]) -> None:
        with self._write_lock():
            for path in paths:
                self.db.execute(
                    """UPDATE docs SET size_bytes = NULL, mtime = NULL, version = NULL
                       WHERE path = ?""",
                    (path,),
                )
            self.db.commit()
            self._drop_empty_rows()

    def delete_documents(self, paths: Sequence[str]) -> None:
        with self._write_lock():
            self.delete_document_metadata(paths)
            self.delete_line_embeddings(paths)

    def _drop_empty_rows(self) -> None:
        self.db.execute(
            "DELETE FROM docs WHERE size_bytes IS NULL AND slot_start IS NULL"
        )
        self.db.commit()

    # -- compaction --------------------------------------------------------
    #
    # The free-range allocator reuses holes best-fit, but churn still leaves
    # slot space larger than the live row count, and every capacity-shaped
    # cost (device corpus, scan length, budget fit: see _slot_rows) is paid
    # on CAPACITY. ``workspace compact`` densifies it.

    def fragmentation(self) -> Tuple[int, int]:
        """(live rows, slot capacity). capacity > live means dead slots
        are inflating device memory and scan time."""
        return self.count_line_embeddings(), self._capacity()

    def _delete_epoch_files(self, keep_epoch: int) -> None:
        """Remove vector/hash files of every epoch except ``keep_epoch``:
        crash leftovers of an interrupted compact (new epoch written, swap
        never committed) and superseded epochs whose post-commit unlink was
        interrupted. Caller holds the write lock."""
        keep = set(self._epoch_paths(keep_epoch))
        for pat in (_VECTORS_FILE, _HASH_FILE, "lines.e*.f32", "lines.e*.h64"):
            for p in self.dir.glob(pat):
                if p not in keep:
                    try:
                        p.unlink()
                    except OSError:
                        pass

    def compact(self) -> Dict[str, object]:
        """Copy live blocks densely into the NEXT epoch of the vector file
        and hash sidecar, swap epochs in one sqlite transaction, and empty
        the free table; the JAX package's compaction, byte for byte.

        Crash-safe with the copy-on-write contract of
        :meth:`upsert_documents_bulk`: the new epoch's files are written and
        fsynced BEFORE the one commit that repoints slot_starts,
        'vec_epoch' and the generation, so a crash leaves the old state
        (the next compact deletes the orphan files) or the new one. Readers
        are never torn: a superseded epoch is immutable from the commit on
        (an open mmap keeps its snapshot after the unlink; a reader that
        loses the race retries through :meth:`_search_batched_retry`).
        A cached device corpus catches up by the patch's move path (the
        rows keep their content hashes).

        A FRESH IVF-PQ index survives: its rows' content is untouched
        (bytes move, values don't), so the meta's ``slots`` and
        ``lay_starts`` are remapped through the move map instead of forcing
        a rebuild. A stale index is left alone: after the moves its build
        layout matches nothing, so the drift bound retires it.

        Returns ``{"rows_live", "slots_before", "slots_reclaimed",
        "index_remapped"}``.
        """
        with self._write_lock():
            epoch = self._vec_epoch()
            self._delete_epoch_files(keep_epoch=epoch)
            gen_before = self.generation()
            ann_fresh = self._ann_generation_matches()
            layout = self._layout_with_rev()  # ascending slot order
            cap_before = self._capacity()
            total = sum(n for _, _, n, _ in layout)
            moves: List[Tuple[str, int, int, int]] = []  # path, old, new, n
            dest = 0
            for path, s, n, _ in layout:
                if s != dest:
                    moves.append((path, s, dest, n))
                dest += n
            report = {"rows_live": total, "slots_before": cap_before,
                      "slots_reclaimed": 0, "index_remapped": False}
            if not moves and cap_before == total:
                return report
            new_vec, new_hash = self._epoch_paths(epoch + 1)
            mm = self._mmap("r")
            hm = self._hash_mmap("r")

            def write_live(path, src) -> None:
                """The live blocks of ``src`` in slot order, fsynced."""
                with open(path, "wb") as f:
                    for _, s, n, _ in layout if src is not None else ():
                        for off in range(0, n, 1 << 16):
                            f.write(np.asarray(src[s + off : s + min(off + (1 << 16), n)]).tobytes())
                    f.flush()
                    os.fsync(f.fileno())

            write_live(new_vec, mm)
            if hm is not None:
                write_live(new_hash, hm)
            del mm, hm
            # make the new directory entries durable before the commit that
            # starts referencing them
            try:
                dfd = os.open(self.dir, os.O_RDONLY)
                os.fsync(dfd)
                os.close(dfd)
            except OSError:
                pass
            # The swap: one transaction, the crash-atomicity point. On any
            # failure roll back explicitly (close() commits pending work).
            try:
                for path, _, dst, _ in moves:
                    self.db.execute("UPDATE docs SET slot_start = ? WHERE path = ?", (dst, path))
                self.db.execute("DELETE FROM free")
                self.db.execute(
                    """INSERT INTO meta (key, value) VALUES ('vec_epoch', ?)
                       ON CONFLICT(key) DO UPDATE SET value = excluded.value""",
                    (str(epoch + 1),),
                )
                self._bump_generation()
                self.db.commit()
            except BaseException:
                self.db.rollback()
                raise
            self._refresh_vec_paths()
            if ann_fresh:
                report["index_remapped"] = self._ann_remap_after_compact(moves, gen_before)
            # retire the superseded epoch (safe for open reader mmaps)
            for p in self._epoch_paths(epoch):
                try:
                    p.unlink()
                except OSError:
                    pass
            self._ranges_cache = None
            self._ann_disk_cache = None
            self._ann_meta_cache = None
            self._ann_cache = None
            report["slots_reclaimed"] = cap_before - total
            return report

    def _ann_remap_after_compact(
        self, moves: List[Tuple[str, int, int, int]], gen_before: int
    ) -> bool:
        """Shift a fresh index's slot references through the compaction
        move map and stamp it with the post-compact generation; numpy over
        ``ann_meta.npz`` (the PQ codes are row content: untouched)."""
        _, meta_path = self._ann_paths()
        if not meta_path.exists():
            return False
        try:
            with np.load(meta_path, allow_pickle=False) as meta:
                m = {k: np.array(meta[k]) for k in meta.files}
        except Exception:
            return False
        if int(m.get("generation", -1)) != gen_before or "lay_paths" not in m:
            return False
        if moves:
            starts = np.array([s for _, s, _, _ in moves], np.int64)
            deltas = np.array([d - s for _, s, d, _ in moves], np.int64)
            lens = np.array([n for _, _, _, n in moves], np.int64)
            slots = m["slots"].astype(np.int64, copy=True)
            idx = np.searchsorted(starts, slots, side="right") - 1
            safe = idx.clip(min=0)
            in_range = (idx >= 0) & (slots < starts[safe] + lens[safe])
            m["slots"] = np.where(in_range, slots + deltas[safe], slots)
            shift = {p: d for p, _, d, _ in moves}
            m["lay_starts"] = np.array(
                [shift.get(str(p), int(s)) for p, s in zip(m["lay_paths"], m["lay_starts"])],
                np.int64,
            )
        m["generation"] = np.int64(self.generation())
        tmp = meta_path.with_suffix(".tmp.npz")
        np.savez(tmp, **m)
        tmp.replace(meta_path)
        return True

    # -- maintenance -------------------------------------------------------

    def flush(self) -> None:
        self.db.commit()

    def close(self) -> None:
        try:
            self.db.commit()
            self.db.close()
        except sqlite3.ProgrammingError:
            pass  # idempotent: already closed
        try:
            self._lock_fh.close()
        except Exception:
            pass

    def __enter__(self) -> "Store":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
