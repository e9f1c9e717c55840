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
  writer lock.

The serving side runs on one torch device (:attr:`Store.device`, resolved
lazily: ``cuda`` unless ``cpu`` is asked for; ``workspace status`` never
touches it). Whole-store and path-subset queries are served from the
store's slot-space device corpus (``patch_cache``) on the tier the JAX
package's policy names (``serving_tier``): the exact f32 scan (fused
kernels ``csrc/fused_scan.cu``); the int8 tier (two-phase int8 kernels
``csrc/int8_scan.cu``, plain and masked) with an exact f32 re-rank in numpy
on the host, grown until the margin certificate proves the top-k complete;
or the int4 capacity rung (the deep-candidate sweep of
``csrc/int4_scan.cu``, plain and masked: every row within a noise margin of
each query's quantized ``k_cut``-th best) with the same re-rank.
Other path subsets gather their rows and scan them on the device (the
compact path). ``SEMTOOLS_TPU_SCAN=host`` scores on the host from the mmap;
``auto`` means the device (the JAX package's link-probe placement is not
ported). When the policy names a tier the port does not have yet (IVF-PQ,
reduced-dim, sharded), the store raises :class:`NotPortedError` rather than
serve another tier in its place.
"""

from __future__ import annotations

import os
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

CURRENT_EMBEDDING_VERSION = 2
LINE_EMBEDDING_SIZE = 256

_VECTORS_FILE = "lines.f32"
_HASH_FILE = "lines.h64"
_DB_FILE = "store.sqlite"


class NotPortedError(RuntimeError):
    """A serving tier or operation the JAX package has and the port does
    not have yet; raised rather than serving another tier in its place."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported yet (see ROADMAP.md)")


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


def _sharded_enabled(n_rows: int) -> bool:
    """Mesh-sharded serving: the port serves from one device, so never;
    ``SEMTOOLS_TPU_SHARDED=1`` asks for the sharded tier, which is not
    ported yet."""
    del n_rows
    if os.environ.get("SEMTOOLS_TPU_SHARDED") in ("1", "on"):
        raise NotPortedError("sharded serving (SEMTOOLS_TPU_SHARDED=1)")
    return False


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

    def _device_budget_bytes(self, n_rows: int) -> int:
        """The device cache's byte budget (one device: the JAX package's
        budget times its mesh size is this budget)."""
        from semtools_tpu_torch.store import device_cache

        del n_rows
        return device_cache._max_bytes()

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
        tier; the port does not serve these rungs yet.
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

    def _served_kind(self, n_rows: int) -> str:
        """'f32', 'int8' or 'int4', the whole-store device tier the policy
        picks; raises :class:`NotPortedError` for the tiers the port has not
        yet (IVF-PQ, sharded, reduced-dim int8)."""
        if self._use_ann_tier(n_rows):
            raise NotPortedError("the IVF-PQ serving tier")
        _sharded_enabled(n_rows)
        kind, rd = self._device_kind(n_rows)
        if rd:
            raise NotPortedError(f"the reduced-{rd}d int8 serving tier")
        return kind

    def serving_tier(self, n_rows: Optional[int] = None) -> str:
        """Name of the tier a whole-store query would use right now
        (``workspace status`` reports this); the JAX package's names."""
        if n_rows is None:
            n_rows = self.count_line_embeddings()
        if os.environ.get("SEMTOOLS_TPU_SCAN", "").lower() == "host":
            return "host-mmap-scan"
        kind = self._served_kind(n_rows)
        return "exact-mxu-scan" if kind == "f32" else f"{kind}-mxu-scan"

    def build_ann_index(self, force: bool = False, verbose: bool = False):
        """The IVF-PQ capacity tier: nothing to do while the corpus fits the
        device tiers (the JAX package returns None then too); a store that
        needs it raises :class:`NotPortedError`."""
        del verbose
        n = self.count_line_embeddings()
        if n == 0 or (not force and not self._use_ann_tier(n)):
            return None
        raise NotPortedError("the IVF-PQ serving tier (workspace index)")

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
        """Batched search: Q query rows against the same path subset.

        Retries once on a stale snapshot: if a concurrent compact() (by the
        JAX package) swaps the vector-file epoch between this query's
        layout read and its row access, the row gather can fault (file
        retired: FileNotFoundError; new epoch smaller than a stale slot:
        IndexError; mmap/file size disagreement: ValueError). All state is
        re-readable, so drop the snapshot and re-run once — the retry reads
        the post-compact state consistently."""
        try:
            return self._search_batched_impl(
                query_vecs, subset_paths, top_k, max_distance
            )
        except (FileNotFoundError, IndexError, ValueError):
            self._ranges_cache = None
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

        Routes: the whole store -> its slot corpus on the device; a path
        subset -> the same corpus under a keep mask when that pays (see
        :meth:`_search_subset_device`), else its rows gathered and scanned
        on the device (the compact path); ``SEMTOOLS_TPU_SCAN=host`` -> the
        host scan of the mmap.
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

        if full_store:
            hits = self._search_slot_cached_batched(qs, top_k, max_distance, n_rows)
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
    def _int8_oversample(top_k: int, n: int) -> int:
        """INITIAL candidate count for the exact re-rank — a warm start,
        not a recall guarantee: the serving loop grows the pool until the
        margin-bounded top-k completion criterion proves no outside row
        can displace a served one (_search_slot_cached_batched). The int8
        tier's ~1e-2 sim error rarely grows past 4*k."""
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
        from semtools_tpu_torch.utils.tracing import stage

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
        _sharded_enabled(total_rows)
        kind, rd = self._device_kind(total_rows)
        warm = not rd and kind in ("f32", "int8", "int4") and patch_cache.is_warm(
            self, kind, self.device
        )
        if mode not in ("1", "on") and not warm:
            subset_rows = sum(n for _, _, n in subset_ranges)
            build_bytes = self._slot_rows(total_rows) * self._tier_bytes_per_row(kind, rd)
            if subset_rows * 4 * self.dim < build_bytes:
                return None
        return self._search_slot_cached_batched(
            qs, top_k, max_distance, total_rows, subset_ranges=subset_ranges,
        )

    def _subset_mask(self, sc, subset_ranges) -> torch.Tensor:
        """[capacity] uint8 keep mask on the device (1 = slot in the
        subset), cached per (store, generation, subset digest, device) —
        a repeated subset query re-uploads nothing."""
        import hashlib

        from semtools_tpu_torch.store import device_cache, patch_cache

        digest = hashlib.sha1(
            "\0".join(sorted(p for p, _, _ in subset_ranges)).encode()
        ).hexdigest()
        key = (str(self.dir), "mask", sc.generation, digest, str(self.device), sc.capacity)

        def build():
            m = np.zeros(sc.capacity, np.uint8)
            for _, s, n in subset_ranges:
                m[s : s + n] = 1
            patch_cache._uploaded[0] += m.nbytes
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
        max_distance: Optional[float], n_rows: int, subset_ranges=None,
    ) -> Optional[List[List[RankedLine]]]:
        """Q query rows through the slot corpus of the tier the policy
        picks. Returns None (the caller takes the exact compact path, for
        every query) when any query's zero-slot slack is exhausted.

        ``n_rows`` is always the WHOLE store's live row count (it picks
        the tier the cached corpus was built as). With ``subset_ranges``
        the scan applies the subset's slot keep mask."""
        from semtools_tpu_torch.ops.int4_scan import int4_deep_candidates
        from semtools_tpu_torch.ops.int8_scan import int8_topk_scan, quantize_global
        from semtools_tpu_torch.store import patch_cache

        kind = self._served_kind(n_rows)
        sc = patch_cache.get(self, kind, self.device)
        if sc is None:
            return None
        qs = np.asarray(query_vecs, np.float32)
        qn = int(qs.shape[0])
        q_dev = torch.from_numpy(qs).to(self.device)
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

        def _topk(k_scan):
            d, i = topk_scan(q_dev, sc.corpus, k_scan, n_true=sc.capacity, mask=mask)
            return d.cpu().numpy(), i.cpu().numpy()

        if kind == "f32":
            if max_distance is not None:
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
            ids = int4_deep_candidates(
                q_dev, sc.corpus, n_true=sc.capacity, mask=mask, k_cut=max(need, 10),
            )
            return self._rerank_candidates(
                ids.cpu().numpy(), qs, owners, paths, need, top_k, max_distance,
            )

        oversample = self._int8_oversample(top_k, sel_rows)

        def _fused(k_now: int) -> bool:
            # The int8 kernels take CLI-scale batches (the JAX package's
            # routing limits); larger ones score the unscaled int corpus
            # through the plain scan (int8 rows widened, ranking unchanged).
            return k_now <= 64 and qn <= 32

        def _candidates(k_sel: int):
            """([Q, k_sel] candidate slots, [Q, k_sel] TRUE-SCALE quantized
            distances ascending). The distances feed the completion
            criteria below."""
            if _fused(k_sel):
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
            provably contains every within-threshold row.
            """
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
            ||e||_1 bounded by the corpus's measured max int-L1)."""
            env = os.environ.get("SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS", "6")
            hard_mode = env.strip().lower() == "hard"
            sigmas = 0.0 if hard_mode else float(env)
            sig_c = (sc.scale or 0.0) * np.linalg.norm(qs, axis=1) / np.sqrt(12.0)
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
                hard_c = 0.5 * (sc.scale or 0.0) * np.abs(qs).sum(axis=1)
                return hard_c + hard_q + 1e-6
            # 1e-6: f32 arithmetic slack in the scan/re-rank dots
            return sigmas * sig_c + hard_q + 1e-6

        k_target = min(oversample, sel_rows)
        k_sel = min(oversample + patch_cache._SLACK, sc.capacity)
        t_margin = _threshold_margin() if max_distance is not None else None
        while True:
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

    def fragmentation(self) -> Tuple[int, int]:
        """(live rows, slot capacity). capacity > live means dead slots
        are inflating device memory and scan time."""
        return self.count_line_embeddings(), self._capacity()

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
