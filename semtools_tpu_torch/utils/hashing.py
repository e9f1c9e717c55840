"""Stable hashing utilities.

Deterministic ids make store upserts idempotent: re-adding the same
(path, line) pair overwrites rather than duplicates. The reference derives
point ids the same way (FNV-1a over path bytes, store.rs:650-661; id
derivations at store.rs:75-89).

A copy of ``semtools_tpu/utils/hashing.py``: document ids and line hashes
are part of the workspace's on-disk format, which both packages share.
"""

_FNV_OFFSET_BASIS = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_64(data: bytes) -> int:
    """64-bit FNV-1a hash of a byte string."""
    h = _FNV_OFFSET_BASIS
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def doc_id(path: str) -> int:
    """Deterministic id for a document path."""
    return fnv1a_64(path.encode("utf-8"))


def line_content_hash(text: str) -> int:
    """Nonzero 64-bit content hash of an (already case-folded) line.

    Keys the store's line-reuse sidecar (store.py ``lines.h64``); 0 is
    reserved for "unknown" so rows written without hashes never match.
    blake2b runs in C at >1 GB/s — the per-byte Python FNV above would
    dominate large updates.
    """
    import hashlib

    h = int.from_bytes(
        hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest(), "little"
    )
    return h or 1


def line_id(path: str, line_number: int) -> int:
    """Deterministic id for a (path, line) pair.

    Matches the layout used by the reference (path bytes followed by the
    0-based line number as a little-endian i32, store.rs:84-89).
    """
    data = path.encode("utf-8") + int(line_number).to_bytes(4, "little", signed=True)
    return fnv1a_64(data)
