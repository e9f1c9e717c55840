"""The chip's peaks and the least time a scan's work needs.

Peaks are NVIDIA's published numbers for one H100 SXM at its full 700 W
power limit (dense, no sparsity). A card set below 700 W runs slower under
load, so a share of these peaks is given with the card's power limit beside
it.

The scan of one request (Q queries against N rows of D float32 values,
returning H hits) needs at least:

- bytes: the corpus N·D·4 and the queries Q·D·4 read once, and 12 bytes a
  returned hit (a float32 distance and an int64 row) written once;
- operations: 2·Q·N·D (a multiply and an add a value), at the float32 rate
  outside the tensor cores, since the configurations state float32.

The least time is the larger of bytes over the memory bandwidth and
operations over the float32 rate. It counts the work that the batch needs,
not the work that a kernel does, so it reads the same whatever implements
the scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12},
}
HIT_BYTES = 12


def peaks(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)


def scan_bytes(n: int, d: int, q: int, hits: int) -> int:
    return n * d * 4 + q * d * 4 + HIT_BYTES * hits


def scan_flops(n: int, d: int, q: int) -> int:
    return 2 * q * n * d


def least_seconds(n: int, d: int, q: int, hits: int, peak: dict) -> Tuple[float, str]:
    """(seconds, "bytes" or "flops"): the scan's least time and its bound."""
    by_bytes = scan_bytes(n, d, q, hits) / peak["bytes_per_s"]
    by_flops = scan_flops(n, d, q) / peak["f32_flop_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_flops else (by_flops, "flops")
