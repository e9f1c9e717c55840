"""The least time a workspace store's scan needs, by the tier that serves it.

The store scans its corpus in the form its tier keeps on the card
(``Store.serving_tier``), so the bytes a row depend on the tier's name, not
on the kernel that serves it (D the rows' width):

- ``exact-mxu-scan``: 4·D (float32 rows);
- ``int8-mxu-scan``: D (one int8 a value);
- ``int4-mxu-scan``: D/2 (two values a byte);
- ``int8-mxu-scan-reducedXd``: X+1 (the projected int8 row and its
  residual-norm column).

The exact tier's scan is the library's: ``roofline.least_seconds`` counts
it. A quantised tier's request of Q queries returning H hits over N live
rows needs at least the rows read once, the queries read once (Q·D·4,
float32) and 12 bytes a hit written once (``roofline.HIT_BYTES``), over
the memory bandwidth; or its 2·Q·N·w int8 operations (w the row's values)
over their tensor-core peak, where that is larger (Hopper has no int4 rate
of its own; the int4 rows are scored as int8). Other tiers (IVF-PQ, the
host scan, the sharded tiers) are not counted. The bandwidth is
``roofline.PEAKS``'s; the int8 rate is NVIDIA's published dense number for
one H100 SXM at its full 700 W power limit.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

from perfbench import roofline

INT8_OPS_PER_S = {"NVIDIA H100 80GB HBM3": 1979e12}
_REDUCED = re.compile(r"^int8-mxu-scan-reduced(\d+)d$")


def row_bytes(tier: Optional[str], dim: int) -> Optional[int]:
    """Bytes a row of the corpus ``tier`` scans; None for a tier not
    counted."""
    if tier == "exact-mxu-scan":
        return 4 * dim
    if tier == "int8-mxu-scan":
        return dim
    if tier == "int4-mxu-scan":
        return dim // 2
    m = _REDUCED.match(tier or "")
    return int(m.group(1)) + 1 if m else None


def least_seconds(tier: Optional[str], rows: int, dim: int, queries: int, hits: int,
                  device_name: str) -> Optional[Tuple[float, str]]:
    """(seconds, bound): the least time of one request's scan on ``tier``,
    bound by "bytes", by float32 "flops" (the exact tier) or by int8
    "ops"; None for a tier not counted or a card without published
    peaks."""
    peak = roofline.peaks(device_name)
    per_row = row_bytes(tier, dim)
    if peak is None or per_row is None or device_name not in INT8_OPS_PER_S:
        return None
    if tier == "exact-mxu-scan":
        return roofline.least_seconds(rows, dim, queries, hits, peak)
    m = _REDUCED.match(tier)
    values = int(m.group(1)) + 1 if m else dim
    n_bytes = rows * per_row + queries * dim * 4 + roofline.HIT_BYTES * hits
    by_bytes = n_bytes / peak["bytes_per_s"]
    by_ops = 2 * queries * rows * values / INT8_OPS_PER_S[device_name]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")
