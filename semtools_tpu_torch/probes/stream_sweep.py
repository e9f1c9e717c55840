"""The card's streaming roof: column sums of a ~10M x 256 int8 corpus
(2.56 GB) by kernels that only stream, over tile sizes and ring depths.

Counterpart of ``benchmarks/quantitative/bench_stream_sweep.py``:

    python -m semtools_tpu_torch.probes.stream_sweep [--rows N] [--device cpu]

``auto_tile{T}_gbps`` is kernel ``stream_tiles`` (one block per T-row
tile); ``manual_t{R}_b{S}_gbps`` is kernel ``stream_ring`` (S stages of R
rows in shared memory, filled by cp.async; the TPU's stages of 2,048-16,384
rows do not fit a block's 227 KB, so R and S are this card's own);
``torch_sum_gbps`` is one ``torch.sum(e, 0, dtype=torch.int32)``, and
``stream_roof_gbps`` the best of them all. GB/s counts the rows each call
reads (rows past the last whole tile or stage are not read).
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

import torch

from semtools_tpu_torch.ops import probes
from semtools_tpu_torch.probes import common

N = 8192 * 1221  # ~10M rows
TILES = (2048, 4096, 8192, 16384, 24576)
# (stage rows, stages): the TPU sweep's (tile, buffers) points with the
# stage cut 64-fold to fit shared memory
RINGS = ((64, 2), (64, 4), (128, 2), (128, 3), (256, 2), (32, 4), (32, 8))
SALT = 7


def corpus(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """The probe's int8 corpus: rint(80 x) of Gaussian x, clipped to +-127."""
    parts = []
    for start in range(0, n, 1 << 20):
        x = torch.randn((min(1 << 20, n - start), probes.DIM), generator=gen, device=device)
        parts.append(torch.clamp(torch.round(x * 80), -127, 127).to(torch.int8))
    return torch.cat(parts)


def cases(e: torch.Tensor) -> List[common.Case]:
    out = []
    n = e.shape[0]
    for tile in TILES:
        t = n // tile
        if t == 0:
            continue
        rows = t * tile
        out.append(common.Case(
            f"auto_tile{tile}_gbps", "stream_tiles",
            lambda tile=tile: probes.stream_tiles(e, tile, SALT),
            lambda tile=tile: probes.stream_tiles_reference(e, tile, SALT),
            rows, rows * probes.DIM + t * probes.DIM * 4, float(rows * probes.DIM), "f32",
            library=lambda tile=tile, t=t: e[: t * tile].view(t, tile, probes.DIM)
            .sum(1, dtype=torch.int32)))
    for stage_rows, stages in RINGS:
        rows = n // stage_rows * stage_rows
        if rows == 0:
            continue
        out.append(common.Case(
            f"manual_t{stage_rows}_b{stages}_gbps", "stream_ring",
            lambda r=stage_rows, s=stages: probes.stream_ring(e, SALT, stage_rows=r, stages=s),
            lambda rows=rows: probes.stream_ring_reference(e, SALT, rows),
            rows, rows * probes.DIM + probes.DIM * 4, float(rows * probes.DIM), "f32",
            library=lambda rows=rows: e[:rows].sum(0, dtype=torch.int32)))
    return out


def run(args) -> Tuple[dict, List[common.Case]]:
    device = common.device_of(args)
    e = corpus(args.rows, common.generator(device), device)
    found = cases(e)
    common.measure(found, device)
    results = {c.key: common.gbps(c.vectors * probes.DIM, c.ms) for c in found}
    torch_ms = common.time_ms(lambda: e.sum(0, dtype=torch.int32), device)
    results["torch_sum_gbps"] = common.gbps(e.numel(), torch_ms)
    rates = [v for v in results.values() if not isinstance(v, str)]
    results["stream_roof_gbps"] = max(rates) if rates else common.NOT_MEASURED
    return results, found


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], N).parse_args(argv)
    results, _ = run(args)
    print(common.card_line(common.device_of(args)))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
