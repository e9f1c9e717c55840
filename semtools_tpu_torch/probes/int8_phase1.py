"""The int8 scan's phase 1 taken apart: at 10,002,432 x 256 int8 rows,
tile 8,192, Q = 8, the full tile max (convert to bf16, dot, mask, max) and
the same without the mask, a bf16-convert column sum, a pure int8 stream,
an int8 direct dot and an f32 dot.

Counterpart of ``benchmarks/quantitative/bench_int8_phase1.py``:

    python -m semtools_tpu_torch.probes.int8_phase1 [--rows N] [--device cpu]

Kernel ``probe_tilemax`` (``ops/probes.py``): ``convert_bf16`` on the bf16
tensor cores, ``int_dot`` on the int8 tensor cores, ``f32_dot`` (the values
made f32, as the JAX probe casts them) on the TF32 tensor cores; the column
sums (first Q columns of each tile's sums; every column is summed) through
bf16 in f32, and in int32.
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

import torch

from semtools_tpu_torch.ops import probes
from semtools_tpu_torch.probes import common

TILE = 8192
NUM_TILES = 1221  # ~10M rows
N = TILE * NUM_TILES
Q = 8
SCALE = 0.35 / 127.0
# key -> (recipe, masked, reduce, unit): the JAX probe's bodies k_full,
# k_nomask, k_convsum, k_stream, k_i8dot, k_f32dot
BODIES = {
    "phase1_full_vecs_per_ms": ("convert_bf16", True, "max", "bf16"),
    "phase1_nomask_vecs_per_ms": ("convert_bf16", False, "max", "bf16"),
    "convert_sum_vecs_per_ms": ("convert_bf16", False, "sum", "f32"),
    "pure_stream_vecs_per_ms": ("plain", False, "sum", "f32"),
    "int8_direct_dot_vecs_per_ms": ("int_dot", False, "max", "int8"),
    "f32_convert_dot_vecs_per_ms": ("f32_dot", False, "max", "tf32"),
}


def corpus(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Seeded unit rows quantized by 0.35 / 127, clipped to +-127."""
    return common.unit_rows(n, gen, device,
                            lambda x: torch.clamp(torch.round(x / SCALE), -127, 127)
                            .to(torch.int8))


def cases(e8: torch.Tensor) -> List[common.Case]:
    n = e8.shape[0]
    q8 = e8[:Q].clone()
    t = -(-n // TILE)
    out = []
    for key, (recipe, masked, reduce, unit) in BODIES.items():
        kw = dict(tile=TILE, storage="int8", masked=masked, reduce=reduce)
        ops = float(n * probes.DIM) if reduce == "sum" else 2.0 * Q * n * probes.DIM
        library = None
        if recipe == "plain" and n % TILE == 0:  # k_stream: one torch.sum (every column)
            library = lambda: e8.view(t, TILE, probes.DIM).sum(1, dtype=torch.int32)
        out.append(common.Case(
            key, probes.VARIANTS[("int8", recipe, reduce)][1],
            lambda kw=kw, r=recipe: probes.tilemax_probe(q8, e8, n, recipe=r, **kw),
            lambda kw=kw: probes.tilemax_probe_reference(q8, e8, n, **kw),
            n, n * probes.DIM + Q * probes.DIM + t * Q * 4, ops, unit, library=library))
    return out


def run(args) -> Tuple[dict, List[common.Case]]:
    device = common.device_of(args)
    found = cases(corpus(args.rows, common.generator(device), device))
    common.measure(found, device)
    results = {c.key: common.per_ms(c.vectors, c.ms) for c in found}
    stream = next(c for c in found if c.key == "pure_stream_vecs_per_ms")
    results["pure_stream_gbps"] = common.gbps(stream.vectors * probes.DIM, stream.ms)
    return results, found


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], N).parse_args(argv)
    results, _ = run(args)
    print(common.card_line(common.device_of(args)))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
