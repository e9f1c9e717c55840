"""The phase-1 tile-max sweep over storage type, tile and recipe: each
query's max of q . e over every tile of a 2M x 256 corpus, Q = 8, rows past
the corpus masked to -inf.

Counterpart of ``benchmarks/quantitative/bench_kernel_variants.py``:

    python -m semtools_tpu_torch.probes.kernel_variants [--rows N] [--device cpu]

Prints one JSON line a case, ``{"dtype", "recipe", "tile", "vecs_per_ms"}``.
Recipes: bf16 ``plain`` and int8 ``convert_bf16`` on the bf16 tensor cores
(mma m16n8k16), int8 ``int_dot`` on the int8 tensor cores (mma m16n8k32);
kernel ``probe_tilemax`` (``ops/probes.py``).
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

import torch

from semtools_tpu_torch.ops import probes
from semtools_tpu_torch.probes import common

N = 1 << 21
Q = 8
CASES = (
    ("bf16", "plain", 2048),
    ("bf16", "plain", 4096),
    ("int8", "convert_bf16", 2048),
    ("int8", "convert_bf16", 4096),
    ("int8", "convert_bf16", 8192),
    ("int8", "int_dot", 8192),
)
BF16_TOL = 1e-5  # bf16 unit rows: the sum's order


def corpora(n: int, gen: torch.Generator, device: torch.device):
    """(bf16 rows, int8 rows): seeded unit rows, and the same scaled by 127
    over their largest magnitude."""
    base = common.unit_rows(n, gen, device, lambda x: x)
    e8 = torch.clamp(torch.round(base * (127.0 / base.abs().max())), -127, 127).to(torch.int8)
    return base.to(torch.bfloat16), e8


def cases(e16: torch.Tensor, e8: torch.Tensor) -> List[common.Case]:
    out = []
    n = e8.shape[0]
    for dtype, recipe, tile in CASES:
        e = e16 if dtype == "bf16" else e8
        q = e[:Q].clone()
        kw = dict(tile=tile, storage=dtype, masked=True)
        counter = probes.VARIANTS[(dtype, recipe, "max")][1]
        t = -(-n // tile)
        out.append(common.Case(
            f"{dtype}_{recipe}_tile{tile}", counter,
            lambda q=q, e=e, kw=kw, r=recipe: probes.tilemax_probe(q, e, n, recipe=r, **kw),
            lambda q=q, e=e, kw=kw: probes.tilemax_probe_reference(q, e, n, **kw),
            n, e.numel() * e.element_size() + q.numel() * q.element_size() + t * Q * 4,
            2.0 * Q * n * probes.DIM, "int8" if recipe == "int_dot" else "bf16",
            tol=BF16_TOL if dtype == "bf16" else 0.0))
    return out


def run(args) -> Tuple[List[dict], List[common.Case]]:
    device = common.device_of(args)
    found = cases(*corpora(args.rows, common.generator(device), device))
    common.measure(found, device)
    lines = [{"dtype": dtype, "recipe": recipe, "tile": tile,
              "vecs_per_ms": common.per_ms(c.vectors, c.ms)}
             for (dtype, recipe, tile), c in zip(CASES, found)]
    return lines, found


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], N).parse_args(argv)
    lines, _ = run(args)
    print(common.card_line(common.device_of(args)))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
