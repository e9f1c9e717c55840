"""The int4 tile max over split-half nibbles: dims 0-127 in the low nibble
and 128-255 in the high, both sign-extended, uint8 [2M, 128], int8 queries
[8, 256], tile 2,048, rows past the corpus masked. (Not the shipped biased
format.)

Counterpart of ``benchmarks/quantitative/bench_int4_sweep.py``:

    python -m semtools_tpu_torch.probes.int4_sweep [--rows N] [--device cpu]

Kernel ``probe_tilemax`` (``ops/probes.py``, storage ``int4_u8``: the
nibbles biased to s8 bytes, int8 tensor cores; the JAX probe converts to
bf16). Prints ``max_tilemax_err`` (against an integer unpack and a float64
product) and then ``int4_sweep_vecs_per_ms``.
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
TILE = 2048


def data(n: int, gen: torch.Generator, device: torch.device):
    """(int8 queries [Q, 256], packed uint8 rows [n, 128]): seeded unit rows
    at 7 over their largest magnitude, packed by halves (``pack_int4``);
    the queries are the first Q rows at 127 over theirs."""
    x = common.unit_rows(n, gen, device, lambda x: x)
    scale = float(x.abs().max()) / 7.0
    e4 = probes.pack_split_half(torch.clamp(torch.round(x / scale), -7, 7), biased=False)
    q = x[:Q]
    q8 = torch.clamp(torch.round(q / (float(q.abs().max()) / 127.0)), -127, 127).to(torch.int8)
    return q8, e4.view(torch.uint8)


def oracle(q8: torch.Tensor, e4: torch.Tensor) -> torch.Tensor:
    """[T, Q] tile maxima from the JAX probe's own unpack ((b & 15) - ((b &
    8) << 1), and the same of b >> 4) and a float64 product."""
    b = e4.to(torch.int64)
    lo, hi = b & 0xF, b >> 4
    vals = torch.cat((lo - ((lo & 8) << 1), hi - ((hi & 8) << 1)), dim=1).double()
    sims = vals @ q8.double().T  # [n, Q]
    t = -(-e4.shape[0] // TILE)
    sims = torch.cat((sims, sims.new_full((t * TILE - e4.shape[0], Q), float("-inf"))))
    return sims.view(t, TILE, Q).amax(1)


def cases(q8: torch.Tensor, e4: torch.Tensor) -> List[common.Case]:
    n = e4.shape[0]
    kw = dict(tile=TILE, storage="int4_u8", masked=True)
    return [common.Case(
        "int4_sweep_vecs_per_ms", probes.VARIANTS[("int4_u8", "convert_bf16", "max")][1],
        lambda: probes.tilemax_probe(q8, e4, n, recipe="convert_bf16", **kw),
        lambda: probes.tilemax_probe_reference(q8, e4, n, **kw),
        n, e4.numel() + q8.numel() + -(-n // TILE) * Q * 4, 2.0 * Q * n * probes.DIM, "int8")]


def run(args) -> Tuple[List[dict], List[common.Case]]:
    device = common.device_of(args)
    q8, e4 = data(args.rows, common.generator(device), device)
    found = cases(q8, e4)
    tm = found[0].fn()[:, :, 0]
    found[0].oracle_err = float((tm.double() - oracle(q8, e4)).abs().max())
    common.measure(found, device)
    return [{"max_tilemax_err": found[0].oracle_err},
            {"int4_sweep_vecs_per_ms": common.per_ms(found[0].vectors, found[0].ms)}], found


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], N).parse_args(argv)
    lines, _ = run(args)
    print(common.card_line(common.device_of(args)))
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
