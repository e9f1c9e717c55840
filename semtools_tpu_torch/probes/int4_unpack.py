"""The int4 unpack-throughput probes: the maximum of every 512-row sub-tile
of q . e over 4,194,304 packed split-half rows, Q = 8, for each unpack
recipe and tile, then the biased floor recipe's full sims against the
integer oracle.

Counterpart of ``scripts/probe_int4_opt.py`` and ``scripts/probe_int4_opt2.py``
(throughput only: the ``mask`` placeholder is not equal to the packed values):

    python -m semtools_tpu_torch.probes.int4_unpack [--rows N] [--device cpu]

Recipes (storage formats of kernel ``probe_tilemax``, ``ops/probes.py``):
``shift`` and ``mask+sub(placeholder)`` (the ``& 15`` unpack, ``int4_and15``)
over the unbiased packing, ``native`` over an interleaved int4 array of N / 8
rows (on the TPU only compiled), ``floor`` (float unpack) and ``and15`` over
the biased one (low nibble lo + 8). Each unpacks, converts to bf16 and runs
on the bf16 tensor cores, but ``native``, whose nibbles go to the int8 tensor
cores as biased s8 bytes with no conversion (the same sims, exactly). The
floor scheme's full sims are one more call, over the first 8,192 rows of a
biased corpus, held against the integer oracle (``Case.oracle_err``).
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import torch

from semtools_tpu_torch.ops import probes
from semtools_tpu_torch.probes import common

N = 8192 * 512  # 4.2M rows
Q = 8
SUB = 512
SCALE = 0.35 / 7.0
CHECK_ROWS = 8192  # the floor scheme's full sims, checked against the oracle
# (name, storage, packing, tile): the two scripts' bench() calls in order
RUNS = (
    ("shift", "int4_shift", "unbiased", 8192),
    ("shift", "int4_shift", "unbiased", 16384),
    ("shift", "int4_shift", "unbiased", 32768),
    ("mask+sub(placeholder)", "int4_and15", "unbiased", 16384),
    ("native", "int4_native", "native", 8192),
    ("floor", "int4_floor", "biased", 16384),
    ("and15", "int4_and15", "biased", 16384),
    ("floor", "int4_floor", "biased", 32768),
    ("and15", "int4_and15", "biased", 32768),
)


def values(n: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Seeded unit rows quantized by 0.35 / 7, clipped to +-7 (int32)."""
    return common.unit_rows(n, gen, device, lambda x: torch.clamp(
        torch.round(x / SCALE), -7, 7).to(torch.int32))


def corpora(n: int, gen: torch.Generator, device: torch.device):
    qv = values(n, gen, device)
    native = torch.randint(-7, 8, (max(1, n // 8), probes.DIM), generator=gen, device=device)
    return {"unbiased": probes.pack_split_half(qv, biased=False),
            "biased": probes.pack_split_half(qv, biased=True),
            "native": probes.pack_interleaved(native)}


def queries(gen: torch.Generator, device: torch.device) -> torch.Tensor:
    return torch.randint(-127, 128, (Q, probes.DIM), generator=gen, device=device,
                         dtype=torch.int8)


def cases(q8: torch.Tensor, packed: dict) -> List[common.Case]:
    out = []
    for name, storage, packing, tile in RUNS:
        e = packed[packing]
        n = e.shape[0]
        kw = dict(tile=tile, storage=storage, sub_rows=SUB)
        t = -(-n // tile)
        out.append(common.Case(
            f"{name}_tile{tile}", probes.VARIANTS[(storage, "convert_bf16", "max")][1],
            lambda e=e, kw=kw: probes.tilemax_probe(q8, e, recipe="convert_bf16", **kw),
            lambda e=e, kw=kw: probes.tilemax_probe_reference(q8, e, **kw),
            n, e.numel() + q8.numel() + t * Q * (tile // SUB) * 4, 2.0 * Q * n * probes.DIM,
            "int8" if storage == "int4_native" else "bf16"))
    return out


def floor_case(qv: torch.Tensor, q8: torch.Tensor) -> common.Case:
    """The floor scheme's full sims (``sub_rows=1``: ``_kern_once``) of a
    biased corpus of the values ``qv``, one tile of CHECK_ROWS rows."""
    e = probes.pack_split_half(qv, biased=True)
    n = e.shape[0]
    kw = dict(tile=CHECK_ROWS, storage="int4_floor", sub_rows=1)
    counter = probes.VARIANTS[("int4_floor", "convert_bf16", "max")][1]
    return common.Case(
        f"floor_full_sims_tile{CHECK_ROWS}", counter,
        lambda: probes.tilemax_probe(q8, e, recipe="convert_bf16", **kw),
        lambda: probes.tilemax_probe_reference(q8, e, **kw),
        n, e.numel() + q8.numel() + Q * CHECK_ROWS * 4, 2.0 * Q * n * probes.DIM, "bf16")


def floor_oracle_err(case: common.Case, qv: torch.Tensor, q8: torch.Tensor) -> float:
    """Max |sims - oracle| of the floor case's call against the biased
    integer oracle ql . (lo + 8) + qh . hi."""
    sims = case.fn()[0, :, : qv.shape[0]].double()
    qd, vd = q8.double(), qv.double()
    expect = qd[:, : probes.HALF] @ (vd[:, : probes.HALF] + 8).T \
        + qd[:, probes.HALF:] @ vd[:, probes.HALF:].T
    return float((sims - expect).abs().max())


def run(args) -> Tuple[List[str], List[common.Case]]:
    device = common.device_of(args)
    gen = common.generator(device)
    found = cases(queries(gen, device), corpora(args.rows, gen, device))
    qv, q8 = values(min(args.rows, CHECK_ROWS), gen, device), queries(gen, device)
    check = floor_case(qv, q8)
    check.oracle_err = floor_oracle_err(check, qv, q8)
    found.append(check)
    common.measure(found, device)
    lines = []
    for (name, _, _, tile), c in zip(RUNS, found):
        rate = common.per_ms(c.vectors, c.ms)
        gb = common.gbps(c.vectors * probes.HALF, c.ms)
        lines.append(f"{name} tile={tile}: {rate / 1e6:.2f}M vecs/ms ({gb:.1f} GB/s)"
                     if c.ms is not None else f"{name} tile={tile}: {rate}")
    lines.append(f"floor-scheme max abs err vs biased int oracle: {check.oracle_err}")
    return lines, found


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], N).parse_args(argv)
    lines, _ = run(args)
    print(common.card_line(common.device_of(args)))
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
