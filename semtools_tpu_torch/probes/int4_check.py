"""The int4 top-k scan held against a host oracle on the device it runs
on, then timed at the headline size.

Counterpart of ``scripts/probe_int4.py``:

    python -m semtools_tpu_torch.probes.int4_check [--rows N] [--device cpu]

Check: CHECK_ROWS (60,000; ``--rows`` when fewer) unit Gaussian rows from
numpy's generator (seed 0), packed by ``quantize_pack_global``; the first
four rows are the queries. ``int4_topk_scan``'s top 10 must equal a numpy ``lexsort((arange,
-sims))`` of the exact integer sims (int64 products of the int8 queries and
the unpacked rows), plain and with a 30% mask (its first ten rows kept,
masked-out rows at -inf). One JSON line each, ``"ok"`` true or false; a
mismatch also prints both index lists. Throughput: ``int4_two_phase`` at k
10 over ``--rows`` (default 10,002,432) random packed rows (seeded unit
rows at scale 0.35 / 7, made on the device in 4M-row chunks), Q 8 random
int8 queries, REPEATS back-to-back calls timed by CUDA events and the host
clock; on the CPU one call runs and no time is measured. Exit 1 when a
check fails.

The JAX probe also sweeps the TPU kernel's row tile (``tile_n`` 16,384 and
32,768). That sweep has no counterpart: the port's K5 reads fixed 128-row
sub-tiles, so there is no tile to choose.
"""

from __future__ import annotations

import json
import sys
from typing import List, Tuple

import numpy as np
import torch

from semtools_tpu_torch.ops.int4_scan import (
    int4_topk_scan,
    int4_two_phase,
    pack_int4,
    quantize_pack_global,
    unpack_int4,
)
from semtools_tpu_torch.ops.int8_scan import quantize_global
from semtools_tpu_torch.probes import common, int4_tier

DIM = 256
Q = int4_tier.Q_PERF
K = 10
REPEATS = 64
CHECK_ROWS = 60_000
N_INT4 = 8192 * 1221  # the int8 headline's 10M-row corpus
SCALE = 0.35 / 7.0
GEN_CHUNK = 8192 * 512


def check(n: int, device: torch.device) -> Tuple[List[dict], List[np.ndarray]]:
    """The two correctness records, ``int4_topk_scan`` plain and masked
    against the lexsort oracle on ``n`` rows, and the two [4, K] answers."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    p4, es = quantize_pack_global(x)
    q = x[:4]
    sims = quantize_global(q)[0].astype(np.int64) @ unpack_int4(p4).astype(np.int64).T
    mask = (rng.random(n) < 0.3).astype(np.int8)
    mask[:10] = 1
    p4_dev = torch.as_tensor(p4, device=device)
    records, answers = [], []
    for masked in (False, True):
        _, got = int4_topk_scan(q, p4_dev, es, K,
                                mask=torch.as_tensor(mask, device=device) if masked else None)
        got = got.cpu().numpy()
        answers.append(got)
        ok = True
        for r in range(len(q)):
            s = sims[r].astype(np.float64)
            if masked:
                s[mask == 0] = -np.inf
            want = np.lexsort((np.arange(n), -s))[:K]
            if got[r].tolist() != want.tolist():
                ok = False
                print(f"{'masked ' if masked else ''}mismatch q{r}: {got[r].tolist()} "
                      f"!= {want.tolist()}", flush=True)
        records.append({"probe": "int4_check", "rows": n, "masked": masked, "ok": ok})
    return records, answers


def packed_corpus(n: int, device: torch.device) -> torch.Tensor:
    """Random unit rows at SCALE, packed; chunk c from a generator seeded c."""
    p4 = torch.empty((n, DIM // 2), dtype=torch.int8, device=device)
    s = torch.tensor(SCALE, dtype=torch.float32, device=device)
    for c, start in enumerate(range(0, n, GEN_CHUNK)):
        m = min(GEN_CHUNK, n - start)
        x = torch.randn((m, DIM), generator=common.generator(device, c), device=device)
        p4[start : start + m] = pack_int4(torch.round(x / x.norm(dim=1, keepdim=True) / s)
                                          .clamp_(-7, 7))
    return p4


def throughput(n: int, device: torch.device) -> dict:
    p4 = packed_corpus(n, device)
    q8 = torch.as_tensor(np.random.default_rng(0).integers(-127, 128, (Q, DIM)),
                         dtype=torch.int8, device=device)
    record = int4_tier.throughput("int4_throughput", lambda: int4_two_phase(q8, p4, n, K), n, K,
                                  device, REPEATS)
    ms = record["events_ms_per_scan"]
    record["events_gbps"] = ms if ms == common.NOT_MEASURED else common.gbps(n * DIM // 2, ms)
    return record


def main(argv=None) -> int:
    args = common.parser(__doc__.splitlines()[0], N_INT4).parse_args(argv)
    device = common.device_of(args)
    print(common.card_line(device), flush=True)
    records = check(min(CHECK_ROWS, args.rows), device)[0] + [throughput(args.rows, device)]
    for r in records:
        print(json.dumps(r), flush=True)
    return 0 if all(r.get("ok", True) for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
