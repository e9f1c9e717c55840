"""The int4 serving tier's calibration: the deep-candidate margin
(``int4_margin_sigmas``) and cap (``int4_candidate_cap``), K5's candidate
recall against its depth, and the int4 and int8 two-phase scans' time
against k, on a clustered corpus at the tier's sizes.

Counterpart of ``scripts/probe_int4_tier.py``:

    python -m semtools_tpu_torch.probes.int4_tier [--sizes N ...] [--out PATH]
    python -m semtools_tpu_torch.probes.int4_tier --device cpu --rows N

The corpus (the JAX probe's family): DIM 256, 512 centres, each row a
centre plus 0.15 Gaussian noise, unit-normalised, made on the device in
1M-row chunks, each chunk from a generator seeded with its own number, so
that any chunk is made again bit for bit. The int4 scale is ``max|chunk 0|
* 1.02 / 7`` (later chunks clip to +-7), packed by ``pack_int4`` and not
padded (the kernels take ``n_true``). 50 recall queries lie near chunk-0
rows (0.05 noise); K 10. The oracle is an exact f32 product (TF32 off, the
matmul precision "highest"), merged chunk by chunk by a stable sort (ties to
the lower row).

Sweeps, one JSON record a line with the JAX probe's keys:
``int4_deep_recall`` (``int4_deep_candidates`` at 4 and 6 sigmas, 8
queries a call: recall@10 of the candidate sets, which the store's exact
re-rank makes the served recall; median and largest candidate count; the
last call's width ``cap``), ``int4_candidate_recall`` (``int4_topk_scan``
at depths 40-1024, up to the first at recall 1.0), ``int4_throughput``
(``int4_two_phase``, Q 8, k 10/64/128/256) and ``int8_ref_throughput``
(``int8_two_phase``, k 40, on a random int8 corpus of the same size). To
them each adds CUDA-events milliseconds beside the host wall (both over
the same calls, each ended by a synchronise), and the deep sweep the policy
cap and the number of queries whose candidates reach it (past the cap the
extraction's rule keeps the cap's best-ranked rows). The throughput rows
time REPEATS back-to-back calls. On the CPU the plain versions run and no
time is measured. The records also go to ``--out`` as one JSON list.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from semtools_tpu_torch.ops.int4_scan import (
    int4_candidate_cap,
    int4_deep_candidates,
    int4_topk_scan,
    int4_two_phase,
    pack_int4,
)
from semtools_tpu_torch.ops.int8_scan import int8_two_phase
from semtools_tpu_torch.probes import common

DIM = 256
Q_RECALL = 50
Q_PERF = 8
K = 10
N_CLUSTERS = 512
CHUNK = 1 << 20  # rows made per step: bounds the f32 temporaries (1 GB)
SIZES = (1 << 21, 8192 * 1221)
SIGMAS = (4.0, 6.0)
DEPTHS = (40, 64, 128, 256, 512, 1024)
PERF_KS = (10, 64, 128, 256)
INT8_K = 40
REPEATS = 32
BATCH = 8  # queries a deep-sweep or recall call
# generator seeds: the centres, the queries, chunk c of the clustered corpus
# and chunk c of the int8 reference corpus
CENTRES_SEED, QUERY_SEED, CHUNK_SEED, INT8_SEED = 0, 7, 1000, 2000
INT8_SCALE = 0.35 / 127.0
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "probe_int4_tier.json"


class Corpus(NamedTuple):
    p4: torch.Tensor  # [n, DIM / 2] packed int8
    scale: float
    qs: torch.Tensor  # [Q_RECALL, DIM] f32 unit queries
    oracle: np.ndarray  # [Q_RECALL, K] int64 exact f32 top-K rows


def centres_of(device: torch.device) -> torch.Tensor:
    return torch.randn((N_CLUSTERS, DIM), generator=common.generator(device, CENTRES_SEED),
                       device=device)


def gen_chunk(centres: torch.Tensor, c: int, n: int) -> torch.Tensor:
    """Rows [c * CHUNK, c * CHUNK + n) of the clustered corpus, unit-norm f32."""
    g = common.generator(centres.device, CHUNK_SEED + c)
    assign = torch.randint(0, N_CLUSTERS, (n,), generator=g, device=centres.device)
    x = centres[assign] + 0.15 * torch.randn((n, DIM), generator=g, device=centres.device)
    return x / x.norm(dim=1, keepdim=True)


def pack_chunk(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``rint(x / scale)`` clipped to +-7 and packed: the f32 division by the
    scale's f32 rounding as a tensor operand (elementwise IEEE division, as
    the JAX probe's; a host scalar may become a reciprocal multiply)."""
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return pack_int4(torch.round(x / s).clamp_(-7, 7))


def _exact_f32() -> None:
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the oracle needs exact f32 products: TF32 is on")


def _merge_top(best_v, best_i, sims, base: int):
    """The K best of (best, a chunk's sims) by (value desc, row asc)."""
    rows = torch.arange(base, base + sims.shape[1], device=sims.device).expand(sims.shape[0], -1)
    v, pos = torch.sort(torch.cat([best_v, sims], 1), dim=1, descending=True, stable=True)
    return v[:, :K], torch.cat([best_i, rows], 1).gather(1, pos[:, :K])


def build(n_rows: int, device: torch.device) -> Corpus:
    """The packed corpus, its scale, the recall queries and the exact oracle:
    each chunk made once, packed and scored against the queries."""
    _exact_f32()
    centres = centres_of(device)
    c0 = gen_chunk(centres, 0, min(CHUNK, n_rows))
    scale = float(c0.abs().max()) * 1.02 / 7.0
    g = common.generator(device, QUERY_SEED)
    ids = torch.randint(0, c0.shape[0], (Q_RECALL,), generator=g, device=device)
    qs = c0[ids] + 0.05 * torch.randn((Q_RECALL, DIM), generator=g, device=device)
    qs = qs / qs.norm(dim=1, keepdim=True)
    p4 = torch.empty((n_rows, DIM // 2), dtype=torch.int8, device=device)
    best_v = torch.full((Q_RECALL, K), float("-inf"), device=device)
    best_i = torch.zeros((Q_RECALL, K), dtype=torch.int64, device=device)
    for c, start in enumerate(range(0, n_rows, CHUNK)):
        x = c0 if c == 0 else gen_chunk(centres, c, min(CHUNK, n_rows - start))
        p4[start : start + x.shape[0]] = pack_chunk(x, scale)
        best_v, best_i = _merge_top(best_v, best_i, qs @ x.T, start)
    return Corpus(p4, scale, qs, best_i.cpu().numpy())


def _emit(row: dict, out: list) -> None:
    print(json.dumps(row), flush=True)
    out.append(row)


def deep_sweep(p4, qs, oracle, n_rows: int, out: list) -> Dict[float, List[torch.Tensor]]:
    """The serving design's recall and candidate volume: the margin-cutoff
    deep candidates, whose exact re-rank keeps every oracle row they hold.
    Returns each sigma's [BATCH, cap] candidate rows, call by call."""
    policy_cap = int4_candidate_cap(n_rows)
    kept = {}
    for sig in SIGMAS:
        hit, counts, walls, events, calls = 0, [], [], [], []
        for s in range(0, Q_RECALL, BATCH):
            ids, wall, ev = common.timed(lambda: int4_deep_candidates(
                qs[s : min(s + BATCH, Q_RECALL)], p4, n_true=n_rows, margin_sigmas=sig),
                p4.device)
            calls.append(ids)
            walls.append(wall)
            events.append(ev)
            for r, row in enumerate(ids.cpu().numpy()):
                cand = np.unique(row[row < n_rows])
                counts.append(cand.size)
                hit += int(np.isin(oracle[s + r], cand).sum())
        kept[sig] = calls
        _emit({"probe": "int4_deep_recall", "n": n_rows, "margin_sigmas": sig,
               "recall_at_10": round(hit / (Q_RECALL * K), 4),
               "median_candidates": int(np.median(counts)),
               "max_candidates": int(np.max(counts)),
               "cap": int(ids.shape[1]),
               "warm_batch8_ms": common.least(walls), "warm_batch8_events_ms": common.least(events),
               "policy_cap": policy_cap,
               "queries_at_cap": sum(c >= policy_cap for c in counts)}, out)
    return kept


def query_hits(got: np.ndarray, oracle: np.ndarray) -> List[int]:
    """Each query's count of its K oracle rows among its ``got`` rows."""
    return [int(np.isin(o, g).sum()) for g, o in zip(got, oracle)]


def recall_sweep(p4, scale: float, qs, oracle, n_rows: int, out: list) -> Dict[int, torch.Tensor]:
    """K5's candidate recall against its depth (its k), up to the first depth
    at recall 1.0. Returns each depth's [Q_RECALL, depth] rows."""
    kept = {}
    for depth in DEPTHS:
        if depth > n_rows:
            break
        idx = torch.cat([int4_topk_scan(qs[s : min(s + BATCH, Q_RECALL)], p4, scale, depth,
                                        n_true=n_rows)[1] for s in range(0, Q_RECALL, BATCH)])
        kept[depth] = idx
        rec = sum(query_hits(idx.cpu().numpy(), oracle)) / (Q_RECALL * K)
        _emit({"probe": "int4_candidate_recall", "n": n_rows, "depth": depth,
               "recall_at_10": round(rec, 4)}, out)
        if rec == 1.0:
            break
    return kept


def perf_queries(device: torch.device) -> torch.Tensor:
    """The throughput rows' int8 queries (numpy's generator, seed 0)."""
    q = np.random.default_rng(0).integers(-127, 127, (Q_PERF, DIM), np.int64)
    return torch.as_tensor(q, dtype=torch.int8, device=device)


def throughput(probe: str, fn, n_rows: int, k: int, device, reps: int = REPEATS) -> dict:
    """A throughput record of ``fn``, one scan of ``n_rows`` rows at ``k``
    for Q_PERF queries: warmed once, then ``reps`` back-to-back calls."""
    fn()  # warm: the kernel library's load and first launch
    _, wall, ev = common.timed(fn, device, reps)
    return {"probe": probe, "n": n_rows, "k": k, "q": Q_PERF,
            "vecs_per_ms": common.per_ms(n_rows, wall), "ms_per_scan": common.least([wall]),
            "events_vecs_per_ms": common.per_ms(n_rows, ev),
            "events_ms_per_scan": common.least([ev])}


def perf_sweep(p4, n_rows: int, out: list) -> None:
    """K5's two-phase time against k (the depth the recall sweep needs)."""
    q8 = perf_queries(p4.device)
    for k in PERF_KS:
        if k > n_rows:
            break
        _emit(throughput("int4_throughput", lambda: int4_two_phase(q8, p4, n_rows, k), n_rows,
                         k, p4.device), out)


def int8_corpus(n_rows: int, device: torch.device) -> torch.Tensor:
    """Random unit rows at ``INT8_SCALE``, int8, chunk c from seed INT8_SEED + c."""
    e8 = torch.empty((n_rows, DIM), dtype=torch.int8, device=device)
    s = torch.tensor(INT8_SCALE, dtype=torch.float32, device=device)
    for c, start in enumerate(range(0, n_rows, CHUNK)):
        n = min(CHUNK, n_rows - start)
        x = torch.randn((n, DIM), generator=common.generator(device, INT8_SEED + c), device=device)
        e8[start : start + n] = torch.round(x / x.norm(dim=1, keepdim=True) / s).clamp_(-127, 127)
    return e8


def int8_ref(n_rows: int, device: torch.device, out: list) -> None:
    """The int8 tier's two-phase time at the same size (the int8 -> int4
    crossover's other side), its queries the corpus' first rows."""
    e8 = int8_corpus(n_rows, device)
    q8 = e8[:Q_PERF].contiguous()
    _emit(throughput("int8_ref_throughput", lambda: int8_two_phase(q8, e8, n_rows, INT8_K),
                     n_rows, INT8_K, device), out)


def run(sizes, device: torch.device) -> List[dict]:
    out: List[dict] = []
    for n_rows in sizes:
        t0 = time.perf_counter()
        corpus = build(n_rows, device)
        print(f"# built n={n_rows} in {time.perf_counter() - t0:.1f}s", flush=True)
        deep_sweep(corpus.p4, corpus.qs, corpus.oracle, n_rows, out)
        recall_sweep(corpus.p4, corpus.scale, corpus.qs, corpus.oracle, n_rows, out)
        perf_sweep(corpus.p4, n_rows, out)
        del corpus
        int8_ref(n_rows, device, out)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--rows", type=int, default=None, help="one corpus size (else --sizes)")
    p.add_argument("--sizes", type=int, nargs="*", default=list(SIZES),
                   help=f"corpus rows, one run each (default {' '.join(map(str, SIZES))})")
    p.add_argument("--out", default=str(DEFAULT_OUT), help="the records as one JSON list")
    args = p.parse_args(argv)
    device = common.device_of(args)
    print(common.card_line(device), flush=True)
    out = run([args.rows] if args.rows else args.sizes, device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"# wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
