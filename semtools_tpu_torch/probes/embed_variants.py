"""The device embed taken apart: gather, segment sum, the full f32 path,
the counts fused into the sum, a bf16 table, and the port's own
``embedding_bag`` path.

Counterpart of ``benchmarks/quantitative/bench_embed_variants.py``, at its
sizes (2^19 tokens over 2^15 lines, vocab 65,536, dim 256, segment ids
sorted, a trash segment past the last line):

    python -m semtools_tpu_torch.probes.embed_variants [--tokens N] [--lines N]
        [--device cpu] [--out PATH]

Each variant is plain torch on the card (none has a hand-written kernel):
``gather_only`` (``index_select`` of the rows), ``seg_only`` (the segment
sum of fixed ones rows, ``index_add_``), ``full_f32`` (gather, weights, the
sums and the counts as two segment sums, mean, norm), ``fused_counts`` (a
ones column carries the counts through one segment sum), ``full_bf16`` (the
full path from a bf16 table) and ``embedding_bag`` (``ops/embed.py``'s
recipe: ``F.embedding_bag(mode="sum")`` over offsets, counts, mean, norm).
The inputs are made by numpy from seed 1 (:func:`workload`). Times are the
least over 3 trials of CUDA events around 20 calls, per call; off the card
nothing is timed. Every variant's embeddings are held against
``full_f32``'s: within ``TOL`` in f32, within ``BF16_TOL`` from the bf16
table. One JSON object with the JAX driver's keys (``*_ms``,
``*_lines_per_s``, ``tokens``, ``lines``, ``gather_gbps_f32``); beside them
the card's name and power limit, the errors and the launches (none).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from semtools_tpu_torch.probes import common

DIM = 256
VOCAB = 1 << 16
TOKENS = 1 << 19
LINES = 1 << 15
TOL = 1e-5  # f32 variants against full_f32: the same sums in another order
# bf16 keeps 8 significant bits: each table entry moves by up to 2^-9 of
# itself, and on the unit rows out of the norm the measured error is ~6e-4;
# 1e-2 bounds it with room and still fails on a wrong row or line
BF16_TOL = 1e-2


def workload(tokens: int = TOKENS, lines: int = LINES, seed: int = 1):
    """(table [VOCAB, DIM] f32, token ids [T], sorted line ids [T] in
    [0, lines), weights [T] of ones), numpy."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((VOCAB, DIM)).astype(np.float32)
    ids = rng.integers(0, VOCAB, tokens).astype(np.int32)
    segs = np.sort(rng.integers(0, lines, tokens)).astype(np.int32)
    return table, ids, segs, np.ones(tokens, np.float32)


def _segment_sum(x: torch.Tensor, segs: torch.Tensor, lines: int) -> torch.Tensor:
    """Sum of ``x``'s rows per segment id, ``lines + 1`` segments (the last
    is the JAX driver's trash segment)."""
    out = torch.zeros((lines + 1, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, segs, x)


def _normalise(mean: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(mean, dim=-1, keepdim=True)
    return torch.where(norm > 0, mean / norm.clamp(min=1e-30), mean)


def gather_only(ids, tab, segs, w, lines):
    return tab.index_select(0, ids)


def seg_only(rows, segs, lines):
    return _segment_sum(rows, segs, lines)


def full_f32(ids, tab, segs, w, lines):
    rows = tab.index_select(0, ids).float() * w[:, None]
    sums = _segment_sum(rows, segs, lines)
    counts = _segment_sum(w, segs, lines)
    return _normalise(sums / counts.clamp(min=1.0)[:, None])


def fused_counts(ids, tab, segs, w, lines):
    rows = tab.index_select(0, ids) * w[:, None]
    both = _segment_sum(torch.cat([rows, w[:, None]], dim=1), segs, lines)
    return _normalise(both[:, :DIM] / both[:, DIM:].clamp(min=1.0))


full_bf16 = full_f32  # the same recipe, given the bf16 table (rows cast to f32)


def embedding_bag(ids, tab, offsets, counts):
    """``ops/embed.py``'s recipe over flat ids and per-line offsets."""
    sums = F.embedding_bag(ids, tab, offsets, mode="sum")
    return _normalise(sums / counts.clamp(min=1.0)[:, None])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--lines", type=int, default=LINES)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="the record as one JSON object")
    return ap


def run(args, device: torch.device) -> dict:
    from semtools_tpu_torch.ops import kernels

    lines = args.lines
    table, ids, segs, weights = workload(args.tokens, lines)
    tab = torch.from_numpy(table).to(device)
    tab_bf16 = tab.to(torch.bfloat16)
    t_ids = torch.from_numpy(ids).to(device).long()
    t_segs = torch.from_numpy(segs).to(device).long()
    w = torch.from_numpy(weights).to(device)
    fixed_rows = torch.ones((args.tokens, DIM), dtype=torch.float32, device=device)
    offsets = torch.from_numpy(np.searchsorted(segs, np.arange(lines))).to(device)
    line_counts = torch.from_numpy(np.bincount(segs, minlength=lines).astype(np.float32)).to(device)

    calls = {
        "gather_only": lambda: gather_only(t_ids, tab, t_segs, w, lines),
        "segment_sum_only": lambda: seg_only(fixed_rows, t_segs, lines),
        "full_f32": lambda: full_f32(t_ids, tab, t_segs, w, lines),
        "fused_counts": lambda: fused_counts(t_ids, tab, t_segs, w, lines),
        "full_bf16": lambda: full_bf16(t_ids, tab_bf16, t_segs, w, lines),
        "embedding_bag": lambda: embedding_bag(t_ids, tab, offsets, line_counts),
    }
    kernels.reset_launch_counts()
    out = {name: fn() for name, fn in calls.items()}
    ref = out["full_f32"]
    errors = {
        "gather_only": float((out["gather_only"] - tab[t_ids]).abs().max()),
        "segment_sum_only": float((out["segment_sum_only"][:lines] - line_counts[:, None]).abs().max()),
        "fused_counts": float((out["fused_counts"] - ref).abs().max()),
        "full_bf16": float((out["full_bf16"] - ref).abs().max()),
        "embedding_bag": float((out["embedding_bag"] - ref[:lines]).abs().max()),
    }
    for name, err in errors.items():
        limit = BF16_TOL if name == "full_bf16" else TOL
        if not err <= limit:
            raise AssertionError(f"{name}: max |err| {err} against full_f32 > {limit}")

    ms = {name: common.time_ms(fn, device) for name, fn in calls.items()}
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    results = {}
    for name in calls:
        results[f"{name}_ms"] = common.NOT_MEASURED if ms[name] is None else ms[name]
        if name not in ("gather_only", "segment_sum_only"):
            results[f"{name}_lines_per_s"] = (common.NOT_MEASURED if ms[name] is None
                                              else lines / (ms[name] * 1e-3))
    results["tokens"] = args.tokens
    results["lines"] = lines
    results["gather_gbps_f32"] = common.gbps(args.tokens * DIM * 4, ms["gather_only"])
    results.update(max_abs_err=errors, device=device.type, launches=launches)
    return results


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    results = run(args, device)
    results["card"] = card
    print(json.dumps(results), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
