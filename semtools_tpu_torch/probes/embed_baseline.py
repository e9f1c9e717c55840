"""The reference's CPU encode, the denominator of BASELINE's embed target,
beside the port's embed on the card.

Counterpart of ``benchmarks/quantitative/bench_embed_baseline.py``. The
reference encodes (model2vec's CPU path) by an embedding-table row gather, a
mean per line and an L2 normalisation, after host tokenization (the same in
both systems, so it is left out: the token ids are given). The workload is
the JAX driver's: 2^19 tokens over 2^15 lines, vocab 65,536, dim 256, from
``_workload(seed=1)``:

    python -m semtools_tpu_torch.probes.embed_baseline [--tokens N] [--lines N]
        [--device cpu] [--out PATH]

- ``numpy-reduceat`` and ``torch-embedding-bag``: the reference's encode on
  the CPU. They run on the CPU by definition (they are the baseline, not a
  fallback), with the threads torch grants.
- ``port-embed``: the port's own embed (``ops/embed.embed_token_lists``,
  the path ``StaticModel.encode`` takes after tokenizing: the ragged id
  lists flattened on the host, then ``embedding_bag`` sums, the mean and
  the norm on the device) over the same ids, on the card unless ``--device
  cpu``; ``vs_numpy`` and ``vs_torch`` are its rate over theirs.

The three outputs must agree within ``TOL`` (``max_abs_err`` against the
numpy rows). One JSON record a line (``config`` embed_cpu_baseline, the JAX
driver's keys); beside them the card's name and power limit and the port
row's kernel launches (none: the embed has no hand-written kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from semtools_tpu_torch.probes import common

VOCAB = 1 << 16
DIM = 256
TOKENS = 1 << 19
LINES = 1 << 15
REPEATS = 5
TOL = 1e-5  # f32 against f32, the sums in another order


def _workload(seed=1, tokens=TOKENS, lines=LINES):
    """The JAX driver's table, token ids and sorted line ids, call for call."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((VOCAB, DIM)).astype(np.float32)
    ids = rng.integers(0, VOCAB, tokens).astype(np.int64)
    segs = np.sort(rng.integers(0, lines, tokens)).astype(np.int64)
    return table, ids, segs


def encode_numpy(table, ids, segs, lines: int) -> np.ndarray:
    """Gather, ``np.add.reduceat`` per line, mean, normalise (a line with no
    token: reduceat repeats its neighbour's row, as the JAX driver's does;
    such lines are excluded from the comparison)."""
    boundaries = np.searchsorted(segs, np.arange(lines))
    counts = np.bincount(segs, minlength=lines).astype(np.float32)
    rows = table[ids]
    sums = np.add.reduceat(rows, boundaries, axis=0)
    mean = sums / np.maximum(counts, 1.0)[:, None]
    norms = np.linalg.norm(mean, axis=1, keepdims=True)
    return np.where(norms > 0, mean / np.maximum(norms, 1e-30), mean)


def encode_torch(t_table, t_ids, offsets) -> torch.Tensor:
    mean = torch.nn.functional.embedding_bag(t_ids, t_table, offsets, mode="mean")
    return torch.nn.functional.normalize(mean, dim=1, eps=1e-30)


def token_lists(ids: np.ndarray, segs: np.ndarray, lines: int):
    """Each line's token ids, as the tokenizer hands them to the embed."""
    bounds = np.searchsorted(segs, np.arange(lines + 1))
    return [ids[bounds[i]:bounds[i + 1]] for i in range(lines)]


def lines_per_sec(fn, lines: int, sync=lambda: None):
    """(last output, lines a second) over REPEATS calls after a warm one,
    each call ended by ``sync``."""
    fn()  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        out = fn()
        sync()
    return out, lines / ((time.perf_counter() - t0) / REPEATS)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--lines", type=int, default=LINES)
    ap.add_argument("--device", default=None, help="the port row's device: cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="the records, one JSON object a line")
    return ap


def main(argv=None) -> int:
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.ops.embed import embed_token_lists

    args = parser().parse_args(argv)
    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    lines = args.lines
    table, ids, segs = _workload(tokens=args.tokens, lines=lines)
    shape = {"tokens": args.tokens, "lines": lines, "dim": DIM}
    records = []

    def emit(record: dict) -> None:
        record.update(card=card)
        print(json.dumps(record), flush=True)
        records.append(record)

    ref, np_lps = lines_per_sec(lambda: encode_numpy(table, ids, segs, lines), lines)
    has_tokens = np.bincount(segs, minlength=lines) > 0
    emit({"config": "embed_cpu_baseline", "impl": "numpy-reduceat",
          "metric": "lines_per_sec", "value": round(np_lps, 1),
          "cores_available": os.cpu_count(), **shape, "device": "cpu",
          "note": "the reference's CPU encode: the baseline, on the CPU by definition"})

    offsets = torch.from_numpy(np.searchsorted(segs, np.arange(lines)))
    out_t, th_lps = lines_per_sec(lambda: encode_torch(torch.from_numpy(table),
                                                       torch.from_numpy(ids), offsets), lines)
    err_t = float(np.abs(out_t.numpy() - ref)[has_tokens].max())
    emit({"config": "embed_cpu_baseline", "impl": "torch-embedding-bag",
          "metric": "lines_per_sec", "value": round(th_lps, 1),
          "threads": torch.get_num_threads(), "cores_available": os.cpu_count(), **shape,
          "device": "cpu", "max_abs_err": err_t,
          "note": "the reference's CPU encode: the baseline, on the CPU by definition"})

    t_table = torch.from_numpy(table).to(device)
    lists = token_lists(ids, segs, lines)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    kernels.reset_launch_counts()
    out_p, port_lps = lines_per_sec(lambda: embed_token_lists(t_table, lists), lines, sync)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    err_p = float(np.abs(out_p.cpu().numpy() - ref)[has_tokens].max())
    emit({"config": "embed_cpu_baseline", "impl": "port-embed",
          "metric": "lines_per_sec", "value": round(port_lps, 1), **shape,
          "device": device.type, "max_abs_err": err_p,
          "vs_numpy": port_lps / np_lps, "vs_torch": port_lps / th_lps,
          "launches": launches,
          "note": "ops/embed.embed_token_lists from ragged id lists (host flatten, "
                  "embedding_bag sums, mean, norm); tokenization excluded"})
    worst = max(err_t, err_p)
    if worst > TOL:
        raise AssertionError(f"embed outputs disagree: max |err| {worst} > {TOL}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
