"""Deterministic synthetic corpus for the quantitative drivers.

Counterpart of ``benchmarks/quantitative/gen_corpus.py``: text files shaped
like the arxiv corpus (academic prose, line lengths of 4-24 words, a
vocabulary shared across four topical clusters), fully seeded, so the same
arguments give byte-equal files in both packages:

    python -m semtools_tpu_torch.probes.gen_corpus OUT_DIR [--files 100]
        [--lines 200] [--seed 0]
"""

from __future__ import annotations

import argparse
import random
import sys
from pathlib import Path

TOPICS = {
    "attention": ["attention", "transformer", "head", "query", "key", "value",
                  "softmax", "context", "sequence", "token"],
    "optimization": ["gradient", "descent", "learning", "rate", "momentum",
                     "convergence", "loss", "minimum", "adaptive", "schedule"],
    "retrieval": ["retrieval", "embedding", "index", "nearest", "neighbor",
                  "cosine", "vector", "corpus", "ranking", "relevance"],
    "systems": ["throughput", "latency", "memory", "bandwidth", "cache",
                "pipeline", "kernel", "accelerator", "compiler", "parallel"],
}

FILLER = ("the of a in we that is for with this are on as by an be our "
          "results show propose method model approach using based paper").split()


def gen_line(rng: random.Random, topic_words) -> str:
    n = rng.randint(4, 24)
    words = []
    for _ in range(n):
        if rng.random() < 0.35:
            words.append(rng.choice(topic_words))
        else:
            words.append(rng.choice(FILLER))
    return " ".join(words)


def gen_corpus(out_dir: Path, n_files: int, lines_per_file: int, seed: int = 0):
    """Write ``n_files`` files of ``lines_per_file`` lines under ``out_dir``;
    returns their paths in order."""
    rng = random.Random(seed)
    out_dir.mkdir(parents=True, exist_ok=True)
    topics = list(TOPICS)
    paths = []
    for i in range(n_files):
        topic = topics[i % len(topics)]
        lines = [gen_line(rng, TOPICS[topic]) for _ in range(lines_per_file)]
        p = out_dir / f"doc_{i:04d}_{topic}.txt"
        p.write_text("\n".join(lines) + "\n")
        paths.append(p)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--files", type=int, default=100)
    ap.add_argument("--lines", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    paths = gen_corpus(args.out_dir, args.files, args.lines, args.seed)
    print(f"wrote {len(paths)} files under {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
