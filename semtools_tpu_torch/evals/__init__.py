"""The port's evaluation drivers: product quality, not speed.

Counterparts of the repository's three evaluation drivers, run against the
port's entry points (workspace search, the store's tiers, the ask agent's
tools and loop) on a CUDA card, or on the CPU with ``--device cpu``:

- :mod:`~semtools_tpu_torch.evals.realtext`: 15 questions over the committed
  real-prose corpus (doc-hit@10, each compressed tier's recall@10 against
  the exact scan, grep against Python ``re``, batched throughput);
- :mod:`~semtools_tpu_torch.evals.retrieval`: the 15 arxiv questions' search
  stage over the synthetic corpus of :mod:`~semtools_tpu_torch.evals.corpus`;
- :mod:`~semtools_tpu_torch.evals.agent`: all 15 questions through ``ask``
  in both API modes, driven by a deterministic policy LLM on localhost, every
  citation re-read from disk, and 20 fault-injection runs;
- :mod:`~semtools_tpu_torch.evals.fuzz_grep`: the grep router's differential
  fuzz (native scanner against Python ``re``).

``python -m semtools_tpu_torch.evals {realtext,retrieval,agent,fuzz_grep} ...``
"""
