"""A workspace built end to end through the real pipeline: generated text,
the ``potion_mini`` model2vec artifacts, ``search_with_workspace``.

Counterpart of ``benchmarks/quantitative/bench_workspace_e2e.py``: tokenize,
embed on the device, upsert, the tier policy and the device scan, as a
user's first ``semtools search -w`` over a large corpus takes them:

    python -m semtools_tpu_torch.probes.workspace_e2e [--papers 8000]
        [--device cpu] [--out PATH] [--answers PATH]

The corpus is ``evals/corpus.gen`` at seed 7 (the JAX driver's
``gen_text_corpus.gen``, byte for byte); the model is
``tests/fixtures/potion_mini`` unless ``SEMTOOLS_TPU_MODEL_DIR`` names
another. Three steps, each asserted as the JAX driver does: a cold build and
query (hits), a warm query (hits), and ``files[17]`` rewritten, which must
rank first for its own text. One JSON record with the JAX driver's keys
(``config`` workspace_e2e_realpipeline); beside them the card's name and
power limit, each step's kernel launches and ``SEMTOOLS_TPU_TIMINGS``
stages (the cold build's ``store_upsert``, ``embed``, ``line_hashes`` and
``slot_corpus_build`` among them). ``HOME`` is a temp dir, removed at exit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

from semtools_tpu_torch.probes import common
from semtools_tpu_torch.probes.run_bench import counted

REPO = Path(__file__).resolve().parents[2]
DEFAULT_MODEL_DIR = REPO / "tests" / "fixtures" / "potion_mini"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--papers", type=int, default=8000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="the record as one JSON object")
    ap.add_argument("--answers", default=None, help="each step's hits, as one JSON object")
    return ap


def model_dir() -> str:
    """``SEMTOOLS_TPU_MODEL_DIR``, else the ``potion_mini`` fixture; a
    directory without the artifacts fails (the drivers measure that model,
    never the built-in fallback)."""
    path = os.environ.get("SEMTOOLS_TPU_MODEL_DIR") or str(DEFAULT_MODEL_DIR)
    if not (Path(path) / "model.safetensors").exists():
        raise SystemExit(f"no model2vec artifacts in {path}")
    return path


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    tmp = Path(tempfile.mkdtemp(prefix="ws_e2e_"))
    try:
        with common.environ(HOME=str(tmp), SEMTOOLS_TPU_TIMINGS="1",
                            SEMTOOLS_TPU_MODEL_DIR=model_dir()):
            record, answers = run(args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(record), flush=True)
    for path, obj in ((args.out, record), (args.answers, answers)):
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            Path(path).write_text(json.dumps(obj))
    return 0


def run(args, tmp: Path):
    from semtools_tpu_torch.evals.corpus import gen
    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.search import SearchConfig, search_with_workspace
    from semtools_tpu_torch.store import Workspace, WorkspaceConfig
    from semtools_tpu_torch.utils import tracing

    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    corpus_root = tmp / "corpus"
    t0 = time.perf_counter()
    gen(corpus_root, n_papers=args.papers, seed=7)
    gen_s = time.perf_counter() - t0
    files = sorted(str(p) for p in (corpus_root / "full_text").glob("*.txt"))
    total_lines = sum(1 for f in files for _ in open(f))

    model = StaticModel.from_pretrained(os.environ["SEMTOOLS_TPU_MODEL_DIR"], device=device)
    Workspace(WorkspaceConfig(name="e2e", root_dir=Workspace.root_path("e2e"))).save()
    cfg = SearchConfig(top_k=5, n_lines=2)

    def search(query: str):
        hits = search_with_workspace(files, query, model, cfg, workspace_name="e2e")
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        return hits

    steps = {}
    t0 = time.perf_counter()
    with counted(steps, "cold"):
        hits = search("denoising diffusion noise schedule")
    build_s = time.perf_counter() - t0
    if not hits:
        raise AssertionError("no hits from cold build")

    t0 = time.perf_counter()
    with counted(steps, "warm"):
        hits_warm = search("attention mechanisms weigh context")
    warm_s = time.perf_counter() - t0
    if not hits_warm:
        raise AssertionError("no warm hits")

    # incremental: rewrite ONE file, re-search: only that file re-embeds
    target = Path(files[17])
    target.write_text("a fresh unique sentinel about zebra calibration\n" * 30)
    t0 = time.perf_counter()
    with counted(steps, "update"):
        hits_inc = search("zebra calibration sentinel")
    inc_s = time.perf_counter() - t0
    if not hits_inc or hits_inc[0].path != str(target):
        raise AssertionError(f"the rewritten file is not first: {hits_inc[:1]}")
    tracing.reset()  # the stages went into the record

    record = {
        "config": "workspace_e2e_realpipeline",
        "papers": len(files),
        "total_lines": total_lines,
        "model": "potion_mini fixture (real model2vec artifacts)",
        "corpus_gen_s": round(gen_s, 1),
        "cold_build_and_query_s": round(build_s, 1),
        "build_lines_per_s": round(total_lines / build_s, 1),
        "warm_query_s": round(warm_s, 2),
        "one_file_update_query_s": round(inc_s, 2),
        # beside the JAX driver's keys: unrounded walls, the card, each step's
        # launches and stages
        "walls_s": {"cold": build_s, "warm": warm_s, "update": inc_s},
        "card": card, "device": device.type,
        "launches": {s: v["launches"] for s, v in steps.items()},
        "stages_s": {s: v["stages_s"] for s, v in steps.items()},
    }
    root = str(corpus_root)
    answers = {step: [[h.path.replace(root, "<root>"), h.line_number, h.distance] for h in hs]
               for step, hs in (("cold", hits), ("warm", hits_warm), ("update", hits_inc))}
    return record, answers


if __name__ == "__main__":
    sys.exit(main())
