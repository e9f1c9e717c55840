"""Parallel reads through the daemon: N concurrent searches against N in turn
and one batched ``search -Q`` request.

Counterpart of ``benchmarks/quantitative/bench_daemon_parallel.py``. An agent
that issues parallel search tool calls lands N commands on the daemon at
once; they share its read gate and the warm corpus on the device (and its
coalescer merges same-shape scans), so N parallel searches should cost
about one batched search:

    python -m semtools_tpu_torch.probes.daemon_parallel [--papers 400]
        [--parallel 8] [--device cpu] [--out PATH] [--answers PATH]

A live ``python -m semtools_tpu_torch.cli daemon run`` child (on the card
unless ``--device cpu``; its ``HOME`` and ``SEMTOOLS_TPU_DAEMON_DIR`` in a
temp dir) serves a workspace built through the product pipeline over
``evals/corpus.gen`` at seed 7 with the ``potion_mini`` artifacts. The
clients talk to its socket through ``daemon._request`` (process starts
excluded): a cold pass and a settling pass, then the timed orders. The
three orders must print the same hits, query by query. One JSON record with
the JAX driver's keys (``config`` daemon_parallel_reads); beside them the
card's name and power limit and the daemon's kernel launches over its life
(warm-up, the cold pass and the timed orders), which the child writes at
exit. A daemon that does not come up fails the run; it is stopped in a
``finally``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from semtools_tpu_torch.probes import common
from semtools_tpu_torch.probes.workspace_e2e import model_dir

REPO = Path(__file__).resolve().parents[2]
QUERIES = [
    "attention mechanisms weigh context",
    "gradient descent convergence rate",
    "transformer architecture layers",
    "reinforcement learning reward signal",
    "convolution over image patches",
    "tokenization of input text",
    "distributed training across devices",
    "overfitting and regularization",
]
# `daemon run` with its kernel launches written to argv[1] at exit
_DAEMON = (
    "import atexit, json, runpy, sys\n"
    "out = sys.argv.pop(1)\n"
    "def _write():\n"
    "    from semtools_tpu_torch.ops import kernels\n"
    "    open(out, 'w').write(json.dumps(kernels.launch_counts()))\n"
    "atexit.register(_write)\n"
    "runpy.run_module('semtools_tpu_torch.cli', run_name='__main__', alter_sys=True)\n"
)
UP_TIMEOUT_S = 300  # the card's daemon builds or loads the kernel library first
# The orders' distances agree within this: a query embedded alone and in a
# batch of N goes through matmuls of other shapes (last-bit differences)
DIST_TOL = 1e-5
_HIT = re.compile(r"^(.*):(\d+)::(\d+) \(([-+0-9.e]+)\)$")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--papers", type=int, default=400)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="the record as one JSON object")
    ap.add_argument("--answers", default=None,
                    help="each order's outputs, query by query, as one JSON object")
    return ap


def query_blocks(stdout: str, queries) -> list:
    """A ``search -Q`` output cut into each query's block (its
    ``# query:`` header line dropped), in query order."""
    blocks, cur = [], None
    for line in stdout.splitlines(keepends=True):
        if line.startswith("# query: "):
            cur = []
            blocks.append(cur)
        elif cur is not None:
            cur.append(line)
    if len(blocks) != len(queries):
        raise AssertionError(f"-Q printed {len(blocks)} blocks for {len(queries)} queries")
    return ["".join(b).strip("\n") for b in blocks]


def hits_of(stdout: str) -> list:
    """[path, the two line numbers of its header, distance] of each hit a
    search printed (``path:A::B (distance)``)."""
    out = []
    for line in stdout.splitlines():
        m = _HIT.match(line)
        if m:
            out.append([m.group(1), int(m.group(2)), int(m.group(3)), float(m.group(4))])
    return out


def same_hits(a: list, b: list) -> bool:
    """Equal hits in equal order, distances within DIST_TOL."""
    return len(a) == len(b) and all(
        x[:3] == y[:3] and abs(x[3] - y[3]) <= DIST_TOL for x, y in zip(a, b))


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    n = args.parallel
    queries = (QUERIES * ((n + len(QUERIES) - 1) // len(QUERIES)))[:n]
    device = common.device_of(args)
    card = common.card_line(device)
    print(card, flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="daemon_par_"))
    try:
        with common.environ(HOME=str(tmp), SEMTOOLS_TPU_DAEMON_DIR=str(tmp / "run"),
                            SEMTOOLS_WORKSPACE="bench", SEMTOOLS_TPU_NO_FETCH="1",
                            SEMTOOLS_TPU_MODEL_DIR=model_dir()):
            record, answers = run(args, queries, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record.update(card=card, device=device.type)
    print(json.dumps(record), flush=True)
    for path, obj in ((args.out, record), (args.answers, answers)):
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            Path(path).write_text(json.dumps(obj))
    return 0


def run(args, queries, device, tmp: Path):
    from semtools_tpu_torch import daemon
    from semtools_tpu_torch.evals.corpus import gen

    corpus_root = tmp / "corpus"
    gen(corpus_root, n_papers=args.papers, seed=7)
    files = sorted(str(p) for p in (corpus_root / "full_text").glob("*.txt"))
    total_lines = sum(1 for f in files for _ in open(f))

    launches_path = tmp / "daemon_launches.json"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with open(tmp / "daemon.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DAEMON, str(launches_path), "daemon", "run",
             "--device", device.type],
            env=env, cwd=str(REPO), stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=log)
    try:
        deadline = time.monotonic() + UP_TIMEOUT_S
        while not daemon.ping():
            if time.monotonic() > deadline or proc.poll() is not None:
                raise RuntimeError("daemon did not come up: "
                                   + (tmp / "daemon.log").read_text()[-3000:])
            time.sleep(0.25)

        req_env = {
            "SEMTOOLS_WORKSPACE": "bench",
            "SEMTOOLS_TPU_MODEL_DIR": os.environ["SEMTOOLS_TPU_MODEL_DIR"],
            "HOME": str(tmp),
        }

        def request(argv) -> dict:
            resp = daemon._request({"argv": argv, "stdin": None, "cwd": str(tmp),
                                    "env": req_env}, timeout=600.0)
            if resp is None or resp.get("exit") != 0:
                raise AssertionError(f"{argv[:2]}: {resp}")
            return resp

        def search(q: str) -> dict:
            return request(["search", q, *files, "--top-k", "3", "-n", "0"])

        # cold pass: classify, embed and upsert the whole corpus; then a
        # second pass to settle the warm device corpus
        t0 = time.perf_counter()
        search(queries[0])
        cold_s = time.perf_counter() - t0
        for q in queries:
            search(q)

        t0 = time.perf_counter()
        seq = [search(q) for q in queries]
        t_seq = time.perf_counter() - t0

        # parallel warm (all threads released together)
        results = [None] * len(queries)
        errors = {}
        start = threading.Barrier(len(queries) + 1)

        def one(i: int, q: str) -> None:
            start.wait()
            try:
                results[i] = search(q)
            except AssertionError as e:
                errors[i] = str(e)

        threads = [threading.Thread(target=one, args=(i, q)) for i, q in enumerate(queries)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        t_par = time.perf_counter() - t0
        if errors or not all(r is not None and r["exit"] == 0 for r in results):
            raise AssertionError(f"parallel searches failed: {errors}")

        # one batched request carrying every query
        qf = tmp / "queries.txt"
        qf.write_text("".join(q + "\n" for q in queries))
        t0 = time.perf_counter()
        resp = request(["search", "-Q", str(qf), *files, "--top-k", "3", "-n", "0"])
        t_batched = time.perf_counter() - t0
    finally:
        daemon.stop()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
    launches = json.loads(launches_path.read_text()) if launches_path.exists() else None
    if launches is None:
        raise AssertionError("the daemon wrote no launch counts at exit")

    orders = {
        "sequential": [r["stdout"].strip("\n") for r in seq],
        "parallel": [r["stdout"].strip("\n") for r in results],
        "batched": query_blocks(resp["stdout"], queries),
    }
    hits = {name: [hits_of(out) for out in outs] for name, outs in orders.items()}
    for name in ("parallel", "batched"):
        if not all(h and same_hits(h, s) for h, s in zip(hits[name], hits["sequential"])):
            raise AssertionError(f"the {name} order disagrees with the sequential: {hits}")
    record = {
        "config": "daemon_parallel_reads",
        "metric": "parallel_over_batched",
        "value": round(t_par / t_batched, 2),
        "n_parallel": len(queries),
        "papers": len(files),
        "total_lines": total_lines,
        "cold_build_s": round(cold_s, 2),
        "sequential_s": round(t_seq, 3),
        "parallel_s": round(t_par, 3),
        "batched_s": round(t_batched, 3),
        "parallel_speedup_vs_sequential": round(t_seq / t_par, 2),
        "note": (
            "N agent tool-call searches race through the daemon's concurrent "
            "read gate against one warm workspace; socket-level clients "
            "(process spawn excluded). parallel_over_batched ~1 means N "
            "parallel searches cost about one batched search wall-clock."
        ),
        # beside the JAX driver's keys
        "walls_s": {"cold": cold_s, "sequential": t_seq, "parallel": t_par,
                    "batched": t_batched},
        "launches": {k: v for k, v in launches.items() if v},
    }
    root = str(corpus_root)
    answers = {name: [[[h[0].replace(root, "<root>"), *h[1:]] for h in per] for per in lists]
               for name, lists in hits.items()}
    return record, answers


if __name__ == "__main__":
    sys.exit(main())
