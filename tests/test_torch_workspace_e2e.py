"""The port's real-pipeline drivers (``semtools_tpu_torch.probes.workspace_e2e``
and ``.daemon_parallel``) against the JAX package's
``benchmarks/quantitative/bench_workspace_e2e.py`` and
``bench_daemon_parallel.py``, on the CPU, at 24 papers (the drivers rewrite
``files[17]``) and 4 parallel clients, over the ``potion_mini`` artifacts.

Each JAX driver runs unmodified in a child process, loaded by path
(``SEMTOOLS_TPU_PLATFORM=cpu``; its daemon child inherits that), with the
library call whose answer it does not print wrapped to record it:
``search_with_workspace`` and the daemon client's ``_request``. The port's
drivers run beside them with ``--device cpu`` and ``--answers``. Each child
has its own ``HOME``, one BLAS/OpenMP thread and no ``SEMTOOLS_*`` or
``XLA_FLAGS`` of this process.

- ``workspace_e2e``: ``papers`` and ``total_lines`` equal; the hits of each
  step (cold build, warm query, the rewritten file) equal: files and line
  numbers in order, distances within ``ATOL``.
- ``daemon_parallel``: ``papers``, ``total_lines`` and ``n_parallel``
  equal; each order's hits (sequential, parallel, one ``-Q`` request) equal
  to the JAX driver's, query by query, and within each package the three
  orders equal (a query embedded alone and in a batch goes through matmuls
  of other shapes, so distances agree within ``ATOL``, as the driver's own
  check allows).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from semtools_tpu_torch.probes import daemon_parallel

REPO = Path(__file__).resolve().parents[1]
QUANT = REPO / "benchmarks" / "quantitative"
PAPERS, PARALLEL = 24, 4
ATOL = 1e-5  # tests/test_torch_search.py's distance tolerance

_JAX_E2E = f"""
import importlib.util, json, sys
import semtools_tpu.search as S
answers = []
_search = S.search_with_workspace
def search_with_workspace(*a, **k):
    out = _search(*a, **k)
    answers.append([[h.path, h.line_number, float(h.distance)] for h in out])
    return out
S.search_with_workspace = search_with_workspace
out_path = sys.argv[1]
sys.argv = [sys.argv[0], "{PAPERS}"]
spec = importlib.util.spec_from_file_location("bench_workspace_e2e",
                                              {str(QUANT / "bench_workspace_e2e.py")!r})
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.main()
json.dump(dict(zip(("cold", "warm", "update"), answers)), open(out_path, "w"))
"""

_JAX_DAEMON = f"""
import importlib.util, json, sys
import semtools_tpu.daemon as D
calls = []
_request = D._request
def request(obj, timeout=600.0):
    resp = _request(obj, timeout)
    if "argv" in obj:
        calls.append([obj["argv"], resp["stdout"]])
    return resp
D._request = request
out_path = sys.argv[1]
sys.argv = [sys.argv[0], "{PAPERS}", "{PARALLEL}"]
spec = importlib.util.spec_from_file_location("bench_daemon_parallel",
                                              {str(QUANT / "bench_daemon_parallel.py")!r})
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.main()
json.dump(calls, open(out_path, "w"))
"""


def _env(home: Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMTOOLS_") and k != "XLA_FLAGS"}
    env.update(HOME=str(home), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1", SEMTOOLS_TPU_NO_FETCH="1",
               **extra)
    return env


def _spawn(argv, env):
    return subprocess.Popen(argv, cwd=str(REPO), env=env, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _record(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    (rec,) = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    homes = {}
    for tag in ("jax_e2e", "jax_daemon", "port_e2e", "port_daemon"):
        homes[tag] = tmp / f"home_{tag}"
        homes[tag].mkdir()
    jax_env = dict(SEMTOOLS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                   SEMTOOLS_TPU_SCAN="device", SEMTOOLS_TPU_EMBED="device")
    procs = {
        "jax_e2e": _spawn([sys.executable, "-c", _JAX_E2E, str(tmp / "jax_e2e.json")],
                          _env(homes["jax_e2e"], **jax_env)),
        "jax_daemon": _spawn([sys.executable, "-c", _JAX_DAEMON, str(tmp / "jax_daemon.json")],
                             _env(homes["jax_daemon"], **jax_env)),
        "port_e2e": _spawn([sys.executable, "-m", "semtools_tpu_torch.probes.workspace_e2e",
                            "--papers", str(PAPERS), "--device", "cpu",
                            "--answers", str(tmp / "port_e2e.json")], _env(homes["port_e2e"])),
        "port_daemon": _spawn([sys.executable, "-m", "semtools_tpu_torch.probes.daemon_parallel",
                               "--papers", str(PAPERS), "--parallel", str(PARALLEL),
                               "--device", "cpu", "--answers", str(tmp / "port_daemon.json")],
                              _env(homes["port_daemon"])),
    }
    try:
        records = {tag: _record(p) for tag, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    answers = {tag: json.loads((tmp / f"{tag}.json").read_text()) for tag in procs}
    return records, answers


def _named(hits):
    """Hits with each path cut to its file name (the corpora lie in other
    temp dirs) and the distance split off."""
    return [[Path(h[0]).name, *h[1:-1]] for h in hits], [h[-1] for h in hits]


def _same(have, want) -> None:
    (h_rows, h_d), (w_rows, w_d) = _named(have), _named(want)
    assert h_rows == w_rows
    assert all(abs(a - b) <= ATOL for a, b in zip(h_d, w_d)), (h_d, w_d)


def test_workspace_e2e_record(runs):
    records, _ = runs
    want, have = records["jax_e2e"], records["port_e2e"]
    assert set(want) <= set(have)
    assert want["config"] == have["config"] == "workspace_e2e_realpipeline"
    for key in ("papers", "total_lines", "model"):
        assert have[key] == want[key], key
    assert have["papers"] == PAPERS
    stages = have["stages_s"]["cold"]
    assert {"store_upsert", "embed", "line_hashes", "slot_corpus_build"} <= set(stages)


@pytest.mark.parametrize("step", ["cold", "warm", "update"])
def test_workspace_e2e_hits(runs, step):
    _, answers = runs
    want, have = answers["jax_e2e"][step], answers["port_e2e"][step]
    assert have and len(have) == len(want) == 5
    _same(have, want)


def test_daemon_record(runs):
    records, _ = runs
    want, have = records["jax_daemon"], records["port_daemon"]
    assert set(want) <= set(have)
    for key in ("config", "metric", "papers", "total_lines", "n_parallel"):
        assert have[key] == want[key], key
    assert have["n_parallel"] == PARALLEL and have["launches"] == {}


def _jax_orders(calls) -> dict:
    """The JAX driver's requests in call order: the cold pass, the settling
    pass, the sequential pass, the parallel pass (completion order: keyed
    by query) and the ``-Q`` request."""
    n = PARALLEL
    queries = [argv[1] for argv, _ in calls[1 + n : 1 + 2 * n]]
    parallel = {argv[1]: out for argv, out in calls[1 + 2 * n : 1 + 3 * n]}
    (argv, batched), = calls[1 + 3 * n :]
    assert argv[1] == "-Q"
    return {
        "sequential": [daemon_parallel.hits_of(out) for _, out in calls[1 + n : 1 + 2 * n]],
        "parallel": [daemon_parallel.hits_of(parallel[q]) for q in queries],
        "batched": [daemon_parallel.hits_of(b)
                    for b in daemon_parallel.query_blocks(batched, queries)],
    }


@pytest.mark.parametrize("order", ["sequential", "parallel", "batched"])
def test_daemon_orders_equal_jax(runs, order):
    _, answers = runs
    jax = _jax_orders(answers["jax_daemon"])
    port = answers["port_daemon"]
    assert len(port[order]) == len(jax[order]) == PARALLEL
    for i, (have, want) in enumerate(zip(port[order], jax[order])):
        assert have and len(have) == len(want) == 3
        _same(have, want)
        _same(have, port["sequential"][i])
        _same(want, jax["sequential"][i])  # the reference's own orders
