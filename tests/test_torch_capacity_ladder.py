"""The port's capacity ladder (``semtools_tpu_torch.probes.capacity_ladder``)
against the JAX package's ``benchmarks/quantitative/bench_capacity_ladder.py``.

Both drivers run unmodified as children on the CPU (the JAX one under
``SEMTOOLS_TPU_PLATFORM=cpu JAX_PLATFORMS=cpu``, the port's with ``--device
cpu``) at a 2 MiB budget, 8 queries: the hops hold 6,790 to 35,405 rows.
Apart from the timings their records are equal: each hop's tier, rows,
recall, threshold mode, budget and (on the reduced-32d hops) oversample,
and the largest distance error within 1e-6; the policy tables are equal at
2 MiB, 512 MiB and 4 GiB; the two stores' vector files are byte-equal. The
port's truth pass on torch (the card's route, here on the CPU) equals the
numpy one the JAX driver runs, ties included.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semtools_tpu_torch.probes import capacity_ladder

REPO = Path(__file__).resolve().parents[1]
JAX_DRIVER = REPO / "benchmarks" / "quantitative" / "bench_capacity_ladder.py"
BUDGET = 2 << 20
POLICY_BUDGETS = (BUDGET, 512 << 20, 4 << 30)
QUERIES = "8"


def _env(home: Path, **extra) -> dict:
    # one device, as the drivers run on one chip (no forced host devices);
    # one BLAS/OpenMP thread a child: the children run at once, beside the
    # suite's other workers
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMTOOLS_") and k != "XLA_FLAGS"}
    env.update(HOME=str(home), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


def _jax(args, home):
    return subprocess.Popen(
        [sys.executable, str(JAX_DRIVER), *args], cwd=str(REPO),
        env=_env(home, SEMTOOLS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu"),
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _port(args, home, out: Path):
    return subprocess.Popen(
        [sys.executable, "-m", "semtools_tpu_torch.probes.capacity_ladder", *args,
         "--device", "cpu", "--out", str(out)], cwd=str(REPO),
        env=_env(home), stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _records(proc) -> list:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax"/"port": {budget: records}} and the two measured stores' dirs.
    Every child runs at once."""
    root = tmp_path_factory.mktemp("ladder")
    home = root / "home"
    home.mkdir()
    common = ["--budget", str(BUDGET), "--queries", QUERIES]
    procs = {("jax", BUDGET): _jax([*common, "--workdir", str(root / "jax")], home),
             ("port", BUDGET): _port([*common, "--workdir", str(root / "port")], home,
                                     root / "port.json")}
    for b in POLICY_BUDGETS[1:]:
        policy = ["--budget", str(b), "--skip-measure"]
        procs[("jax", b)] = _jax(policy, home)
        procs[("port", b)] = _port(policy, home, root / f"port{b}.json")
    got = {"jax": {}, "port": {}}
    for (who, b), proc in procs.items():
        got[who][b] = _records(proc)
    return got, root


def _hops(records) -> dict:
    return {r["hop"]: r for r in records if r["config"] == "capacity_ladder"}


@pytest.mark.parametrize("hop", capacity_ladder.HOPS)
def test_hop_records_equal(runs, hop):
    from semtools_tpu.ops.reduce import reduced_oversample

    got, _ = runs
    want, have = _hops(got["jax"][BUDGET])[hop], _hops(got["port"][BUDGET])[hop]
    for key in ("serving_tier", "n", "dim", "value", "threshold_mode_exact", "budget_bytes",
                "batch_q", "metric"):
        assert have[key] == want[key], (key, have[key], want[key])
    assert have["value"] == 1.0 and have["threshold_mode_exact"]
    assert abs(have["max_abs_dist_err"] - want["max_abs_dist_err"]) <= 1e-6
    if hop.startswith("reduced32"):  # the JAX driver adds it after printing the row
        assert have["oversample"] == reduced_oversample(want["n"], 10)
    assert have["device"] == "cpu" and not any(have["launches"]["cold"].values())


@pytest.mark.parametrize("budget", POLICY_BUDGETS)
def test_policy_tables_equal(runs, budget):
    got, _ = runs
    for config in ("capacity_ladder_policy", "capacity_ladder_policy_mesh"):
        want = [r for r in got["jax"][budget] if r["config"] == config]
        have = [r for r in got["port"][budget] if r["config"] == config]
        assert have == want and len(want) in (9, 5), config


def test_corpus_byte_equal(runs):
    """The two stores' vector files: the same docs, rows and slots."""
    _, root = runs
    jax_file, port_file = root / "jax" / "ws" / "lines.f32", root / "port" / "ws" / "lines.f32"
    assert jax_file.stat().st_size == port_file.stat().st_size == 35_405 * 256 * 4
    assert jax_file.read_bytes() == port_file.read_bytes()


def test_truth_pass_equals_jax_driver(tmp_path):
    """The port's truth pass (torch, chunked) against the JAX driver's
    ``exact_topk_mmap`` (numpy), over an mmap with planted ties across a
    chunk boundary: the same slots, distances within 1e-6."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_capacity_ladder", JAX_DRIVER)
    jax_driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_driver)
    n, k = 3000, 10
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, capacity_ladder.DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[2999] = x[5] = x[17]  # exact ties: the lower slot first
    mm = np.memmap(tmp_path / "v.f32", dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    q = x[[17, 40, 2999]] + 0.01
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    old = capacity_ladder.TRUTH_CHUNK
    capacity_ladder.TRUTH_CHUNK = 1024
    try:
        got_i, got_d = capacity_ladder.exact_topk_mmap(mm, n, q, k, torch.device("cpu"))
    finally:
        capacity_ladder.TRUTH_CHUNK = old
    want_i, want_d = jax_driver.exact_topk_mmap(mm, n, q, k)
    assert (got_i == want_i).all() and np.abs(got_d - want_d).max() <= 1e-6
    assert list(got_i[0][:3]) == [5, 17, 2999]
