"""The port's store-scale drivers (``semtools_tpu_torch.probes.patch_scale``,
``.ann_scale``, ``.ann_incremental``) against the JAX package's
``benchmarks/quantitative/bench_patch_scale.py``, ``bench_ann_scale.py`` and
``bench_ann_incremental.py``, on the CPU.

- patch: the JAX module, loaded by path in a child with ``DOCS``/``LINES``
  set to 1,004 x 50 (its four rewritten documents are d1000-d1003, its query
  row 42 of d0007) and its one-line edit at 30,000 lines, beside the port's
  driver at the same sizes; both children set ``SEMTOOLS_TPU_INT8_MIN_ROWS``
  low, so these 50,200 rows are served by the int8 tier the driver measures.
  The bytes each update uploads are equal (an int8 document; the edited row
  and its int32 index), and so are the tiers.
- IVF-PQ: the JAX drivers do not run whole here (F1: the JAX build pads
  each chunk to ``max(8192, 2**25 // nlist)`` rows and makes a
  ``[chunk, 32, 256]`` f32 tensor, ~2.1 GB at 20,000 rows). Their
  ``synth_clustered`` and ``exact_topk`` are held against the port's (the
  corpus file byte-equal, the truth equal) and the store's parameters
  against the JAX formula and ``Store._ann_candidate_depth``; then the port's
  two drivers run whole at 20,000 rows: ``ann_scale`` with 256 clusters
  (the 10M run's ratio of clusters to lists, 2,000 / 4,096, at nlist 512;
  2,000 clusters would leave 10 rows a cluster, a regime the index is not
  built for) at recall@10 >= 0.98, and ``ann_incremental`` at 20 documents
  with its asserts (the edited row first under 1e-4, the tier ``ivf-pq``,
  nothing rebuilt, the edited document alone in the delta).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from semtools_tpu_torch.probes import ann_scale

REPO = Path(__file__).resolve().parents[1]
QUANT = REPO / "benchmarks" / "quantitative"
PATCH_DOCS, PATCH_LINES, SINGLE_LINES = 1004, 50, 30_000
ANN_ROWS = 20_000

_JAX_PATCH = f"""
import importlib.util, sys
path = {str(QUANT / "bench_patch_scale.py")!r}
spec = importlib.util.spec_from_file_location("bench_patch_scale", path)
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.DOCS, m.LINES = {PATCH_DOCS}, {PATCH_LINES}
m.main()
m.single_file_edit({SINGLE_LINES})
"""


def _env(home: Path, **extra) -> dict:
    # one device, as the drivers run on one chip (no forced host devices);
    # one BLAS/OpenMP thread a child: the children run at once, beside the
    # suite's other workers
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMTOOLS_") and k != "XLA_FLAGS"}
    env.update(HOME=str(home), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


def _spawn(argv, env):
    return subprocess.Popen(argv, cwd=str(REPO), env=env, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _records(proc) -> list:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _port(name: str, *args, env, out: Path):
    return _spawn([sys.executable, "-m", f"semtools_tpu_torch.probes.{name}", *args,
                   "--device", "cpu", "--out", str(out)], env)


@pytest.fixture(scope="module")
def patch_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("patch")
    home = root / "home"
    home.mkdir()
    env = _env(home, SEMTOOLS_TPU_INT8_MIN_ROWS="1000")
    procs = [
        # the JAX side's scan route pinned to the device: its "auto" probes
        # the link's speed, and a loaded host can send the cold store to the
        # host scan, which uploads nothing (the port's route is the device)
        _spawn([sys.executable, "-c", _JAX_PATCH],
               dict(env, SEMTOOLS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                    SEMTOOLS_TPU_SCAN="device")),
        _port("patch_scale", "--docs", str(PATCH_DOCS), "--lines", str(PATCH_LINES), env=env,
              out=root / "many.json"),
        _port("patch_scale", "--single-file", "--lines", str(SINGLE_LINES), env=env,
              out=root / "single.json"),
    ]
    jax, many, single = (_records(p) for p in procs)
    return jax, many + single


@pytest.mark.parametrize("config,keys", [
    ("workspace_patch_500k", ("per_update_uploaded_bytes", "total_lines", "tier")),
    ("patch_single_file_edit", ("edit_shipped_bytes", "total_lines", "tier",
                                "whole_file_bytes_int8")),
])
def test_patch_bytes_equal(patch_runs, config, keys):
    jax, port = patch_runs
    want = next(r for r in jax if r["config"] == config)
    have = next(r for r in port if r["config"] == config)
    for key in keys:
        assert have[key] == want[key], (key, have[key], want[key])
    assert have["tier"] == "int8-mxu-scan"


def test_patch_bytes_are_o_doc(patch_runs):
    _, port = patch_runs
    many = next(r for r in port if r["config"] == "workspace_patch_500k")
    single = next(r for r in port if r["config"] == "patch_single_file_edit")
    assert many["per_update_uploaded_bytes"] == [PATCH_LINES * 256] * 4
    assert single["edit_shipped_bytes"] == 256 + 4
    assert {"slot_corpus_patch"} <= set(many["per_update_stages_s"][0])
    assert "slot_corpus_build" not in single["edit_query_stages_s"]


def _load_jax(name: str):
    old = os.environ.get("SEMTOOLS_TPU_PLATFORM")
    os.environ["SEMTOOLS_TPU_PLATFORM"] = "cpu"
    try:
        spec = importlib.util.spec_from_file_location(name, QUANT / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if old is None:
            os.environ.pop("SEMTOOLS_TPU_PLATFORM")
        else:
            os.environ["SEMTOOLS_TPU_PLATFORM"] = old
    return module


@pytest.fixture(scope="module")
def ann_corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("ann")
    jax_mod = _load_jax("bench_ann_scale")
    jax_mod.synth_clustered(str(root / "jax.f32"), ANN_ROWS, 256, 2000)
    ann_scale.synth_clustered(str(root / "port.f32"), ANN_ROWS, 256, 2000)
    return jax_mod, root


def test_ann_corpus_byte_equal(ann_corpora):
    _, root = ann_corpora
    assert (root / "jax.f32").read_bytes() == (root / "port.f32").read_bytes()


def test_ann_truth_equal(ann_corpora):
    jax_mod, root = ann_corpora
    mm = np.memmap(root / "port.f32", dtype=np.float32, mode="r", shape=(ANN_ROWS, 256))
    q = ann_scale.queries(mm, ANN_ROWS, 50, 256)
    want = jax_mod.exact_topk(mm, q, 10)
    assert (ann_scale.exact_topk(mm, q, 10, torch.device("cpu")) == want).all()


@pytest.mark.parametrize("n", [20_000, 1_000_000, 10_000_000, 100_000_000])
def test_ann_store_parameters(n):
    """nlist, nprobe and the candidate depth: the JAX driver's formula with
    the JAX store's depth."""
    from semtools_tpu.store.store import Store

    nlist = int(min(4096, max(16, 1 << int(np.log2(max(4 * np.sqrt(n), 16))))))
    nprobe = max(16, nlist // 16)
    assert ann_scale.store_parameters(n, 10) == (
        nlist, nprobe, Store._ann_candidate_depth(10, n, nlist, nprobe))


@pytest.fixture(scope="module")
def ann_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ann_runs")
    home = root / "home"
    home.mkdir()
    env = _env(home)
    procs = [
        _port("ann_scale", "--rows", str(ANN_ROWS), "--clusters", "256", env=env,
              out=root / "scale.json"),
        _port("ann_incremental", "--rows", str(ANN_ROWS), "--docs", "20", env=env,
              out=root / "incr.json"),
    ]
    return [_records(p)[0] for p in procs]


def test_ann_scale_driver_recall(ann_runs):
    row = ann_runs[0]
    assert row["config"] == "ann_scale" and row["n"] == ANN_ROWS
    assert (row["nlist"], row["nprobe"]) == (512, 32)
    assert row["value"] >= 0.98 and row["candidate_recall_at_10"] >= row["value"]
    assert {"ann_train", "ann_encode", "ann_finalize"} <= set(row["build_stages_s"])
    assert not row["launches"]["build"] and not row["launches"]["search"]


def test_ann_incremental_driver_asserts(ann_runs):
    row = ann_runs[1]
    assert row["config"] == "ann_incremental" and row["doc_rows"] == 1000
    assert not row["rebuilt"] and row["delta_rows"] == 1000
    assert row["edited_distance"] < 1e-4
