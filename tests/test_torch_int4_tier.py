"""The port's int4 tier probes (``semtools_tpu_torch.probes.int4_tier`` and
``.int4_check``) against the JAX package's ``scripts/probe_int4_tier.py`` and
``scripts/probe_int4.py``, on the same numpy inputs.

The JAX tier probe is loaded by path and its sweeps run with their Pallas
calls under ``pltpu.force_tpu_interpret_mode()``; its ``build`` (jax.random
on the chip) is bypassed: both probes' sweeps get one numpy-made corpus
(32,000 rows, 64 clusters, DIM 256, the probe's noise and scale), its
queries and an exact float64 oracle. ``scripts/probe_int4.py`` runs the chip
when imported, so its correctness half (the statements before the 10M-row
corpus) is taken out with ``ast``, shrunk, and run. Nothing of the JAX side
changes. The port runs its plain versions here (CPU tensors); the kernels
are held against those on a card by tests/test_torch_int4_tier_cuda.py.

Tolerances: the sweeps' records are equal apart from their times (integer
arithmetic, one margin and one cap rule); the packing is byte-equal; the
port's chunked oracle holds only true top-10 rows, within 1e-6 in float64
sims (f32 products).
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from semtools_tpu_torch.ops import int4_scan as i4
from semtools_tpu_torch.probes import int4_check, int4_tier

REPO = Path(__file__).resolve().parents[1]
N, CLUSTERS = 32_000, 64
RECALL_QUERIES = 2  # the recall sweep's queries: interpret mode's cost grows with the depth
CPU = torch.device("cpu")


def _load(rel: str, name: str):
    old = os.environ.get("SEMTOOLS_TPU_PLATFORM")
    os.environ["SEMTOOLS_TPU_PLATFORM"] = "cpu"  # no compile cache under HOME
    try:
        spec = importlib.util.spec_from_file_location(name, REPO / rel)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if old is None:
            os.environ.pop("SEMTOOLS_TPU_PLATFORM")
        else:
            os.environ["SEMTOOLS_TPU_PLATFORM"] = old
    return module


def _pack_numpy(x: np.ndarray, scale: float) -> np.ndarray:
    return i4.pack_int4(np.clip(np.rint(x / np.float32(scale)), -7, 7).astype(np.int8))


def _oracle(qs: np.ndarray, x: np.ndarray, k: int = 10) -> np.ndarray:
    sims = qs.astype(np.float64) @ x.astype(np.float64).T
    return np.stack([np.lexsort((np.arange(x.shape[0]), -s))[:k] for s in sims])


@pytest.fixture(scope="module")
def tier_data():
    """(packed int8 [N, 128], scale, f32 queries [50, 256], oracle [50, 10])
    of the probe's family, made with numpy."""
    rng = np.random.default_rng(14)
    centres = rng.standard_normal((CLUSTERS, 256)).astype(np.float32)
    x = centres[rng.integers(0, CLUSTERS, N)]
    x = x + np.float32(0.15) * rng.standard_normal((N, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    scale = float(np.abs(x).max()) * 1.02 / 7.0
    qs = x[rng.integers(0, N, int4_tier.Q_RECALL)]
    qs = qs + np.float32(0.05) * rng.standard_normal(qs.shape).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return _pack_numpy(x, scale), scale, qs, _oracle(qs, x)


@pytest.fixture(scope="module")
def records(tier_data):
    """Both probes' deep-sweep records (all 50 queries) and recall-sweep
    records (RECALL_QUERIES of them) on ``tier_data``; the JAX corpus padded
    to its tile, as its ``main`` does."""
    jmod = _load("scripts/probe_int4_tier.py", "jax_probe_int4_tier")
    p4, scale, qs, oracle = tier_data
    from semtools_tpu.ops.int4_scan import TILE_N

    pad = (-N) % TILE_N
    p4_jax = jnp.concatenate([jnp.asarray(p4), jnp.zeros((pad, 128), jnp.int8)])
    p4_port, qs_port = torch.as_tensor(p4), torch.as_tensor(qs)
    want, got = {"deep": [], "recall": []}, {"deep": [], "recall": []}
    with contextlib.redirect_stdout(io.StringIO()):
        with pltpu.force_tpu_interpret_mode():
            jmod.deep_sweep(p4_jax, qs, oracle, N, want["deep"])
        int4_tier.deep_sweep(p4_port, qs_port, oracle, N, got["deep"])
        with pytest.MonkeyPatch.context() as mp:
            jmod.Q_RECALL = RECALL_QUERIES
            mp.setattr(int4_tier, "Q_RECALL", RECALL_QUERIES)
            with pltpu.force_tpu_interpret_mode():
                jmod.recall_sweep(p4_jax, scale, qs[:RECALL_QUERIES], oracle, N, want["recall"])
            int4_tier.recall_sweep(p4_port, scale, qs_port, oracle, N, got["recall"])
    return want, got


def _untimed(record: dict) -> dict:
    return {k: v for k, v in record.items() if k != "warm_batch8_ms"}


@pytest.mark.parametrize("sigma", int4_tier.SIGMAS)
def test_deep_sweep_record_equal(records, sigma):
    want, got = records
    (w,) = [r for r in want["deep"] if r["margin_sigmas"] == sigma]
    (g,) = [r for r in got["deep"] if r["margin_sigmas"] == sigma]
    assert {k: g[k] for k in _untimed(w)} == _untimed(w)
    assert g["policy_cap"] == i4.int4_candidate_cap(N)
    assert g["queries_at_cap"] == 0 and g["max_candidates"] < g["policy_cap"]
    assert g["warm_batch8_ms"] == g["warm_batch8_events_ms"] == "not measured"


def test_recall_sweep_records_equal(records):
    want, got = records
    assert len(want["recall"]) >= 2  # the sweep passes more than one depth
    assert got["recall"] == want["recall"]
    assert got["recall"][-1]["recall_at_10"] == 1.0 or got["recall"][-1]["depth"] == 1024


@pytest.mark.parametrize("shrink", [1.0, 3.0])
def test_pack_chunk_equals_the_jax_probe_layout(monkeypatch, shrink):
    """``pack_chunk`` (the port's ``pack_int4`` of the clipped rint) against
    the JAX probe's ``_pack_chunk`` on the same rows; ``shrink`` > 1 makes
    the scale small enough that rows clip at +-7. Rows include exact
    half-steps (round half to even on both sides)."""
    jmod = _load("scripts/probe_int4_tier.py", "jax_probe_int4_tier_pack")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1000, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    scale = float(np.abs(x).max()) * 1.02 / 7.0 / shrink
    x[0, :31] = np.float32(scale) * np.arange(-7.5, 8.0, 0.5, dtype=np.float32)
    monkeypatch.setattr(jmod, "_gen_chunk", lambda centers, seed, n: jnp.asarray(x))
    want = np.asarray(jmod._pack_chunk(jnp.zeros((1, 256)), 0, n=x.shape[0], scale=scale))
    got = int4_tier.pack_chunk(torch.as_tensor(x), scale)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(_pack_numpy(x, scale), want)


def test_pack_int4_tensor_equals_numpy():
    q = np.random.default_rng(5).integers(-8, 8, (300, 64)).astype(np.int8)
    packed = i4.pack_int4(torch.as_tensor(q))
    assert packed.dtype == torch.int8 and np.array_equal(packed.numpy(), i4.pack_int4(q))
    assert np.array_equal(i4.unpack_int4(packed.numpy()), q)
    assert np.array_equal(i4.pack_int4(torch.as_tensor(q, dtype=torch.float32)).numpy(),
                          i4.pack_int4(q))


def test_build_chunks_pack_and_oracle(monkeypatch):
    """The port's build in chunks of 1,000 rows: each chunk made again bit
    for bit from its seed, the packed corpus that of the remade rows, and
    every oracle row a true top-10 row."""
    monkeypatch.setattr(int4_tier, "CHUNK", 1000)
    n = 2500
    corpus = int4_tier.build(n, CPU)
    centres = int4_tier.centres_of(CPU)
    chunks = [int4_tier.gen_chunk(centres, c, min(1000, n - 1000 * c)) for c in range(3)]
    assert torch.equal(chunks[1], int4_tier.gen_chunk(centres, 1, 1000))
    assert not torch.equal(chunks[0][:500], chunks[1][:500])
    x = torch.cat(chunks)
    assert torch.equal(corpus.p4, torch.cat([int4_tier.pack_chunk(c, corpus.scale)
                                              for c in chunks]))
    assert corpus.scale == float(chunks[0].abs().max()) * 1.02 / 7.0
    sims = corpus.qs.double() @ x.double().T
    tenth = sims.sort(dim=1, descending=True).values[:, 9:10]
    assert (sims.gather(1, torch.as_tensor(corpus.oracle)) >= tenth - 1e-6).all()
    assert all(len(set(r)) == 10 for r in corpus.oracle.tolist())


def test_build_refuses_a_tf32_oracle():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            int4_tier.build(100, CPU)
    finally:
        torch.set_float32_matmul_precision(old)


def test_tier_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "tier.json"
    assert int4_tier.main(["--device", "cpu", "--rows", "3000", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["probe"] for r in rows] == (["int4_deep_recall"] * 2
                                          + ["int4_candidate_recall"] * (len(rows) - 7)
                                          + ["int4_throughput"] * 4 + ["int8_ref_throughput"])
    assert [r["k"] for r in rows if r["probe"] == "int4_throughput"] == list(int4_tier.PERF_KS)
    assert all(r["vecs_per_ms"] == "not measured" for r in rows if "vecs_per_ms" in r)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == rows


# -- int4_check against scripts/probe_int4.py --------------------------------------

CHECK_N = 6000


@pytest.fixture(scope="module")
def jax_check():
    """scripts/probe_int4.py's statements before its 10M-row corpus, with
    ``n`` set to CHECK_N: (its plain top 10, its masked top 10, ok, okm)."""
    tree = ast.parse((REPO / "scripts" / "probe_int4.py").read_text())
    body = []
    for node in tree.body:
        target = getattr(node.targets[0], "id", None) if isinstance(node, ast.Assign) else None
        if target == "scale":
            break
        if target == "n":
            node.value = ast.copy_location(ast.Constant(CHECK_N), node.value)
        body.append(node)
    ns = {"__name__": "jax_probe_int4"}
    with contextlib.redirect_stdout(io.StringIO()), pltpu.force_tpu_interpret_mode():
        exec(compile(ast.Module(body=body, type_ignores=[]), "probe_int4.py", "exec"), ns)
    return np.asarray(ns["i_got"]), np.asarray(ns["i_m"]), ns["ok"], ns["okm"]


def test_int4_check_equals_the_jax_probe(jax_check):
    records, got = int4_check.check(CHECK_N, CPU)
    assert [(r["masked"], r["ok"]) for r in records] == [(False, True), (True, True)]
    i_got, i_m, ok, okm = jax_check
    assert ok and okm
    assert np.array_equal(got[0], i_got) and np.array_equal(got[1], i_m)


def test_int4_check_fails_on_a_wrong_answer(monkeypatch, capsys):
    real = int4_check.int4_topk_scan

    def shifted(*a, **kw):
        d, idx = real(*a, **kw)
        return d, idx.roll(1, dims=1)

    monkeypatch.setattr(int4_check, "int4_topk_scan", shifted)
    assert int4_check.main(["--device", "cpu", "--rows", "2000"]) == 1
    out = capsys.readouterr().out
    assert "mismatch q0" in out and '"ok": false' in out
