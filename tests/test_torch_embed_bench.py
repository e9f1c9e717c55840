"""The port's embed drivers (``semtools_tpu_torch.probes.embed_baseline`` and
``.embed_variants``) against the JAX package's
``benchmarks/quantitative/bench_embed_baseline.py`` and
``bench_embed_variants.py``, on the CPU, at 2^12 tokens over 2^8 lines.

- baseline: the JAX module, loaded by path in a child with ``TOKENS`` and
  ``LINES`` set, runs its ``main`` (its records) and writes its
  ``_workload``; the port's driver runs beside it with ``--device cpu``. The
  workloads are byte-equal, every JAX key is in the port's records with the
  same ``impl`` rows, and the numpy baseline, the torch baseline and the
  port's embed agree within ``TOL`` (the driver's own check, and its
  ``max_abs_err``).
- variants: the JAX driver's variants are nested in its ``main`` and return
  one element each (what its timing loop folds); a child takes
  ``gather_only``, ``full_f32``, ``fused_counts`` and ``full_bf16`` out of
  the source with ``ast``, with the final ``return`` given the whole array
  (``rows`` for the gather, ``emb`` for the others), and runs them on the
  port's seeded inputs; ``seg_only``'s op is its
  ``jax.ops.segment_sum(..., num_segments=LINES + 1, indices_are_sorted=True)``
  called directly. Each port variant equals the JAX one within ``TOL``; the
  bf16 variant too (both round the same table to bf16, then compute in
  f32). The port's driver runs whole on the CPU: every variant against
  ``full_f32`` within its stated tolerances, nothing timed.
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

from semtools_tpu_torch.probes import embed_baseline, embed_variants

REPO = Path(__file__).resolve().parents[1]
QUANT = REPO / "benchmarks" / "quantitative"
TOKENS, LINES = 1 << 12, 1 << 8
TOL = 1e-5

_JAX_BASELINE = f"""
import importlib.util, sys
import numpy as np
spec = importlib.util.spec_from_file_location("bench_embed_baseline",
                                              {str(QUANT / "bench_embed_baseline.py")!r})
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.TOKENS, m.LINES = {TOKENS}, {LINES}
table, ids, segs = m._workload()
np.savez(sys.argv[1], table=table, ids=ids, segs=segs)
m.main()
"""

_JAX_VARIANTS = f"""
import ast, sys
import numpy as np
import jax, jax.numpy as jnp
src = open({str(QUANT / "bench_embed_variants.py")!r}).read()
(main,) = [n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name == "main"]
keep = {{"gather_only": "rows", "full_f32": "emb", "fused_counts": "emb", "full_bf16": "emb"}}
defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in keep]
for fn in defs:
    assert isinstance(fn.body[-1], ast.Return)
    fn.body[-1].value = ast.Name(id=keep[fn.name], ctx=ast.Load())
module = ast.fix_missing_locations(ast.Module(body=defs, type_ignores=[]))
ns = dict(jax=jax, jnp=jnp, DIM=256, VOCAB=1 << 16, LINES={LINES})
exec(compile(module, "bench_embed_variants.py", "exec"), ns)
with np.load(sys.argv[1]) as z:
    table, ids, segs, w = (jnp.asarray(z[k]) for k in ("table", "ids", "segs", "w"))
out = {{name: np.asarray(ns[name](ids, table.astype(jnp.bfloat16) if name == "full_bf16"
                                  else table, segs, w).astype(jnp.float32))
       for name in keep}}
out["seg_only"] = np.asarray(jax.ops.segment_sum(
    jnp.ones(({TOKENS}, 256), jnp.float32), segs, num_segments={LINES} + 1,
    indices_are_sorted=True))
np.savez(sys.argv[2], **out)
"""


def _env(home: Path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMTOOLS_") and k != "XLA_FLAGS"}
    env.update(HOME=str(home), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return env


def _spawn(argv, env):
    return subprocess.Popen(argv, cwd=str(REPO), env=env, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _lines(proc) -> list:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("embed")
    env = _env(tmp)
    table, ids, segs, w = embed_variants.workload(TOKENS, LINES)
    np.savez(tmp / "inputs.npz", table=table, ids=ids, segs=segs, w=w)
    size = ["--tokens", str(TOKENS), "--lines", str(LINES), "--device", "cpu"]
    procs = {
        "jax_baseline": _spawn([sys.executable, "-c", _JAX_BASELINE,
                                str(tmp / "jax_workload.npz")], env),
        "jax_variants": _spawn([sys.executable, "-c", _JAX_VARIANTS, str(tmp / "inputs.npz"),
                                str(tmp / "jax_variants.npz")], env),
        "port_baseline": _spawn([sys.executable, "-m", "semtools_tpu_torch.probes.embed_baseline",
                                 *size], env),
        "port_variants": _spawn([sys.executable, "-m", "semtools_tpu_torch.probes.embed_variants",
                                 *size], env),
    }
    try:
        lines = {tag: _lines(p) for tag, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    with np.load(tmp / "jax_workload.npz") as z:
        workload = dict(z)
    with np.load(tmp / "jax_variants.npz") as z:
        variants = dict(z)
    return lines, workload, variants, (table, ids, segs, w)


def test_baseline_workload_byte_equal(runs):
    _, workload, _, _ = runs
    table, ids, segs = embed_baseline._workload(tokens=TOKENS, lines=LINES)
    for name, arr in (("table", table), ("ids", ids), ("segs", segs)):
        assert workload[name].dtype == arr.dtype and workload[name].tobytes() == arr.tobytes()


@pytest.mark.parametrize("impl", ["numpy-reduceat", "torch-embedding-bag"])
def test_baseline_records(runs, impl):
    lines, _, _, _ = runs
    (want,) = [r for r in lines["jax_baseline"] if r["impl"] == impl]
    (have,) = [r for r in lines["port_baseline"] if r["impl"] == impl]
    assert set(want) <= set(have)
    for key in ("config", "metric", "tokens", "lines", "dim", "cores_available"):
        assert have[key] == want[key], key
    assert have["device"] == "cpu"


def test_baseline_three_encodes_agree(runs):
    lines, _, _, _ = runs
    port = {r["impl"]: r for r in lines["port_baseline"]}
    assert set(port) == {"numpy-reduceat", "torch-embedding-bag", "port-embed"}
    for impl in ("torch-embedding-bag", "port-embed"):
        assert port[impl]["max_abs_err"] <= TOL, port[impl]
    assert port["port-embed"]["launches"] == {}


def _port_variant(name, table, ids, segs, w):
    tab, t_ids = torch.from_numpy(table), torch.from_numpy(ids).long()
    t_segs, t_w = torch.from_numpy(segs).long(), torch.from_numpy(w)
    if name == "seg_only":
        return embed_variants.seg_only(torch.ones((TOKENS, 256)), t_segs, LINES)
    if name == "full_bf16":
        tab = tab.to(torch.bfloat16)
    return getattr(embed_variants, name)(t_ids, tab, t_segs, t_w, LINES).float()


@pytest.mark.parametrize("name", ["gather_only", "seg_only", "full_f32", "fused_counts",
                                  "full_bf16"])
def test_variant_equals_jax(runs, name):
    _, _, variants, inputs = runs
    got = _port_variant(name, *inputs).numpy()
    want = variants[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_embedding_bag_equals_jax_full_f32(runs):
    _, _, variants, (table, ids, segs, w) = runs
    offsets = torch.from_numpy(np.searchsorted(segs, np.arange(LINES)))
    counts = torch.from_numpy(np.bincount(segs, minlength=LINES).astype(np.float32))
    got = embed_variants.embedding_bag(torch.from_numpy(ids).long(), torch.from_numpy(table),
                                       offsets, counts).numpy()
    np.testing.assert_allclose(got, variants["full_f32"][:LINES], atol=TOL, rtol=0)


def test_variants_driver_record(runs):
    lines, _, _, _ = runs
    (rec,) = lines["port_variants"]
    for key in ("gather_only_ms", "segment_sum_only_ms", "full_f32_ms", "full_f32_lines_per_s",
                "fused_counts_ms", "fused_counts_lines_per_s", "full_bf16_ms",
                "full_bf16_lines_per_s", "tokens", "lines", "gather_gbps_f32"):
        assert key in rec, key
    assert (rec["tokens"], rec["lines"], rec["device"]) == (TOKENS, LINES, "cpu")
    assert rec["full_f32_ms"] == "not measured"  # nothing is timed off the card
    errs = rec["max_abs_err"]
    assert errs.pop("full_bf16") <= embed_variants.BF16_TOL
    assert all(v <= embed_variants.TOL for v in errs.values()), errs
