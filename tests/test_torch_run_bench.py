"""The port's BASELINE matrix driver (``semtools_tpu_torch.probes.run_bench``)
and corpus generator against the JAX package's
``benchmarks/quantitative/run_bench.py`` and ``gen_corpus.py``, on the CPU.

The JAX driver runs unmodified in child processes (``SEMTOOLS_TPU_PLATFORM=
cpu``), loaded by path; a few of its library calls are wrapped to record what
they returned (the search hits, the batched scan's inputs, the threshold
extract's counts), and the port's driver writes the same answers
(``--answers``). Children run at once, one BLAS/OpenMP thread each, each with
its own ``HOME``, with no ``SEMTOOLS_*`` or ``XLA_FLAGS`` of this process.

- ``gen_corpus``: byte-equal files at ``--small``'s 20 x 50.
- ``--small`` over ``search_e2e``, ``batched_scan``, ``batched_threshold``,
  ``workspace_warm``, ``workspace_batched``, ``line_reuse`` and
  ``subset_warm``: every key that is not a time equal; the ``search_e2e``
  hits (files, lines, context spans; distances within ``ATOL``, the
  tolerance of ``tests/test_torch_search.py``), the batched top-k indices
  (same order, ties to the lower index; distances within ``ATOL``), every
  query's threshold hit count, and the warm workspace hits.
- ``sharded_scan``: 4 forced host devices for JAX, 4 virtual shards for the
  port: ``devices`` and ``queries`` equal; the port's record says its answer
  equals the single-device scan (the driver checks it). With one device both
  print the ``skipped`` record.
- ``ivfpq_recall`` and ``tier_recall`` (F1: the JAX IVF-PQ build pads a
  chunk to ``max(8192, 2**25 // nlist)`` rows and makes a ``[chunk, 32,
  256]`` f32 tensor, ~2.1 GB at 20,000 rows): in the JAX child only,
  ``IvfPqIndex.build`` is a stub that records its arguments and the caller's
  queries and parameters, then raises; the child catches that one
  exception. The int8 and reduced rows of ``tier_recall`` come before the
  build, so they run whole. Corpora (``bench_ivfpq``'s inline mixture and
  ``_clustered_corpus``) byte-equal, queries equal, nlist, nprobe, m, the
  training iterations, ``keep_vectors`` and the oversample equal, and the
  int8 and reduced rows' recall equal. The port's IVF-PQ rows run whole at
  20,000 rows, held to the floors below.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from semtools_tpu_torch.probes import run_bench

REPO = Path(__file__).resolve().parents[1]
QUANT = REPO / "benchmarks" / "quantitative"
ATOL = 1e-5
ROWS = 20_000  # --small's IVF-PQ and tier corpus
# The port's IVF-PQ at --small (20,000 rows, 512 centres: ~39 rows a
# centre; nlist 512, nprobe 32). ivfpq_recall keeps the vectors and
# re-ranks 16k candidates exactly: the 20 queries reach 1.0 on the CPU; the
# floor leaves a margin of two hits of 200 for k-means on another machine.
# tier_recall's ivf-pq-host row serves ADC distances of 32 one-byte codes a
# row with no re-rank (the store's build keeps no vectors): 0.62 on the CPU
# (10 queries); the floor 0.5 catches a broken codebook or probe, which
# falls to near 0 (10 of 20,000 rows by chance).
IVFPQ_RECALL_FLOOR = 0.99
IVF_HOST_RECALL_FLOOR = 0.5

MAIN_CONFIGS = ("search_e2e,batched_scan,batched_threshold,workspace_warm,"
                "workspace_batched,line_reuse,subset_warm,sharded_scan")
EQUAL_KEYS = ("files", "hits", "n_chunks", "k", "max_hits", "q", "total_lines", "n",
              "subset_rows", "tier", "max_distance", "metric")

# Loads the JAX driver by path and records what its library calls return;
# no socket leaves the machine (the model lookup never fetches: NO_FETCH).
_JAX_MAIN = f"""
import importlib.util, inspect, json, sys
import numpy as np
spec = importlib.util.spec_from_file_location("run_bench", {str(QUANT / "run_bench.py")!r})
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
import jax.numpy as jnp
import semtools_tpu.ops.scan as scan_mod
import semtools_tpu.search as S
answers = {{}}
out_path = sys.argv[1]
sys.argv = [sys.argv[0]] + sys.argv[2:]

_search_files = S.search_files
def search_files(*a, **k):
    out = _search_files(*a, **k)
    answers["search_e2e"] = [[r.filename, r.match_line, r.start, r.end, float(r.distance)]
                             for r in out]
    return out
S.search_files = search_files

def _recording(fn, key):
    sig = inspect.signature(fn)
    def wrapped(*a, **k):
        out = fn(*a, **k)
        name = sig.bind(*a, **k).arguments.get("workspace_name")
        answers.setdefault(key, {{}}).setdefault(name, []).append(out)
        return out
    return wrapped
S.search_with_workspace = _recording(S.search_with_workspace, "single")
S.search_with_workspace_batched = _recording(S.search_with_workspace_batched, "batched")

_bench_batched_scan = m.bench_batched_scan
def bench_batched_scan(results, **kw):
    seen = []
    _asarray = jnp.asarray
    def grab(x, *a, **k):
        if isinstance(x, np.ndarray):
            seen.append(x)
        return _asarray(x, *a, **k)
    jnp.asarray = grab
    try:
        _bench_batched_scan(results, **kw)
    finally:
        jnp.asarray = _asarray
    e, qq = seen[0], seen[1]
    d, i = scan_mod.chunk_for_shape(e.shape[0])(jnp.asarray(qq), jnp.asarray(e), 0,
                                                e.shape[0], k=10)
    answers["batched_scan"] = {{"indices": np.asarray(i).tolist(),
                               "distances": np.asarray(d).tolist()}}
m.bench_batched_scan = bench_batched_scan

_extract = scan_mod._batched_threshold_extract
def extract(*a, **k):
    out = _extract(*a, **k)
    answers.setdefault("batched_threshold", np.asarray(out[0]).tolist())
    return out
extract.__wrapped__ = _extract.__wrapped__
scan_mod._batched_threshold_extract = extract

m.main()

def hits(rows):
    return [[h.path, h.line_number, float(h.distance)] for h in rows]
single, batched = answers.pop("single"), answers.pop("batched")
answers["workspace_warm"] = hits(single["bench_ws"][-1])
answers["workspace_batched"] = [hits(r) for r in batched["bench_ws_batched"][-1]]
answers["line_reuse"] = [[[h.line_number, float(h.distance)] for h in r]
                         for r in single["bench_line_reuse"][-2:]]
json.dump(answers, open(out_path, "w"))
"""

# The IVF-PQ rows with the JAX build stubbed (F1), in this child only.
_JAX_IVF = f"""
import importlib.util, json, sys
import numpy as np
spec = importlib.util.spec_from_file_location("run_bench", {str(QUANT / "run_bench.py")!r})
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
from semtools_tpu.utils.platform import configure_jax
configure_jax()
from semtools_tpu.index.ivf_pq import IvfPqIndex

class BuildStubbed(Exception):
    pass

captured = {{}}
def build(cls, x, nlist=256, m=32, train_iters=10, seed=0, keep_vectors=True, **kw):
    caller = sys._getframe(1)
    captured[caller.f_code.co_name] = dict(
        e=np.asarray(x), qq=np.asarray(caller.f_locals["qq"]), nlist=nlist,
        nprobe=caller.f_locals["nprobe"], m=m, train_iters=train_iters,
        keep_vectors=keep_vectors)
    raise BuildStubbed
IvfPqIndex.build = classmethod(build)

results = []
for fn, kw in ((m.bench_ivfpq, dict(n={ROWS}, n_queries=20)),
               (m.bench_tier_recall, dict(n={ROWS}, n_queries=10))):
    try:
        fn(results, **kw)
    except BuildStubbed:
        pass
out = sys.argv[1]
arrays = {{}}
params = {{}}
for name, c in captured.items():
    arrays[name + "_e"] = c.pop("e")
    arrays[name + "_qq"] = c.pop("qq")
    params[name] = c
np.savez(out + ".npz", **arrays)
json.dump({{"results": results, "params": params}}, open(out + ".json", "w"))
"""


def _env(home: Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMTOOLS_") and k != "XLA_FLAGS"}
    env.update(HOME=str(home), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1", SEMTOOLS_TPU_NO_FETCH="1",
               SEMTOOLS_TPU_ALLOW_FALLBACK="1", **extra)
    return env


def _jax_env(home: Path, **extra) -> dict:
    # the reference's timed scan and embed routes pinned to the device (the
    # port's only route; a loaded host could send a cold store to the host)
    return _env(home, SEMTOOLS_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu",
                SEMTOOLS_TPU_SCAN="device", SEMTOOLS_TPU_EMBED="device", **extra)


def _spawn(argv, env):
    return subprocess.Popen(argv, cwd=str(REPO), env=env, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _lines(proc) -> list:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _port(*args, env, tmp: Path, tag: str):
    return _spawn([sys.executable, "-m", "semtools_tpu_torch.probes.run_bench", "--small",
                   "--device", "cpu", *args, "--out", str(tmp / f"{tag}.jsonl"),
                   "--answers", str(tmp / f"{tag}.answers.json")], env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run_bench")
    homes = {}
    for tag in ("jax", "jax_ivf", "jax_sharded", "port", "port_ivf", "port_tier",
                "port_sharded"):
        homes[tag] = tmp / f"home_{tag}"
        homes[tag].mkdir()
    procs = {
        "jax": _spawn([sys.executable, "-c", _JAX_MAIN, str(tmp / "jax.answers.json"),
                       "--small", "--configs", MAIN_CONFIGS], _jax_env(homes["jax"])),
        "jax_ivf": _spawn([sys.executable, "-c", _JAX_IVF, str(tmp / "jax_ivf")],
                          _jax_env(homes["jax_ivf"])),
        "jax_sharded": _spawn(
            [sys.executable, str(QUANT / "run_bench.py"), "--small", "--configs", "sharded_scan"],
            _jax_env(homes["jax_sharded"], XLA_FLAGS="--xla_force_host_platform_device_count=4")),
        "port": _port("--configs", MAIN_CONFIGS, env=_env(homes["port"]), tmp=tmp, tag="port"),
        "port_ivf": _port("--configs", "ivfpq_recall", env=_env(homes["port_ivf"]), tmp=tmp,
                          tag="port_ivf"),
        "port_tier": _port("--configs", "tier_recall", env=_env(homes["port_tier"]), tmp=tmp,
                           tag="port_tier"),
        "port_sharded": _port("--configs", "sharded_scan",
                              env=_env(homes["port_sharded"], SEMTOOLS_TORCH_VIRTUAL_DEVICES="4"),
                              tmp=tmp, tag="port_sharded"),
    }
    try:
        lines = {tag: _lines(p) for tag, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    ivf = json.loads((tmp / "jax_ivf.json").read_text())
    with np.load(tmp / "jax_ivf.npz") as z:
        ivf["arrays"] = dict(z)
    answers = {tag: json.loads((tmp / f"{tag}.answers.json").read_text())
               for tag in ("jax", "port")}
    return lines, ivf, answers


def _record(records, config, tier=None):
    (r,) = [r for r in records if r["config"] == config and "skipped" not in r
            and (tier is None or r["tier"] == tier)]
    return r


def test_gen_corpus_byte_equal(tmp_path):
    subprocess.run([sys.executable, str(QUANT / "gen_corpus.py"), str(tmp_path / "jax"),
                    "--files", "20", "--lines", "50"], check=True, cwd=str(REPO),
                   env=_env(tmp_path), stdout=subprocess.DEVNULL, timeout=120)
    from semtools_tpu_torch.probes.gen_corpus import gen_corpus

    paths = gen_corpus(tmp_path / "port", 20, 50, seed=0)
    want = sorted((tmp_path / "jax").iterdir())
    assert [p.name for p in paths] == [p.name for p in want]
    for got, ref in zip(paths, want):
        assert got.read_bytes() == ref.read_bytes(), got.name


@pytest.mark.parametrize("config", ["search_e2e", "batched_scan", "batched_threshold",
                                    "workspace_warm", "workspace_batched", "line_reuse_edit",
                                    "subset_warm"])
def test_keys_equal(runs, config):
    lines, _, _ = runs
    want, have = _record(lines["jax"], config), _record(lines["port"], config)
    keys = set(want) - {"extract_size"}
    assert keys <= set(have), sorted(keys - set(have))
    assert "extract_size" not in have
    for key in EQUAL_KEYS:
        if key in want:
            assert have[key] == want[key], (key, have[key], want[key])
    assert have["device"] == "cpu" and have["launches"] == {}  # plain versions: nothing launched


def test_search_e2e_hits(runs):
    _, _, answers = runs
    want, have = answers["jax"]["search_e2e"], answers["port"]["search_e2e"]
    assert len(have) == len(want) == 3
    for (wf, wl, ws, we, wd), (hf, hl, hs, he, hd) in zip(want, have):
        assert (Path(hf).name, hl, hs, he) == (Path(wf).name, wl, ws, we)
        assert abs(hd - wd) <= ATOL


def test_batched_scan_topk(runs):
    _, _, answers = runs
    want, have = answers["jax"]["batched_scan"], answers["port"]["batched_scan"]
    assert have["indices"] == want["indices"]
    np.testing.assert_allclose(have["distances"], want["distances"], atol=ATOL, rtol=0)


def test_batched_threshold_counts(runs):
    _, _, answers = runs
    want, have = answers["jax"]["batched_threshold"], answers["port"]["batched_threshold"]
    assert len(have) == 100 and have == want


@pytest.mark.parametrize("config", ["workspace_warm", "workspace_batched", "line_reuse"])
def test_workspace_hits(runs, config):
    _, _, answers = runs
    want, have = answers["jax"][config], answers["port"][config]

    def norm(rows):
        if rows and isinstance(rows[0], list) and rows[0] and isinstance(rows[0][0], list):
            return [norm(r) for r in rows]
        return [[Path(r[0]).name if isinstance(r[0], str) else r[0], *r[1:-1]] for r in rows]

    def dists(rows):
        if rows and isinstance(rows[0], list) and rows[0] and isinstance(rows[0][0], list):
            return [d for r in rows for d in dists(r)]
        return [r[-1] for r in rows]

    assert norm(have) == norm(want)
    np.testing.assert_allclose(dists(have), dists(want), atol=ATOL, rtol=0)


def test_sharded_scan(runs):
    lines, _, _ = runs
    want = _record(lines["jax_sharded"], "sharded_scan")
    have = _record(lines["port_sharded"], "sharded_scan")
    assert (have["devices"], have["queries"]) == (want["devices"], want["queries"]) == (4, 8)
    assert have["matches_single_device"] and have["virtual_shards_of_one_card"]
    for tag in ("jax", "port"):  # one device: the skipped record
        assert {"config": "sharded_scan", "skipped": "single device"} in lines[tag]


def test_ivf_corpora_and_parameters(runs):
    _, ivf, _ = runs
    arrays, params = ivf["arrays"], ivf["params"]
    for fn, nq in (("bench_ivfpq", 20), ("bench_tier_recall", 10)):
        e, qq = run_bench._clustered_corpus(ROWS, 256, nq)
        assert arrays[f"{fn}_e"].tobytes() == e.tobytes()
        assert arrays[f"{fn}_qq"].tobytes() == qq.tobytes()
        nlist, nprobe = run_bench.ivf_parameters(ROWS)
        p = params[fn]
        assert (p["nlist"], p["nprobe"], p["m"], p["train_iters"]) == (nlist, nprobe, 32, 8)
        assert p["keep_vectors"] == (fn == "bench_ivfpq")


def test_ivf_records_parameters(runs):
    lines, ivf, _ = runs
    params = ivf["params"]
    rec = _record(lines["port_ivf"], "ivfpq_recall")
    assert (rec["nlist"], rec["nprobe"], rec["n"]) == (params["bench_ivfpq"]["nlist"],
                                                      params["bench_ivfpq"]["nprobe"], ROWS)
    host = _record(lines["port_tier"], "tier_recall", "ivf-pq-host")
    assert (host["nlist"], host["nprobe"]) == (params["bench_tier_recall"]["nlist"],
                                               params["bench_tier_recall"]["nprobe"])


@pytest.mark.parametrize("tier", ["int8-full", "reduced-int8-64d", "reduced-int8-32d"])
def test_tier_recall_rows_equal(runs, tier):
    lines, ivf, _ = runs
    (want,) = [r for r in ivf["results"] if r.get("tier") == tier]
    have = _record(lines["port_tier"], "tier_recall", tier)
    for key in ("value", "n", "oversample", "bytes_per_row", "metric"):
        assert have[key] == want[key], (key, have[key], want[key])


def test_port_ivf_rows_whole(runs):
    lines, _, _ = runs
    rec = _record(lines["port_ivf"], "ivfpq_recall")
    assert rec["value"] >= IVFPQ_RECALL_FLOOR, rec
    assert rec["build_seconds"] > 0 and rec["speedup_vs_exact"] > 0
    host = _record(lines["port_tier"], "tier_recall", "ivf-pq-host")
    assert host["value"] >= IVF_HOST_RECALL_FLOOR, host
    assert host["bytes_per_row"] == 32 and host["n"] == ROWS
