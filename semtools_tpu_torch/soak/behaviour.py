"""The JAX package's behavioural edge cases at the sizes where the port's
store routes through the card's kernels.

The suites ``tests/test_torch_{threshold_boundary,subset_device,
parallel_fused,native,device_cache}.py`` hold these cases on the CPU at tens
to hundreds of rows, where the kernels' own boundaries never fall among the
planted rows (one tile, one selection chunk). Here the same properties are
checked over a store of ``bg_rows`` background rows (``chip_smoke.py``'s
behaviour phase: 600,000 at d = 256, so the int8 scan's sub-tile selection
spans two chunks of ``ops.fused_scan.SELECT_CHUNK``):

- :func:`threshold_checks`: shells planted at THRESH + eps for each eps of
  EPS (12 rows each), below the int8 and int4 similarity error, in a store
  with and without freed slots ahead of its rows, served at top k 5 and 40
  by the int8, int4 and reduced tiers, and a dense cluster's top 10 on each:
  every served list must equal the f32-exact one (on a card with TF32 off);
- :func:`subset_checks`: a subset of the store's files served through the
  masked slot corpus (int8, int4) must equal the compact path (the subset's
  rows gathered and scanned in f32), also with a top k wider than the
  subset (each row once);
- :func:`sharded_checks`: ``parallel.scan.sharded_topk_fn`` with the fused
  kernels on 4 shards of one device must equal it without them, the
  single-device scan and the exact answer, with a planted best row in a
  ragged tail and an anti-aligned corpus whose pad rows would win if read;
  the sharded int8 scan must equal the single-device one, and the sharded
  threshold scan the single-device one;
- :func:`native_checks`: the native grep and tokenizer against their Python
  fallbacks;
- :func:`cache_checks`: ``device_cache.stats()`` after a warm search counts
  the slot corpus tensor's bytes.

Each check counts kernel launches (``ops.kernels.launch_counts``) before and
after itself, fails when a kernel it names did not launch (on a CUDA device;
CPU tensors run the plain versions, which count nothing), and returns a
record with its launches and wall seconds. Nothing here imports jax or the
JAX package.
"""

from __future__ import annotations

import contextlib
import os
import random
import re
import string
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

THRESH = 0.3
EPS = (-2e-2, -1e-2, -1e-3, -1e-4, 1e-4, 1e-3, 1e-2, 2e-2)
PER_SHELL = 12
TOPKS = (5, 40)
DIST_ATOL = 1e-5
FILE_ROWS = 10_000  # background rows a file: the subsets are sets of files
JUNK_ROWS = 4096  # freed slots ahead of the rows in the fragmented store
CLUSTER_ROWS = 3000
TINY_ROWS = 3  # the subset narrower than every top k checked

INT8 = ("int8_tilemax", "select_subtiles", "int8_rescan_topk")
INT8_MASKED = ("int8_tilemax_masked", "select_subtiles", "int8_rescan_topk_masked")
INT4 = ("int4_sims_max", "select_subtiles", "int4_cutoff_counts", "int4_extract_above")
INT4_MASKED = ("int4_sims_max_masked", "select_subtiles", "int4_cutoff_counts",
               "int4_extract_above")
F32 = ("fused_tilemax", "select_subtiles", "fused_rescan_topk")


@contextlib.contextmanager
def _env(**variables):
    """The process environment with ``variables`` set (None: unset), restored
    after."""
    old = {k: os.environ.get(k) for k in variables}
    try:
        for k, v in variables.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Launches:
    """Kernel launches made inside the block; ``check`` fails on a CUDA
    device when a named kernel is not among them."""

    def __init__(self, device: torch.device, names: Sequence[str], what: str):
        self.device, self.names, self.what = device, tuple(names), what
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        from semtools_tpu_torch.ops import kernels

        self._before = kernels.launch_counts()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from semtools_tpu_torch.ops import kernels

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self._t0
        after = kernels.launch_counts()
        self.counts = {k: v - self._before.get(k, 0) for k, v in after.items()
                       if v != self._before.get(k, 0)}
        if exc[0] is None and self.device.type == "cuda":
            missing = [k for k in self.names if not self.counts.get(k)]
            if missing:
                raise AssertionError(f"{self.what}: never launched {missing} "
                                     f"(launches {self.counts})")
        return False

    def record(self, **extra) -> dict:
        return {"check": self.what, "launches": self.counts,
                "seconds": round(self.seconds, 4), **extra}


def _exact_f32(device: torch.device) -> None:
    """Refuse an exact pass whose f32 products would run in TF32."""
    if device.type == "cuda" and (torch.get_float32_matmul_precision() != "highest"
                                  or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("the exact pass needs exact f32 products: TF32 is on")


def _unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _orthogonal(rng, q: np.ndarray, n: int) -> np.ndarray:
    o = rng.standard_normal((n, q.shape[0])).astype(np.float32)
    o -= np.outer(o @ q, q)
    return _unit(o)


class Corpus:
    """The behaviour store's documents, made from ``seed``: background rows
    near a ``dim // 5``-dimensional subspace (a decaying spectrum, as real
    embeddings have; the reduced rung's projection keeps it) in files of
    FILE_ROWS rows, the threshold shells around a random query ``q``, a dense
    cluster off the subspace with its query ``q_cluster``, and a tiny file."""

    def __init__(self, bg_rows: int, dim: int, seed: int):
        rng = np.random.default_rng(seed)
        self.dim = dim
        self.q = _unit(rng.standard_normal(dim).astype(np.float32))
        basis = rng.standard_normal((max(4, dim // 5), dim)).astype(np.float32)
        shells = []
        for eps in EPS:
            a = 1.0 - (THRESH + eps)  # the shell's cosine similarity
            shells.append(a * self.q + np.sqrt(1.0 - a * a) * _orthogonal(rng, self.q, PER_SHELL))
        center = rng.standard_normal(dim).astype(np.float32)
        cluster = _unit(center + 0.15 * np.linalg.norm(center) / np.sqrt(dim)
                        * rng.standard_normal((CLUSTER_ROWS, dim)).astype(np.float32))
        self.q_cluster = _unit(cluster[17] + 0.05 / np.sqrt(dim) * np.linalg.norm(cluster[17])
                               * rng.standard_normal(dim).astype(np.float32))
        docs: List[Tuple[str, np.ndarray]] = []
        for i, start in enumerate(range(0, bg_rows, FILE_ROWS)):
            n = min(FILE_ROWS, bg_rows - start)
            coef = rng.standard_normal((n, basis.shape[0])).astype(np.float32)
            docs.append((f"/bg{i:04d}.txt", _unit(
                coef @ basis + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))))
        half = len(docs) // 2  # the shells sit between the halves of the background
        docs.insert(half, ("/shells.txt", _unit(np.concatenate(shells))))
        docs.append(("/cluster.txt", cluster))
        docs.append(("/tiny.txt", _unit(rng.standard_normal((TINY_ROWS, dim)).astype(np.float32))))
        self.docs = docs
        self.junk = _unit(rng.standard_normal((JUNK_ROWS, dim)).astype(np.float32))
        self.paths = [p for p, _ in docs]
        self.rows = sum(len(rows) for _, rows in docs)

    def store(self, root: Path, device: torch.device, fragmented: bool):
        """A store of the documents (the freed junk slots ahead of them when
        ``fragmented``)."""
        from semtools_tpu_torch.store.store import Store

        s = Store(str(root), dim=self.dim, device=device)
        if fragmented:
            s.upsert_document_lines("/junk.txt", self.junk)
        s.upsert_documents_bulk([(p, rows, None) for p, rows in self.docs])
        if fragmented:
            s.delete_documents(["/junk.txt"])
        return s

    def exact(self, device: torch.device, q: np.ndarray, paths: Optional[Sequence[str]] = None):
        """(distance, (path, line)) of every row of ``paths`` (default all),
        ascending, ties to the earlier row: the f32-exact order, on the
        device with TF32 off."""
        _exact_f32(device)
        keep = set(self.paths if paths is None else paths)
        owner = [(p, i) for p, rows in self.docs if p in keep for i in range(len(rows))]
        e = torch.from_numpy(np.concatenate([r for p, r in self.docs if p in keep])).to(device)
        d = 1.0 - e @ torch.from_numpy(q).to(device)
        d, order = torch.sort(d, stable=True)
        return [(float(x), owner[i]) for x, i in zip(d.cpu().numpy(), order.cpu().numpy())]


def _same(what: str, served, want, exact) -> None:
    """``served`` (ranked lines) against ``want``, the exact order's answer
    (``[(distance, (path, line))]``): as many rows, each once, each at its
    exact distance, the distances in ``want``'s order, and every row among
    the exact rows no farther than ``want``'s last. Rows at one distance
    within DIST_ATOL (the planted shells' rows are equal up to f32 rounding)
    may come in either order; apart from such ties the lists are equal."""
    got = [(h.path, h.line_number) for h in served]
    dist = {key: d for d, key in exact}
    last = want[-1][0] + DIST_ATOL if want else -np.inf
    wrong = [k for k in got if k not in dist or dist[k] > last]
    if len(got) != len(want) or len(set(got)) != len(got) or wrong:
        raise AssertionError(f"{what}: served {got[:12]} ({len(got)}), exact "
                             f"{[w[1] for w in want][:12]} ({len(want)}); not in it: {wrong[:8]}")
    err = max([abs(h.distance - dist[k]) for h, k in zip(served, got)]
              + [abs(h.distance - w[0]) for h, w in zip(served, want)] + [0.0])
    if err > DIST_ATOL:
        raise AssertionError(f"{what}: distance error {err}")


def _tier_env(s, tier: str, n: int) -> dict:
    """The variables that put store ``s`` of ``n`` rows on ``tier``."""
    full = {"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": None, "SEMTOOLS_TPU_REDUCED_DIM": None}
    if tier == "int8":
        return {"SEMTOOLS_TPU_STORE_INT8": "1", "SEMTOOLS_TPU_STORE_INT4": None, **full}
    if tier == "int4":
        return {"SEMTOOLS_TPU_STORE_INT4": "1", "SEMTOOLS_TPU_STORE_INT8": None, **full}
    rd = s.dim // 4  # a budget under the int4 corpus, over the reduced one
    return {"SEMTOOLS_TPU_STORE_INT8": "1", "SEMTOOLS_TPU_STORE_INT4": "0",
            "SEMTOOLS_TPU_REDUCED_DIM": str(rd),
            "SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(s._slot_rows(n) * ((rd + 1 + s.dim // 2) // 2))}


def _int8_names(top_k: int) -> Tuple[str, ...]:
    """The int8 tier's kernels at ``top_k``: its first pool is
    ``Store._int8_oversample`` + the zero-slot slack, and the kernels take
    k <= 64 (the routing limit); a wider pool takes the plain scan."""
    from semtools_tpu_torch.ops.fused_scan import MAX_K
    from semtools_tpu_torch.store.patch_cache import _SLACK

    return INT8 if max(4 * top_k, 16) + _SLACK <= MAX_K else ()


def threshold_checks(corpus: Corpus, stores: dict, device: torch.device) -> List[dict]:
    """Threshold shells and the dense cluster's top 10 on the int8, int4 and
    reduced tiers, in the stores of ``stores`` (fragmented -> store: with
    and without freed slots ahead)."""
    from semtools_tpu_torch.store import device_cache

    records = []
    shells = corpus.exact(device, corpus.q)
    cluster = corpus.exact(device, corpus.q_cluster)
    for fragmented, s in stores.items():
        n = s.count_line_embeddings()
        try:
            for tier in ("int8", "int4", "reduced"):
                device_cache.invalidate()
                with _env(SEMTOOLS_TPU_SHARDED="0", **_tier_env(s, tier, n)):
                    name = s.serving_tier(n)
                    for top_k in TOPKS:
                        what = f"shells {tier} fragmented={fragmented} top_k={top_k}"
                        names = {"int8": _int8_names(top_k), "int4": INT4}.get(tier, ())
                        with _Launches(device, names, what) as run:
                            got = s.search_line_embeddings(corpus.q, corpus.paths, top_k=top_k,
                                                           max_distance=THRESH)
                        want = [w for w in shells[:top_k] if w[0] < THRESH]
                        _same(what, got, want, shells)
                        records.append(run.record(tier=name, rows=n, served=len(got)))
                    what = f"dense cluster {tier} fragmented={fragmented} top_k=10"
                    names = {"int8": _int8_names(10), "int4": INT4}.get(tier, ())
                    with _Launches(device, names, what) as run:
                        got = s.search_line_embeddings(corpus.q_cluster, corpus.paths, top_k=10)
                    _same(what, got, cluster[:10], cluster)
                    records.append(run.record(tier=name, rows=n, served=len(got)))
        finally:
            device_cache.invalidate()
    return records


def subset_checks(corpus: Corpus, s, device: torch.device) -> List[dict]:
    """Subsets of store ``s``'s files through the masked slot corpus (int8,
    int4) against the compact path, and a subset narrower than its top k."""
    from semtools_tpu_torch.store import device_cache

    bg = [p for p in corpus.paths if p.startswith("/bg")]
    subset = bg[::2] + ["/shells.txt", "/cluster.txt"]
    qs = np.stack([corpus.q, corpus.q_cluster])
    records = []
    n = s.count_line_embeddings()
    try:
        for tier, names in (("int8", INT8_MASKED), ("int4", INT4_MASKED)):
            device_cache.invalidate()
            with _env(SEMTOOLS_TPU_SHARDED="0", **_tier_env(s, tier, n)):
                name = s.serving_tier(n)
                for paths, top_k, what in ((subset, 10, f"subset {tier} {len(subset)} files"),
                                           (["/tiny.txt"], 20, f"tiny subset {tier} top_k=20")):
                    with _env(SEMTOOLS_TPU_SUBSET_DEVICE="0"):
                        ref = s.search_line_embeddings_batched(qs, paths, top_k)
                    with _env(SEMTOOLS_TPU_SUBSET_DEVICE="1"):
                        with _Launches(device, names, what) as run:
                            got = s.search_line_embeddings_batched(qs, paths, top_k)
                    for r, (g, w) in enumerate(zip(got, ref)):
                        exact = corpus.exact(device, qs[r], paths)
                        _same(f"{what} query {r} (compact path)", w, exact[:top_k], exact)
                        _same(f"{what} query {r}", g, exact[:top_k], exact)
                        keys = [(h.path, h.line_number) for h in g]
                        if len(keys) != len(set(keys)):
                            raise AssertionError(f"{what}: a row served twice")
                    records.append(run.record(tier=name, rows=n, served=[len(g) for g in got]))
    finally:
        device_cache.invalidate()
    return records


def _mesh4(device: torch.device):
    from semtools_tpu_torch.parallel.mesh import Mesh

    return Mesh((device,) * 4)


def _exact_topk(q: torch.Tensor, e: torch.Tensor, k: int):
    """The f32-exact top k of each query, ties to the lower row."""
    _exact_f32(e.device)
    d = 1.0 - q @ e.T
    d, i = torch.sort(d, dim=1, stable=True)
    return d[:, :k], i[:, :k]


def _equal(what: str, got, want, atol: float = DIST_ATOL) -> None:
    (gd, gi), (wd, wi) = got, want
    if not torch.equal(gi.cpu(), wi.cpu()):
        raise AssertionError(f"{what}: rows {gi[:, :8].tolist()} != {wi[:, :8].tolist()}")
    err = float((gd.cpu() - wd.cpu()).abs().max()) if gd.numel() else 0.0
    if err > atol:
        raise AssertionError(f"{what}: distance error {err}")


def sharded_checks(n_local: int, dim: int, device: torch.device, seed: int) -> List[dict]:
    """The sharded scans on 4 shards of ``device``: shards of ``n_local``
    rows and a ragged tail, fused kernels against the plain path, the
    single-device scan and the exact answer; pad rows, int8, threshold."""
    from semtools_tpu_torch.ops.int8_scan import int8_topk_scan, quantize_global
    from semtools_tpu_torch.ops.scan import threshold_scan, topk_scan
    from semtools_tpu_torch.parallel.mesh import shard_corpus
    from semtools_tpu_torch.parallel.scan import (
        sharded_int8_topk_scan_device,
        sharded_threshold_scan_device,
        sharded_topk_fn,
    )

    rng = np.random.default_rng(seed)
    mesh = _mesh4(device)
    n = 4 * n_local - 37  # the last shard ragged, and padded
    e = rng.standard_normal((n, dim)).astype(np.float32)
    q = _unit(rng.standard_normal((2, dim)).astype(np.float32))
    e[n - 5] = 0.98 * q[0] + 0.02 * e[0]  # the best row in the ragged tail
    e = _unit(e)
    et, qt = torch.from_numpy(e).to(device), torch.from_numpy(q).to(device)
    es, n_true = shard_corpus(et, mesh)
    records = []
    k = 10
    with _Launches(device, F32, "sharded f32 fused") as run:
        fused = sharded_topk_fn(mesh, k, es.n_local, fused=True)(qt, es, n_true)
    plain = sharded_topk_fn(mesh, k, es.n_local, fused=False)(qt, es, n_true)
    single = topk_scan(qt, et, k)
    exact = _exact_topk(qt, et, k)
    for what, other in (("fused=False", plain), ("single device", single), ("exact", exact)):
        _equal(f"sharded fused against {what}", fused, other)
    if int(fused[1][0, 0]) != n - 5:
        raise AssertionError("sharded fused: the ragged tail's best row was lost")
    records.append(run.record(rows=n, shards=4, n_local=es.n_local))

    # every row anti-aligned with the query: a pad row (sim 0) would win if read
    neg = _unit(-q[:1] + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))
    o = _orthogonal(rng, q[0], 1)[0]
    neg[n - 1] = _unit(0.999 * o - 0.045 * q[0])
    nt = torch.from_numpy(neg).to(device)
    ns, _ = shard_corpus(nt, mesh)
    with _Launches(device, F32, "sharded f32 pad rows") as run:
        got = sharded_topk_fn(mesh, 3, ns.n_local, fused=True)(qt[:1], ns, n)
    _equal("sharded pad rows against exact", got, _exact_topk(qt[:1], nt, 3))
    if int(got[1][0, 0]) != n - 1 or float(got[0][0, 0]) <= 1.0:
        raise AssertionError("sharded pad rows: a pad row crowded out the best row")
    records.append(run.record(rows=n, shards=4))

    e8, scale = quantize_global(et)
    e8s, _ = shard_corpus(e8, mesh)
    with _Launches(device, INT8, "sharded int8") as run:
        got = sharded_int8_topk_scan_device(qt, e8s, scale, k, n_true, mesh)
    _equal("sharded int8 against single device", got,
           int8_topk_scan(qt, e8, scale, k), atol=0.0)
    records.append(run.record(rows=n, shards=4))

    cut = float(exact[0][0, 5])  # a cut inside the top 10 of query 0
    with _Launches(device, (), "sharded threshold") as run:
        got = sharded_threshold_scan_device(qt[:1], es, n_true, cut, mesh)
    want = threshold_scan(qt[:1], et, cut)
    _equal("sharded threshold against single device", (got[0][None], got[1][None]),
           (want[0][None], want[1][None]))
    records.append(run.record(rows=n, shards=4, hits=int(got[1].numel())))
    return records


def _py_match_lines(path: str, pattern: str, ignore_case: bool) -> List[int]:
    from semtools_tpu_torch.utils.text import read_file_text, split_lines

    compiled = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    return [i for i, line in enumerate(split_lines(read_file_text(path)))
            if compiled.search(line)]


def native_checks(device: torch.device) -> List[dict]:
    """The native grep and tokenizer (``cpp/grepscan.cpp``, ``cpp/hashtok.cpp``
    as the port builds them) against their Python fallbacks: randomized
    literals, regexes, CRLF, an empty and a missing file, a bad regex, and
    randomized texts."""
    from semtools_tpu_torch.models.tokenizer import HashTokenizer, _native_encode_ascii_batch
    from semtools_tpu_torch.utils import grepscan, native

    if not native.available():
        raise AssertionError("native: the library did not build")
    checks = 0
    with _Launches(device, (), "native") as run, tempfile.TemporaryDirectory() as tmp:
        rng = random.Random(7)
        lines = ["".join(rng.choices(string.ascii_letters + string.digits + " .,()[]",
                                     k=rng.randint(0, 60))) for _ in range(2000)]
        rand = Path(tmp) / "rand.txt"
        rand.write_text("\n".join(lines) + "\n")
        crlf = Path(tmp) / "crlf.txt"
        crlf.write_bytes(b"alpha\r\nbeta\r\ngamma\n")
        empty = Path(tmp) / "empty.txt"
        empty.write_text("")
        cases = [(str(crlf), p, False) for p in ("beta$", "a", r"^g\w+")]
        cases.append((str(empty), "x", False))
        for _ in range(200):
            needle = re.escape("".join(rng.choices(string.ascii_letters + " ().",
                                                   k=rng.randint(1, 5))))
            cases += [(str(rand), needle, False), (str(rand), needle, True)]
        cases += [(str(rand), p, ic) for p in (r"\d+", r"\bab", r"[()]+", "a|b")
                  for ic in (False, True)]
        for path, pattern, ic in cases:
            if grepscan.match_lines(path, pattern, ic) != _py_match_lines(path, pattern, ic):
                raise AssertionError(f"native grep: {pattern!r} ignore_case={ic} on {path}")
            checks += 1
        for path, pattern in ((str(Path(tmp) / "nope.txt"), "x"), (str(rand), "(unclosed")):
            try:
                grepscan.match_lines(path, pattern, False)
            except ValueError:
                checks += 1
            else:
                raise AssertionError(f"native grep: {pattern!r} on {path} did not raise")
        tok = HashTokenizer()
        alphabet = string.ascii_letters + string.digits + string.punctuation + " \t\x1c\x1f\x0b"
        texts = ["", "   ", "abc", "abcd", "x" * 10000] + [
            "".join(rng.choices(alphabet, k=rng.randint(0, 120))) for _ in range(2000)]
        native_ids = _native_encode_ascii_batch(texts, tok.vocab_size, tok.ngram_min,
                                                tok.ngram_max)
        if [list(map(int, ids)) for ids in native_ids] != tok._encode_py_batch(texts):
            raise AssertionError("native tokenizer: ids differ from the Python fallback")
        checks += len(texts)
    return [run.record(checks=checks)]


def cache_checks(corpus: Corpus, s, device: torch.device) -> List[dict]:
    """After a warm whole-store search of store ``s``, ``device_cache.stats()``
    holds one entry of the slot corpus tensor's bytes, on each tier."""
    from semtools_tpu_torch.store import device_cache, patch_cache

    records = []
    n = s.count_line_embeddings()
    try:
        for tier in ("int8", "int4"):
            device_cache.invalidate()
            with _env(SEMTOOLS_TPU_SHARDED="0", **_tier_env(s, tier, n)):
                with _Launches(device, (), f"cache stats {tier}") as run:
                    s.search_line_embeddings(corpus.q, corpus.paths, top_k=5)
                    s.search_line_embeddings(corpus.q, corpus.paths, top_k=5)
                    entries, nbytes = device_cache.stats()
                corpus_t = patch_cache.get(s, tier).corpus
                want = corpus_t.numel() * corpus_t.element_size()
                if (entries, nbytes) != (1, want) or corpus_t.device.type != device.type:
                    raise AssertionError(f"cache stats {tier}: {(entries, nbytes)}, the corpus "
                                         f"holds {want} bytes on {corpus_t.device}")
                records.append(run.record(tier=tier, entries=entries, bytes=nbytes))
    finally:
        device_cache.invalidate()
    return records


def run_all(bg_rows: int, dim: int, device: torch.device, root: Path, seed: int = 16,
            n_local: Optional[int] = None) -> List[dict]:
    """Every check above, in turn, over one corpus of ``bg_rows`` background
    rows at ``dim``; the sharded checks over 4 shards of ``n_local`` rows
    (default a quarter of the store)."""
    corpus = Corpus(bg_rows, dim, seed)
    with _env(SEMTOOLS_TPU_SCAN="device", SEMTOOLS_TPU_FORCE_ANN=None,
              SEMTOOLS_TPU_SUBSET_DEVICE=None, SEMTOOLS_TPU_TOPK_MARGIN_SIGMAS=None,
              SEMTOOLS_TPU_INT4_CAP=None, SEMTOOLS_TPU_INT4_MARGIN_SIGMAS=None):
        stores = {f: corpus.store(root / f"store_{int(f)}", device, f) for f in (False, True)}
        try:
            records = threshold_checks(corpus, stores, device)
            records += subset_checks(corpus, stores[False], device)
            records += cache_checks(corpus, stores[False], device)
        finally:
            for s in stores.values():
                s.close()
        records += sharded_checks(n_local or corpus.rows // 4, dim, device, seed)
        records += native_checks(device)
    return records
