"""The IVF-PQ tier of the port's workspace store against the JAX package's.

Every case of ``tests/test_ann_store.py`` on the port's ``Store`` (on the
CPU): force build and freshness, the incremental reconcile (tombstones and
the delta), the drift bound, the mid-build snapshot, the torn publish and
its negative cache, the tmp sweep and the failed-build cleanup, the legacy
tokenless pair, reopen, the candidate depth, a dim not divisible by 32,
large-k probing, the tiny corpus and ``SEMTOOLS_TPU_ANN_NPROBE``. The
``_ann_build_backend`` cost-model cases are not ported: that cost model is on
the port's do-not-port list (the port builds on the store's device, or on
the CPU under ``SEMTOOLS_TPU_ANN_BUILD=host``, which is tested here).

Across packages: an index either package builds is served by the other
with the hits of the package that built it (paths and lines equal,
distances within 1e-6), a
mutation by one is reconciled by the other, and ``workspace index`` prints
the JAX CLI's text and ``--json`` (the forced build against the JAX CLI's
format strings: the JAX CLI runs out of memory building a 30-line
workspace). Brute-force
checks hold distances within 3e-4, as the JAX tests do.
"""

from __future__ import annotations

import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from semtools_tpu import cli as jax_cli
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch import cli as torch_cli
from semtools_tpu_torch.index import ivf_pq
from semtools_tpu_torch.index.ivf_pq import IvfPqIndex
from semtools_tpu_torch.store.store import Store as TorchStore


def Store(path, dim=32):  # noqa: N802 - the JAX tests' constructor, on the CPU
    return TorchStore(path, dim=dim, device="cpu")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SEMTOOLS_TPU_FORCE_ANN", "SEMTOOLS_TPU_ANN_NPROBE", "SEMTOOLS_TPU_ANN_BUILD",
                "SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_STORE_INT4", "SEMTOOLS_WORKSPACE",
                "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_TPU_SCAN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")


def _unit(rng, n, d=32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture()
def store(tmp_path):
    s = Store(str(tmp_path / "ws"), dim=32)
    yield s
    s.close()


def _fill(store, rng, n_docs=6, lines_per_doc=40):
    for i in range(n_docs):
        store.upsert_document_lines(f"/doc{i}.txt", _unit(rng, lines_per_doc))
    return [f"/doc{i}.txt" for i in range(n_docs)]


class TestAnnTier:
    def test_below_threshold_no_build(self, store):
        rng = np.random.default_rng(0)
        _fill(store, rng)
        assert store.build_ann_index() is None  # 240 lines << threshold
        assert store.get_stats().index_type == "exact-mxu-scan"

    def test_force_build_and_fresh(self, store, monkeypatch):
        rng = np.random.default_rng(1)
        _fill(store, rng)
        index = store.build_ann_index(force=True)
        assert index is not None
        assert store._ann_current() is not None
        # a capacity tier: fresh but NOT serving a corpus that fits on-device
        assert store.get_stats().index_type == "exact-mxu-scan"
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        assert store.get_stats().index_type == "ivf-pq"
        assert store.build_ann_index(force=True) is not None  # reuses the fresh index

    def test_mutation_reconciles_incrementally(self, store, monkeypatch):
        rng = np.random.default_rng(2)
        paths = _fill(store, rng)
        store.build_ann_index(force=True)
        store.upsert_document_lines("/new.txt", _unit(rng, 10))
        assert not store._ann_generation_matches()
        state = store._ann_current()
        assert state is not None and len(state[4]) == 10  # delta rows
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        assert store.get_stats().index_type == "ivf-pq"
        monkeypatch.delenv("SEMTOOLS_TPU_FORCE_ANN")
        assert store.get_stats().index_type == "exact-mxu-scan"
        store.build_ann_index(force=True)
        store.delete_line_embeddings([paths[0]])
        state = store._ann_current()
        assert state is not None and len(state[2]) >= 1  # tombstone ranges

    def test_ann_search_matches_exact_on_clustered_data(self, store, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        rng = np.random.default_rng(3)
        centers = _unit(rng, 8)
        paths = []
        for i in range(8):
            rows = centers[i] + 0.05 * rng.standard_normal((50, 32)).astype(np.float32)
            rows /= np.linalg.norm(rows, axis=1, keepdims=True)
            store.upsert_document_lines(f"/c{i}.txt", rows)
            paths.append(f"/c{i}.txt")
        store.build_ann_index(force=True)
        got = store.search_line_embeddings(centers[2], paths, top_k=5)
        assert all(rl.path == "/c2.txt" for rl in got)
        dists = [rl.distance for rl in got]
        assert dists == sorted(dists)

    def test_subset_query_uses_exact_scan(self, store, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        rng = np.random.default_rng(4)
        paths = _fill(store, rng)
        store.build_ann_index(force=True)
        q = _unit(rng, 1)[0]
        got = store.search_line_embeddings(q, paths[:2], top_k=3)
        assert all(rl.path in paths[:2] for rl in got)

    def test_ann_respects_max_distance(self, store, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        rng = np.random.default_rng(5)
        paths = _fill(store, rng)
        store.build_ann_index(force=True)
        q = _unit(rng, 1)[0]
        got = store.search_line_embeddings(q, paths, top_k=10, max_distance=0.5)
        assert all(rl.distance < 0.5 for rl in got)


class TestAnnPublishIntegrity:
    def test_mid_build_mutation_stamps_prebuild_snapshot(self, store, monkeypatch):
        """A mutation landing during the build reads as build->current
        drift afterwards: the meta carries the PRE-build snapshot."""
        rng = np.random.default_rng(10)
        paths = _fill(store, rng)
        real_build = IvfPqIndex.build
        mutated = []

        def build_with_mutation(x, **kw):
            if not mutated:
                mutated.append(True)
                store.upsert_document_lines(paths[0], _unit(rng, 40))
            return real_build(x, **kw)

        monkeypatch.setattr(IvfPqIndex, "build", staticmethod(build_with_mutation))
        store.build_ann_index(force=True)
        assert not store._ann_generation_matches()
        state = store._ann_current()
        assert state is not None
        assert len(state[4]) == 40  # the delta re-encodes the rewritten doc

    def test_torn_publish_rejected(self, store):
        rng = np.random.default_rng(11)
        paths = _fill(store, rng)
        store.build_ann_index(force=True)
        _, meta_path = store._ann_paths()
        with np.load(meta_path, allow_pickle=False) as z:
            m = {k: np.array(z[k]) for k in z.files}
        assert "build_token" in m
        m["build_token"] = np.int64(int(m["build_token"]) + 1)
        np.savez(meta_path, **m)
        store._ann_disk_cache = store._ann_meta_cache = store._ann_cache = None
        assert store._ann_load_meta() is None
        assert store._ann_meta_light() is None
        assert not store._ann_available()
        got = store.search_line_embeddings(_unit(rng, 1)[0], paths, top_k=3)
        assert len(got) == 3  # the exact tier keeps serving

    def test_torn_pair_negative_cached_without_reading_codes(self, store, monkeypatch):
        rng = np.random.default_rng(13)
        _fill(store, rng)
        store.build_ann_index(force=True)
        _, meta_path = store._ann_paths()
        with np.load(meta_path, allow_pickle=False) as z:
            m = {k: np.array(z[k]) for k in z.files}
        m["build_token"] = np.int64(int(m["build_token"]) + 1)
        np.savez(meta_path, **m)
        store._ann_disk_cache = store._ann_meta_cache = store._ann_cache = None
        calls = {"load": 0}
        orig_load = IvfPqIndex.load

        def counting_load(path):
            calls["load"] += 1
            return orig_load(path)

        monkeypatch.setattr(IvfPqIndex, "load", staticmethod(counting_load))
        assert store._ann_load_meta() is None
        assert calls["load"] == 0  # the token mismatch short-circuits
        cached = store._ann_disk_cache
        assert cached is not None and cached[1] is None
        assert store._ann_load_meta() is None
        assert calls["load"] == 0

    def test_failed_build_leaves_no_tmp_files(self, store, monkeypatch):
        rng = np.random.default_rng(14)
        _fill(store, rng)

        def boom(self, path, extra=None):
            Path(path).write_bytes(b"partial")
            raise OSError("disk full")

        monkeypatch.setattr(IvfPqIndex, "save", boom)
        with pytest.raises(OSError):
            store.build_ann_index(force=True)
        assert list(Path(store.dir).glob("*.tmp*.npz")) == []

    def test_device_error_raises_and_leaves_nothing(self, store, monkeypatch):
        """No fallback: a failure inside the build raises, and neither the
        pair nor a tmp file is left."""
        rng = np.random.default_rng(15)
        _fill(store, rng)

        def fail(*args):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(ivf_pq, "_fused_assign_encode", fail)
        with pytest.raises(RuntimeError, match="CUDA error"):
            store.build_ann_index(force=True)
        assert not any(p.exists() for p in store._ann_paths())
        assert list(Path(store.dir).glob("*.tmp*.npz")) == []

    def test_sweep_removes_dead_processes_tmps_only(self, store):
        d = Path(store.dir)
        dead = d / "ann.tmp999999999.npz"  # beyond pid_max: never alive
        alive = d / f"ann.tmp{os.getpid()}.npz"
        dead.write_bytes(b"x")
        alive.write_bytes(b"x")
        store._sweep_ann_tmp_files()
        assert not dead.exists()
        assert alive.exists()
        alive.unlink()

    def test_legacy_tokenless_pair_served(self, store):
        rng = np.random.default_rng(12)
        _fill(store, rng)
        store.build_ann_index(force=True)
        for p in store._ann_paths():
            with np.load(p, allow_pickle=False) as z:
                m = {k: np.array(z[k]) for k in z.files if k != "build_token"}
            np.savez(p, **m)
        store._ann_disk_cache = store._ann_meta_cache = store._ann_cache = None
        assert store._ann_load_meta() is not None
        assert store._ann_meta_light() is not None


def test_ann_index_survives_reopen(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
    rng = np.random.default_rng(21)
    d1 = str(tmp_path / "persist")
    s1 = Store(d1, dim=32)
    centers = _unit(rng, 4)
    paths = []
    for i in range(4):
        rows = centers[i] + 0.05 * rng.standard_normal((30, 32)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        s1.upsert_document_lines(f"/p{i}.txt", rows)
        paths.append(f"/p{i}.txt")
    s1.build_ann_index(force=True)
    gen1 = s1.generation()
    s1.close()

    s2 = Store(d1, dim=32)
    assert s2.generation() == gen1
    assert s2._ann_current() is not None
    assert s2.get_stats().index_type == "ivf-pq"
    got = s2.search_line_embeddings(centers[1], paths, top_k=3)
    assert all(rl.path == "/p1.txt" for rl in got)
    s2.upsert_document_lines("/new.txt", _unit(rng, 5))
    assert not s2._ann_generation_matches()
    state = s2._ann_current()
    assert state is not None and len(state[4]) == 5
    s2.close()


class TestAnnBuildDevice:
    """The port builds on the store's device; SEMTOOLS_TPU_ANN_BUILD=host
    (or cpu) pins the build to the CPU and changes no answer."""

    def _spy(self, monkeypatch):
        seen = []
        real = IvfPqIndex.build

        def spy(x, **kw):
            seen.append(kw["device"])
            return real(x, **kw)

        monkeypatch.setattr(IvfPqIndex, "build", staticmethod(spy))
        return seen

    @pytest.mark.parametrize("mode,want", [("host", "cpu"), ("cpu", "cpu"), ("auto", "store")])
    def test_build_device(self, tmp_path, rng, monkeypatch, mode, want):
        s = TorchStore(str(tmp_path / "ws"), dim=32, device="meta")
        assert s._ann_build_device() == s.device == torch.device("meta")
        monkeypatch.setenv("SEMTOOLS_TPU_ANN_BUILD", mode)
        expect = torch.device("cpu") if want == "cpu" else s.device
        assert s._ann_build_device() == expect
        s.close()

    def test_env_override_pins_cpu(self, store, monkeypatch, rng):
        _fill(store, rng)
        seen = self._spy(monkeypatch)
        monkeypatch.setenv("SEMTOOLS_TPU_ANN_BUILD", "host")
        assert store.build_ann_index(force=True) is not None
        assert seen == [torch.device("cpu")]

    def test_cpu_pinned_build_matches_results(self, store, monkeypatch, rng):
        _fill(store, rng)
        q = _unit(rng, 1)[0]
        monkeypatch.setenv("SEMTOOLS_TPU_ANN_BUILD", "host")
        store.build_ann_index(force=True)
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        got_cpu = store.search_line_embeddings(q, store.get_all_document_paths(), 5)
        monkeypatch.delenv("SEMTOOLS_TPU_ANN_BUILD")
        for p in store._ann_paths():
            os.unlink(p)
        store.build_ann_index(force=True)
        got_auto = store.search_line_embeddings(q, store.get_all_document_paths(), 5)
        assert [(r.path, r.line_number) for r in got_cpu] == [
            (r.path, r.line_number) for r in got_auto
        ]


def test_ann_candidate_depth_scales_with_pool():
    depth = TorchStore._ann_candidate_depth
    assert depth(10, 200_000, 1024, 64) == 640
    assert depth(10, 10_000_000, 4096, 256) == 9765
    d1 = depth(10, 4_000_000, 4096, 256)
    d2 = depth(10, 8_000_000, 4096, 256)
    assert abs(d2 - 2 * d1) <= 2
    for n in (30, 200_000, 1_002_000, 10_000_000):
        assert TorchStore._ann_nlist(n) == JaxStore._ann_nlist(n)
        assert depth(10, n, 2048, 128) == JaxStore._ann_candidate_depth(10, n, 2048, 128)


def test_ann_build_dim_not_divisible_by_32(tmp_path, rng):
    s = Store(str(tmp_path / "ws"), dim=13)
    x = rng.standard_normal((120, 13)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    s.upsert_document_lines("/a.txt", x)
    idx = s.build_ann_index(force=True)
    assert idx is not None
    assert 13 % idx.pq.m == 0
    s.close()


def test_ann_large_k_probes_enough_lists(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
    s = Store(str(tmp_path / "ws"), dim=16)
    docs = {}
    for i in range(5):
        x = rng.standard_normal((33, 16)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        s.upsert_document_lines(f"/d{i}.txt", x)
        docs[f"/d{i}.txt"] = x
    s.build_ann_index(force=True)
    keys = sorted(docs)
    rows = np.concatenate([docs[k] for k in keys])
    q = rng.standard_normal(16).astype(np.float32)
    q /= np.linalg.norm(q)
    got = s.search_line_embeddings(q, keys, 70)
    want = np.sort(1.0 - rows @ q, kind="stable")[:70]
    np.testing.assert_allclose([r.distance for r in got], want, atol=3e-4)
    s.close()


class TestIncrementalAnn:
    """Mutations serve through the ANN tier without a rebuild (tombstoned
    build rows + the ADC-encoded delta under the frozen quantizers),
    matching brute force; past the drift bound the tier steps aside."""

    def _mk(self, tmp_path, rng, docs=6, rows=40):
        s = Store(str(tmp_path / "ws"), dim=16)
        model = {}
        for i in range(docs):
            x = _unit(rng, rows, d=16)
            s.upsert_document_lines(f"/d{i}.txt", x)
            model[f"/d{i}.txt"] = x
        s.build_ann_index(force=True)
        return s, model

    def _check(self, s, model, rng, top_k=5, t=None):
        keys = sorted(model)
        rows = np.concatenate([model[k] for k in keys])
        q = _unit(rng, 1, d=16)[0]
        got = s.search_line_embeddings(q, keys, top_k, t)
        dist = 1.0 - rows @ q
        order = np.argsort(dist, kind="stable")[:top_k]
        if t is not None:
            order = order[dist[order] < t]
        assert len(got) == len(order), (len(got), len(order))
        for g, j in zip(got, order):
            assert abs(g.distance - float(dist[j])) < 3e-4

    def test_edit_serves_without_rebuild(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        build_gen = s.generation()
        x2 = _unit(rng, 37, d=16)
        s.upsert_document_lines("/d2.txt", x2)
        model["/d2.txt"] = x2
        assert s.serving_tier() == "ivf-pq"
        self._check(s, model, rng)
        self._check(s, model, rng, top_k=8, t=1.1)
        with np.load(s._ann_paths()[1]) as meta:
            assert int(meta["generation"]) == build_gen
        s.close()

    def test_refresh_keeps_a_servable_index(self, tmp_path, rng, monkeypatch):
        """The search path's refresh (``build_ann_index()`` unforced) keeps
        an index that mutations left within the drift bound, and rebuilds
        one past it; ``force`` rebuilds."""
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        meta = s._ann_paths()[1]
        before = meta.stat().st_mtime_ns
        s.upsert_document_lines("/d2.txt", _unit(rng, 37, d=16))
        assert s.build_ann_index() is not None
        assert meta.stat().st_mtime_ns == before and not s._ann_generation_matches()
        assert len(s._ann_current()[4]) == 37
        for i in range(4):
            s.upsert_document_lines(f"/d{i}.txt", _unit(rng, 40, d=16))
        assert not s._ann_available()
        time.sleep(0.01)
        assert s.build_ann_index() is not None and s._ann_generation_matches()
        s.upsert_document_lines("/d5.txt", _unit(rng, 40, d=16))
        assert s._ann_available()
        time.sleep(0.01)
        before = meta.stat().st_mtime_ns
        s.build_ann_index(force=True)
        assert meta.stat().st_mtime_ns != before and s._ann_generation_matches()
        s.close()

    def test_delete_tombstones_rows(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        s.delete_documents(["/d3.txt"])
        del model["/d3.txt"]
        assert s.serving_tier() == "ivf-pq"
        q = _unit(rng, 1, d=16)[0]
        got = s.search_line_embeddings(q, sorted(model), 10)
        assert all(g.path != "/d3.txt" for g in got)
        self._check(s, model, rng, top_k=10)
        s.close()

    def test_new_doc_joins_via_delta(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        x = _unit(rng, 25, d=16)
        s.upsert_document_lines("/new.txt", x)
        model["/new.txt"] = x
        got = s.search_line_embeddings(x[7], sorted(model), 1)
        assert (got[0].path, got[0].line_number) == ("/new.txt", 7)
        assert got[0].distance < 1e-4
        self._check(s, model, rng)
        s.close()

    def test_drift_bound_forces_fallthrough(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        for i in range(4):
            x = _unit(rng, 40, d=16)
            s.upsert_document_lines(f"/d{i}.txt", x)
            model[f"/d{i}.txt"] = x
        assert s._ann_current() is None
        assert s.serving_tier() != "ivf-pq"
        self._check(s, model, rng)  # the exact tiers still serve
        s.close()

    def test_cross_process_rebuild_picked_up(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        assert s._ann_current() is not None
        other = Store(str(tmp_path / "ws"), dim=16)
        x2 = _unit(rng, 37, d=16)
        other.upsert_document_lines("/d1.txt", x2)
        model["/d1.txt"] = x2
        time.sleep(0.01)
        other.build_ann_index(force=True)
        other.close()
        self._check(s, model, rng)
        state = s._ann_current()
        assert state is not None and len(state[4]) == 0  # the REBUILT index
        s.close()

    def test_tier_probe_never_reads_codes(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        s.close()
        cold = Store(str(tmp_path / "ws"), dim=16)

        def _boom(*a, **k):
            raise AssertionError("tier probe loaded the PQ codes")

        monkeypatch.setattr(IvfPqIndex, "load", staticmethod(_boom))
        assert cold.serving_tier() == "ivf-pq"
        monkeypatch.undo()
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        cold.upsert_document_lines("/d2.txt", _unit(rng, 37, d=16))
        monkeypatch.setattr(IvfPqIndex, "load", staticmethod(_boom))
        assert cold.serving_tier() == "ivf-pq"
        cold.close()

    def test_missing_codes_file_demotes_tier(self, tmp_path, rng, monkeypatch):
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        s, model = self._mk(tmp_path, rng)
        s._ann_paths()[0].unlink()
        s._ann_disk_cache = None
        s._ann_meta_cache = None
        assert s.serving_tier() != "ivf-pq"
        self._check(s, model, rng)
        s.close()


class TestProbeDepth:
    """Tiny corpora probe every list, and SEMTOOLS_TPU_ANN_NPROBE wins over
    the automatic policy."""

    def _spy_nprobe(self, monkeypatch):
        seen = {}
        orig = IvfPqIndex.search

        def spy(self, q, k, nprobe=8, rerank=16):
            seen["nprobe"] = nprobe
            return orig(self, q, k=k, nprobe=nprobe, rerank=rerank)

        monkeypatch.setattr(IvfPqIndex, "search", spy)
        return seen

    def test_tiny_corpus_probes_all_lists(self, store, monkeypatch):
        rng = np.random.default_rng(11)
        paths = _fill(store, rng)
        store.build_ann_index(force=True)
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        seen = self._spy_nprobe(monkeypatch)
        store.search_line_embeddings(_unit(rng, 1)[0], paths, top_k=1)
        assert seen["nprobe"] == store._ann_current()[0].nlist

    def test_env_nprobe_overrides(self, store, monkeypatch):
        rng = np.random.default_rng(12)
        paths = _fill(store, rng)
        store.build_ann_index(force=True)
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        monkeypatch.setenv("SEMTOOLS_TPU_ANN_NPROBE", "2")
        seen = self._spy_nprobe(monkeypatch)
        store.search_line_embeddings(_unit(rng, 1)[0], paths, top_k=1)
        assert seen["nprobe"] == 2

    def test_exact_at_soak_scale_random_data(self, store, monkeypatch):
        rng = np.random.default_rng(13)
        docs = {f"/doc{i}.txt": _unit(rng, 49) for i in range(6)}
        for p, m in docs.items():
            store.upsert_document_lines(p, m)
        paths = sorted(docs)
        store.build_ann_index(force=True)
        monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
        rows = np.concatenate([docs[p] for p in paths], axis=0)
        qs = _unit(rng, 200)
        per = store.search_line_embeddings_batched(qs, paths, 1)
        for r in range(200):
            want = float(np.min(1.0 - rows @ qs[r]))
            assert per[r], r
            assert abs(per[r][0].distance - want) < 3e-4, (r, per[r][0], want)


# -- across packages ---------------------------------------------------------


def _shared(tmp_path, rng, d=16):
    """A JAX store and a port store on the SAME directory, six documents of
    40 rows: {path: rows}."""
    j = JaxStore(str(tmp_path / "ws"), dim=d)
    t = Store(str(tmp_path / "ws"), dim=d)
    model = {}
    for i in range(6):
        x = _unit(rng, 40, d)
        j.upsert_document_lines(f"/d{i}.txt", x)
        model[f"/d{i}.txt"] = x
    return j, t, model


def _hits(store, qs, paths, top_k=10, t=None):
    return store.search_line_embeddings_batched(qs, paths, top_k, t)


def _same_hits(got, want):
    assert [[(h.path, h.line_number) for h in per] for per in got] == \
        [[(h.path, h.line_number) for h in per] for per in want]
    np.testing.assert_allclose([h.distance for per in got for h in per],
                               [h.distance for per in want for h in per], atol=1e-6, rtol=0)


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_index_served_by_the_other_package(tmp_path, rng, monkeypatch, built_by):
    """An index built by one package is served by the other with the
    hits of the package that built it; a mutation made through the server
    reconciles in both."""
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
    j, t, model = _shared(tmp_path, rng)
    build, serve = (j, t) if built_by == "jax" else (t, j)
    build.build_ann_index(force=True)
    paths = sorted(model)
    qs = _unit(rng, 8, 16)
    want = _hits(build, qs, paths)
    assert serve.serving_tier() == build.serving_tier() == "ivf-pq"
    assert serve._ann_current() is not None
    _same_hits(_hits(serve, qs, paths), want)
    _same_hits(_hits(serve, qs, paths, top_k=20, t=0.9), _hits(build, qs, paths, top_k=20, t=0.9))
    x = _unit(rng, 25, 16)
    serve.upsert_document_lines("/new.txt", x)
    paths = sorted([*paths, "/new.txt"])
    for s in (j, t):
        state = s._ann_current()
        assert state is not None and len(state[4]) == 25  # the delta, no rebuild
    _same_hits(_hits(t, qs, paths), _hits(j, qs, paths))
    got = t.search_line_embeddings(x[7], paths, 1)
    assert (got[0].path, got[0].line_number) == ("/new.txt", 7)
    j.close()
    t.close()


def _cli(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    capsys.readouterr()
    rc = main(argv)
    captured = capsys.readouterr()
    assert rc == 0, (argv, captured.err)
    return captured.out


def test_workspace_index_cli(tmp_path, monkeypatch, capsys):
    """``workspace index [--force] [-j]``: the JAX CLI's text and JSON where
    it builds nothing, its format strings for the forced build (the JAX CLI
    runs out of memory building this 30-line workspace), then both CLIs
    name the tier."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("SEMTOOLS_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    assert _cli(torch_cli.main, ["workspace", "use", "anntest"], capsys, monkeypatch)
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "anntest")
    for argv in (["workspace", "index"], ["workspace", "index", "-j"]):  # an empty store
        assert _cli(torch_cli.main, argv, capsys, monkeypatch) == \
            _cli(jax_cli.main, argv, capsys, monkeypatch)
    f = tmp_path / "f.txt"
    f.write_text("\n".join(f"line about topic {i}" for i in range(30)) + "\n")
    _cli(torch_cli.main, ["search", "topic", str(f), "--device", "cpu"], capsys, monkeypatch)
    for argv in (["workspace", "index"], ["workspace", "-j", "index", "anntest"]):
        out = _cli(torch_cli.main, argv, capsys, monkeypatch)
        assert out == _cli(jax_cli.main, argv, capsys, monkeypatch)
    assert "'exact-mxu-scan' over 30 lines" in out or json.loads(out)["built"] is False

    out = _cli(torch_cli.main, ["workspace", "index", "--force"], capsys, monkeypatch)
    assert out == ("IVF-PQ index built (capacity fallback); corpus fits on-device so "
                   "'exact-mxu-scan' serves 30 lines\n")
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
    out = _cli(torch_cli.main, ["workspace", "index", "--force", "-j"], capsys, monkeypatch)
    assert json.loads(out) == {"workspace": "anntest", "index_type": "ivf-pq", "built": True,
                               "total_lines": 30}
    out = _cli(torch_cli.main, ["workspace", "index"], capsys, monkeypatch)
    assert out == "Index ready: ivf-pq serving 30 lines\n"
    for main in (torch_cli.main, jax_cli.main):
        assert "Index: Yes (ivf-pq)" in _cli(main, ["workspace", "status"], capsys, monkeypatch)
    argv = ["search", "topic 7", str(f), "-j", "--top-k", "5"]
    got = json.loads(_cli(torch_cli.main, [*argv, "--device", "cpu"], capsys, monkeypatch))
    want = json.loads(_cli(jax_cli.main, argv, capsys, monkeypatch))
    key = lambda r: (r["filename"], r["match_line_number"])  # noqa: E731
    assert [key(r) for r in got["results"]] == [key(r) for r in want["results"]]
    np.testing.assert_allclose([r["distance"] for r in got["results"]],
                               [r["distance"] for r in want["results"]], atol=1e-5, rtol=0)
