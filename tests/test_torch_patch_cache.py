"""The port's slot-corpus build and in-place patch (``store/patch_cache.py``)
against the JAX package's, on the same numpy embeddings.

A JAX store and a port store (separate directories; the disk format is
shared byte for byte) receive the same mutations; after each one, each
package's ``get`` must take the same decision (cache hit, patch or rebuild:
``_build`` calls are counted on both sides) and leave the same corpus bytes,
scale, residual scale, rotation, row-L1 bound, hash snapshot, layout and
drift count. Tolerance: none, except the port's on-device build of the
reduced kind, held to the JAX package's own rule for its device build (every
value within 1 unit, scales within 1e-6 relative, the residual column an
upper bound on every live row's residual within 1e-5).
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import pytest
import torch

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store import patch_cache as jax_patch_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

CPU = torch.device("cpu")
KINDS = [("f32", None), ("int8", None), ("int4", None), ("int8", 8)]
KIND_IDS = ["f32", "int8", "int4", "reduced8d"]


def _unit(rng, n, d=32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _content_hashes(rows):
    """Deterministic per-row uint64 stand-ins for lines.h64 content hashes."""
    return np.array([
        int.from_bytes(hashlib.blake2b(r.tobytes(), digest_size=8).digest(), "little") | 1
        for r in rows
    ], np.uint64)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_STORE_INT4",
                "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_TPU_REDUCED_DIM"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_BUILD", "host")
    device_cache.invalidate()
    jax_device_cache.invalidate()
    yield
    device_cache.invalidate()
    jax_device_cache.invalidate()


class Pair:
    """One JAX store and one port store under the same mutations."""

    def __init__(self, root, monkeypatch, dim=32, model="m"):
        self.root, self.dim = root, dim
        self.builds = {"jax": 0, "torch": 0}
        for side, module in (("jax", jax_patch_cache), ("torch", patch_cache)):
            real = module._build

            def counting(*args, _real=real, _side=side, **kwargs):
                self.builds[_side] += 1
                return _real(*args, **kwargs)

            monkeypatch.setattr(module, "_build", counting)
        self.open(model)

    def open(self, model):
        self.j = JaxStore(str(self.root / "jax"), dim=self.dim, model_name=model)
        self.t = Store(str(self.root / "torch"), dim=self.dim, model_name=model, device="cpu")

    def close(self):
        self.j.close()
        self.t.close()

    def apply(self, method, *args):
        getattr(self.j, method)(*args)
        getattr(self.t, method)(*args)

    def get(self, kind, rd):
        """(JAX entry, port entry, decision) after one get on each side;
        the decision is 'build' or 'reuse' (a hit or a patch) and must agree."""
        before = dict(self.builds)
        sc_j = jax_patch_cache.get(self.j, kind, rd)
        sc_t = patch_cache.get(self.t, kind, device=CPU, reduced_dim=rd)
        built = {s: self.builds[s] > before[s] for s in self.builds}
        assert built["jax"] == built["torch"], built
        assert_same(sc_j, sc_t)
        return sc_j, sc_t, "build" if built["jax"] else "reuse"


def assert_same(sc_j, sc_t):
    cap = sc_t.capacity
    assert (sc_j.kind, sc_j.capacity, sc_j.generation) == (sc_t.kind, cap, sc_t.generation)
    assert sc_t.corpus.shape[0] == cap
    np.testing.assert_array_equal(np.asarray(sc_j.corpus)[:cap], sc_t.corpus.numpy())
    assert sc_j.scale == sc_t.scale and sc_j.resid_scale == sc_t.resid_scale
    assert sc_j.max_row_int_l1 == sc_t.max_row_int_l1
    assert sc_j.patched_rows == sc_t.patched_rows
    assert sc_j.layout == sc_t.layout and sc_j.model == sc_t.model
    assert (sc_j.rotation is None) == (sc_t.rotation is None)
    if sc_t.rotation is not None:
        np.testing.assert_array_equal(sc_j.rotation, sc_t.rotation)
    assert (sc_j.hashes is None) == (sc_t.hashes is None)
    if sc_t.hashes is not None:
        np.testing.assert_array_equal(sc_j.hashes[:cap], sc_t.hashes)


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


def _fill_big(pair, seed=3, hashes=False):
    """40 documents of 100 rows: a one-document change is 2.5% of the corpus."""
    rng = np.random.default_rng(seed)
    docs = {f"/d{i:02}.txt": _unit(rng, 100) for i in range(40)}
    pair.apply("upsert_documents_bulk", [
        (p, r, _content_hashes(r) if hashes else None) for p, r in docs.items()])
    return docs, rng


# -- build ---------------------------------------------------------------------


def _fragmented(pair, dim=32):
    rng = np.random.default_rng(7)
    for i in range(12):
        rows = _unit(rng, 37 + 11 * i, dim)
        pair.apply("upsert_document_lines", f"/d{i}.txt", rows, _content_hashes(rows))
    pair.apply("delete_documents", ["/d3.txt", "/d7.txt"])  # holes


@pytest.mark.parametrize("kind,rd", KINDS + [("int8", 16)], ids=KIND_IDS + ["reduced16d"])
def test_host_build_is_byte_equal_to_jax(pair, monkeypatch, kind, rd):
    _fragmented(pair)
    monkeypatch.setattr(jax_patch_cache, "_BUILD_CHUNK_ROWS", 64)
    monkeypatch.setattr(patch_cache, "_BUILD_CHUNK_ROWS", 64)
    sc_j = jax_patch_cache._build(pair.j, kind, rd)
    sc_t = patch_cache._build(pair.t, kind, CPU, rd)
    assert_same(sc_j, sc_t)
    assert sc_t.corpus.shape[1] == {"f32": 32, "int4": 16}.get(kind, (rd or 31) + 1)


@pytest.mark.parametrize("kind,rd", [("int8", None), ("int4", None), ("int8", 16)],
                         ids=["int8", "int4", "reduced16d"])
def test_device_build_path_matches_host(tmp_path, monkeypatch, kind, rd):
    """The torch transform (SEMTOOLS_TPU_BUILD=device, here on CPU tensors;
    small chunks so the in-flight bound runs) against the host build: byte
    equal for int8 and int4, within the JAX rule for the reduced kind."""
    s = Store(str(tmp_path / "ws"), dim=64, device="cpu")
    rng = np.random.default_rng(13)
    rows = _unit(rng, 2000, 64)
    s.upsert_document_lines("/a.txt", rows[:900])
    s.upsert_document_lines("/b.txt", rows[900:])
    s.delete_documents(["/a.txt"])  # fragmentation
    monkeypatch.setattr(patch_cache, "_BUILD_CHUNK_ROWS", 256)
    monkeypatch.setenv("SEMTOOLS_TPU_BUILD", "device")
    before = patch_cache.uploaded_bytes()
    dev = patch_cache._build(s, kind, CPU, rd)
    assert patch_cache.uploaded_bytes() - before == 2 * 2000 * 64 * 4  # two f32 passes
    monkeypatch.setenv("SEMTOOLS_TPU_BUILD", "host")
    host = patch_cache._build(s, kind, CPU, rd)
    cd, ch = dev.corpus.numpy(), host.corpus.numpy()
    assert cd.shape == ch.shape and cd.dtype == ch.dtype
    if rd is None:
        np.testing.assert_array_equal(cd, ch)
        assert (dev.scale, dev.max_row_int_l1) == (host.scale, host.max_row_int_l1)
        s.close()
        return
    assert np.abs(cd.astype(np.int32) - ch.astype(np.int32)).max() <= 1
    assert abs(dev.scale - host.scale) <= 1e-6 * host.scale
    assert abs(dev.resid_scale - host.resid_scale) <= 1e-6 * host.resid_scale
    np.testing.assert_array_equal(dev.rotation, host.rotation)
    live = rows[900:]  # /b.txt occupies slots 900..1999
    proj = live @ host.rotation
    r = np.sqrt(np.maximum(np.einsum("ij,ij->i", live, live)
                           - np.einsum("ij,ij->i", proj, proj), 0.0))
    for built in (dev, host):
        bound = built.corpus.numpy()[900:2000, rd].astype(np.float64) * built.resid_scale
        assert np.all(bound >= r - 1e-5)
    s.close()


def test_build_placement(monkeypatch):
    cuda = torch.device("cuda")  # a device object needs no card
    monkeypatch.setenv("SEMTOOLS_TPU_BUILD", "auto")
    assert patch_cache._use_device_build("int8", cuda)
    assert patch_cache._use_device_build("int4", cuda)
    assert not patch_cache._use_device_build("f32", cuda)
    assert not patch_cache._use_device_build("int8", CPU)
    monkeypatch.setenv("SEMTOOLS_TPU_BUILD", "device")
    assert patch_cache._use_device_build("int8", CPU)
    monkeypatch.setenv("SEMTOOLS_TPU_BUILD", "host")
    assert not patch_cache._use_device_build("int8", cuda)


# -- patch scenarios -------------------------------------------------------------


@pytest.mark.parametrize("kind,rd", KINDS, ids=KIND_IDS)
def test_update_add_delete_matches_jax(pair, kind, rd):
    docs, rng = _fill_big(pair)
    assert pair.get(kind, rd)[2] == "build"
    assert pair.get(kind, rd)[2] == "reuse"  # a hit
    for step in (
        ("upsert_document_lines", "/d11.txt", _unit(rng, 140)),  # grows the tail
        ("upsert_document_lines", "/new.txt", _unit(rng, 60)),
        ("delete_documents", ["/d20.txt"]),
        ("upsert_document_lines", "/d05.txt", _unit(rng, 30)),  # reuses freed space
    ):
        before = patch_cache.uploaded_bytes()
        pair.apply(*step)
        _, sc_t, decision = pair.get(kind, rd)
        assert decision == "reuse"  # patched
        rows = 0 if step[0] == "delete_documents" else step[2].shape[0]
        assert patch_cache.uploaded_bytes() - before == rows * sc_t.corpus.shape[1] * (
            4 if kind == "f32" else 1)


@pytest.mark.parametrize("kind,rd", KINDS, ids=KIND_IDS)
def test_one_row_edit_ships_one_row(pair, kind, rd):
    rng = np.random.default_rng(11)
    rows = _unit(rng, 4096)
    pair.apply("upsert_document_lines", "/big.txt", rows, _content_hashes(rows))
    pair.get(kind, rd)
    before = patch_cache.uploaded_bytes()
    rows2 = rows.copy()
    rows2[777] = _unit(rng, 1)[0]
    pair.apply("upsert_document_lines", "/big.txt", rows2, _content_hashes(rows2))
    _, sc_t, decision = pair.get(kind, rd)
    assert decision == "reuse"
    # the 4095 unchanged rows move on the device as two runs; the edited row
    # and its int32 slot index cross the bus (the JAX package's 260 bytes
    # at int8 and D 256)
    row_bytes = sc_t.corpus.shape[1] * sc_t.corpus.element_size()
    assert patch_cache.uploaded_bytes() - before == row_bytes + 4


@pytest.mark.parametrize("kind,rd", KINDS, ids=KIND_IDS)
def test_shuffled_and_edited_rows_move_by_index(pair, kind, rd):
    """A shuffle leaves no long runs: the moves take index_select/index_copy_
    (8 index bytes a row: int32 source and destination) and the edited rows
    upload."""
    rng = np.random.default_rng(12)
    rows = _unit(rng, 500)
    other = _unit(rng, 100)
    pair.apply("upsert_document_lines", "/doc.txt", rows, _content_hashes(rows))
    pair.apply("upsert_document_lines", "/other.txt", other, _content_hashes(other))
    pair.get(kind, rd)
    rows2 = np.concatenate([rows[rng.permutation(500)][:480], _unit(rng, 20)])
    before = patch_cache.uploaded_bytes()
    pair.apply("upsert_document_lines", "/doc.txt", rows2, _content_hashes(rows2))
    _, sc_t, decision = pair.get(kind, rd)
    assert decision == "reuse"
    row_bytes = sc_t.corpus.shape[1] * sc_t.corpus.element_size()
    assert patch_cache.uploaded_bytes() - before == 480 * 8 + 20 * (row_bytes + 4)


@pytest.mark.parametrize("kind,rd", [("f32", None), ("int8", None)], ids=["f32", "int8"])
def test_reused_slot_range_matches_jax(pair, kind, rd):
    """Delete a document, then re-add the same path with the same line
    count: the allocator hands back the same range, (start, n) is unchanged
    while the bytes differ; the diff keys on the vector revision."""
    rng = np.random.default_rng(13)
    pair.apply("upsert_document_lines", "/a.txt", _unit(rng, 20))
    pair.apply("upsert_document_lines", "/b.txt", _unit(rng, 200))  # 20 rows stay under the drift bound
    pair.get(kind, rd)
    pair.apply("delete_line_embeddings", ["/a.txt"])
    second = _unit(rng, 20)
    pair.apply("upsert_document_lines", "/a.txt", second)
    _, sc_t, decision = pair.get(kind, rd)
    assert decision == "reuse"
    s, n, _ = sc_t.layout["/a.txt"]
    if kind == "f32":
        np.testing.assert_array_equal(sc_t.corpus.numpy()[s : s + n], second)


def test_same_doc_twice_between_searches(pair):
    rng = np.random.default_rng(14)
    pair.apply("upsert_document_lines", "/x.txt", _unit(rng, 10))
    pair.apply("upsert_document_lines", "/y.txt", _unit(rng, 200))  # under the drift bound
    pair.get("int8", None)
    pair.apply("upsert_document_lines", "/x.txt", _unit(rng, 10))
    pair.apply("upsert_document_lines", "/x.txt", _unit(rng, 10))
    assert pair.get("int8", None)[2] == "reuse"


@pytest.mark.parametrize("kind,rd", [("int8", None), ("int4", None), ("int8", 8)],
                         ids=["int8", "int4", "reduced8d"])
def test_drift_refit_matches_jax(pair, kind, rd):
    """Lossy entries accept small patches, then refuse them once cumulative
    patched rows pass a quarter of the corpus: both packages rebuild at the
    same step."""
    docs, rng = _fill_big(pair)
    pair.get(kind, rd)
    decisions = []
    for i in range(14):
        pair.apply("upsert_document_lines", f"/d{i:02}.txt", _unit(rng, 100))
        decisions.append(pair.get(kind, rd)[2])
    assert "build" in decisions and decisions.index("build") >= 3, decisions


def test_f32_entry_never_refits(pair):
    docs, rng = _fill_big(pair)
    pair.get("f32", None)
    for i in range(14):
        pair.apply("upsert_document_lines", f"/d{i:02}.txt", _unit(rng, 100))
        assert pair.get("f32", None)[2] == "reuse"


def test_zero_scale_rebuilds(pair):
    pair.apply("upsert_document_lines", "/blank.txt", np.zeros((40, 32), np.float32))
    sc_j, sc_t, _ = pair.get("int8", None)
    assert sc_t.scale == 0.0
    pair.apply("upsert_document_lines", "/real.txt", _unit(np.random.default_rng(31), 40))
    assert pair.get("int8", None)[2] == "build"


def test_model_swap_rebuilds(pair):
    docs, rng = _fill_big(pair, hashes=True)
    pair.get("int8", None)
    pair.close()
    pair.open("m2")  # every stored row is now of another model
    rows = _unit(rng, 10)
    pair.apply("upsert_document_lines", "/new.txt", rows, _content_hashes(rows))
    sc_j, sc_t, decision = pair.get("int8", None)
    assert decision == "build" and sc_t.model == "m2"


def test_mid_patch_failure_rebuilds(pair, monkeypatch):
    """An exception inside the patch drops the entry and rebuilds on both
    sides, on the same device."""
    docs, rng = _fill_big(pair)
    pair.get("int8", None)
    pair.apply("upsert_document_lines", "/d09.txt", _unit(rng, 100))
    calls = {"n": 0}

    def exploding(*args, **kwargs):
        calls["n"] += 1
        raise RuntimeError("simulated device failure mid-patch")

    monkeypatch.setattr(jax_patch_cache, "_write_rows", exploding)
    monkeypatch.setattr(patch_cache, "_write_rows", exploding)
    assert pair.get("int8", None)[2] == "build"
    assert calls["n"] == 2  # one failed patch on each side


def test_no_hash_sidecar_uploads_whole_range(pair):
    rng = np.random.default_rng(14)
    rows = _unit(rng, 256)
    pair.apply("upsert_document_lines", "/a.txt", rows)  # no hashes
    pair.apply("upsert_document_lines", "/b.txt", _unit(rng, 1000))  # novel rows < half
    pair.get("f32", None)
    rows2 = rows.copy()
    rows2[3] = _unit(rng, 1)[0]
    before = patch_cache.uploaded_bytes()
    pair.apply("upsert_document_lines", "/a.txt", rows2)
    _, sc_t, decision = pair.get("f32", None)
    assert decision == "reuse" and patch_cache.uploaded_bytes() - before == rows2.nbytes
    s, n, _ = sc_t.layout["/a.txt"]
    np.testing.assert_array_equal(sc_t.corpus.numpy()[s : s + n], rows2)


def test_residual_overflow_rebuilds(pair):
    """A patched row whose projection residual overflows the reduced
    column's ceiling cannot carry a valid bound: both rebuild (refit)."""
    rng = np.random.default_rng(3)
    basis = rng.standard_normal((4, 32)).astype(np.float32)
    rows = rng.standard_normal((600, 4)).astype(np.float32) @ basis
    rows += 0.01 * rng.standard_normal((600, 32)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    pair.apply("upsert_document_lines", "/a.txt", rows)
    pair.get("int8", 8)
    ortho = rng.standard_normal((40, 32)).astype(np.float32)
    ortho -= (ortho @ np.linalg.pinv(basis)) @ basis
    ortho = (ortho / np.linalg.norm(ortho, axis=1, keepdims=True)).astype(np.float32)
    pair.apply("upsert_document_lines", "/b.txt", ortho)
    assert pair.get("int8", 8)[2] == "build"


# -- concurrency -----------------------------------------------------------------


def test_reader_snapshot_survives_a_concurrent_patch(tmp_path):
    """A reader holding an entry keeps its tensor, layout and lookup while
    another thread patches: the patch publishes a new entry."""
    s = Store(str(tmp_path / "ws"), dim=32, device="cpu")
    rng = np.random.default_rng(4)
    for i in range(20):
        s.upsert_document_lines(f"/d{i}.txt", _unit(rng, 50))
    held = patch_cache.get(s, "int8", device=CPU)
    bytes_before = held.corpus.clone()
    layout_before, starts_before = dict(held.layout), held.starts.copy()
    out = {}

    def writer():
        w = Store(str(tmp_path / "ws"), dim=32, device="cpu")
        try:
            w.upsert_document_lines("/d3.txt", _unit(np.random.default_rng(5), 70))
            w.delete_documents(["/d5.txt"])
            out["fresh"] = patch_cache.get(w, "int8", device=CPU)
        finally:
            w.close()

    t = threading.Thread(target=writer)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    fresh = out["fresh"]
    assert fresh is not held and fresh.generation > held.generation
    assert fresh.patched_rows == 70 + 50  # patched, not rebuilt
    assert torch.equal(held.corpus, bytes_before)
    assert held.layout == layout_before and np.array_equal(held.starts, starts_before)
    assert "/d5.txt" in held.layout and "/d5.txt" not in fresh.layout
    s.close()


def test_concurrent_gets_build_once(tmp_path, monkeypatch):
    """The per-key lock: eight threads asking for a cold corpus build it
    once and all get the same entry."""
    s = Store(str(tmp_path / "ws"), dim=32, device="cpu")
    s.upsert_document_lines("/a.txt", _unit(np.random.default_rng(6), 300))
    real, calls = patch_cache._build, []

    def slow_build(*args, **kwargs):
        calls.append(1)
        threading.Event().wait(0.05)  # widen the race window
        return real(*args, **kwargs)

    monkeypatch.setattr(patch_cache, "_build", slow_build)
    got = [None] * 8

    def one(i):
        st = Store(str(tmp_path / "ws"), dim=32, device="cpu")
        try:
            got[i] = patch_cache.get(st, "int8", device=CPU)
        finally:
            st.close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and all(g is got[0] for g in got)
    s.close()
