"""``Store.compact`` and ``workspace compact`` of the port against the JAX
package's.

The same churn goes into a JAX store and a port store; after each package
compacts its own, the new epoch's vector and hash files, the sqlite rows
(slot starts, free table, ``vec_epoch``, generation) and the reports are
byte-equal, and each package serves the other's compacted store with the
exact hits (distances within 1e-6 of brute force). The port's compaction
keeps the JAX package's crash and reader contracts (the scenarios of
``tests/test_compact.py``), and a warm device corpus catches up by the
patch's move path with the JAX package's bytes. A fresh IVF-PQ index built
by either package survives the other's compaction: it is remapped in place
(``ann_meta.npz`` equal, array for array, to the building package's own
compaction), and that package still serves it with the exact hits; a stale
one is retired.
"""

from __future__ import annotations

import io
import json
import shutil
import sqlite3
import sys

import numpy as np
import pytest
import torch

from semtools_tpu import cli as jax_cli
from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store import patch_cache as jax_patch_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch import cli as torch_cli
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

D = 16
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_STORE_INT4",
                "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_WORKSPACE", "SEMTOOLS_TPU_BUILD"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    device_cache.invalidate()
    jax_device_cache.invalidate()
    yield
    device_cache.invalidate()
    jax_device_cache.invalidate()


def _unit(rng, n, d=D):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _churn(stores, seed=11, d=D):
    """Eight documents, then deletes and rewrites at other sizes: holes the
    best-fit allocator cannot fully reuse. Returns {path: rows}."""
    rng = np.random.default_rng(seed)
    model = {}
    for i in range(8):
        x = _unit(rng, 20, d)
        hashes = (np.arange(20, dtype=np.uint64) + 1) * 7919 + i * 1_000_003
        for s in stores:
            s.upsert_document_lines(f"/d{i}.txt", x, hashes)
        model[f"/d{i}.txt"] = x
    for s in stores:
        s.delete_documents(["/d1.txt", "/d4.txt"])
    del model["/d1.txt"], model["/d4.txt"]
    for name, n in (("/d2.txt", 33), ("/d6.txt", 7), ("/d0.txt", 29)):
        x = _unit(rng, n, d)
        for s in stores:
            s.upsert_document_lines(name, x)
        model[name] = x
    return model


def _check_search(store, model, seed=5, top_k=10):
    keys = sorted(model)
    rows = np.concatenate([model[k] for k in keys])
    owner = [(k, i) for k in keys for i in range(model[k].shape[0])]
    q = _unit(np.random.default_rng(seed), 1, rows.shape[1])[0]
    got = store.search_line_embeddings(q, keys, top_k)
    dist = 1.0 - rows @ q
    order = np.argsort(dist, kind="stable")[:top_k]
    assert [(g.path, g.line_number) for g in got] == [owner[o] for o in order]
    np.testing.assert_allclose([g.distance for g in got], dist[order], atol=ATOL, rtol=0)


def _db_rows(store_dir):
    db = sqlite3.connect(store_dir / "store.sqlite")
    try:
        return {table: sorted(db.execute(f"SELECT * FROM {table}").fetchall())
                for table in ("meta", "docs", "free")}
    finally:
        db.close()


@pytest.fixture()
def both(tmp_path):
    j = JaxStore(str(tmp_path / "jax"), dim=D)
    t = Store(str(tmp_path / "torch"), dim=D, device="cpu")
    yield j, t
    j.close()
    t.close()


def test_compaction_is_byte_equal_to_jax(both, tmp_path):
    j, t = both
    model = _churn((j, t))
    live, cap = t.fragmentation()
    assert (live, cap) == j.fragmentation() and cap > live
    rep_j, rep_t = j.compact(), t.compact()
    assert rep_t == rep_j == {"rows_live": live, "slots_before": cap,
                              "slots_reclaimed": cap - live, "index_remapped": False}
    j.flush()
    t.flush()
    assert _db_rows(tmp_path / "torch") == _db_rows(tmp_path / "jax")
    for name in ("lines.e1.f32", "lines.e1.h64"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for side in ("jax", "torch"):
        assert not (tmp_path / side / "lines.f32").exists()  # epoch 0 retired
    assert t.fragmentation() == (live, live)
    _check_search(t, model)
    # a second compaction is a no-op on both, generation untouched
    gen = t.generation()
    assert t.compact()["slots_reclaimed"] == j.compact()["slots_reclaimed"] == 0
    assert t.generation() == gen == j.generation()


def test_each_package_reads_the_others_compacted_store(both, tmp_path):
    j, t = both
    model = _churn((j, t))
    j.compact()
    t.compact()
    t_on_jax = Store(str(tmp_path / "jax"), dim=D, device="cpu")
    j_on_torch = JaxStore(str(tmp_path / "torch"), dim=D)
    try:
        for store in (t_on_jax, j_on_torch):
            _check_search(store, model)
            _check_search(store, model, seed=6, top_k=3)
        # and the port keeps writing into the JAX package's new epoch
        x = _unit(np.random.default_rng(3), 12)
        t_on_jax.upsert_document_lines("/new.txt", x)
        model["/new.txt"] = x
        with JaxStore(str(tmp_path / "jax"), dim=D) as again:
            _check_search(again, model, seed=7)
    finally:
        t_on_jax.close()
        j_on_torch.close()


def test_empty_store(tmp_path):
    s = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    assert s.compact() == {"rows_live": 0, "slots_before": 0, "slots_reclaimed": 0,
                           "index_remapped": False}
    s.close()


def test_crash_before_swap_leaves_old_state(tmp_path, monkeypatch):
    """A failure after the new epoch's files are written and before the swap
    commits: reopening serves the OLD state, and the next compact cleans the
    orphans and succeeds."""
    s = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    model = _churn((s,))
    before = {p: np.array(s.get_doc_hash_rows(p)[1]) for p in model}
    gen_before = s.generation()

    def crash():
        raise RuntimeError("simulated crash before commit")

    monkeypatch.setattr(s, "_bump_generation", crash)
    with pytest.raises(RuntimeError):
        s.compact()
    s.close()
    s2 = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    assert s2.generation() == gen_before and s2._vec_epoch() == 0
    assert (tmp_path / "ws" / "lines.e1.f32").exists()  # the orphan
    for p in model:
        np.testing.assert_array_equal(np.array(s2.get_doc_hash_rows(p)[1]), before[p])
    _check_search(s2, model)
    assert s2.compact()["slots_reclaimed"] > 0 and s2._vec_epoch() == 1
    live, _ = s2.fragmentation()
    assert (tmp_path / "ws" / "lines.e1.f32").stat().st_size == live * 4 * D
    _check_search(s2, model)
    s2.close()


def test_orphans_cleaned_and_hashes_move(tmp_path):
    s = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    rng = np.random.default_rng(2)
    x = _unit(rng, 5)
    hashes = np.arange(1, 6, dtype=np.uint64) * 1000
    s.upsert_document_lines("/a.txt", _unit(rng, 40))
    s.upsert_document_lines("/h.txt", x, hashes)
    s.delete_documents(["/a.txt"])
    for name in ("lines.e5.f32", "lines.e5.h64"):
        (tmp_path / "ws" / name).write_bytes(b"junk")
    s.compact()
    assert not any((tmp_path / "ws" / n).exists()
                   for n in ("lines.e5.f32", "lines.e5.h64", "lines.f32", "lines.h64"))
    got_h, got_rows = s.get_doc_hash_rows("/h.txt")
    np.testing.assert_array_equal(got_h, hashes)
    np.testing.assert_array_equal(got_rows, x)
    s.close()
    s2 = Store(str(tmp_path / "ws"), dim=D, device="cpu")  # survives reopen
    _check_search(s2, {"/h.txt": x}, top_k=3)
    s2.close()


def test_readers_across_compaction(tmp_path):
    """An open mmap keeps its pre-compact snapshot; a reader whose cached
    layout predates the compact retries with fresh state instead of
    serving wrong rows."""
    s = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    model = _churn((s,))
    reader = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    _check_search(reader, model)
    stale_ranges = reader._valid_ranges_cached()
    mm = reader._mmap("r")
    pre = {p: np.array(mm[st : st + n]) for p, st, n in stale_ranges}
    assert s.compact()["slots_reclaimed"] > 0
    for p, st, n in stale_ranges:
        np.testing.assert_array_equal(np.array(mm[st : st + n]), pre[p])
    del mm
    reader._ranges_cache = (reader.generation(), stale_ranges)  # lose the race
    with pytest.raises(FileNotFoundError):
        reader._mmap("r")  # the pinned epoch faults, never reads wrong rows
    _check_search(reader, model)  # the retry heals
    reader.close()
    # a path subset reads its slots from the same (generation, ranges,
    # epoch) snapshot as the whole store, before and after a compact
    reader = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    subset = {p: model[p] for p in sorted(model)[:3]}
    _check_search(reader, subset, seed=8, top_k=5)
    s.upsert_document_lines("/gap.txt", _unit(np.random.default_rng(4), 3))
    s.delete_documents(["/gap.txt", "/d7.txt"])
    assert s.compact()["slots_reclaimed"] > 0
    _check_search(reader, subset, seed=8, top_k=5)
    reader.close()
    s.close()


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
def test_warm_corpus_follows_compaction_by_moves(both, kind):
    """After compact, the cached slot corpus catches up by moving the rows
    on the device (their hashes survive), uploading nothing, with the bytes
    of the JAX package's patched corpus."""
    j, t = both
    rng = np.random.default_rng(5)
    docs = {}
    bulk = []
    for i in range(30):
        rows = _unit(rng, 100, D)
        bulk.append((f"/d{i:02}.txt", rows,
                     (np.arange(100, dtype=np.uint64) + 1) * 7919 + i * 1_000_003))
        docs[f"/d{i:02}.txt"] = rows
    for s in (j, t):
        s.upsert_documents_bulk(bulk)
        s.delete_documents(["/d01.txt"])  # a hole near the front: most docs move
    del docs["/d01.txt"]
    cpu = torch.device("cpu")
    old = patch_cache.get(t, kind, device=cpu)
    jax_patch_cache.get(j, kind, None)
    assert t.compact()["slots_reclaimed"] == j.compact()["slots_reclaimed"] == 100
    before = patch_cache.uploaded_bytes()
    sc_t = patch_cache.get(t, kind, device=cpu)
    sc_j = jax_patch_cache.get(j, kind, None)
    assert patch_cache.uploaded_bytes() == before  # moves only
    assert sc_t is not old and sc_t.patched_rows == sc_j.patched_rows
    assert sc_t.capacity == sc_j.capacity == 2900 and sc_t.corpus.shape[0] == 2900
    # the port pads rows to the kernels' 16 bytes (patch_cache.padded_dim):
    # JAX's bytes first, the zero encoding after them
    want = np.asarray(sc_j.corpus)[:2900]
    got = sc_t.corpus.numpy()
    np.testing.assert_array_equal(want, got[:, : want.shape[1]])
    assert (got[:, want.shape[1]:] == patch_cache._fill_byte(kind)).all()
    np.testing.assert_array_equal(sc_j.hashes[:2900], sc_t.hashes)
    _check_search(t, docs, seed=9)


def _cli(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out
    assert rc == 0, argv
    return out


def test_cli_compact_matches_jax(tmp_path, monkeypatch, capsys):
    """``workspace compact [-j]`` and the status hint, on both CLIs."""
    outs = {}
    for side, main, store_cls in (("jax", jax_cli.main, JaxStore),
                                  ("torch", torch_cli.main, Store)):
        home = tmp_path / side
        home.mkdir()
        monkeypatch.setenv("HOME", str(home))
        monkeypatch.setenv("SEMTOOLS_WORKSPACE", "c")
        _cli(main, ["workspace", "use", "c"], capsys, monkeypatch)
        from semtools_tpu_torch.store import Workspace

        rng = np.random.default_rng(3)
        with store_cls(Workspace.open("c").config.root_dir, dim=D) as s:
            s.upsert_document_lines("/big.txt", _unit(rng, 1500))  # >= 1024 reclaimable
            s.upsert_document_lines("/keep.txt", _unit(rng, 64))
            s.delete_documents(["/big.txt"])
        outs[side] = [
            _cli(main, ["workspace", "status"], capsys, monkeypatch),
            _cli(main, ["workspace", "compact", "-j"], capsys, monkeypatch),
            _cli(main, ["workspace", "status"], capsys, monkeypatch),
            _cli(main, ["workspace", "compact"], capsys, monkeypatch),
        ]
        outs[side] = [o.replace(str(home), "<HOME>") for o in outs[side]]
    assert outs["torch"] == outs["jax"]
    status, report, status2, again = outs["torch"]
    assert "workspace compact" in status and "workspace compact" not in status2
    assert json.loads(report) == {"workspace": "c", "rows_live": 64, "slots_before": 1564,
                                  "slots_reclaimed": 1500, "index_remapped": False}
    assert "already compact" in again


def _ann_meta(store_dir):
    with np.load(store_dir / "ann_meta.npz", allow_pickle=False) as z:
        return {k: np.array(z[k]) for k in z.files}


@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_fresh_index_remapped_by_the_other_package(tmp_path, monkeypatch, built_by):
    """One package builds a forced index after a delete, the other compacts
    (a copy of the same directory is compacted by the building package): the
    report says remapped, ``ann_meta.npz`` equals that package's own
    compaction array for array, and that package still serves ``ivf-pq`` with
    the exact hits, also after a later mutation (reconciled by the delta)."""
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
    cls = {"jax": JaxStore, "torch": lambda d, dim: Store(d, dim=dim, device="cpu")}
    other = "torch" if built_by == "jax" else "jax"
    rng = np.random.default_rng(11)
    s = cls[built_by](str(tmp_path / "built"), dim=D)
    model = {}
    for i in range(6):
        x = _unit(rng, 40)
        s.upsert_document_lines(f"/d{i}.txt", x)
        model[f"/d{i}.txt"] = x
    s.delete_documents(["/d2.txt"])
    del model["/d2.txt"]
    s.build_ann_index(force=True)  # fresh AFTER the delete
    assert s.serving_tier() == "ivf-pq"
    s.close()
    shutil.copytree(tmp_path / "built", tmp_path / "self")

    reports = {}
    for where, side in (("built", other), ("self", built_by)):
        with cls[side](str(tmp_path / where), dim=D) as c:
            reports[where] = c.compact()
    assert reports["built"] == reports["self"] == {
        "rows_live": 200, "slots_before": 240, "slots_reclaimed": 40, "index_remapped": True}
    got, want = _ann_meta(tmp_path / "built"), _ann_meta(tmp_path / "self")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    s = cls[built_by](str(tmp_path / "built"), dim=D)
    assert s.serving_tier() == "ivf-pq"
    assert s._ann_current() is not None and len(s._ann_current()[4]) == 0
    _check_search(s, model)
    _check_search(s, model, seed=6, top_k=3)
    x = _unit(rng, 25)
    s.upsert_document_lines("/new.txt", x)
    model["/new.txt"] = x
    assert s.serving_tier() == "ivf-pq"
    got = s.search_line_embeddings(x[7], sorted(model), 1)
    assert (got[0].path, got[0].line_number) == ("/new.txt", 7)
    _check_search(s, model, seed=7)
    s.close()


def test_stale_index_retired_not_corrupted(tmp_path, monkeypatch):
    """A mutation after the build leaves the index stale; compaction then
    moves rows, so the port does not remap it and the drift bound retires
    it in both packages: the exact tiers serve."""
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
    rng = np.random.default_rng(12)
    s = Store(str(tmp_path / "ws"), dim=D, device="cpu")
    model = {}
    for i in range(6):
        x = _unit(rng, 40)
        s.upsert_document_lines(f"/d{i}.txt", x)
        model[f"/d{i}.txt"] = x
    s.build_ann_index(force=True)
    s.delete_documents(["/d3.txt"])
    del model["/d3.txt"]
    assert s.compact()["index_remapped"] is False
    assert s.serving_tier() != "ivf-pq"
    _check_search(s, model)
    with JaxStore(str(tmp_path / "ws"), dim=D) as j:
        assert j.serving_tier() != "ivf-pq"
        _check_search(j, model)
    s.close()


def test_cli_compact_reports_the_remap(tmp_path, monkeypatch, capsys):
    """``workspace compact`` prints the JAX CLI's remap line, and ``-j``
    reports ``index_remapped: true``."""
    monkeypatch.setenv("SEMTOOLS_TPU_FORCE_ANN", "1")
    outs = {}
    for side, main, store_cls in (("jax", jax_cli.main, JaxStore),
                                  ("torch", torch_cli.main, Store)):
        for flag in ([], ["-j"]):
            home = tmp_path / f"{side}{len(flag)}"
            home.mkdir()
            monkeypatch.setenv("HOME", str(home))
            monkeypatch.setenv("SEMTOOLS_WORKSPACE", "c")
            _cli(main, ["workspace", "use", "c"], capsys, monkeypatch)
            from semtools_tpu_torch.store import Workspace

            rng = np.random.default_rng(3)
            with Store(Workspace.open("c").config.root_dir, dim=D, device="cpu") as s:
                s.upsert_document_lines("/gone.txt", _unit(rng, 30))
                s.upsert_document_lines("/keep.txt", _unit(rng, 64))
                s.delete_documents(["/gone.txt"])
                s.build_ann_index(force=True)
            outs[side, len(flag)] = _cli(main, ["workspace", "compact", *flag], capsys,
                                         monkeypatch)
    assert outs["torch", 0] == outs["jax", 0] == (
        "Compacted 64 lines: reclaimed 30 of 94 slots.\n"
        "IVF-PQ index remapped in place (no rebuild needed).\n")
    assert json.loads(outs["torch", 1]) == json.loads(outs["jax", 1]) == {
        "workspace": "c", "rows_live": 64, "slots_before": 94, "slots_reclaimed": 30,
        "index_remapped": True}
