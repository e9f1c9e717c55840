"""The port's mesh-sharded serving tier of the workspace store against the JAX
package's (``test_store_sharded.py``), on the same numpy embeddings.

The JAX store serves on the 8 virtual CPU devices of this session; the port's
on a mesh of 8 CPU shards (``SEMTOOLS_TORCH_VIRTUAL_DEVICES=8``). Both name the
same tier and serve the same ``(path, line)`` hits in the same order on every
route: the f32, int8 and int4 tiers, threshold mode, path subsets (the
sharded keep mask), the reduced rung, a mutation, a ``top_k`` wider than the
store. Int8 and int4 distances are bit-equal (both re-rank the same pool in
numpy); f32 distances agree within 1e-5. Then the port's own properties: the
sharded corpus keeps its shape and is patched across a small mutation, a
cold process names the warm tier, and a daemon's mesh is not re-shaped by a
forwarded request.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from semtools_tpu.store import device_cache as jax_device_cache
from semtools_tpu.store.store import Store as JaxStore
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

REPO = Path(__file__).resolve().parent.parent
DIM = 32
F32_ATOL = 1e-5


def _unit(rng, n, d=DIM):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for var in ("SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_STORE_INT4", "SEMTOOLS_TPU_SUBSET_DEVICE",
                "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_TPU_REDUCED_DIM",
                "SEMTOOLS_TPU_SHARDED_MIN_ROWS", "SEMTOOLS_TPU_FORCE_ANN"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SEMTOOLS_TPU_SCAN", "device")
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "1")
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "8")
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)
    # the JAX package counts 1 device until its backend is up (store._n_devices)
    assert len(jax.devices()) == 8
    device_cache.invalidate()
    jax_device_cache.invalidate()
    yield
    device_cache.invalidate()
    jax_device_cache.invalidate()


@pytest.fixture()
def stores(tmp_path):
    """Both stores with 3 documents in non-alphabetical slot order and a
    ragged total (123 rows over 8 shards)."""
    j = JaxStore(str(tmp_path / "jax"), dim=DIM)
    t = Store(str(tmp_path / "torch"), dim=DIM, device="cpu")
    rng = np.random.default_rng(42)
    docs = {}
    for name in ("/z.txt", "/a.txt", "/m.txt"):
        rows = _unit(rng, 41)
        for s in (j, t):
            s.upsert_document_lines(name, rows)
        docs[name] = rows
    yield j, t, docs
    j.close()
    t.close()


def _hits(per):
    return [(h.path, h.line_number) for h in per]


def _assert_same(want, got, exact):
    assert _hits(got) == _hits(want) and want
    wd = np.array([h.distance for h in want])
    gd = np.array([h.distance for h in got])
    if exact:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, atol=F32_ATOL, rtol=0)


def _both(j, t, q, paths, top_k, max_distance=None):
    return (j.search_line_embeddings(q, paths, top_k, max_distance),
            t.search_line_embeddings(q, paths, top_k, max_distance))


@pytest.mark.parametrize("tier,env", [
    ("sharded-exact-scan[8]", {}),
    ("sharded-int8-scan[8]", {"SEMTOOLS_TPU_STORE_INT8": "1"}),
    ("sharded-int4-scan[8]", {"SEMTOOLS_TPU_STORE_INT4": "1"}),
])
@pytest.mark.parametrize("subset", ["all", "one"])
@pytest.mark.parametrize("top_k,max_distance", [(5, None), (50, 0.9), (500, None)])
def test_sharded_tiers_match_jax(stores, monkeypatch, tier, env, subset, top_k, max_distance):
    j, t, docs = stores
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("SEMTOOLS_TPU_SUBSET_DEVICE", "1")
    assert t.serving_tier() == j.serving_tier() == tier
    paths = list(docs) if subset == "all" else ["/z.txt"]
    rng = np.random.default_rng(1)
    for q in (docs["/m.txt"][5], docs["/z.txt"][0], _unit(rng, 1)[0]):
        want, got = _both(j, t, q, paths, top_k, max_distance)
        _assert_same(want, got, exact=tier != "sharded-exact-scan[8]")
        assert all(h.path in paths for h in got)
        if max_distance is not None:
            assert all(h.distance < max_distance for h in got)
    if top_k == 500 and subset == "all":
        assert len(got) == 123  # clamped to the store, no padding row served
    assert patch_cache.is_warm(t, "f32" if not env else ("int8" if "INT8" in str(env) else "int4"),
                               mesh=torch_mesh.corpus_mesh(device="cpu"))


def test_sharded_cache_invalidated_on_mutation(stores):
    j, t, docs = stores
    q = docs["/m.txt"][3]
    want, got = _both(j, t, q, list(docs), 3)
    _assert_same(want, got, exact=False)
    new_rows = _unit(np.random.default_rng(9), 7)
    for s in (j, t):
        s.upsert_document_lines("/new.txt", new_rows)
    want, got = _both(j, t, new_rows[2], list(docs) + ["/new.txt"], 1)
    _assert_same(want, got, exact=False)
    assert _hits(got) == [("/new.txt", 2)] and got[0].distance < 1e-5


def test_sharded_auto_threshold(stores, monkeypatch):
    j, t, _ = stores
    monkeypatch.delenv("SEMTOOLS_TPU_SHARDED")
    assert t.serving_tier() == j.serving_tier() == "exact-mxu-scan"  # 123 rows
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED_MIN_ROWS", "100")
    assert t.serving_tier() == j.serving_tier() == "sharded-exact-scan[8]"
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    assert t.serving_tier() == j.serving_tier() == "exact-mxu-scan"


def test_reduced_rung_on_the_mesh(tmp_path, monkeypatch):
    j = JaxStore(str(tmp_path / "jax"), dim=DIM)
    t = Store(str(tmp_path / "torch"), dim=DIM, device="cpu")
    rng = np.random.default_rng(6)
    centers = _unit(rng, 4)
    paths, probe = [], None
    for i in range(4):
        rows = centers[i] + 0.07 * rng.standard_normal((60, DIM)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        for s in (j, t):
            s.upsert_document_lines(f"/d{i}.txt", rows)
        paths.append(f"/d{i}.txt")
        probe = rows[13] if i == 2 else probe
    # the budget scales x8 with the mesh: 500 * 8 = 4000 B is under the int8
    # corpus (240 * 32) and over the reduced one (240 * 9)
    monkeypatch.setenv("SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "500")
    monkeypatch.setenv("SEMTOOLS_TPU_REDUCED_DIM", "8")
    monkeypatch.setenv("SEMTOOLS_TPU_STORE_INT4", "0")
    assert t.serving_tier() == j.serving_tier() == "sharded-int8-scan[8]-reduced8d"
    for top_k, max_distance in ((3, None), (10, 0.5)):
        want, got = _both(j, t, probe, paths, top_k, max_distance)
        _assert_same(want, got, exact=False)
    assert _hits(got)[0] == ("/d2.txt", 13)
    j.close()
    t.close()


def test_sharded_shape_kept_and_patched_across_small_mutation(tmp_path, monkeypatch):
    s = Store(str(tmp_path / "stab"), dim=DIM, device="cpu")
    rng = np.random.default_rng(23)
    bulk = [(f"/s{i}.txt", _unit(rng, 100)) for i in range(30)]  # 3000 rows
    s.upsert_documents_bulk(bulk)
    paths = [p for p, _ in bulk]
    s.search_line_embeddings(bulk[3][1][0], paths, top_k=3)
    keys = [k for k in device_cache._entries if k[0] == str(s.dir)]
    assert len(keys) == 1 and keys[0][1] == "slot" and keys[0][-1] == 8
    sc = device_cache.peek(keys[0])
    assert sc.mesh.size == 8 and sc.corpus.shape[0] == torch_mesh.bucket_rows(3000, 8)
    built = patch_cache.uploaded_bytes()

    builds = []
    real_build = patch_cache._build
    monkeypatch.setattr(patch_cache, "_build", lambda *a: builds.append(a) or real_build(*a))
    new_rows = _unit(rng, 101)  # one row more
    s.upsert_documents_bulk([("/s3.txt", new_rows)])
    hit = s.search_line_embeddings(new_rows[7], paths, top_k=1)[0]
    assert (hit.path, hit.line_number) == ("/s3.txt", 7)
    assert not builds, "the sharded corpus was rebuilt, not patched"
    sc2 = device_cache.peek(keys[0])
    assert sc2.generation > sc.generation and sc2.corpus.shape == sc.corpus.shape
    assert patch_cache.uploaded_bytes() - built <= 2 * new_rows.nbytes
    exact = Store(str(tmp_path / "stab"), dim=DIM, device="cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    ref = exact.search_line_embeddings(new_rows[7], paths, top_k=5)
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "1")
    assert _hits(s.search_line_embeddings(new_rows[7], paths, top_k=5)) == _hits(ref)
    exact.close()
    s.close()


def test_search_documents_sharded_matches_jax(monkeypatch):
    from semtools_tpu.search import Document as JaxDocument
    from semtools_tpu.search import SearchConfig as JaxConfig
    from semtools_tpu.search import search_documents as jax_search
    from semtools_tpu_torch.search import Document, SearchConfig, search_documents

    rng = np.random.default_rng(17)
    mats = [_unit(rng, 50) for _ in range(3)]
    lines = [[f"line {di}:{i}" for i in range(50)] for di in range(3)]
    jdocs = [JaxDocument(filename=f"f{di}.txt", lines=lines[di], embeddings=m)
             for di, m in enumerate(mats)]
    import torch

    tdocs = [Document(filename=f"f{di}.txt", lines=lines[di], embeddings=torch.from_numpy(m))
             for di, m in enumerate(mats)]
    q = mats[1][20]
    for max_distance in (None, 0.9):
        want = jax_search(jdocs, q, JaxConfig(top_k=5, n_lines=0, max_distance=max_distance))
        got = search_documents(tdocs, q, SearchConfig(top_k=5, n_lines=0,
                                                      max_distance=max_distance))
        assert [(r.filename, r.match_line) for r in got] == \
            [(r.filename, r.match_line) for r in want]
        np.testing.assert_allclose([r.distance for r in got], [r.distance for r in want],
                                   atol=F32_ATOL)
    assert (got[0].filename, got[0].match_line) == ("f1.txt", 20)


def test_cold_process_tier_agrees_with_warm(tmp_path, monkeypatch):
    """A cold process names the tier a warm one serves, for a store big
    enough to shard by size."""
    monkeypatch.delenv("SEMTOOLS_TPU_SHARDED")
    ws = tmp_path / "ws"
    s = Store(str(ws), dim=16, device="cpu")
    s.upsert_document_lines("/big.txt", _unit(np.random.default_rng(7), 8300, d=16))
    s.search_line_embeddings(np.ones(16, np.float32) / 4, ["/big.txt"], top_k=1)
    warm = s.serving_tier()
    s.close()
    assert warm == "sharded-exact-scan[8]"
    env = dict(os.environ)
    env.update(SEMTOOLS_TORCH_VIRTUAL_DEVICES="8", SEMTOOLS_TORCH_DEVICE="cpu",
               PYTHONPATH=str(REPO))
    script = ("import sys\n"
              "from semtools_tpu_torch.store.store import Store\n"
              "print(Store(sys.argv[1]).serving_tier())\n")
    out = subprocess.run([sys.executable, "-c", script, str(ws)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == warm


def test_daemon_mesh_not_reshaped_by_a_forwarded_request(tmp_path, monkeypatch):
    """The daemon fixes its mesh when it starts (4 shards here); a request
    that carries SEMTOOLS_TORCH_VIRTUAL_DEVICES=8 is served on those 4, and a
    forwarded search answers as a local one."""
    from semtools_tpu_torch import cli as torch_cli
    from semtools_tpu_torch import daemon

    home = tmp_path / "home"
    home.mkdir()
    doc = tmp_path / "doc.txt"
    doc.write_text("\n".join(f"line {i} about databases and pages" for i in range(40)) + "\n")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("SEMTOOLS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON", "off")
    monkeypatch.setenv("SEMTOOLS_WORKSPACE", "mesh")
    monkeypatch.setenv("SEMTOOLS_TPU_DAEMON_DIR", str(tmp_path / "run"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert torch_cli.main(["workspace", "use", "mesh"]) == 0
    monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "4")
    search = ["search", "database pages", str(doc), "--top-k", "3"]
    local = io.StringIO()
    with contextlib.redirect_stdout(local):
        assert torch_cli.main(search) == 0
    monkeypatch.setattr(torch_mesh, "_VIRTUAL", None)
    th = threading.Thread(target=daemon.serve, kwargs={"warm": False}, daemon=True)
    th.start()
    try:
        for _ in range(200):
            if daemon.ping():
                break
            time.sleep(0.05)
        monkeypatch.setenv(torch_mesh.VIRTUAL_ENV, "8")  # what the client sends
        outs = []
        for argv in (["workspace", "status"], search):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert daemon.forward(argv, None) == 0
            outs.append(buf.getvalue())
    finally:
        assert daemon.stop()
        th.join(timeout=10)
        os.environ["SEMTOOLS_TPU_DAEMON"] = "off"
    assert not th.is_alive()
    assert "Index: Yes (sharded-exact-scan[4])" in outs[0]
    assert outs[1] == local.getvalue()
