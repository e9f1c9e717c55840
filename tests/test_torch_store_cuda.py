"""The store's slot corpus at dims whose rows are not 16-byte aligned.

The kernels read rows of whole 16-byte vectors (``csrc/*.cu``), and a store
of dim 13 (52-byte f32 rows, 13-byte int8 rows) or an int4 store of dim 16
(8 packed bytes a row) has none. The slot corpus is therefore padded with
zero columns (``patch_cache.padded_dim``; int4 pads each half, so the
split-half packing keeps the unpadded row's bytes first) and the queries
alike, so the card serves such a store through its kernels with the same
answers.

The ``cuda`` cases drive the store's whole-store, subset and sharded
searches on a card and need one (they skip without). The other cases pin
the layout on the CPU. This file imports neither jax nor tests/conftest.py's
jax setup, so the card's machine runs it alone:

    python -m pytest --noconftest -m cuda tests/test_torch_store_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from semtools_tpu_torch.ops import kernels
from semtools_tpu_torch.ops.int4_scan import PACKED_ZERO_BYTE, pack_int4
from semtools_tpu_torch.ops.int8_scan import quantize_global
from semtools_tpu_torch.parallel import mesh as torch_mesh
from semtools_tpu_torch.store import device_cache, patch_cache
from semtools_tpu_torch.store.store import Store

ENV = ("SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_STORE_INT4", "SEMTOOLS_TPU_SHARDED",
       "SEMTOOLS_TPU_SUBSET_DEVICE", "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_TPU_SCAN",
       "SEMTOOLS_TPU_REDUCED_DIM", "SEMTOOLS_TPU_FORCE_ANN", "SEMTOOLS_TPU_BUILD")
PATHS = [f"/d{i}.txt" for i in range(6)]

# (name, dim, environment, subset?, kernels the search must launch). The
# f32 corpus of 480 slots takes the single-phase kernel (k + slack > tiles);
# the subset of the f32 case is served by the compact path (a gathered
# corpus of 320 rows, padded by ops.scan.topk_scan).
CASES = [
    ("f32", 13, {}, False, ("fused_scan_candidates",)),
    ("f32-subset", 13, {"SEMTOOLS_TPU_SUBSET_DEVICE": "0"}, True, ("fused_scan_candidates",)),
    ("int8", 13, {"SEMTOOLS_TPU_STORE_INT8": "1"}, False,
     ("int8_tilemax", "select_subtiles", "int8_rescan_topk")),
    ("int8-masked", 13, {"SEMTOOLS_TPU_STORE_INT8": "1", "SEMTOOLS_TPU_SUBSET_DEVICE": "1"},
     True, ("int8_tilemax_masked", "select_subtiles", "int8_rescan_topk_masked")),
    ("int4", 16, {"SEMTOOLS_TPU_STORE_INT4": "1"}, False,
     ("int4_sims_max", "select_subtiles", "int4_cutoff_counts", "int4_extract_above")),
    ("int4-masked", 16, {"SEMTOOLS_TPU_STORE_INT4": "1", "SEMTOOLS_TPU_SUBSET_DEVICE": "1"},
     True, ("int4_sims_max_masked", "int4_cutoff_counts", "int4_extract_above")),
    ("sharded-int8", 13, {"SEMTOOLS_TPU_STORE_INT8": "1", "SEMTOOLS_TPU_SHARDED": "1"}, False,
     ("int8_tilemax", "select_subtiles", "int8_rescan_topk")),
    ("sharded-int4", 16, {"SEMTOOLS_TPU_STORE_INT4": "1", "SEMTOOLS_TPU_SHARDED": "1"}, False,
     ("int4_sims_max", "int4_cutoff_counts", "int4_extract_above")),
]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture()
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    device_cache.invalidate()
    yield monkeypatch
    device_cache.invalidate()


def _fill(store, rng, dim):
    docs = {}
    for p in PATHS:
        rows = _unit(rng, 80, dim)
        store.upsert_document_lines(p, rows)
        docs[p] = rows
    store.delete_line_embeddings([PATHS[2]])  # a freed range inside the corpus
    del docs[PATHS[2]]
    return docs


def _check(store, docs, keys, qs, k):
    rows = np.concatenate([docs[p] for p in keys])
    owner = [(p, i) for p in keys for i in range(len(docs[p]))]
    per = store.search_line_embeddings_batched(qs, keys, k)
    for r, got in enumerate(per):
        dist = 1.0 - rows @ qs[r]
        order = np.argsort(dist, kind="stable")[:k]
        assert [(h.path, h.line_number) for h in got] == [owner[j] for j in order]
        np.testing.assert_allclose([h.distance for h in got], dist[order], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dim,env,subset,launched", CASES, ids=[c[0] for c in CASES])
def test_unaligned_store_is_served_by_the_kernels(tmp_path, clean_env, name, dim, env,
                                                  subset, launched):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the store's kernels have no CPU mode")
    for var, value in env.items():
        clean_env.setenv(var, value)
    if "SEMTOOLS_TPU_SHARDED" in env:
        clean_env.setenv(torch_mesh.VIRTUAL_ENV, "4")
        clean_env.setattr(torch_mesh, "_VIRTUAL", None)
    rng = np.random.default_rng(13)
    s = Store(str(tmp_path / "ws"), dim=dim, device="cuda")
    docs = _fill(s, rng, dim)
    assert s._capacity() >= 256
    keys = sorted(docs)[:4] if subset else sorted(docs)  # a subset of 320 rows
    kernels.reset_launch_counts()
    _check(s, docs, keys, _unit(rng, 2, dim), 3)
    counts = kernels.launch_counts()
    assert all(counts[kn] for kn in launched), {kn: counts[kn] for kn in launched}
    s.close()


# -- the layout, on the CPU ------------------------------------------------------


def test_padded_dims():
    assert [patch_cache.padded_dim("f32", d) for d in (13, 16, 256)] == [16, 16, 256]
    assert [patch_cache.padded_dim("int8", d) for d in (13, 16, 17)] == [16, 16, 32]
    assert [patch_cache.padded_dim("int4", d) for d in (16, 32, 34)] == [32, 32, 64]
    x = np.arange(1, 9, dtype=np.float32).reshape(2, 4)
    np.testing.assert_array_equal(patch_cache.pad_columns(x, "int8", 6),
                                  [[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 0, 0]])
    np.testing.assert_array_equal(patch_cache.pad_columns(x, "int4", 8),
                                  [[1, 2, 0, 0, 3, 4, 0, 0], [5, 6, 0, 0, 7, 8, 0, 0]])
    assert patch_cache.pad_columns(x, "f32", 4) is x


@pytest.mark.parametrize("build", ["host", "device"])
@pytest.mark.parametrize("kind,dim", [("f32", 13), ("int8", 13), ("int4", 16)])
def test_slot_corpus_layout_is_padded(tmp_path, clean_env, kind, dim, build):
    """The built corpus holds the unpadded encoding in its first columns
    (int8: the same quantization; int4: the same packed bytes) and the
    kind's zero encoding after them; a search through it equals brute force."""
    clean_env.setenv("SEMTOOLS_TPU_BUILD", build)
    env = {"int8": "SEMTOOLS_TPU_STORE_INT8", "int4": "SEMTOOLS_TPU_STORE_INT4"}.get(kind)
    if env:
        clean_env.setenv(env, "1")
    rng = np.random.default_rng(5)
    s = Store(str(tmp_path / "ws"), dim=dim, device="cpu")
    docs = _fill(s, rng, dim)
    sc = patch_cache.get(s, kind, device=torch.device("cpu"))
    cap = s._capacity()
    mm = np.zeros((cap, dim), np.float32)
    for p, st, n in s._valid_ranges():
        mm[st : st + n] = docs[p]
    got = sc.corpus.numpy()
    width = patch_cache.padded_dim(kind, dim)
    if kind == "f32":
        want, pad = mm, 0
    elif kind == "int8":
        want, scale = quantize_global(mm)
        assert sc.scale == scale
        pad = 0
    else:
        want, pad = pack_int4(np.clip(np.rint(mm / sc.scale), -7, 7).astype(np.int8)), \
            PACKED_ZERO_BYTE
        width //= 2
    assert got.shape == (cap, width)
    np.testing.assert_array_equal(got[:, : want.shape[1]], want)
    assert (got[:, want.shape[1]:] == pad).all()
    qs = _unit(rng, 3, dim)
    assert sc.query_rows(qs).shape == (3, patch_cache.padded_dim(kind, dim))
    _check(s, docs, sorted(docs), qs, 4)
    # a patch writes padded rows too
    rows = _unit(rng, 7, dim)
    s.upsert_document_lines(PATHS[0], rows)
    docs[PATHS[0]] = rows
    sc2 = patch_cache.get(s, kind, device=torch.device("cpu"))
    assert sc2 is not sc and sc2.corpus.shape[1] == width
    assert (sc2.corpus.numpy()[:, want.shape[1]:] == pad).all()
    _check(s, docs, sorted(docs), qs, 4)
    s.close()
