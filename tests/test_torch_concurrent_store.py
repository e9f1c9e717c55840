"""Writers in several processes on one port store (counterpart of
``test_concurrent_store.py``).

Without the flock writer lock two processes can interleave
``_alloc_range``'s SELECT and DELETE, claim the same free range and clobber
each other's mmap rows: real concurrent processes (importing the port only)
write, then every document's stored vectors are checked byte for byte.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from semtools_tpu_torch.store.store import Store

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import sys
import numpy as np
from semtools_tpu_torch.store.store import Store

ws_dir, worker_id, n_docs, dim = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])

def rows_for(w, d, dim):
    rng = np.random.default_rng(1000 * w + d)
    n = int(rng.integers(1, 20))
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)

s = Store(ws_dir, dim=dim, device="cpu")
for d in range(n_docs):
    path = f"/w{worker_id}_d{d}.txt"
    s.upsert_document_lines(path, rows_for(worker_id, d, dim))
    if d % 3 == 0 and d > 0:
        # churn the allocator: delete and re-insert an earlier doc
        prev = f"/w{worker_id}_d{d-1}.txt"
        s.delete_line_embeddings([prev])
        s.upsert_document_lines(prev, rows_for(worker_id, d - 1, dim))
s.close()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "semtools_tpu"))
assert not leaked, leaked
"""


def _rows_for(w, d, dim):
    rng = np.random.default_rng(1000 * w + d)
    n = int(rng.integers(1, 20))
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n_workers,n_docs", [(4, 12)])
def test_concurrent_writers_do_not_clobber(tmp_path, n_workers, n_docs):
    ws = str(tmp_path / "ws")
    dim = 16
    Store(ws, dim=dim, device="cpu").close()  # the schema up front
    env = dict(os.environ, PYTHONPATH=str(REPO), SEMTOOLS_TORCH_DEVICE="cpu")
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, ws, str(w), str(n_docs), str(dim)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for w in range(n_workers)
    ]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()

    with Store(ws, dim=dim, device="cpu") as s:
        ranges = s._valid_ranges()
        mm = s._mmap("r")
        stored = {p: np.array(mm[st : st + n]) for p, st, n in ranges}
        # every doc present with exactly its own vectors
        for w in range(n_workers):
            for d in range(n_docs):
                path = f"/w{w}_d{d}.txt"
                want = _rows_for(w, d, dim)
                assert stored[path].shape == want.shape, path
                np.testing.assert_allclose(stored[path], want, atol=1e-6, err_msg=path)
        # no two docs share slots
        spans = sorted((start, start + n) for _, start, n in ranges)
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 <= b0, f"overlapping ranges {(a0, a1)} {(b0, b1)}"
        assert s.count_line_embeddings() == sum(
            len(_rows_for(w, d, dim)) for w in range(n_workers) for d in range(n_docs))


def test_write_lock_is_reentrant(tmp_path):
    s = Store(str(tmp_path / "ws"), dim=8, device="cpu")
    with s._write_lock():
        with s._write_lock():  # delete_documents nests the two delete ops
            assert s._lock_depth == 2
        assert s._lock_depth == 1
    assert s._lock_depth == 0
    s.close()
