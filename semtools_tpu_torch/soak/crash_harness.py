"""SIGKILL crash injection for the port's workspace store.

Counterpart of the repository's ``tests/crash_harness.py``, for
``semtools_tpu_torch.store.store.Store``. The store's write paths keep a
copy-on-write contract (``Store.upsert_documents_bulk`` / ``Store.compact``):
a process death at any instruction leaves every document bytewise equal to
its last committed state or the in-flight one, never a torn mix, and the
store stays openable, servable and writable. This harness proves it with
real kills:

* **child mode**: a subprocess mutates a store on the CPU (upsert, partial
  edit, delete, compact, IVF-PQ build), journaling each operation's intent
  (content digest) *before* it runs and a ``done`` record after. The
  journal is line-buffered, so a SIGKILL keeps what was written (the page
  cache survives a process's death; the contract is process-crash safety).
* **phase traps**: instead of a timer, the child can arm a trap that
  ``os._exit(137)``'s at one point *inside* a write path (before the sqlite
  commit, between the vector flush and the hash-sidecar write, after the
  commit before the old range is freed, between the IVF-PQ index's two
  paired renames, ...); each pins one ordering claim of the store.
* **verifier**: re-opens the store and checks, per document, that the stored
  bytes' digest is one the journal allows; that the hash sidecar agrees
  with the vectors; that no two live ranges overlap and all sit inside the
  epoch file; that a batched search on the verifier's device (the card
  unless the CPU is asked for) equals brute force over the read-back rows on
  the default tier, the int4 tier and the forced IVF-PQ tier; and that the
  store takes a fresh upsert and a compact afterwards.

Used by ``tests/test_torch_crash_safety.py`` and the crash campaign of
``python -m semtools_tpu_torch.soak``. The child alone::

    python -m semtools_tpu_torch.soak.crash_harness child STORE_DIR JOURNAL SEED STEPS [PHASE]
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

os.environ.setdefault("SEMTOOLS_TPU_NO_FETCH", "1")
os.environ.setdefault("SEMTOOLS_TPU_ALLOW_FALLBACK", "1")

import numpy as np

from semtools_tpu_torch.soak import CHILD_TIMEOUT, check_no_jax, child_env

DIM = 16
PATHS = [f"/d{i}.txt" for i in range(6)]

# Every phase trap, with the op that triggers it. Names are "<op>-<point>";
# the child arms the trap, journals ``begin``, runs the op, and the trap
# kills the process mid-write-path.
PHASES = {
    # upsert_documents_bulk: inside the transaction, before db.commit: the
    # docs rows must roll back to the old state.
    "upsert-pre-commit": "upsert",
    # upsert: after the vector mmap flush, before the hash sidecar write (and
    # so before the commit): the old state must survive.
    "upsert-mid-sidecar": "upsert",
    # upsert over an existing path: after the commit, before the replaced
    # range is freed: the new state, the old range leaks (merged back by a
    # later compact), nothing torn.
    "upsert-post-commit": "upsert",
    # delete: _free_range runs inside the transaction: the doc must survive.
    "delete-pre-commit": "delete",
    # compact: the new epoch's files written, the swap not committed: the
    # old epoch keeps serving, the orphan files are swept later.
    "compact-pre-swap": "compact",
    # compact: the swap committed, the instance's paths not refreshed and
    # the old epoch not unlinked: the new epoch serves on reopen.
    "compact-post-swap": "compact",
    # build_ann_index: death before the first rename (tmp files only) and
    # between the two paired renames (index new, meta old): the build token
    # keeps the pair unserved until it is consistent.
    "ann-pre-publish": "ann",
    "ann-mid-publish": "ann",
}


def digest(rows: np.ndarray) -> str:
    return hashlib.blake2b(
        np.ascontiguousarray(rows, np.float32).tobytes(), digest_size=16
    ).hexdigest()


def content_hashes(rows: np.ndarray) -> np.ndarray:
    """Per-row uint64 content hashes (the lines.h64 convention: 0 means
    unknown, so real hashes set the low bit)."""
    return np.array(
        [
            int.from_bytes(
                hashlib.blake2b(
                    np.ascontiguousarray(r, np.float32).tobytes(), digest_size=8
                ).digest(),
                "little",
            )
            | 1
            for r in rows
        ],
        np.uint64,
    )


def make_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    nn = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.where(nn > 0, nn, 1)


# ---------------------------------------------------------------------------
# child


def _arm(phase: str) -> None:
    """Install the phase's kill trap (in this process only; it fires once)."""
    import pathlib

    import semtools_tpu_torch.store.store as st

    def boom(*a, **k):
        os._exit(137)

    if phase in ("upsert-pre-commit", "compact-pre-swap"):
        # _bump_generation runs inside the write transaction, right before
        # db.commit, in both paths.
        st.Store._bump_generation = boom
    elif phase == "upsert-mid-sidecar":
        # called right after the vector mmap flush in the upsert path
        st.Store._hash_mmap = boom
    elif phase in ("upsert-post-commit", "delete-pre-commit"):
        # upsert: the first call is after db.commit; delete: inside the txn
        st.Store._free_range = boom
    elif phase == "compact-post-swap":
        # compact calls _refresh_vec_paths right after the swap's commit
        st.Store._refresh_vec_paths = boom
    elif phase in ("ann-pre-publish", "ann-mid-publish"):
        target = 1 if phase == "ann-pre-publish" else 2
        orig = pathlib.Path.replace
        calls = {"n": 0}

        def patched(self, other):
            calls["n"] += 1
            if calls["n"] == target:
                os._exit(137)
            return orig(self, other)

        pathlib.Path.replace = patched
    else:  # pragma: no cover - a harness bug
        raise ValueError(f"unknown phase {phase!r}")


def child(store_dir: str, journal: str, seed: int, steps: int, phase: str | None):
    """Mutation loop on the CPU. With ``phase``: ``steps`` random ops, then
    one scripted op with the trap armed (it exits 137 from inside). Without:
    loops until the parent's SIGKILL."""
    from semtools_tpu_torch.store.store import Store

    rng = np.random.default_rng(seed)
    s = Store(store_dir, dim=DIM, device="cpu")
    jf = open(journal, "a", buffering=1)
    check_no_jax("crash child")

    def record(rec):
        jf.write(json.dumps(rec) + "\n")

    # Readiness handshake: the parent starts its kill timer only after this
    # record (killing a process that has not mutated anything yet proves
    # nothing).
    record({"op": "ready", "phase": "done"})

    def do_upsert(p, n):
        rows = make_rows(rng, n)
        record({"op": "upsert", "path": p, "phase": "begin", "digest": digest(rows)})
        s.upsert_document_lines(p, rows, content_hashes(rows))
        record({"op": "upsert", "path": p, "phase": "done", "digest": digest(rows)})

    def do_delete(p):
        record({"op": "delete", "path": p, "phase": "begin"})
        s.delete_line_embeddings([p])
        record({"op": "delete", "path": p, "phase": "done"})

    def do_compact():
        record({"op": "compact", "phase": "begin"})
        s.compact()
        record({"op": "compact", "phase": "done"})

    def do_ann():
        record({"op": "ann", "phase": "begin"})
        s.build_ann_index(force=True)
        record({"op": "ann", "phase": "done"})

    live = set()

    def random_op():
        r = rng.random()
        p = PATHS[int(rng.integers(0, len(PATHS)))]
        if r < 0.6 or not live:
            do_upsert(p, int(rng.integers(1, 60)))
            live.add(p)
        elif r < 0.75:
            victim = sorted(live)[int(rng.integers(0, len(live)))]
            do_delete(victim)
            live.discard(victim)
        elif r < 0.88:
            do_compact()
        else:
            do_ann()

    if phase is None:
        while True:  # the parent kills us
            random_op()

    # Warm-up, then the scripted op under the trap. The warm-up gives the
    # op work to do (an existing path to replace or delete, a hole so that
    # compact moves rows).
    for _ in range(steps):
        random_op()
    anchor = sorted(live)[0] if live else PATHS[0]
    if not live:
        do_upsert(anchor, 8)
        live.add(anchor)
    if PHASES[phase] == "compact":
        # a hole below the survivors, so that compact moves rows
        if len(live) < 2:
            do_upsert(PATHS[1], 8)
            live.add(PATHS[1])
        do_delete(sorted(live)[0])
    if PHASES[phase] == "ann":
        # A fresh index makes build_ann_index return early, before the
        # renames: bump the generation so that the build runs.
        do_upsert(anchor, 9)
    _arm(phase)
    op = PHASES[phase]
    if op == "upsert":
        do_upsert(anchor, 12)  # replaces an existing block
    elif op == "delete":
        do_delete(anchor)
    elif op == "compact":
        do_compact()
    else:
        do_ann()
    # The trap must have fired inside the op: exit 0 tells the parent it
    # did not.
    sys.exit(0)


# ---------------------------------------------------------------------------
# verifier

MISSING = object()


class CrashVerifyError(AssertionError):
    pass


def _journal_state(journal: str):
    """Replay the journal: the committed state per path (a digest, or None
    for a committed delete) and the in-flight record, if any."""
    committed: dict = {}
    inflight = None
    with open(journal) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec["phase"] == "begin":
                inflight = rec
            else:
                if rec["op"] == "upsert":
                    committed[rec["path"]] = rec["digest"]
                elif rec["op"] == "delete":
                    committed[rec["path"]] = None
                inflight = None
    return committed, inflight


# The verifier's serving tiers: the default one, the int4 tier (its packed
# corpus rebuilt from the surviving bytes, zero rows included) and the
# forced IVF-PQ tier, which pins the ann-mid-publish ordering claim (a new
# index beside an old meta must stay unserved).
TIER_ENVS = ({}, {"SEMTOOLS_TPU_STORE_INT4": "1"}, {"SEMTOOLS_TPU_FORCE_ANN": "1"})


def verify(store_dir: str, journal: str, device: str = "cpu") -> int:
    """Re-open the crashed store, serving on ``device``, and check every
    invariant. Returns the number of checks made; raises CrashVerifyError on
    a violation."""
    from semtools_tpu_torch.store import device_cache
    from semtools_tpu_torch.store.store import Store

    committed, inflight = _journal_state(journal)
    checks = 0

    def ensure(ok, msg):
        nonlocal checks
        checks += 1
        if not ok:
            raise CrashVerifyError(f"{msg} (journal={journal})")

    s = Store(store_dir, dim=DIM, device=device)  # must open: no damage error
    checks += 1
    try:
        docs = {
            r[0]: (int(r[1]), int(r[2]))
            for r in s.db.execute(
                "SELECT path, slot_start, n_lines FROM docs WHERE slot_start IS NOT NULL"
            )
        }
        cap = s._capacity()
        mm = s._mmap("r")
        hm = s._hash_mmap("r")

        # live ranges: in bounds, pairwise disjoint
        spans = sorted((st, st + n) for st, n in docs.values() if n)
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            ensure(a1 <= b0, f"overlapping live ranges {(a0, a1)} / {(b0, b1)}")
        if spans:
            ensure(spans[-1][1] <= cap, f"live range {spans[-1]} beyond capacity {cap}")
        # free ranges must not meet live ranges
        for fst, fln in s.db.execute("SELECT start, length FROM free"):
            for st_, n in docs.values():
                ensure(
                    fst + fln <= st_ or st_ + n <= fst,
                    f"free range ({fst},{fln}) overlaps live ({st_},{n})",
                )

        def inflight_is(op, path):
            return bool(inflight and inflight["op"] == op and inflight["path"] == path)

        read_rows = {}
        for path, (st_, n) in docs.items():
            rows = np.array(mm[st_ : st_ + n]) if n else np.empty((0, DIM), np.float32)
            read_rows[path] = rows
            dig = digest(rows)
            allowed = set()
            c = committed.get(path, MISSING)
            if c not in (MISSING, None):
                allowed.add(c)
            if inflight_is("upsert", path):
                allowed.add(inflight["digest"])
            ensure(
                dig in allowed,
                f"{path}: stored bytes match NEITHER the committed nor the "
                f"in-flight state (torn write?) got={dig} allowed={allowed} "
                f"committed={c if c is not MISSING else '<absent>'} inflight={inflight}",
            )
            if hm is not None and n:
                ensure(
                    (np.array(hm[st_ : st_ + n]) == content_hashes(rows)).all(),
                    f"{path}: hash sidecar disagrees with stored vectors",
                )
        del mm, hm

        for path, c in committed.items():
            if c is None:
                ensure(path not in docs or inflight_is("upsert", path),
                       f"{path}: committed delete but rows still present")
            else:
                ensure(path in docs or inflight_is("delete", path),
                       f"{path}: committed rows lost by the crash")

        # servability: a batched search equals brute force over the bytes
        # just read back, on each tier of TIER_ENVS
        paths = sorted(docs)
        if paths and sum(len(read_rows[p]) for p in paths):
            rows = np.concatenate([read_rows[p] for p in paths], axis=0)
            qs = make_rows(np.random.default_rng(99), 3)
            saved = {k: os.environ.get(k) for t in TIER_ENVS for k in t}
            for tier_env in TIER_ENVS:
                os.environ.update(tier_env)
                device_cache.invalidate()
                try:
                    per = s.search_line_embeddings_batched(qs, paths, 4)
                    for r in range(len(qs)):
                        dist = 1.0 - rows @ qs[r]
                        order = np.argsort(dist, kind="stable")[: min(4, len(dist))]
                        got = per[r]
                        ensure(
                            len(got) == len(order)
                            and all(abs(h.distance - float(dist[j])) < 3e-4
                                    for h, j in zip(got, order)),
                            f"post-crash search mismatch q={r} tier_env={tier_env}",
                        )
                finally:
                    for k in tier_env:
                        if saved[k] is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = saved[k]
                    device_cache.invalidate()

        # writability: the crash must not wedge the lock, the allocator or
        # the epoch bookkeeping
        fresh = make_rows(np.random.default_rng(100), 5)
        s.upsert_document_lines("/post-crash.txt", fresh, content_hashes(fresh))
        got = s.search_line_embeddings(fresh[0], ["/post-crash.txt"], top_k=1)
        ensure(got and got[0].distance < 3e-4, "post-crash upsert not servable")
        s.compact()
        got = s.search_line_embeddings(fresh[0], ["/post-crash.txt"], top_k=1)
        ensure(got and got[0].distance < 3e-4, "post-crash compact lost the new document")
    finally:
        s.close()
        device_cache.invalidate()
    return checks


# ---------------------------------------------------------------------------
# kill-and-verify rounds (the tests' scenarios and the soak's crash campaign)


def child_argv(store_dir: str, journal: str, seed: int, steps: int, phase: str | None):
    argv = [sys.executable, "-m", "semtools_tpu_torch.soak.crash_harness", "child",
            store_dir, journal, str(seed), str(steps)]
    if phase:
        argv.append(phase)
    return argv


def run_round(tmpdir: str, seed: int, phase: str | None, steps: int = 12,
              kill_after: float = 0.4, device: str = "cpu") -> int:
    """One kill and verify round: the child mutates on the CPU, the verifier
    serves on ``device``. Returns the verifier's checks."""
    import signal
    import subprocess
    import time

    store_dir = os.path.join(tmpdir, "ws")
    journal = os.path.join(tmpdir, "journal.jsonl")
    proc = subprocess.Popen(
        child_argv(store_dir, journal, seed, steps, phase),
        env=child_env("cpu"),
        stdout=subprocess.DEVNULL,
        # timer mode never reads stderr: an undrained pipe could stall it
        stderr=subprocess.PIPE if phase else subprocess.DEVNULL,
    )
    if phase is None:
        # Wait for the readiness record: the interpreter's start takes a
        # while, and a kill timed from the spawn would hit a process that
        # has not touched the store.
        deadline = time.monotonic() + CHILD_TIMEOUT
        while time.monotonic() < deadline:
            if os.path.exists(journal) and os.path.getsize(journal) > 0:
                break
            if proc.poll() is not None:
                raise CrashVerifyError(
                    f"timer child died during startup (exit {proc.returncode})")
            time.sleep(0.01)
        else:
            proc.kill()
            proc.wait(timeout=60)
            raise CrashVerifyError("timer child never became ready")
        time.sleep(kill_after)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
        if proc.returncode != -signal.SIGKILL:
            raise CrashVerifyError(
                f"timer child exited {proc.returncode} before the kill: the "
                f"round proves nothing (the mutation loop is infinite)")
    else:
        try:
            _, err = proc.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise CrashVerifyError(f"phase {phase!r}: child ran past {CHILD_TIMEOUT} s")
        if proc.returncode != 137:
            raise CrashVerifyError(
                f"phase {phase!r}: trap never fired (exit {proc.returncode}); "
                f"stderr:\n{err.decode(errors='replace')[-2000:]}")
    return verify(store_dir, journal, device)


if __name__ == "__main__":
    if len(sys.argv) >= 6 and sys.argv[1] == "child":
        child(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]),
              sys.argv[6] if len(sys.argv) > 6 else None)
    else:  # pragma: no cover
        print(__doc__)
        sys.exit(2)
