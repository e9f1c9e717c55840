"""SIGKILL crash safety of the port's store (counterpart of
``test_crash_safety.py``): its copy-on-write contract under real process
kills.

Each phase test arms a trap that ``os._exit``'s a child mutator at one point
inside a write path (``semtools_tpu_torch/soak/crash_harness.py``; the child
imports the port only and mutates on the CPU), then verifies the re-opened
store: per-document atomicity (the bytes equal the committed OR the
in-flight state, never a mix), vector and hash sidecar agreement, disjoint
in-bounds live ranges, brute-force-equal search (default, int4 and forced
IVF-PQ tiers) and continued writability. The timer tests add kills at random
instants.
"""

import json
import os
import zlib

import numpy as np
import pytest

from semtools_tpu_torch.soak import crash_harness as ch
from semtools_tpu_torch.store.store import Store

pytestmark = pytest.mark.skipif(os.name != "posix", reason="SIGKILL crash injection is POSIX-only")


@pytest.mark.parametrize("phase", sorted(ch.PHASES))
def test_phase_kill(tmp_path, phase):
    # crc32, not hash(): str hashes are randomized per process
    seed = zlib.crc32(phase.encode()) % 1000
    assert ch.run_round(str(tmp_path), seed=seed, phase=phase) > 0


@pytest.mark.parametrize("seed,delay", [(1, 0.15), (2, 0.45), (3, 0.9)])
def test_timer_kill(tmp_path, seed, delay):
    assert ch.run_round(str(tmp_path), seed=seed, phase=None, kill_after=delay) > 0


def test_verifier_detects_torn_write(tmp_path):
    """A verifier that cannot fail proves nothing: flip one byte inside a
    committed document's vectors and the digest check must trip."""
    store_dir, journal = tmp_path / "ws", tmp_path / "j.jsonl"
    rows = ch.make_rows(np.random.default_rng(5), 10)
    with Store(str(store_dir), dim=ch.DIM, device="cpu") as s:
        s.upsert_document_lines("/a.txt", rows, ch.content_hashes(rows))
    rec = {"op": "upsert", "path": "/a.txt", "digest": ch.digest(rows)}
    journal.write_text(json.dumps({**rec, "phase": "begin"}) + "\n"
                       + json.dumps({**rec, "phase": "done"}) + "\n")
    vec = store_dir / "lines.f32"
    data = bytearray(vec.read_bytes())
    data[3] ^= 0xFF
    vec.write_bytes(data)
    with pytest.raises(ch.CrashVerifyError, match="torn write"):
        ch.verify(str(store_dir), str(journal))
