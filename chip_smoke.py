#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``semtools_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and ``make``/``g++``;
exits non-zero without them. Phases:

1. build: compiles the scan kernels (``semtools_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once) for sm_90a, the native tokenizer
   (``cpp/`` into ``semtools_tpu_torch/_build/``) and the native daemon
   client (``semtools_tpu_torch/native/semtools_client.cpp`` into
   ``_build/semtools-client``);
2. f32 kernels: each fused kernel against its plain PyTorch version on the
   card, at N = 2M and 10M rows x D = 256 f32 (plus bf16 at 2M),
   Q in {1, 8, 32}, k in {3, 10, 64}, ragged n_true, planted duplicate
   rows across sub-tile boundaries (so query 0's sub-tile maxima tie across
   sub-tiles). Sims agree rank by rank within 1e-5; indices must be equal
   except at ranks where the plain version's neighbouring sims lie within
   1e-5 (near-ties of summation order); planted duplicates resolve to the
   lower index. The sub-tile selection (``select_subtiles``, every format's)
   must equal the plain stable sort exactly. Times at N = 2M, Q = 8, k = 10:
   CUDA events around 20 calls (what a caller pays, host included), the
   device time of the same calls under torch.profiler, the plain path's
   events time and, for the selection, one ``torch.topk``; one two-phase
   call under the profiler must show phase 1 and then exactly the
   selection and the rescan-and-merge kernels;
3. int8 kernels: each int8 kernel (plain and masked) against its plain
   version on int8 corpora of N = 2M and 10M rows x 256 (``quantize_global``
   of seeded unit rows; ragged n_true; planted duplicates), Q in {1, 8, 32},
   k in {3, 10, 64}, with no mask, a random 50% mask and a mask keeping
   fewer than k rows. Integer arithmetic: sims equal rank by rank, indices
   equal (the rescan-and-merge's -inf filler rows too), duplicates lowest
   first. Times as in phase 2 at N = 10M, Q = 8, k = 10;
4. int4 kernels: each int4 kernel (the deep-candidate sweep and the two
   phases, plain and masked) against its plain version on packed corpora of
   N = 2M and 10M rows x 256 (random bytes made on the card from a seeded
   generator; ragged n_true; planted duplicates across the 128- and 512-row
   boundaries), Q in {1, 8, 32, 40} (40: two launches of at most 32), k in
   {3, 10, 64, 200}, masks as in phase 3. Integer arithmetic: the sweep's
   sims and block maxima bit-equal, the phases as in phase 3; the selection
   kernels (``csrc/select_above.cu``: ``int4_cutoff_counts`` in each of its
   modes, ``int4_extract_above`` at the batch's cap and past the cap) against
   their plain versions on the same sweep: the margin on the card and the
   cutoffs bit-equal, the counts and the count pass's marks (per-block
   counts, group totals, the hit blocks' masks) equal, the candidate sets
   equal, under the cap row for row the rows the marks give (a second call
   gives the same tensor); query 1 is a row copied into one row of every
   1,500 (its candidates alone span 1,333 / 6,666 blocks: n_b >= 1024); the
   deep candidates of the kernel path equal those of the plain sweep through
   the plain selection, also past the candidate cap
   (``SEMTOOLS_TPU_INT4_CAP``: query 0 keeps its first four duplicates,
   query 1 the copies in the four lowest blocks), and equal the rows at or
   above their lowest sim when under it. Then ``int4_topk_scan`` through its
   public entry point (counts reset just before: the two-phase kernels' own
   path) against the plain phases, and times as in phase 2 at N = 10M, Q =
   8, k = 10; ``int4_deep_candidates`` also against the sweep kernel plus
   the plain selection (and with the dense query), and one call of it,
   plain and masked, and past the cap, must make exactly one synchronising
   read (``torch.cuda.set_sync_debug_mode("warn")``) and launch no sort or
   top-k kernel; after the sweep its profiler listing must hold exactly
   ``select_subtiles``, the cutoff and count kernels (the one pass over the
   hit blocks' sims) and, under the cap, the one write kernel (past it the
   write kernel listing every marked row, then the rule kernel), logged as
   the call's launches; the extraction past the cap is timed too;
5. probes (``semtools_tpu_torch/probes``, kernels ``csrc/stream.cu`` and
   ``csrc/probe_tilemax.cu``): every tile-max variant (masked and not; a
   whole-tile max, 512-row sub-tiles, full sims) and the stream kernels
   against their plain versions at ragged small sizes; then each probe
   module at its published size (launches counted on its own run): the
   stream sweep over ~10M x 256 int8 rows (tiles, rings, ``torch.sum``; the
   best is ``stream_roof_gbps``), the tile-max sweep (2M rows), the int8
   phase 1 taken apart (10M rows), the int4 split-half sweep (2M rows) and
   the int4 unpack recipes (4.2M rows; and the floor scheme's full sims of
   8,192 rows), each call against its plain version (bit-equal; bf16 rows
   within 1e-5), the int4 sweep's tile maxima and the floor scheme's full
   sims against their JAX probes' integer oracles (exactly 0), and timed as
   in phase 2 (the module's events time: least of 3 trials of 20 calls), the
   byte-bound scan kernels of phases 2-4 quoted as a share of the roof;
6. main path: ``semtools search`` through ``semtools_tpu_torch.cli.main``
   over ~1M lines of seeded synthetic text in 500 files (the corpus sits on
   the card as 1M x 256 f32) with the built-in 65,536 x 256 embedder, one
   query and an 8-query ``-Q`` batch, plus a 2,000-line search that routes
   to the single-phase kernel;
7. workspace: under a fresh HOME, ``workspace use``, a cold ``search -w``
   over the same 1M lines (embed + upsert; the store serves them from its
   int8 slot corpus, 256 MB on the card), a warm repeat, a ``-Q`` batch, a
   300-file subset (the masked int8 kernels), the same query on the f32
   tier (``SEMTOOLS_TPU_STORE_INT8=0``: the fused f32 kernels), a one-line
   edit (line reuse) and ``workspace status``; then the int4 tier on the same
   workspace (``SEMTOOLS_TPU_STORE_INT4=1``): a first search (the 128 MB
   packed corpus build), a warm repeat, a ``-Q`` batch, the 300-file subset
   (the masked sweep) and a ``-m`` threshold search; and without that
   variable, a 200 MB device budget, where the int8 corpus (256 MB) does not
   fit and the int4 one does: ``workspace status`` must name
   ``int4-mxu-scan`` and a search is served from it;
8. workspace residency, on the same workspace: the int8 and int4 corpora
   built on the card (``SEMTOOLS_TPU_BUILD=device``, as the cold search's
   ``auto`` does) and on the host must be byte-equal; the one-line edit of
   phase 7 must be served by a patch (no ``slot_corpus_build`` stage, one
   row and its index uploaded); budgets of 100 MB and 50 MB pick the
   reduced-64d and reduced-32d rungs (``workspace status``), whose top-k and
   ``-m`` searches must equal the plain scan; ``workspace compact -j`` must
   reclaim the 2,000 slots the edit freed, and the next search must catch up
   by the patch's moves (nothing uploaded); then the daemon, served from a
   thread of this process (``daemon.serve``, warm-up included, under its own
   ``SEMTOOLS_TPU_DAEMON_DIR``): a search forwarded from a child process
   against the same search in a child that does not forward, 8 concurrent
   child clients (one coalesced scan or a few; each output equal to its
   direct run; the int8 kernels launched from the daemon's threads), the
   forwarded search through the native client 10 times from new processes
   (stdout and exit code equal to the Python client's; the median wall
   logged), an edit then a forwarded search (patched, not rebuilt), and
   ``stop``; then the native client with no daemon, which must exec
   ``python -m semtools_tpu_torch.cli`` and print the daemon's answer;
9. IVF-PQ: the index layer (``semtools_tpu_torch/index``) on a seeded,
   clustered 100,000 x 256 set (nlist 1024, m 32), built twice on the card
   (byte-equal: the build's determinism) and once on the CPU (the full
   builds' agreement logged: k-means amplifies last-bit differences); on the
   card's quantizers a Lloyd step and the fused pass agree on the card and
   the CPU to >= 99.9% of the assignments and code bytes and answer 64
   queries alike; then on a 10M x 256 tensor made on the card (nlist 4096:
   train, fused pass and finalize timed, the memory peak, the lists and
   codes of one chunk's worth of sampled rows recomputed by the separate
   passes); then the store,
   on the workspace of phases 7-8 with ``SEMTOOLS_TPU_FORCE_ANN=1``:
   ``workspace index --force -j`` built on the card, ``workspace status``
   naming ``ivf-pq``, a ``-Q`` 8 search (every served distance equal to
   ``1 - row . q`` from the vector file within 1e-6; recall@10 against the
   exact hits logged), the 300-file subset (served exactly by the compact
   path: the fused kernels' launches counted), ``workspace compact``
   (``index_remapped``; the next search names ``ivf-pq`` with the same hits)
   and a one-line edit served through the delta (no rebuild: the meta
   untouched, one document in the reconcile).
10. parse and ask: on the workspace of phase 7 (its int8 tier warm, after
   the edit), ``ask`` against a scripted fake OpenAI on localhost
   (``tests/fake_servers.py``): chat mode over the 1M lines without ``-w``
   (turn 1: four parallel ``search`` calls with one config, which must be
   served by one batched scan: the fused kernels; turn 2: a ``grep``, which
   must run the native scanner and equal a Python ``re`` scan, and a
   ``read``; turn 3: the answer), then responses mode with ``-w`` over all
   files (the int8 kernels; once more under torch.profiler for the device's
   busy share) and over the 300-file subset (the masked ones), and after
   the int4 steps the same two on the int4 rung (the sweep, plain and
   masked).
   Each search tool output's hits equal the plain scan of the same
   embeddings (tolerance as in phase 2), no tool output may start with
   ``Error:`` and each run must show launches of its path's kernels (counts
   reset just before it; their sum is each kernel's ``ask_launches``). In
   phase 8's daemon steps, an ``ask`` forwarded from a child process must
   print what the same ask prints run here. Then, under a fresh HOME,
   ``parse -b local`` over 250 seeded documents (docx, pptx, xlsx, html and
   pdf with FlateDecode streams), five of them carrying a planted line: a
   ``search`` on the card over the printed markdown must rank each planted
   line first for its own text, and a second ``parse`` must be served from
   the cache; ``parse`` against a fake LlamaParse on localhost with one
   injected 5xx must take the retry, and a rerun must send no request.
   Every run logs its wall time and stages (``SEMTOOLS_TPU_TIMINGS``).
11. sharded serving, in a child process whose mesh is 4 shards of the card
   (``SEMTOOLS_TORCH_VIRTUAL_DEVICES=4``): ``parallel.dryrun``'s checks on
   the card; the sharded scans at phases 2-4's sizes (2M x 256 f32, 10M x
   256 int8, 10M x 256 int4 plain and masked; Q 8, k 10, a ragged n_true
   that leaves the last shard partly padding) against the single-device
   kernel path on the same tensors (f32 under phase 2's near-tie rule, int8
   exactly, int4 as candidate sets; planted duplicates lowest first), each
   kernel launched once per shard (the int4 cutoff kernel twice and once for
   the merge; one synchronising read, no sort, as in phase 4), both timed;
   then on the workspace of
   phase 7 every command on one device (``SEMTOOLS_TPU_SHARDED=0``) and on
   the mesh (``=1``), outputs equal: ``search -w``, ``-Q 8``, the 300-file
   subset, ``-m``, a one-line edit served by a patch of the sharded corpus,
   the f32 tier, the int4 rung, the reduced-64d rung (a quarter of the
   budget: the budget scales with the mesh), each ``workspace status``
   naming ``sharded-*-scan[4]``, and a plain ``search -Q 8`` over the 1M
   lines through ``search.py``'s sharded branch. The counts are reset
   before each run on the mesh and read after: their sums are each
   kernel's ``sharded_launches``.
12. the soak (``python -m semtools_tpu_torch.soak``) in a child process on
   the card, its sharded tiers on 4 shards (``SEMTOOLS_TORCH_VIRTUAL_DEVICES=4``),
   at ``SOAK_ARGS``: the store campaign (random op sequences on its eleven
   tiers at dims 13 and 16, corpora of 1-300 rows, k in {1, 3, 70, n+5}, Q
   in {1, 2, 40}, thresholds, subsets, zero and duplicate rows, compaction
   mid-churn), the workspace and daemon campaigns and the SIGKILL crash
   campaign (its verifier serving on the card), every answer against brute
   force. It fails on a mismatch, on a campaign with no check, and when a
   serving kernel of ``SOAK_KERNELS`` (or a sharded twin of
   ``SOAK_SHARDED``) shows no launch in the soak's counts (reset before each
   campaign); the kernels of ``SOAK_REPORTED`` are logged with their
   launches and the routing that keeps them out. Each campaign's wall,
   checks and launches are logged; the sums are each kernel's
   ``soak_launches``.

Phases 6-10 check their hits against a plain exact scan of the same
embeddings on the card (tolerance as in phase 2), and every kernel of each
path must show launches in that path's run (counts reset just before it).
The launch floor (an empty kernel through the kernels' ctypes path) is
timed after the build. The last line of stdout is ``{"ok": true,
"device": {...}}``; the lines before it are the card's name and power limit,
the ``stream_roof_gbps`` line, and the per-kernel JSON summary (with
``device_ms``, ``floor_ms``, ``ask_launches``, ``sharded_launches`` and
``soak_launches`` beside the contract's keys;
a probe's entry is the call named in PROBES).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TOL = 1e-5
SEED = 20261016
N_FILES, LINES_PER_FILE = 500, 2000  # the main path's ~1M-line corpus
SUBSET_FILES = 300  # the workspace phase's path subset (60% of the slots)
D = 256
FUSED_SOURCE = "semtools_tpu_torch/csrc/fused_scan.cu"
INT8_SOURCE = "semtools_tpu_torch/csrc/int8_scan.cu"
INT4_SOURCE = "semtools_tpu_torch/csrc/int4_scan.cu"
SELECT_SOURCE = "semtools_tpu_torch/csrc/select.cu"
SELECT_ABOVE_SOURCE = "semtools_tpu_torch/csrc/select_above.cu"
REPLACES = {
    "fused_tilemax": "semtools_tpu/ops/pallas_scan.py:269",
    "fused_rescan_topk": "semtools_tpu/ops/pallas_scan.py:293",
    "fused_scan_candidates": "semtools_tpu/ops/pallas_scan.py:152",
    "select_subtiles": "semtools_tpu/ops/pallas_scan.py:362",
    "int8_tilemax": "semtools_tpu/ops/int8_scan.py:118",
    "int8_rescan_topk": "semtools_tpu/ops/int8_scan.py:133",
    "int8_tilemax_masked": "semtools_tpu/ops/int8_scan.py:217",
    "int8_rescan_topk_masked": "semtools_tpu/ops/int8_scan.py:236",
    "int4_sims_max": "semtools_tpu/ops/int4_scan.py:317",
    "int4_sims_max_masked": "semtools_tpu/ops/int4_scan.py:334",
    "int4_tilemax": "semtools_tpu/ops/int4_scan.py:220",
    "int4_rescan_topk": "semtools_tpu/ops/int4_scan.py:232",
    "int4_tilemax_masked": "semtools_tpu/ops/int4_scan.py:608",
    "int4_rescan_topk_masked": "semtools_tpu/ops/int4_scan.py:624",
    # the XLA between K6 and the answer: _int4_cutoff_counts after the
    # pallas_call, and _extract_above
    "int4_cutoff_counts": "semtools_tpu/ops/int4_scan.py:420",
    "int4_extract_above": "semtools_tpu/ops/int4_scan.py:439",
}
SOURCES = {"fused": FUSED_SOURCE, "int8": INT8_SOURCE, "int4": INT4_SOURCE,
           "select": SELECT_SOURCE}
SELECTION = ("int4_cutoff_counts", "int4_extract_above")  # csrc/select_above.cu
# the device kernels of the selection after the sweep: select.cu's, then
# csrc/select_above.cu's (int4_cutoff_counts', then int4_extract_above's under
# the cap and past it)
CUTOFF_KERNELS = ("select_kernel", "int4_cutoff_kernel", "int4_count_kernel")
EXTRACT_KERNELS = ("int4_write_kernel",)
PAST_CAP_KERNELS = ("int4_write_kernel", "int4_rule_kernel")
SELECTION_KERNELS = CUTOFF_KERNELS + PAST_CAP_KERNELS
K5 = ("int4_tilemax", "select_subtiles", "int4_rescan_topk", "int4_tilemax_masked",
      "int4_rescan_topk_masked")
K6 = ("int4_sims_max", "int4_sims_max_masked")
# Copies of row 9 every DENSE_STRIDE rows of the packed corpora (one a
# block): query 1 of the int4 checks is that row, so its candidates alone
# span 1,333 blocks at 2M rows and 6,666 at 10M (n_b 2048 and 8192 at least).
DENSE_STRIDE = 1500
INT4_BUDGET = 209_715_200  # bytes: under the int8 corpus of 1M x 256, over the int4 one
# bytes: between the reduced-64d corpus (65 B a slot, 1.002M slots) and the
# int4 one (128 B), then between the reduced-32d (33 B) and the 64d one
REDUCED_BUDGETS = (("reduced64d", 104_857_600), ("reduced32d", 52_428_800))
INT8_PATH = ("int8_tilemax", "select_subtiles", "int8_rescan_topk")
F32_PATH = ("fused_tilemax", "select_subtiles", "fused_rescan_topk")
# The IVF-PQ index layer: a clustered set built on the card and on the CPU,
# then a corpus at scale made on the card.
ANN_ROWS, ANN_CENTERS, ANN_SPREAD, ANN_QUERIES = 100_000, 4096, 0.05, 64
SCALE_ROWS, SCALE_CENTERS = 10_000_000, 65_536
AGREE = 0.999  # card against CPU on the same quantizers: least share of equal results
E_SCALE = 1.0 / 7.0  # the packed corpora of phase 4 are random bytes: any scale serves
# Data-sheet peaks of one H100 SXM at 700 W: HBM bytes/s, f32 FLOP/s on the
# CUDA cores, bf16 and int8 tensor-core FLOP/s and OP/s.
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, kind: str):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agree(what, vals, ref_vals, idx=None, ref_idx=None) -> float:
    """Max |vals - ref| over finite ranks; raises when sims differ by more
    than TOL or an index differs away from a near-tie of the plain sims.
    The plain version may carry one rank more than the kernel (its k+1-th
    value is the last rank's neighbour across the cut)."""
    import torch

    k = vals.shape[-1]
    full = ref_vals.float()
    vals, ref_vals = vals.float(), full[..., :k]
    fin = torch.isfinite(ref_vals)
    if not torch.equal(fin, torch.isfinite(vals)):
        raise AssertionError(f"{what}: -inf slots differ from the plain version")
    err = (vals - ref_vals)[fin].abs().max().item() if bool(fin.any()) else 0.0
    if not err <= TOL:
        raise AssertionError(f"{what}: max |sim - plain| = {err} > {TOL}")
    if idx is not None:
        gap = (full[..., 1:] - full[..., :-1]).abs() <= TOL
        near = torch.zeros_like(full, dtype=torch.bool)
        near[..., 1:] |= gap
        near[..., :-1] |= gap
        bad = (idx != ref_idx[..., :k]) & fin & ~near[..., :k]
        if bool(bad.any()):
            raise AssertionError(f"{what}: {int(bad.sum())} indices differ away from near-ties")
    return err


def equal(what, vals, ref_vals, idx=None, ref_idx=None) -> float:
    """Integer sims: values equal rank by rank, indices equal wherever the
    values are finite. Returns the max abs difference (0.0)."""
    import torch

    if not torch.equal(vals, ref_vals):
        raise AssertionError(f"{what}: sims differ from the plain version")
    if idx is not None:
        fin = torch.isfinite(ref_vals)
        if not torch.equal(idx[fin], ref_idx[fin]):
            raise AssertionError(f"{what}: indices differ from the plain version")
    return 0.0


def cuda_ms(fn, reps: int = 20) -> float:
    """CUDA events around ``reps`` back-to-back calls, per call: for a kernel
    of a few microseconds this is the host's issue rate, not device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced(fn, reps: int = 1, tries: int = 5, want: str = ""):
    """(the CUDA events in start order, wall ms) of ``reps`` calls of ``fn``
    under torch.profiler. Now and then the profiler hands back a trace that
    holds no device event at all, or only some of them, though the calls
    launched kernels: a trace with no event, or with none whose name holds
    ``want``, is taken again, up to ``tries`` times in all, and each retry is
    logged. The last trace is returned, whatever it holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if (events and any(want in e.name for e in events)) or attempt == tries:
            return events, wall
        log(f"profiler: trace {attempt} of {tries} held no device event"
            f"{f' named {want!r}' if want else ''}; tracing again")


def device_ms(fn, name=None, reps: int = 20) -> float:
    """Device time of ``fn`` under torch.profiler over ``reps`` calls: with
    ``name``, the mean of the traced launches of the kernels whose name holds
    it (one a call); without, all traced device work summed, per call. Where
    the profiler traces no device work, events around the replay of a CUDA
    graph of the same calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    events, _ = traced(fn, reps, want=name or "")
    events = [e for e in events if name is None or name in e.name]
    if events:
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / (
            reps if name is None else len(events))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=1) / reps


def launch_floor():
    """(events ms, device ms) of one empty kernel launched through the
    kernels' ctypes path: what any launch of a few microseconds costs."""
    import torch

    from semtools_tpu_torch.ops import kernels

    lib = kernels.library()

    def empty():
        code = lib.semtools_empty_launch(torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"empty launch failed: CUDA error {code}")

    floor = (cuda_ms(empty), device_ms(empty, "empty_kernel"))
    log(f"time: launch floor (empty kernel through ctypes): {floor[0]:.4f} ms events, "
        f"{floor[1]:.4f} ms device")
    return floor


def timing(fn, plain, bnd, kernel=None, plain_reps: int = 20, library=None) -> dict:
    """One kernel's (or path's) numbers: events and device time, its plain
    version's events time, its bound and, where one exists, the events
    time of the one PyTorch call that computes the same function."""
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn, kernel),
            "plain_ms": cuda_ms(plain, reps=plain_reps), "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None if library is None else cuda_ms(library)}


def log_times(prefix: str, t: dict) -> None:
    for name, r in t.items():
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        log(f"time: {prefix} {name}{' 50% mask' if 'masked' in name else ''}: kernel "
            f"{r['ms']:.4f} ms events / {r['device_ms']:.4f} ms device, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){lib}")


def select_timing(sub_max, k: int) -> dict:
    """The selection kernel's numbers on phase 1's [Q, S] maxima; its
    library yardstick is one torch.topk (whose tie order is not pinned; the
    port never calls it)."""
    import torch

    from semtools_tpu_torch.ops import fused_scan as fs

    qn, s = sub_max.shape
    r = timing(lambda: fs.top_subtiles(sub_max, k), lambda: fs.select_subtiles(sub_max, k),
               bound(qn * s * 4 + qn * k * 8, float(qn * s), "f32"), "select_kernel",
               library=lambda: torch.topk(sub_max, k))
    log(f"time: select_subtiles Q={qn} S={s} k={k}: {r['ms']:.4f} ms events / "
        f"{r['device_ms']:.4f} ms device, torch.topk {r['library_ms']:.4f} ms, plain (stable "
        f"sort) {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    # blocks per query: one per SELECT_CHUNK maxima, the last one merging
    chosen, sweep = fs.SELECT_CHUNK, []
    try:
        for chunk in (1024, 2048, 4096, 8192):
            fs.SELECT_CHUNK = chunk
            sweep.append(f"{chunk}: {device_ms(lambda: fs.top_subtiles(sub_max, k), 'select'):.4f}")
    finally:
        fs.SELECT_CHUNK = chosen
    log(f"time: select_subtiles Q={qn} S={s} k={k} device ms by maxima per block "
        f"({-(-s // chosen)} blocks per query at {chosen}): " + ", ".join(sweep))
    return r


def two_phase_ops(what: str, fn, phase1: str) -> None:
    """One call of a two-phase scan under torch.profiler: after phase 1 its
    device work is the selection and the rescan-and-merge kernels, and
    nothing else (no torch op, no copy) until the [Q, k] answer they write;
    what a caller does with the answer (distances from sims) comes after."""
    import torch

    fn()
    torch.cuda.synchronize()
    ops, _ = traced(fn, want=phase1)
    names = [e.name for e in ops]
    first = next((i for i, n in enumerate(names) if phase1 in n), None)
    after = names[first + 1:] if first is not None else names
    if first is None or len(after) < 2 or "select_kernel" not in after[0] \
            or "rescan_topk_kernel" not in after[1]:
        raise AssertionError(f"{what}: device work after phase 1 is {after}")
    log(f"{what}: {len(names)} device ops; after phase 1 select_kernel, rescan_topk_kernel "
        f"({sum(e.time_range.elapsed_us() for e in ops[first + 1:first + 3]):.1f} us), then the "
        f"answer; {len(after) - 2} ops on it after")


def after_phase1(t: dict, whole: str, phase1: str) -> None:
    """The time a two-phase scan spends after its phase 1."""
    log(f"time: {whole} minus {phase1}: {t[whole]['ms'] - t[phase1]['ms']:.4f} ms events, "
        f"{t[whole]['device_ms'] - t[phase1]['device_ms']:.4f} ms device")


def build_phase():
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.ops.fused_scan import SUB_ROWS
    from semtools_tpu_torch.utils import native

    t0 = time.perf_counter()
    path = kernels.build()
    lib = kernels.library()
    if lib.semtools_scan_rows() != SUB_ROWS:
        raise AssertionError("kernel rows per block disagree with fused_scan.SUB_ROWS")
    log(f"build: kernels {path.name} ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.last_build_seconds} s, {len(kernels.SOURCES)} sources in parallel)")
    report = path.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", report)]
    log(f"build: ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} registers, "
        f"{sum(1 for b in spills if b)} with spill stores (at most {max(spills)} bytes)")
    t0 = time.perf_counter()
    if not native.build():
        raise RuntimeError(f"native tokenizer build (make -C cpp) failed: {native.lib_path()}")
    log(f"build: native tokenizer into {native.lib_path().relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    client = native.build_client()
    log(f"build: native daemon client into {client.relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.2f} s")


def unit_rows(n, gen):
    import torch

    e = torch.randn((n, D), generator=gen, device="cuda")
    return e / e.norm(dim=1, keepdim=True)


def make_corpus(n, dtype, n_true, gen):
    e = unit_rows(n, gen)
    dups = [5, 127, 128, n // 2, n_true - 1]  # inside, across sub-tiles, far
    e[dups[1:]] = e[5].clone()
    return e.to(dtype), dups


def f32_kernel_phase():
    import torch

    from semtools_tpu_torch.ops import fused_scan as fs

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {name: 0.0 for name in ("fused_tilemax", "fused_rescan_topk", "fused_scan_candidates",
                                   "select_subtiles")}
    times = {}
    cases = [(n, torch.float32) for n in (2_000_000, 10_000_000)] + [(2_000_000, torch.bfloat16)]
    for n, dtype in cases:
        n_true = n - 777
        e, dups = make_corpus(n, dtype, n_true, gen)
        for qn in (1, 8, 32):
            q = unit_rows(qn, gen)
            q[0] = e[5].float()
            ref_max = fs.tilemax_reference(q, e, n_true)
            errs["fused_tilemax"] = max(errs["fused_tilemax"], agree(
                "tilemax", fs.tilemax(q, e, n_true), ref_max))
            for k in (3, 10, 64):
                ids = fs.top_subtiles(ref_max, k)
                equal("select_subtiles", ids, fs.select_subtiles(ref_max, k))
                v, i = fs.rescan_topk(q, e, n_true, ids, k)
                vr, ir = fs.rescan_topk_reference(q, e, n_true, ids, k + 1)
                errs["fused_rescan_topk"] = max(errs["fused_rescan_topk"],
                                                agree("rescan_topk", v, vr, i, ir))
                cv, ci = fs.scan_candidates(q, e, n_true, k)
                cvr, cir = fs.scan_candidates_reference(q, e, n_true, k + 1)
                errs["fused_scan_candidates"] = max(
                    errs["fused_scan_candidates"], agree("scan_candidates", cv, cvr, ci, cir))
                d, idx = fs.fused_topk_scan(q, e, k, n_true=n_true)
                want = sorted(dups)[: min(k, len(dups))]
                if idx[0, : len(want)].tolist() != want:
                    raise AssertionError(f"planted duplicates {want} came out as "
                                         f"{idx[0, :len(want)].tolist()}")
                del cv, ci, cvr, cir
            log(f"kernels: {str(dtype)[6:]} N={n} n_true={n_true} Q={qn} k=3,10,64: "
                f"agree (max err so far {max(errs.values()):.3g})")
        if n == 2_000_000 and dtype == torch.float32:
            times = time_f32_kernels(e, n_true, gen)
        elif n == 2_000_000:
            time_f32_kernels(e, n_true, gen)  # bf16: logged only
        del e
        torch.cuda.empty_cache()
    return errs, times


def time_f32_kernels(e, n_true, gen):
    from semtools_tpu_torch.ops import fused_scan as fs
    from semtools_tpu_torch.ops.scan import _topk_chunk

    qn, k = 8, 10
    q = unit_rows(qn, gen)
    sub_max = fs.tilemax(q, e, n_true)
    ids = fs.top_subtiles(sub_max, k)
    item = e.element_size()
    s = fs._num_blocks(n_true)
    u = ids.unique().numel()
    scan_ops = 2.0 * qn * n_true * D
    two_phase_ops(f"{e.dtype} _two_phase_topk", lambda: fs._two_phase_topk(q, e, n_true, k),
                  "tilemax_kernel")
    t = {
        "fused_tilemax": timing(
            lambda: fs.tilemax(q, e, n_true),
            lambda: fs.tilemax_reference(q, e, n_true),
            bound(n_true * D * item + qn * D * 4 + qn * s * 4, scan_ops, "f32"), "tilemax_kernel"),
        "select_subtiles": select_timing(sub_max, k),
        "fused_rescan_topk": timing(
            lambda: fs.rescan_topk(q, e, n_true, ids, k),
            lambda: fs.rescan_topk_reference(q, e, n_true, ids, k),
            bound(u * fs.SUB_ROWS * D * item + qn * D * 4 + ids.numel() * 8 + qn * k * 12,
                  2.0 * ids.numel() * fs.SUB_ROWS * D, "f32"), "rescan_topk_kernel"),
        "fused_scan_candidates": timing(
            lambda: fs.scan_candidates(q, e, n_true, k),
            lambda: fs.scan_candidates_reference(q, e, n_true, k),
            bound(n_true * D * item + qn * D * 4 + s * qn * k * 12, scan_ops, "f32"),
            "scan_kernel"),
        "topk_scan": timing(
            lambda: fs.fused_topk_scan(q, e, k, n_true=n_true),
            lambda: _topk_chunk(q, e, 0, n_true, k),
            bound(n_true * D * item, scan_ops, "f32")),
    }
    log_times(f"{e.dtype} N={e.shape[0]} Q={qn} k={k}", t)
    after_phase1(t, "topk_scan", "fused_tilemax")
    return t


FEW_ROWS = 2  # rows the "few" mask keeps: fewer than every k checked


def int8_masks(n, gen):
    import torch

    half = (torch.rand(n, generator=gen, device="cuda") < 0.5).to(torch.uint8)
    few = torch.zeros(n, dtype=torch.uint8, device="cuda")
    few[torch.randint(0, n, (FEW_ROWS,), generator=gen, device="cuda")] = 1
    return {"none": None, "half": half, "few": few}


def int8_kernel_phase():
    import torch

    from semtools_tpu_torch.ops import int8_scan as i8
    from semtools_tpu_torch.ops.fused_scan import select_subtiles, top_subtiles

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    errs = {name: 0.0 for name in REPLACES if name.startswith("int8")}
    times = {}
    for n in (2_000_000, 10_000_000):
        n_true = n - 777
        e, dups = make_corpus(n, torch.float32, n_true, gen)
        e8, e_scale = i8.quantize_global(e)
        del e
        torch.cuda.empty_cache()
        for qn in (1, 8, 32):
            q = unit_rows(qn, gen)
            q[0] = e8[5].float() * e_scale
            q8, _ = i8.quantize_global(q)
            for label, mask in int8_masks(n, gen).items():
                sfx = "" if mask is None else "_masked"
                ref_max = i8.tilemax_reference(q8, e8, n_true, mask)
                errs["int8_tilemax" + sfx] = max(errs["int8_tilemax" + sfx], equal(
                    f"int8_tilemax{sfx}", i8.tilemax(q8, e8, n_true, mask), ref_max))
                for k in (3, 10, 64):
                    ids = top_subtiles(ref_max, k)
                    equal("select_subtiles", ids, select_subtiles(ref_max, k))
                    v, i = i8.rescan_topk(q8, e8, n_true, ids, k, mask)
                    vr, ir = i8.rescan_topk_reference(q8, e8, n_true, ids, k, mask)
                    errs["int8_rescan_topk" + sfx] = max(errs["int8_rescan_topk" + sfx], equal(
                        f"int8_rescan_topk{sfx}", v, vr, i, ir))
                    equal(f"int8_rescan_topk{sfx} filler rows", i, ir)
                    d, idx = i8.int8_topk_scan(q, e8, e_scale, k, n_true=n_true, mask=mask)
                    want = sorted(dups)[: min(k, len(dups))]
                    if mask is None and idx[0, : len(want)].tolist() != want:
                        raise AssertionError(f"int8: planted duplicates {want} came out as "
                                             f"{idx[0, :len(want)].tolist()}")
                    if label == "few" and bool(torch.isfinite(d).sum(1).gt(FEW_ROWS).any()):
                        raise AssertionError("int8 masked: more finite hits than kept rows")
            log(f"kernels: int8 N={n} n_true={n_true} Q={qn} k=3,10,64 masks none/half/few: "
                f"equal to the plain versions")
        if n == 10_000_000:
            times = time_int8_kernels(e8, e_scale, n_true, gen)
        del e8
        torch.cuda.empty_cache()
    return errs, times


def time_int8_kernels(e8, e_scale, n_true, gen):
    from semtools_tpu_torch.ops import int8_scan as i8
    from semtools_tpu_torch.ops.fused_scan import SUB_ROWS, _num_blocks, select_subtiles, \
        top_subtiles

    qn, k = 8, 10
    q = unit_rows(qn, gen)
    q8, _ = i8.quantize_global(q)
    s = _num_blocks(n_true)
    mask = int8_masks(e8.shape[0], gen)["half"]

    def plain_topk(mask):
        sub = i8.tilemax_reference(q8, e8, n_true, mask)
        return i8.rescan_topk_reference(q8, e8, n_true, select_subtiles(sub, k), k, mask)

    t = {}
    for sfx, m in (("", None), ("_masked", mask)):
        sub_max = i8.tilemax(q8, e8, n_true, m)
        ids = top_subtiles(sub_max, k)
        u = ids.unique().numel()
        two_phase_ops(f"int8_two_phase{sfx}", lambda: i8.int8_two_phase(q8, e8, n_true, k, m),
                      "sweep_kernel")
        if m is None:
            t["select_subtiles"] = select_timing(sub_max, k)
        mask_bytes = 0 if m is None else n_true
        t["int8_tilemax" + sfx] = timing(
            lambda: i8.tilemax(q8, e8, n_true, m),
            lambda: i8.tilemax_reference(q8, e8, n_true, m),
            bound(n_true * D + mask_bytes + qn * D + qn * s * 4, 2.0 * qn * n_true * D, "int8"),
            "sweep_kernel")
        t["int8_rescan_topk" + sfx] = timing(
            lambda: i8.rescan_topk(q8, e8, n_true, ids, k, m),
            lambda: i8.rescan_topk_reference(q8, e8, n_true, ids, k, m),
            bound(u * SUB_ROWS * (D + (0 if m is None else 1)) + qn * D
                  + ids.numel() * 8 + qn * k * 12, 2.0 * ids.numel() * SUB_ROWS * D, "int8"),
            "rescan_topk_kernel")
        t["int8_topk_scan" + sfx] = timing(
            lambda: i8.int8_topk_scan(q, e8, e_scale, k, n_true=n_true, mask=m),
            lambda: plain_topk(m),
            bound(n_true * D + mask_bytes, 2.0 * qn * n_true * D, "int8"))
    log_times(f"int8 N={e8.shape[0]} Q={qn} k={k}", t)
    for sfx in ("", "_masked"):
        after_phase1(t, "int8_topk_scan" + sfx, "int8_tilemax" + sfx)
    return t


def make_packed(n, n_true, gen):
    """Random packed int4 rows on the card; row 5 planted inside a sub-tile,
    across the 128- and 512-row boundaries, far away and at the last row."""
    import torch

    p4 = torch.randint(-128, 128, (n, D // 2), generator=gen, device="cuda", dtype=torch.int8)
    dups = [5, 127, 128, 511, 512, n // 2, n_true - 1]
    p4[dups[1:]] = p4[5].clone()
    p4[9 + DENSE_STRIDE:n_true:DENSE_STRIDE] = p4[9].clone()
    return p4, dups


def int4_queries(p4, qn, gen, dense=False):
    """(f32 queries, their int8 form, its scale); the first query is row 5's
    unpacked values, so the planted duplicates are its best rows; with
    ``dense`` the second is row 9's, whose copies fill one row a block."""
    import torch

    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops import int8_scan as i8

    q = torch.randn((qn, D), generator=gen, device="cuda")
    for r, src in enumerate((5, 9) if dense and qn > 1 else (5,)):
        row = i4.unpack_f32(p4[src])
        row[: D // 2] -= 8
        q[r] = row
    q8, q_scale = i8.quantize_global(q)
    return q, q8.contiguous(), q_scale


def same_candidates(what, ids, want, n_true, sims=None):
    """Equal per-query sets of valid candidate rows; with ``sims`` (the plain
    sweep's), a query under the cap must hold exactly the rows at or above
    its lowest candidate's sim."""
    import torch

    if ids.shape != want.shape:
        raise AssertionError(f"{what}: candidate shape {tuple(ids.shape)} != {tuple(want.shape)}")
    for r in range(ids.shape[0]):
        got = ids[r][ids[r] < n_true].sort().values
        if not torch.equal(got, want[r][want[r] < n_true].sort().values):
            raise AssertionError(f"{what}: query {r}'s candidates differ from the plain path")
        if sims is not None and 0 < got.numel() < ids.shape[1]:
            above = (sims[r, :n_true] >= sims[r, got].min()).nonzero().flatten()
            if not torch.equal(got, above):
                raise AssertionError(f"{what}: query {r}'s candidates are not the rows above "
                                     f"its cutoff")


def plain_int4_topk(q8, p4, n_true, k, mask):
    """int4_two_phase's composition through the plain phases."""
    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops.fused_scan import select_subtiles

    sub = i4.tilemax_reference(q8, p4, n_true, mask)
    return i4.rescan_topk_reference(q8, p4, n_true, select_subtiles(sub, min(k, sub.shape[1])),
                                    k, mask)


def bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_selection(q8, sims, bmax, n_true, what):
    """Each selection kernel against its plain version on one sweep's sims
    (k_cut 10): the margin on the card and the cutoffs bit-equal, the counts
    equal, the extraction's sets equal at the batch's cap and at OVER_CAP
    (the same tensor again from a second call), and the sharded modes of
    int4_cutoff_counts (a shard's tops, the cutoff of merged tops, the
    counts against a given cutoff). Returns the batch's (n_b, cap)."""
    import torch

    from semtools_tpu_torch.ops import int4_scan as i4

    k_cut = 10
    margin = i4.margin_on_device(q8)
    plain_margin = torch.tensor(i4.cutoff_margin(q8), device=q8.device)
    if not bits_equal(margin, plain_margin):
        raise AssertionError(f"{what}: margin {margin.item()} on the card, {plain_margin.item()} "
                             f"in numpy")
    cutoff, count, n_blocks, marks = i4.select_cutoff(sims, bmax, margin, k_cut)
    want_c, want_n, want_b = i4.cutoff_counts(sims, bmax, plain_margin, k_cut)
    if not (bits_equal(cutoff, want_c) and torch.equal(count, want_n)
            and torch.equal(n_blocks, want_b)):
        raise AssertionError(f"{what}: int4_cutoff_counts differs from cutoff_counts")
    same_marks(f"{what}: int4_cutoff_counts' marks", marks, i4.marks_reference(sims, bmax, want_c))
    max_count, max_nb = i4.batch_maxima(count, n_blocks)
    cap, n_b = i4.candidate_sizes(max_count, max_nb, n_true, bmax.shape[1])
    for c in (cap, min(cap, int(OVER_CAP))):
        def extract():
            return i4.select_above(sims, bmax, cutoff, count, marks, n_b=n_b, cap=c,
                                   max_count=max_count)

        got = extract()
        same_candidates(f"{what}: int4_extract_above (cap {c})", got,
                        i4.extract_above(sims, bmax, want_c, n_b=n_b, cap=c), n_true)
        under = count <= c
        if not torch.equal(got[under], i4.marked_rows_reference(marks, c)[under]):
            raise AssertionError(f"{what}: int4_extract_above (cap {c}) is not the marked rows "
                                 f"in row order")
        if not torch.equal(got, extract()):
            raise AssertionError(f"{what}: int4_extract_above (cap {c}) is not deterministic")
    tops = i4.block_tops(sims, bmax, k_cut)
    if not torch.equal(tops.sort(dim=1, descending=True).values,
                       i4.block_tops_reference(sims, bmax, k_cut)):
        raise AssertionError(f"{what}: int4_cutoff_counts' tops differ from the plain ones")
    merged = torch.cat([tops, tops.roll(1, 0)], dim=1)
    if not bits_equal(i4.tops_cutoff(merged, margin, k_cut),
                      i4.tops_cutoff_reference(merged, plain_margin, k_cut)):
        raise AssertionError(f"{what}: the cutoff of merged tops differs from the plain one")
    got_n, got_b, got_marks = i4.counts_above(sims, bmax, want_c)
    if not (torch.equal(got_n, want_n) and torch.equal(got_b, want_b)):
        raise AssertionError(f"{what}: the counts against a given cutoff differ")
    same_marks(f"{what}: the marks against a given cutoff", got_marks, marks)
    return n_b, cap


def same_marks(what, got, want) -> None:
    """Equal per-block counts and group totals, and equal masks wherever a
    block has a count (the count pass writes no other)."""
    import torch

    hit = want.counts > 0
    if not (torch.equal(got.counts, want.counts) and torch.equal(got.groups, want.groups)
            and torch.equal(got.masks[hit], want.masks[hit])):
        raise AssertionError(f"{what} differ from marks_reference")


def int4_kernel_phase():
    import torch

    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops.fused_scan import MAX_QUERIES, select_subtiles, top_subtiles

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {name: 0.0 for name in REPLACES if name.startswith("int4")}
    times, launches = {}, {}
    for n in (2_000_000, 10_000_000):
        n_true = n - 777
        p4, dups = make_packed(n, n_true, gen)
        for qn in (1, 8, 32, 40):
            q, q8, _ = int4_queries(p4, qn, gen, dense=True)
            sizes = {}
            for label, mask in int8_masks(n, gen).items():
                sfx = "" if mask is None else "_masked"
                ref_sims, ref_max = [], []
                for q0 in range(0, qn, MAX_QUERIES):
                    qc = q8[q0 : q0 + MAX_QUERIES]
                    sims, bmax = i4.sims_max(qc, p4, n_true, mask)
                    want_sims, want_max = i4.sims_max_reference(qc, p4, n_true, mask)
                    equal(f"int4_sims_max{sfx}", sims, want_sims)
                    equal(f"int4_sims_max{sfx} maxima", bmax, want_max)
                    ref_sims.append(want_sims)
                    ref_max.append(want_max)
                    del sims, bmax
                    ref_sub = i4.tilemax_reference(qc, p4, n_true, mask)
                    equal(f"int4_tilemax{sfx}", i4.tilemax(qc, p4, n_true, mask), ref_sub)
                    for k in (3, 10, 64, 200):
                        kt = min(k, ref_sub.shape[1])
                        ids = top_subtiles(ref_sub, kt)
                        equal("select_subtiles", ids, select_subtiles(ref_sub, kt))
                        v, i = i4.rescan_topk(qc, p4, n_true, ids, k, mask)
                        vr, ir = i4.rescan_topk_reference(qc, p4, n_true, ids, k, mask)
                        equal(f"int4_rescan_topk{sfx}", v, vr, i, ir)
                        equal(f"int4_rescan_topk{sfx} filler rows", i, ir)
                        del v, i, vr, ir
                ref_sims, ref_max = torch.cat(ref_sims), torch.cat(ref_max)
                sizes[label] = check_selection(q8, ref_sims, ref_max, n_true,
                                               f"int4 N={n} Q={qn} mask {label}")
                if qn > 1 and label != "few" and sizes[label][0] < 1024:
                    raise AssertionError(f"int4 N={n} Q={qn} mask {label}: n_b "
                                         f"{sizes[label][0]}, not the dense query's 1024+")
                cand = i4.int4_deep_candidates(q, p4, n_true=n_true, mask=mask)
                same_candidates(f"deep candidates ({label})", cand,
                                i4.select_candidates_reference(q8, ref_sims, ref_max, n_true),
                                n_true, ref_sims)
                if label == "few" and not all(
                        int((c < n_true).sum()) == int(mask[:n_true].sum()) for c in cand):
                    raise AssertionError("int4 deep candidates: not every kept row")
                if qn == 8 and label != "few":
                    check_over_cap(q, q8, p4, n_true, mask, ref_sims, ref_max)
                del ref_sims, ref_max, cand
                torch.cuda.empty_cache()
            log(f"kernels: int4 N={n} n_true={n_true} Q={qn} k=3,10,64,200 masks none/half/few: "
                f"equal to the plain versions; deep candidates equal the plain path's; the "
                f"selection kernels equal theirs at (n_b, cap) {sizes} and at cap {OVER_CAP}")
        if n == 10_000_000:
            launches = int4_topk_path(p4, n_true, dups, gen)
            times = time_int4_kernels(p4, n_true, gen)
        del p4
        torch.cuda.empty_cache()
    return errs, times, launches


OVER_CAP = "4"  # candidates kept per query when the cap binds (SEMTOOLS_TPU_INT4_CAP)


@contextlib.contextmanager
def past_the_cap():
    """SEMTOOLS_TPU_INT4_CAP = OVER_CAP inside the block: the cap binds."""
    os.environ["SEMTOOLS_TPU_INT4_CAP"] = OVER_CAP
    try:
        yield
    finally:
        os.environ.pop("SEMTOOLS_TPU_INT4_CAP")


def check_over_cap(q, q8, p4, n_true, mask, ref_sims, ref_max):
    """Past the cap the tie rule alone decides: the kernel path keeps the same
    rows as the plain one; query 0 keeps the first 4 of its 7 equal rows."""
    from semtools_tpu_torch.ops import int4_scan as i4

    with past_the_cap():
        cand = i4.int4_deep_candidates(q, p4, n_true=n_true, mask=mask)
        same_candidates("deep candidates over the cap", cand,
                        i4.select_candidates_reference(q8, ref_sims, ref_max, n_true), n_true)
    if cand.shape[1] != int(OVER_CAP):
        raise AssertionError(f"over the cap: {cand.shape[1]} candidates per query")
    if mask is None and sorted(cand[0].tolist()) != [5, 127, 128, 511]:
        raise AssertionError(f"over the cap: query 0 kept {sorted(cand[0].tolist())}")
    # the dense query's copies tie on sim and block max: the lowest blocks
    dense = [9 + DENSE_STRIDE * j for j in range(int(OVER_CAP))]
    if mask is None and sorted(cand[1].tolist()) != dense:
        raise AssertionError(f"over the cap: query 1 kept {sorted(cand[1].tolist())}")


def int4_topk_path(p4, n_true, dups, gen):
    """``int4_topk_scan`` through its public entry point, plain and masked,
    with the counts reset just before: the two-phase kernels' own path. Each
    result against the plain phases (distances bit-equal, indices equal where
    finite)."""
    import torch

    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.ops.fused_scan import MAX_QUERIES

    half = int8_masks(p4.shape[0], gen)["half"]
    cases = [(qn, k, mask, *int4_queries(p4, qn, gen))
             for qn, k in ((8, 10), (40, 200)) for mask in (None, half)]
    from semtools_tpu_torch.ops.int4_scan import int4_topk_scan

    kernels.reset_launch_counts()
    runs = [int4_topk_scan(q, p4, E_SCALE, k, n_true=n_true, mask=mask)
            for _, k, mask, q, _, _ in cases]
    torch.cuda.synchronize()
    launches = launches_of(K5, "int4_topk_scan")
    for (qn, k, mask, _, q8, q_scale), (dist, idx) in zip(cases, runs):
        parts = [plain_int4_topk(q8[q0 : q0 + MAX_QUERIES], p4, n_true, k, mask)
                 for q0 in range(0, qn, MAX_QUERIES)]
        sims = torch.cat([v for v, _ in parts])
        bias = 8.0 * q8[:, : D // 2].double().sum(dim=1, keepdim=True)
        want = (1.0 - (sims.double() - bias) * (q_scale * E_SCALE)).float()
        equal(f"int4_topk_scan Q={qn} k={k}", dist, want, idx, torch.cat([i for _, i in parts]))
        if mask is None and idx[0, :3].tolist() != sorted(dups)[:3]:
            raise AssertionError(f"int4: planted duplicates came out as {idx[0, :3].tolist()}")
    log(f"kernels: int4_topk_scan (Q=8 k=10, Q=40 k=200; plain and masked) equals the "
        f"plain phases")
    return launches


def time_int4_kernels(p4, n_true, gen):
    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops.fused_scan import SUB_ROWS, _num_blocks, top_subtiles

    qn, k = 8, 10
    q, q8, _ = int4_queries(p4, qn, gen)
    s = _num_blocks(n_true)
    n_pad = -(-n_true // i4.SIMS_ROWS) * i4.SIMS_ROWS
    mask = int8_masks(p4.shape[0], gen)["half"]
    row_bytes = D // 2
    scan_ops = 2.0 * qn * n_true * D

    def plain_deep(m):
        return i4.select_candidates_reference(q8, *i4.sims_max_reference(q8, p4, n_true, m),
                                              n_true)

    t = {}
    for sfx, m in (("", None), ("_masked", mask)):
        mask_bytes = 0 if m is None else n_true
        ids = top_subtiles(i4.tilemax(q8, p4, n_true, m), k)
        u = ids.unique().numel()
        two_phase_ops(f"int4_two_phase{sfx}", lambda: i4.int4_two_phase(q8, p4, n_true, k, m),
                      "sweep_kernel")
        t["int4_sims_max" + sfx] = timing(
            lambda: i4.sims_max(q8, p4, n_true, m),
            lambda: i4.sims_max_reference(q8, p4, n_true, m),
            bound(n_true * row_bytes + mask_bytes + qn * D + qn * n_pad * 4
                  + qn * (n_pad // i4.SIMS_ROWS) * 4, scan_ops, "int8"), "sweep_kernel",
            plain_reps=5)
        t["int4_tilemax" + sfx] = timing(
            lambda: i4.tilemax(q8, p4, n_true, m),
            lambda: i4.tilemax_reference(q8, p4, n_true, m),
            bound(n_true * row_bytes + mask_bytes + qn * D + qn * s * 4, scan_ops, "int8"),
            "sweep_kernel", plain_reps=5)
        t["int4_rescan_topk" + sfx] = timing(
            lambda: i4.rescan_topk(q8, p4, n_true, ids, k, m),
            lambda: i4.rescan_topk_reference(q8, p4, n_true, ids, k, m),
            bound(u * SUB_ROWS * (row_bytes + (0 if m is None else 1)) + qn * D
                  + ids.numel() * 8 + qn * k * 12, 2.0 * ids.numel() * SUB_ROWS * D, "int8"),
            "rescan_topk_kernel")
        t["int4_topk_scan" + sfx] = timing(
            lambda: i4.int4_topk_scan(q, p4, E_SCALE, k, n_true=n_true, mask=m),
            lambda: plain_int4_topk(q8, p4, n_true, k, m),
            bound(n_true * row_bytes + mask_bytes, scan_ops, "int8"), plain_reps=5)
        t["int4_deep_candidates" + sfx] = timing(
            lambda: i4.int4_deep_candidates(q, p4, n_true=n_true, mask=m),
            lambda: plain_deep(m),
            bound(n_true * row_bytes + mask_bytes, scan_ops, "int8"), plain_reps=5)
    t.update(time_selection(q8, p4, n_true))
    log_times(f"int4 N={p4.shape[0]} Q={qn} k={k}", t)
    for sfx in ("", "_masked"):
        after_phase1(t, "int4_topk_scan" + sfx, "int4_tilemax" + sfx)
    for sfx, m in (("", None), ("_masked", mask)):
        deep = t["int4_deep_candidates" + sfx]
        glue = {"ms": cuda_ms(lambda: plain_glue(q8, p4, n_true, m)),
                "device_ms": device_ms(lambda: plain_glue(q8, p4, n_true, m))}
        log(f"time: int4_deep_candidates{sfx} N={p4.shape[0]} Q={qn}: through the kernels "
            f"{deep['ms']:.4f} ms events / {deep['device_ms']:.4f} ms device; K6 and the plain "
            f"glue {glue['ms']:.4f} / {glue['device_ms']:.4f} ms; the sweep alone "
            f"{t['int4_sims_max' + sfx]['ms']:.4f} / {t['int4_sims_max' + sfx]['device_ms']:.4f}"
            f" ms ({CARD})")
        selection_path(f"int4_deep_candidates{sfx}",
                       lambda: i4.int4_deep_candidates(q, p4, n_true=n_true, mask=m))
    with past_the_cap():
        past = {"ms": cuda_ms(lambda: i4.int4_deep_candidates(q, p4, n_true=n_true)),
                "device_ms": device_ms(lambda: i4.int4_deep_candidates(q, p4, n_true=n_true))}
        selection_path(f"int4_deep_candidates past the cap ({OVER_CAP})",
                       lambda: i4.int4_deep_candidates(q, p4, n_true=n_true),
                       {k: 1 for k in CUTOFF_KERNELS + PAST_CAP_KERNELS})
    log(f"time: int4_deep_candidates N={p4.shape[0]} Q={qn} past the cap ({OVER_CAP}): "
        f"{past['ms']:.4f} ms events / {past['device_ms']:.4f} ms device ({CARD})")
    busy, wall, ops = device_busy(lambda: i4.int4_deep_candidates(q, p4, n_true=n_true), top=8)
    log(f"time: int4_deep_candidates N={p4.shape[0]} Q={qn} under torch.profiler: device busy "
        f"{busy:.3f} ms of {wall:.3f} ms wall; by kernel: "
        + "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in ops))
    q, q8, _ = int4_queries(p4, qn, gen, dense=True)
    dense = {"ms": cuda_ms(lambda: i4.int4_deep_candidates(q, p4, n_true=n_true)),
             "device_ms": device_ms(lambda: i4.int4_deep_candidates(q, p4, n_true=n_true)),
             "glue_ms": cuda_ms(lambda: plain_glue(q8, p4, n_true, None), reps=5)}
    log(f"time: int4_deep_candidates N={p4.shape[0]} Q={qn} with the dense query: "
        f"{dense['ms']:.4f} ms events / {dense['device_ms']:.4f} ms device; K6 and the plain "
        f"glue {dense['glue_ms']:.4f} ms events")
    return t


def plain_glue(q8, p4, n_true, mask):
    """The deep-candidate call as before the selection kernels: the sweep
    kernel, then the plain selection on the card."""
    from semtools_tpu_torch.ops import int4_scan as i4

    return i4.select_candidates_reference(q8, *i4.sims_max(q8, p4, n_true, mask), n_true)


def kernel_device_ms(fn, names, reps: int = 20) -> float:
    """Device time a call of ``fn`` spends in the kernels whose names hold
    one of ``names`` (torch.profiler over ``reps`` calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    events, _ = traced(fn, reps, want=names[0])
    return sum(e.time_range.elapsed_us() for e in events
               if any(n in e.name for n in names)) / 1e3 / reps


def time_selection(q8, p4, n_true) -> dict:
    """The selection kernels' numbers on the unmasked sweep of ``q8`` (k_cut
    10, the batch's cap): the wrappers' events time (``select_cutoff``
    includes its ``select_subtiles`` launch), the kernels' device time, the
    plain versions' events time, the bound from the bytes this run's
    counts make them move and, for the cutoff, one ``torch.topk`` of the
    k_cut best sims. Also the pair's device time against their shared
    bound (the hit blocks' sims read once) and the extraction past the cap
    (``SEMTOOLS_TPU_INT4_CAP`` = OVER_CAP, far below the counts) by kernel."""
    import torch

    from semtools_tpu_torch.ops import int4_scan as i4

    qn, k_cut = q8.shape[0], 10
    sims, bmax = i4.sims_max(q8, p4, n_true)
    nb = bmax.shape[1]
    margin = i4.margin_on_device(q8)
    cutoff, count, n_blocks, marks = i4.select_cutoff(sims, bmax, margin, k_cut)
    max_count, max_nb = i4.batch_maxima(count, n_blocks)
    cap, n_b = i4.candidate_sizes(max_count, max_nb, n_true, nb)
    with past_the_cap():
        past_cap = i4.candidate_sizes(max_count, max_nb, n_true, nb)[0]
    hits, rows = int(n_blocks.sum()), int(count.sum())
    hit_bytes = hits * i4.SIMS_ROWS * 4  # the sims of the blocks at or above the cutoffs
    # the marks: per-block counts, group totals, the hit blocks' masks
    marks_bytes = qn * nb * 4 + marks.groups.numel() * 4 + hits * i4.MASK_WORDS * 4
    kb = min(k_cut, nb)
    before_count = qn * nb * 4 + qn * kb * (i4.SIMS_ROWS * 4 + 8) + qn * 4 + 4

    def extract(c):
        return lambda: i4.select_above(sims, bmax, cutoff, count, marks, n_b=n_b, cap=c,
                                       max_count=max_count)

    t = {"int4_cutoff_counts": {
        "ms": cuda_ms(lambda: i4.select_cutoff(sims, bmax, margin, k_cut)),
        "device_ms": kernel_device_ms(lambda: i4.select_cutoff(sims, bmax, margin, k_cut),
                                      CUTOFF_KERNELS[1:]),
        "plain_ms": cuda_ms(lambda: i4.cutoff_counts(sims, bmax, margin, k_cut)),
        "library_ms": cuda_ms(lambda: torch.topk(sims, k_cut))}}
    t["int4_cutoff_counts"].update(zip(("bound_ms", "bound_by"), bound(
        before_count + hit_bytes + qn * 16 + marks_bytes,
        float(qn * kb * i4.SIMS_ROWS * 4 + qn * nb + hits * i4.SIMS_ROWS), "f32")))
    t["int4_extract_above"] = {
        "ms": cuda_ms(extract(cap)),
        "device_ms": kernel_device_ms(extract(cap), EXTRACT_KERNELS),
        "plain_ms": cuda_ms(lambda: i4.extract_above(sims, bmax, cutoff, n_b=n_b, cap=cap)),
        "library_ms": None}
    t["int4_extract_above"].update(zip(("bound_ms", "bound_by"), bound(
        marks_bytes + qn * 8 + qn * cap * 8, float(qn * nb), "f32")))
    pair_bound = bound(before_count + hit_bytes + qn * cap * 8,
                       float(qn * kb * i4.SIMS_ROWS * 4 + qn * nb + hits * i4.SIMS_ROWS), "f32")
    pair = t["int4_cutoff_counts"]["device_ms"] + t["int4_extract_above"]["device_ms"]
    past = {name: kernel_device_ms(extract(past_cap), (name,)) for name in PAST_CAP_KERNELS}
    past_bound = bound(marks_bytes + rows * 4 + qn * 8 + qn * past_cap * 8,
                       float(qn * nb + 12 * rows), "f32")
    log(f"time: the selection at N={p4.shape[0]} Q={qn}: {hits} blocks at or above the cutoffs "
        f"(n_b {n_b}), {rows} rows (cap {cap}); select_cutoff device time in all "
        f"(select_subtiles and both kernels) "
        f"{device_ms(lambda: i4.select_cutoff(sims, bmax, margin, k_cut)):.4f} ms ({CARD})")
    log(f"time: int4_cutoff_counts + int4_extract_above under the cap: {pair:.4f} ms device "
        f"against their shared bound {pair_bound[0]:.4f} ms ({pair_bound[1]}: the maxima, the "
        f"cutoff's blocks and the {hit_bytes / 1e6:.1f} MB of hit blocks read once, the "
        f"[{qn}, {cap}] rows written) = {pair_bound[0] / pair:.1%} ({CARD})")
    past_ms = (cuda_ms(extract(past_cap)), kernel_device_ms(extract(past_cap), PAST_CAP_KERNELS),
               cuda_ms(lambda: i4.extract_above(sims, bmax, cutoff, n_b=n_b, cap=past_cap),
                       reps=5))
    log(f"time: int4_extract_above past the cap (cap {past_cap}, every query past it): "
        f"{past_ms[0]:.4f} ms events / {past_ms[1]:.4f} ms device ("
        + ", ".join(f"{n} {ms:.4f}" for n, ms in past.items())
        + f"), plain {past_ms[2]:.4f} ms, bound {past_bound[0]:.4f} ms ({past_bound[1]}: the "
        f"marks and the {rows} marked rows' sims) ({CARD})")
    return t


def selection_path(what, fn, expect=None) -> None:
    """One call of ``fn`` makes one synchronising read (the counts' maxima),
    under ``torch.cuda.set_sync_debug_mode("warn")``; its profiler listing
    holds no sort or top-k kernel, and its selection kernels are exactly
    ``expect`` (by name, with their counts; default one deep-candidate call
    under the cap: select_subtiles, the cutoff and count kernels, the write
    kernel)."""
    import warnings

    import torch

    expect = expect or {k: 1 for k in CUTOFF_KERNELS + EXTRACT_KERNELS}
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message).lower()]
    if len(syncs) != 1:
        raise AssertionError(f"{what}: {len(syncs)} synchronising calls, want 1: {syncs}")
    events, _ = traced(fn, want="int4_write_kernel")
    names = [e.name for e in events]
    sorts = sorted({n for n in names if "sort" in n.lower() or "topk" in n.lower()})
    got = {k: sum(k in n for n in names) for k in SELECTION_KERNELS}
    got = {k: c for k, c in got.items() if c}
    if sorts or got != expect:
        raise AssertionError(f"{what}: selection kernels {got}, want {expect}; device work "
                             f"{sorted(set(names))}")
    last = max(i for i, n in enumerate(names) if "sweep_kernel" in n)
    after = [next((k for k in SELECTION_KERNELS if k in n),
                  n.split()[0] if n.startswith("Mem") else "torch") for n in names[last + 1:]]
    log(f"{what}: one synchronising read a call; {len(events)} device ops, no sort; launches a "
        f"call: " + ", ".join(f"{k} {c}" for k, c in got.items()) + "; device ops after the "
        "last sweep: " + ", ".join(after))


# The probes (semtools_tpu_torch/probes, ops/probes.py): each launch counter
# with the Pallas body it replaces (PERF.md's table maps every other body a
# kernel runs) and the call of its probe that the summary reports.
STREAM_SOURCE = "semtools_tpu_torch/csrc/stream.cu"
PROBE_SOURCE = "semtools_tpu_torch/csrc/probe_tilemax.cu"
PROBES = {
    "stream_tiles": ("benchmarks/quantitative/bench_stream_sweep.py:66", "auto_tile8192_gbps"),
    "stream_ring": ("benchmarks/quantitative/bench_stream_sweep.py:94", "manual_t128_b2_gbps"),
    "tilemax_bf16_plain": ("benchmarks/quantitative/bench_kernel_variants.py:32",
                           "bf16_plain_tile2048"),
    "tilemax_int8_convert_bf16": ("benchmarks/quantitative/bench_int8_phase1.py:97",
                                  "phase1_full_vecs_per_ms"),
    "tilemax_int8_int_dot": ("benchmarks/quantitative/bench_int8_phase1.py:142",
                             "int8_direct_dot_vecs_per_ms"),
    "tilemax_int8_f32_dot": ("benchmarks/quantitative/bench_int8_phase1.py:157",
                             "f32_convert_dot_vecs_per_ms"),
    "colsum_int8_convert_bf16": ("benchmarks/quantitative/bench_int8_phase1.py:124",
                                 "convert_sum_vecs_per_ms"),
    "colsum_int8": ("benchmarks/quantitative/bench_int8_phase1.py:133",
                    "pure_stream_vecs_per_ms"),
    "tilemax_int4_u8": ("benchmarks/quantitative/bench_int4_sweep.py:43",
                        "int4_sweep_vecs_per_ms"),
    "tilemax_int4_shift": ("scripts/probe_int4_opt.py:48", "shift_tile16384"),
    "tilemax_int4_native": ("scripts/probe_int4_opt.py:157", "native_tile8192"),
    "tilemax_int4_floor": ("scripts/probe_int4_opt2.py:43", "floor_tile16384"),
    "tilemax_int4_and15": ("scripts/probe_int4_opt2.py:61", "and15_tile16384"),
}
# the scan kernels quoted as a share of the measured roof (bytes-bound ones)
ROOF_SHARE = ("fused_tilemax", "fused_scan_candidates", "int8_tilemax", "int8_tilemax_masked",
              "int4_tilemax", "int4_tilemax_masked", "int4_sims_max", "int4_sims_max_masked")


def probe_equal(what, got, want, tol: float) -> float:
    """Bit-equal (tol 0) or within tol where finite, -inf in the same places."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} against the plain "
                             f"version's {tuple(want.shape)} {want.dtype}")
    if tol == 0.0:
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from the plain version")
        return 0.0
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{what}: -inf slots differ from the plain version")
    err = (got - want)[fin].abs().max().item() if bool(fin.any()) else 0.0
    if not err <= tol:
        raise AssertionError(f"{what}: max |probe - plain| = {err} > {tol}")
    return err


def probe_ragged_checks(gen) -> None:
    """Every tile-max variant, masked and not, in three output shapes (a
    whole-tile max over two atomic spans, 512-row sub-tiles, every row's
    sims), and the stream kernels, at ragged small sizes, against the plain
    versions."""
    import torch

    from semtools_tpu_torch.ops import probes as pr

    for (storage, recipe, reduce), (_, counter) in pr.VARIANTS.items():
        dtype, width = pr.STORAGES[storage]
        for tile, sub_rows in ((4096, 4096), (1024, 512), (512, 1)):
            if reduce == "sum" and sub_rows != tile:
                continue
            n = 3 * tile + 333
            if storage == "bf16":
                e = unit_rows(n, gen).to(torch.bfloat16)
                q = e[:8].clone()
            else:
                e = torch.randint(-127, 128, (n, width), generator=gen, device="cuda",
                                  dtype=torch.int8).view(dtype)
                q = torch.randint(-127, 128, (8, pr.DIM), generator=gen, device="cuda",
                                  dtype=torch.int8)
            for n_true in (None, n - 400):
                kw = dict(tile=tile, storage=storage, reduce=reduce, sub_rows=sub_rows,
                          masked=n_true is not None)
                probe_equal(f"{counter} N={n} tile={tile} sub={sub_rows} n_true={n_true}",
                            pr.tilemax_probe(q, e, n_true, recipe=recipe, **kw),
                            pr.tilemax_probe_reference(q, e, n_true, **kw),
                            1e-5 if storage == "bf16" else 0.0)
    e = torch.randint(-127, 128, (100_003, pr.DIM), generator=gen, device="cuda",
                      dtype=torch.int8)
    for tile in (64, 1000, 24576):
        probe_equal(f"stream_tiles tile={tile}", pr.stream_tiles(e, tile, 3),
                    pr.stream_tiles_reference(e, tile, 3), 0.0)
    for stages in pr.RING_STAGES:
        for rows in (16, 48, 256 if stages < 4 else 64):
            probe_equal(f"stream_ring {rows}x{stages}",
                        pr.stream_ring(e, 3, stage_rows=rows, stages=stages, n_use=99_999),
                        pr.stream_ring_reference(e, 3, 99_999), 0.0)
    log(f"probes: {len(pr.VARIANTS)} tile-max variants (masked and not; tile max, 512-row "
        f"sub-tiles, full sims) and the stream kernels at ragged sizes: equal to the plain "
        f"versions (bf16 within 1e-5)")


def probe_phase():
    """Each probe module at its published size (launches counted on its
    own run), then each of its calls against the plain version and timed:
    the module's events time, device time under torch.profiler, the plain
    version's time, the bound and, for the stream kernels and k_stream, one
    torch.sum; a call with a JAX probe's oracle must match it exactly.
    Returns (per-counter summary: the call PROBES names, with the largest
    error of all the counter's calls; stream roof in GB/s)."""
    import torch

    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.probes import common, int4_sweep, int4_unpack, int8_phase1, \
        kernel_variants, stream_sweep

    probe_ragged_checks(torch.Generator(device="cuda").manual_seed(SEED + 7))
    summary, errs, roof = {}, {}, None
    for mod in (stream_sweep, kernel_variants, int8_phase1, int4_sweep, int4_unpack):
        name = mod.__name__.rsplit(".", 1)[1]
        args = common.parser(name, mod.N).parse_args([])
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        out, cases = mod.run(args)
        counts = kernels.launch_counts()
        log(f"probe {name} (N={args.rows}) in {time.perf_counter() - t0:.1f} s: {json.dumps(out)}")
        if name == "stream_sweep":
            roof = out["stream_roof_gbps"]
        for c in cases:
            err = probe_equal(f"probe {name} {c.key}", c.fn(), c.plain(), c.tol)
            kernel = c.counter if c.counter.startswith("stream") else "probe_tilemax"
            r = {"key": c.key, "ms": c.ms, "device_ms": device_ms(c.fn, kernel, reps=5),
                 "plain_ms": cuda_ms(c.plain, reps=2), "launches": counts[c.counter],
                 "max_abs_err": err,
                 "library_ms": None if c.library is None else cuda_ms(c.library, reps=5)}
            r["bound_ms"], r["bound_by"] = bound(c.nbytes, c.ops, c.unit)
            gb = c.nbytes / r["ms"] / 1e6  # events, as the roof
            lib = "" if r["library_ms"] is None else f", torch.sum {r['library_ms']:.4f} ms"
            if c.oracle_err is not None:
                if c.oracle_err != 0.0:
                    raise AssertionError(f"probe {name} {c.key}: max |kernel - the JAX probe's "
                                         f"integer oracle| = {c.oracle_err}")
                lib += ", equal to the integer oracle"
            log(f"time: probe {name} {c.key} [{c.counter}] N={c.vectors}: {r['ms']:.4f} ms "
                f"events ({gb:.1f} GB/s, {gb / roof:.1%} of the roof) / {r['device_ms']:.4f} ms "
                f"device, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}){lib}")
            errs[c.counter] = max(err, errs.get(c.counter, 0.0))
            if PROBES[c.counter][1] == c.key:
                summary[c.counter] = r
        del cases
        torch.cuda.empty_cache()
    if set(summary) != set(PROBES):
        raise AssertionError(f"probes: no run of {sorted(set(PROBES) - set(summary))}")
    for counter, r in summary.items():
        r["max_abs_err"] = errs[counter]
    idle = sorted(n for n, r in summary.items() if r["launches"] <= 0)
    if idle:
        raise AssertionError(f"probes: kernels not launched on their probe's run: {idle}")
    return summary, roof


def roof_shares(times: dict, roof_gbps: float) -> None:
    """The byte-bound scan kernels as a share of the measured roof: the
    bytes of their bound over their events time (the roof's clock)."""
    parts = []
    for name in ROOF_SHARE:
        r = times[name]
        gb = r["bound_ms"] * HBM_BPS / 1e9 / r["ms"]  # bytes of the bound, per ms
        parts.append(f"{name} {gb:.1f} GB/s = {gb / roof_gbps:.1%}")
    log(f"roof: stream_roof_gbps {roof_gbps:.1f} ({roof_gbps / (HBM_BPS / 1e9):.1%} of the "
        f"data sheet's 3350 GB/s); scan kernels (events time): " + "; ".join(parts))


WORDS = (
    "index query vector cosine search token embed kernel shard stream corpus "
    "database table row column page disk cache memory latency throughput file "
    "line word model device host batch merge select rank score distance tile "
    "quick brown fox lazy dog river mountain forest ocean city night morning "
    "error warn info debug trace span metric log event request reply server"
).split()
QUERIES = ["database page cache latency", "quick brown fox", "vector search kernel",
           "error log request", "river mountain forest", "shard merge select",
           "token embed model", "night morning city"]


def write_corpus(root: Path, n_files: int, lines_per_file: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = np.array(WORDS + [f"{w}{i}" for i in range(40) for w in WORDS[:25]])
    files, all_lines = [], []
    for f in range(n_files):
        lens = rng.integers(3, 14, size=lines_per_file)
        words = vocab[rng.integers(0, len(vocab), size=int(lens.sum()))]
        cuts = np.cumsum(lens)[:-1]
        lines = [" ".join(ws) for ws in np.split(words, cuts)]
        path = root / f"doc_{f:04d}.txt"
        path.write_text("\n".join(lines) + "\n")
        files.append(str(path))
        all_lines.extend(lines)
    return files, all_lines


def run_cli(argv):
    """(stdout, stderr, wall seconds, stage summary) of one in-process CLI
    call; raises unless it exits 0."""
    from semtools_tpu_torch import cli
    from semtools_tpu_torch.utils import tracing

    tracing.reset()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"semtools {' '.join(argv[:3])}... exited {rc}: "
                             f"{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), wall, stage_text()


def stage_text() -> str:
    """The stages recorded in this process since the last tracing reset."""
    from semtools_tpu_torch.utils import tracing

    return ", ".join(f"{name} {secs * 1e3:.1f} ms" for name, secs, _ in tracing.timings())


def exit_stages(err: str) -> str:
    """The stage table a child process printed at exit (SEMTOOLS_TPU_TIMINGS)."""
    rows = re.findall(r"^\s+(\w+)\s+([\d.]+) ms", err.split("-- semtools timings --")[-1], re.M)
    return ", ".join(f"{name} {ms} ms" for name, ms in rows)


def check_hits(results, queries, model, corpus, starts, files, k, row_of=None):
    """CLI hits == plain scan of the same embeddings (tolerance as above).
    ``row_of`` maps a hit (file index, line) to its corpus row."""
    import torch

    from semtools_tpu_torch.ops.scan import _topk_chunk

    q = model.encode(queries)
    ref_d, ref_i = _topk_chunk(q, corpus, 0, corpus.shape[0], k + 1)
    pos = {f: i for i, f in enumerate(files)}
    got_i = torch.tensor([[starts[pos[r["filename"]]] + r["match_line_number"] for r in rs]
                          for rs in results], device=corpus.device)
    got_d = torch.tensor([[r["distance"] for r in rs] for rs in results], device=corpus.device)
    return agree("search hits", got_d, ref_d, got_i, ref_i)


def device_busy(fn, top: int = 0):
    """(device ms, wall ms, [(kernel, device ms)] of the ``top`` kernels by
    device time) of ``fn()`` under torch.profiler: the summed intervals of
    the CUDA events (kernels and copies) it traced."""
    events, wall = traced(fn)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return busy, wall, sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def launches_of(names, what):
    from semtools_tpu_torch.ops import kernels

    launches = kernels.launch_counts()
    log(f"{what}: kernel launches: {launches}")
    missing = [name for name in names if launches[name] == 0]
    if missing:
        raise AssertionError(f"{what} never launched {missing}")
    return launches


def main_path_phase(files, small):
    from semtools_tpu_torch.ops import kernels

    qfile = Path(files[0]).parent / "queries.txt"
    qfile.write_text("\n".join(QUERIES) + "\n")
    kernels.reset_launch_counts()
    runs = [
        ("1 query, cold", ["search", QUERIES[0], *files, "--top-k", "10", "-j"]),
        ("1 query, warm", ["search", QUERIES[0], *files, "--top-k", "10", "-j"]),
        ("-Q 8 queries", ["search", "-Q", str(qfile), *files, "--top-k", "10", "-j"]),
        ("2000 lines", ["search", QUERIES[1], *small, "--top-k", "10", "-j"]),
    ]
    outs = {}
    for label, argv in runs:
        out, _, wall, stages = run_cli(argv)
        outs[label] = out
        log(f"main: semtools search ({label}): {wall:.3f} s wall; stages: {stages}")
    launches = launches_of(("fused_tilemax", "select_subtiles", "fused_rescan_topk",
                            "fused_scan_candidates"), "main")
    return outs, str(qfile), launches


def check_main_path(outs, model, corpus, starts, files, small_lines, small):
    err = check_hits([json.loads(outs["1 query, warm"])["results"]], QUERIES[:1],
                     model, corpus, starts, files, 10)
    batch = [json.loads(x) for x in outs["-Q 8 queries"].splitlines() if x.strip()]
    if [b["query"] for b in batch] != QUERIES:
        raise AssertionError("-Q output does not list the 8 queries in order")
    err = max(err, check_hits([b["results"] for b in batch], QUERIES, model, corpus,
                              starts, files, 10))
    err = max(err, check_hits([json.loads(outs["2000 lines"])["results"]], QUERIES[1:2],
                              model, model.encode(small_lines), [0], small, 10))
    log(f"main: hits equal the plain scan of the same embeddings (max |d| err {err:.3g})")


def workspace_phase(files, qfile, model, corpus, starts):
    """Workspace search over the 1M-line corpus under a fresh HOME: the int8
    and f32 tiers, then the int4 tier."""
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.ops.scan import _topk_chunk

    subset = files[:SUBSET_FILES]
    hits = {}
    with tempfile.TemporaryDirectory(prefix="semtools_smoke_home_") as home:
        old_home = os.environ.get("HOME")
        os.environ["HOME"] = home
        try:
            run_cli(["workspace", "use", "smoke"])
            kernels.reset_launch_counts()
            steps = [
                ("cold", ["search", QUERIES[0], *files, "-w", "smoke", "--top-k", "10", "-j"]),
                ("warm", ["search", QUERIES[0], *files, "-w", "smoke", "--top-k", "10", "-j"]),
                ("-Q 8", ["search", "-Q", qfile, *files, "-w", "smoke", "--top-k", "10", "-j"]),
                (f"{SUBSET_FILES}-file subset",
                 ["search", QUERIES[2], *subset, "-w", "smoke", "--top-k", "10", "-j"]),
                ("f32 tier", ["search", QUERIES[0], *files, "-w", "smoke", "--top-k", "10",
                              "-j"]),
            ]
            for label, argv in steps:
                if label == "f32 tier":
                    os.environ["SEMTOOLS_TPU_STORE_INT8"] = "0"
                try:
                    out, err, wall, stages = run_cli(argv)
                finally:
                    os.environ.pop("SEMTOOLS_TPU_STORE_INT8", None)
                updating = "Updating workspace" in err
                if updating != (label == "cold"):
                    raise AssertionError(f"workspace ({label}): 'Updating workspace' "
                                         f"{'printed' if updating else 'missing'}")
                hits[label] = out
                log(f"workspace: search -w ({label}): {wall:.3f} s wall; stages: {stages}")
                if label == "warm":
                    busy, wall_ms, _ = device_busy(lambda: run_cli(argv))
                    if not busy > 0:
                        raise AssertionError("warm search -w traced no device work")
                    log(f"workspace: warm search -w under torch.profiler: device busy "
                        f"{busy:.3f} ms of {wall_ms:.1f} ms wall ({100 * busy / wall_ms:.2f}%)")
            build_compare(model.device)

            # a one-line edit: the rewrite re-embeds one line and reuses the
            # rest; the cached int8 corpus is patched: one row uploaded
            from semtools_tpu_torch.store import patch_cache

            edit_file, edit_line = 7, 100
            lines = Path(files[edit_file]).read_text().split("\n")
            lines[edit_line] = "quick brown fox crossing the river at night"
            Path(files[edit_file]).write_text("\n".join(lines))
            shipped = patch_cache.uploaded_bytes()
            out, err, wall, stages = run_cli(
                ["search", QUERIES[1], *files, "-w", "smoke", "--top-k", "10", "-j"])
            shipped = patch_cache.uploaded_bytes() - shipped
            if "embedded 1 unique new lines" not in err:
                raise AssertionError(f"workspace (edit): no reuse line in {err[-500:]!r}")
            patched_by(stage_seconds(), "workspace (edit)", shipped, 4 * (D + 8))
            hits["edit"] = out
            log(f"workspace: search -w (one-line edit): {wall:.3f} s wall; stages: {stages}; "
                f"{[ln.strip() for ln in err.splitlines() if 'reused' in ln][0]}; "
                f"{shipped} bytes uploaded")
            launches = launches_of([n for n in REPLACES if n.startswith("int8") or n in (
                "fused_tilemax", "select_subtiles", "fused_rescan_topk")], "workspace")

            status = json.loads(run_cli(["workspace", "status", "smoke", "-j"])[0])
            text = run_cli(["workspace", "status", "smoke"])[0]
            if status["total_documents"] != N_FILES or "int8-mxu-scan" not in text:
                raise AssertionError(f"workspace status: {status} / {text!r}")
            log(f"workspace: status: {status['total_documents']} documents, "
                f"{status['slots_live']} live slots of {status['slots_allocated']}; "
                f"{text.splitlines()[3]}")

            edited = corpus.clone()
            edited[int(starts[edit_file]) + edit_line] = model.encode([lines[edit_line]])[0]
            t0 = time.perf_counter()
            ask_steps(files, subset, model, edited, starts)
            log(f"ask: the three runs and their checks in {time.perf_counter() - t0:.1f} s")
            ref_d, _ = _topk_chunk(model.encode(QUERIES[3:4]), edited, 0, edited.shape[0], 10)
            thr = float(ref_d[0, 4] + ref_d[0, 5]) / 2  # five hits below it
            hits4, launches4 = int4_workspace_steps(files, qfile, subset, thr)
            ask_int4_steps(files, subset, model, edited, starts)
            hits.update(reduced_steps(files, thr))
            hits["compact"] = compact_steps(files)
            daemon_hits, daemon_edit = daemon_steps(files)
            edited2 = edited.clone()
            edited2[int(starts[daemon_edit[0]]) + daemon_edit[1]] = model.encode(
                [daemon_edit[2]])[0]
            ann_steps(files, qfile, subset, model, edited2, starts)
            sharded_phase(files, qfile, subset, thr)
        finally:
            if old_home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = old_home

    one = lambda label: [json.loads(hits[label])["results"]]  # noqa: E731
    err = check_hits(one("cold"), QUERIES[:1], model, corpus, starts, files, 10)
    err = max(err, check_hits(one("warm"), QUERIES[:1], model, corpus, starts, files, 10))
    err = max(err, check_hits(one("f32 tier"), QUERIES[:1], model, corpus, starts, files, 10))
    batch = [json.loads(x)["results"] for x in hits["-Q 8"].splitlines() if x.strip()]
    err = max(err, check_hits(batch, QUERIES, model, corpus, starts, files, 10))
    n_sub = SUBSET_FILES * LINES_PER_FILE
    err = max(err, check_hits(one(f"{SUBSET_FILES}-file subset"), QUERIES[2:3], model,
                              corpus[:n_sub], starts, subset, 10))
    err = max(err, check_hits(one("edit"), QUERIES[1:2], model, edited, starts, files, 10))
    log(f"workspace: hits equal the plain scan of the same embeddings (max |d| err {err:.3g})")

    one = lambda label: [json.loads(hits4[label])["results"]]  # noqa: E731
    err = 0.0
    for label in ("int4 first", "int4 warm", "int4 budget"):
        err = max(err, check_hits(one(label), QUERIES[:1], model, edited, starts, files, 10))
    batch = [json.loads(x)["results"] for x in hits4["int4 -Q 8"].splitlines() if x.strip()]
    err = max(err, check_hits(batch, QUERIES, model, edited, starts, files, 10))
    err = max(err, check_hits(one("int4 subset"), QUERIES[2:3], model, edited[:n_sub], starts,
                              subset, 10))
    below = one("int4 -m")
    if len(below[0]) != int((ref_d[0] < thr).sum()):
        raise AssertionError(f"int4 -m {thr}: {len(below[0])} hits, the plain scan has "
                             f"{int((ref_d[0] < thr).sum())} below it")
    err = max(err, check_hits(below, QUERIES[3:4], model, edited, starts, files, 10))
    log(f"workspace: int4-tier hits equal the plain scan of the same embeddings "
        f"(max |d| err {err:.3g})")

    one = lambda label: [json.loads(hits[label])["results"]]  # noqa: E731
    err = 0.0
    for rung, _ in REDUCED_BUDGETS:
        for label in (f"{rung} first", f"{rung} warm"):
            err = max(err, check_hits(one(label), QUERIES[:1], model, edited, starts, files, 10))
        below = one(f"{rung} -m")
        if len(below[0]) != int((ref_d[0] < thr).sum()):
            raise AssertionError(f"{rung} -m {thr}: {len(below[0])} hits, the plain scan has "
                                 f"{int((ref_d[0] < thr).sum())} below it")
        err = max(err, check_hits(below, QUERIES[3:4], model, edited, starts, files, 10))
    log(f"workspace: reduced-rung hits equal the plain scan (max |d| err {err:.3g})")
    err = check_hits(one("compact"), QUERIES[1:2], model, edited, starts, files, 10)
    err = max(err, check_hits([json.loads(daemon_hits["forwarded"])["results"]], QUERIES[:1],
                              model, edited, starts, files, 10))
    err = max(err, check_hits([json.loads(o)["results"] for o in daemon_hits["clients"]],
                              QUERIES, model, edited, starts, files, 10))
    err = max(err, check_hits([json.loads(daemon_hits["edit"])["results"]], QUERIES[1:2], model,
                              edited2, starts, files, 10))
    log(f"workspace: hits after compact and through the daemon equal the plain scan "
        f"(max |d| err {err:.3g})")
    return launches, launches4


def stage_seconds() -> dict:
    """{stage: seconds} recorded since the last tracing reset."""
    from semtools_tpu_torch.utils import tracing

    return {name: secs for name, secs, _ in tracing.timings()}


def patched_by(stages: dict, what: str, shipped: int, most: int) -> None:
    """The cached corpus caught up by a patch (no build) that uploaded at most
    ``most`` bytes."""
    if "slot_corpus_build" in stages or "slot_corpus_patch" not in stages:
        raise AssertionError(f"{what}: stages {sorted(stages)}: not served by a patch")
    if shipped > most:
        raise AssertionError(f"{what}: the patch uploaded {shipped} bytes (at most {most})")


def build_compare(dev) -> None:
    """The workspace's int8 and int4 corpora built on the card
    (``SEMTOOLS_TPU_BUILD=device``) and on the host: the tensors byte-equal,
    the same scale and row-L1 bound; both build times."""
    import torch

    from semtools_tpu_torch.store import Workspace, patch_cache
    from semtools_tpu_torch.store.store import Store

    with Store(Workspace.open("smoke").config.root_dir, device=dev) as store:
        gen = store.generation()
        for kind in ("int8", "int4"):
            built, secs = {}, {}
            for where in ("device", "host"):
                os.environ["SEMTOOLS_TPU_BUILD"] = where
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    built[where] = patch_cache._build(store, kind, dev, None, gen)
                    torch.cuda.synchronize()
                    secs[where] = time.perf_counter() - t0
                finally:
                    os.environ.pop("SEMTOOLS_TPU_BUILD")
            card, host = built["device"], built["host"]
            if not (torch.equal(card.corpus, host.corpus) and card.scale == host.scale
                    and card.max_row_int_l1 == host.max_row_int_l1):
                raise AssertionError(f"{kind}: the corpus built on the card differs from the "
                                     f"host build")
            log(f"workspace: {kind} slot corpus ({card.capacity} slots, {card.device_nbytes} "
                f"bytes) built on the card in {secs['device'] * 1e3:.1f} ms and on the host in "
                f"{secs['host'] * 1e3:.1f} ms (slot_corpus_build): byte-equal")
            del built, card, host
    torch.cuda.empty_cache()


def reduced_steps(files, thr):
    """The reduced rungs, picked by device budgets under the int4 corpus:
    ``workspace status`` names each; a first search (the projected corpus
    built on the card), a warm top-k and a ``-m`` search. The rungs score
    through the plain scan: their launch counts (reset just before) are
    logged, and no kernel of the port is expected."""
    from semtools_tpu_torch.ops import kernels

    common = ["-w", "smoke", "--top-k", "10", "-j"]
    hits = {}
    kernels.reset_launch_counts()
    for rung, budget in REDUCED_BUDGETS:
        os.environ["SEMTOOLS_TPU_DEVICE_CACHE_BYTES"] = str(budget)
        try:
            text = run_cli(["workspace", "status", "smoke"])[0]
            if f"int8-mxu-scan-{rung}" not in text:
                raise AssertionError(f"workspace status at a {budget}-byte budget: {text!r}")
            log(f"workspace: status at a {budget}-byte device budget: {text.splitlines()[3]}")
            for label, argv in ((f"{rung} first", ["search", QUERIES[0], *files, *common]),
                                (f"{rung} warm", ["search", QUERIES[0], *files, *common]),
                                (f"{rung} -m", ["search", QUERIES[3], *files, *common,
                                                "-m", repr(thr)])):
                out, err, wall, stages = run_cli(argv)
                if "Updating workspace" in err:
                    raise AssertionError(f"workspace ({label}): 'Updating workspace' printed")
                hits[label] = out
                log(f"workspace: search -w ({label}): {wall:.3f} s wall; stages: {stages}")
        finally:
            os.environ.pop("SEMTOOLS_TPU_DEVICE_CACHE_BYTES")
    log(f"reduced rungs: kernel launches: {kernels.launch_counts()} (plain scan)")
    return hits


def compact_steps(files) -> str:
    """``workspace compact -j`` after the edit (the int8 corpus is first
    brought back to the card: the budget steps evicted it); the next search
    catches up by the patch's moves, uploading nothing. Counts reset just
    before that search."""
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.store import patch_cache

    common = ["-w", "smoke", "--top-k", "10", "-j"]
    stages = run_cli(["search", QUERIES[0], *files, *common])[3]
    log(f"workspace: int8 tier again (after the budget steps): stages: {stages}")
    out, _, wall, _ = run_cli(["workspace", "compact", "smoke", "-j"])
    report = json.loads(out)
    if report["slots_reclaimed"] != LINES_PER_FILE or \
            report["slots_before"] - report["rows_live"] != LINES_PER_FILE:
        raise AssertionError(f"workspace compact: {report}")
    log(f"workspace: compact: {wall:.3f} s wall; {report}")
    shipped = patch_cache.uploaded_bytes()
    kernels.reset_launch_counts()
    out, _, wall, stages = run_cli(["search", QUERIES[1], *files, *common])
    shipped = patch_cache.uploaded_bytes() - shipped
    patched_by(stage_seconds(), "search after compact", shipped, 0)
    launches_of(INT8_PATH, "search after compact")
    log(f"workspace: search -w after compact: {wall:.3f} s wall; stages: {stages}; "
        f"{shipped} bytes uploaded")
    return out


def daemon_steps(files):
    """The daemon, served from a thread of this process (warm-up included)
    under its own socket directory, with ``SEMTOOLS_WORKSPACE`` set: a
    forwarded search from a child process against the same search in a
    child that does not forward; 8 concurrent child clients, each output
    equal to its direct run, merged by the coalescer, the int8 kernels
    launched from the daemon (counts reset just before); an edit, then a
    forwarded search the daemon serves by a patch; stop. Returns the
    outputs and the edit (file index, line, text)."""
    import threading

    from semtools_tpu_torch import daemon
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.store import coalesce, patch_cache
    from semtools_tpu_torch.utils import tracing

    common = ["--top-k", "10", "-j"]
    os.environ.update(SEMTOOLS_TPU_DAEMON_DIR=str(Path(os.environ["HOME"]) / "run"),
                      SEMTOOLS_WORKSPACE="smoke")
    t0 = time.perf_counter()
    server = threading.Thread(target=daemon.serve, daemon=True)
    server.start()
    try:
        for _ in range(1200):
            if daemon.ping():
                break
            time.sleep(0.05)
        else:
            raise AssertionError("the daemon did not come up")
        log(f"daemon: listening on {daemon.socket_path().name} {time.perf_counter() - t0:.3f} s "
            f"after serve() (warm-up included)")
        child_env = dict(os.environ, PYTHONPATH=str(REPO))

        def client(query, forward=True, window_ms=None):
            env = dict(child_env, SEMTOOLS_TPU_DAEMON="auto" if forward else "off")
            if window_ms:  # the coalescer's gather window, forwarded with the request
                env["SEMTOOLS_TPU_COALESCE_WINDOW_MS"] = window_ms
            return subprocess.Popen(
                [sys.executable, "-m", "semtools_tpu_torch.cli", "search", query, *files,
                 *common], env=env, cwd=str(REPO), stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def finish(proc, what):
            out, err = proc.communicate(timeout=300)
            if proc.returncode:
                raise AssertionError(f"{what}: exit {proc.returncode}: {err[-2000:]}")
            return out, err

        tracing.reset()
        t0 = time.perf_counter()
        forwarded, _ = finish(client(QUERIES[0]), "forwarded search")
        wall_fwd = time.perf_counter() - t0
        in_daemon = stage_text()
        t0 = time.perf_counter()
        direct, err = finish(client(QUERIES[0], forward=False), "direct search")
        wall_direct = time.perf_counter() - t0
        if forwarded != direct:
            raise AssertionError("the forwarded search -w printed another answer than the "
                                 "direct one")
        log(f"daemon: search -w in a new process: forwarded {wall_fwd:.3f} s wall (stages in "
            f"the daemon: {in_daemon}); direct {wall_direct:.3f} s wall (torch, CUDA, the model, "
            f"the kernels and the corpus build in the process; stages: {exit_stages(err)}): "
            f"equal outputs")
        native_client_forwarded(files, forwarded)

        os.environ["SEMTOOLS_TPU_COALESCE"] = "0"
        try:  # each query's direct run, in this process, neither forwarded nor merged
            want = [run_cli(["search", q, *files, *common])[0] for q in QUERIES]
        finally:
            os.environ.pop("SEMTOOLS_TPU_COALESCE")
        merged0 = coalesce.stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        clients = [client(q, window_ms="300") for q in QUERIES]
        outs = [finish(p, f"client {i}")[0] for i, p in enumerate(clients)]
        wall = time.perf_counter() - t0
        launches = launches_of(INT8_PATH, "daemon, 8 concurrent clients")
        merged = [a - b for a, b in zip(coalesce.stats(), merged0)]
        if outs != want:
            bad = [i for i, (o, w) in enumerate(zip(outs, want)) if o != w]
            raise AssertionError(f"daemon clients {bad}: output differs from the direct run")
        if merged[0] < 1:
            raise AssertionError("8 concurrent clients: the coalescer merged no batch")
        log(f"daemon: 8 concurrent clients in {wall:.3f} s wall: {merged[0]} merged scans of "
            f"{merged[1]} queries in all; each output equals its direct run")

        edit = (3, 50, "vector search kernel of the quick brown fox")
        lines = Path(files[edit[0]]).read_text().split("\n")
        lines[edit[1]] = edit[2]
        Path(files[edit[0]]).write_text("\n".join(lines))
        tracing.reset()
        shipped = patch_cache.uploaded_bytes()
        t0 = time.perf_counter()
        after_edit, _ = finish(client(QUERIES[1]), "forwarded search after an edit")
        wall = time.perf_counter() - t0
        shipped = patch_cache.uploaded_bytes() - shipped
        secs = stage_seconds()
        patched_by(secs, "daemon (edit)", shipped, 4 * (D + 8))
        log(f"daemon: forwarded search -w after a one-line edit: {wall:.3f} s wall; patched in "
            f"{secs['slot_corpus_patch'] * 1e3:.1f} ms ({shipped} bytes uploaded), store_scan "
            f"{secs['store_scan'] * 1e3:.1f} ms")

        # an ask forwarded from a child (workspace mode: SEMTOOLS_WORKSPACE), against the
        # same ask run here; the int8 kernels launched from the daemon's thread
        fakes = fake_servers()
        ask = ["ask", "which lines speak of caches and rivers?", *files, "--api-key", "k"]
        kernels.reset_launch_counts()
        with fakes.FakeServer(fakes.FakeOpenAI(ask_script("chat", files, False))) as llm:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "semtools_tpu_torch.cli", *ask, "--api-mode", "chat",
                 "--base-url", llm.url], env=dict(child_env, SEMTOOLS_TPU_DAEMON="auto"),
                cwd=str(REPO), stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            fwd_ask, _ = finish(proc, "forwarded ask")
            wall = time.perf_counter() - t0
        launches_ask = launches_of(INT8_PATH, "ask forwarded to the daemon")
        for name, n in launches_ask.items():
            ASK_LAUNCHES[name] = ASK_LAUNCHES.get(name, 0) + n
        direct_ask, _ = run_ask(ask, "chat", files, INT8_PATH, "chat, -w, the same ask here")
        if fwd_ask != direct_ask:
            raise AssertionError("the forwarded ask printed another answer than the direct one")
        log(f"daemon: ask forwarded from a new process: {wall:.3f} s wall; its stdout equals "
            f"the direct run's")
    finally:
        stopped = daemon.stop()
        server.join(timeout=60)
        coalesce._enabled = False
        for key in ("SEMTOOLS_TPU_DAEMON", "SEMTOOLS_TPU_DAEMON_DIR", "SEMTOOLS_WORKSPACE"):
            os.environ.pop(key, None)
    if not stopped or server.is_alive():
        raise AssertionError("daemon stop: the server did not shut down")
    log(f"daemon: stopped; launches in the clients' run {launches}")
    os.environ["SEMTOOLS_WORKSPACE"] = "smoke"
    try:
        native_client_fallback(files, QUERIES[1], after_edit)
    finally:
        os.environ.pop("SEMTOOLS_WORKSPACE", None)
    return {"forwarded": forwarded, "clients": outs, "edit": after_edit}, edit


def int4_workspace_steps(files, qfile, subset, thr):
    """The int4 tier over the workspace of ``workspace_phase`` (under its
    HOME): forced by SEMTOOLS_TPU_STORE_INT4=1, then picked by a device
    budget under the int8 corpus. Counts reset just before: the sweep's own
    path."""
    from semtools_tpu_torch.ops import kernels

    common = ["-w", "smoke", "--top-k", "10", "-j"]
    steps = [
        ("int4 first", ["search", QUERIES[0], *files, *common]),
        ("int4 warm", ["search", QUERIES[0], *files, *common]),
        ("int4 -Q 8", ["search", "-Q", qfile, *files, *common]),
        ("int4 subset", ["search", QUERIES[2], *subset, *common]),
        ("int4 -m", ["search", QUERIES[3], *files, *common, "-m", repr(thr)]),
        ("int4 budget", ["search", QUERIES[0], *files, *common]),
    ]
    hits = {}
    kernels.reset_launch_counts()
    for label, argv in steps:
        env = ({"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(INT4_BUDGET)} if label == "int4 budget"
               else {"SEMTOOLS_TPU_STORE_INT4": "1"})
        os.environ.update(env)
        try:
            if label == "int4 budget":
                text = run_cli(["workspace", "status", "smoke"])[0]
                if "int4-mxu-scan" not in text:
                    raise AssertionError(f"workspace status at a {INT4_BUDGET}-byte budget: "
                                         f"{text!r}")
                log(f"workspace: status at a {INT4_BUDGET}-byte device budget: "
                    f"{text.splitlines()[3]}")
            out, err, wall, stages = run_cli(argv)
            if label == "int4 warm":
                busy, wall_ms, _ = device_busy(lambda: run_cli(argv))
                if not busy > 0:
                    raise AssertionError("warm int4 search -w traced no device work")
                log(f"workspace: warm int4 search -w under torch.profiler: device busy "
                    f"{busy:.3f} ms of {wall_ms:.1f} ms wall ({100 * busy / wall_ms:.2f}%)")
        finally:
            for key in env:
                os.environ.pop(key)
        if "Updating workspace" in err:
            raise AssertionError(f"workspace ({label}): 'Updating workspace' printed")
        hits[label] = out
        log(f"workspace: search -w ({label}): {wall:.3f} s wall; stages: {stages}")
    return hits, launches_of(K6 + SELECTION, "int4 workspace")


def build_timed(x, label, **kw):
    """(index, wall seconds) of one ``IvfPqIndex.build``; logs its stages."""
    import torch

    from semtools_tpu_torch.index import IvfPqIndex
    from semtools_tpu_torch.utils import tracing

    tracing.reset()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = IvfPqIndex.build(x, m=32, **kw)
    secs = time.perf_counter() - t0
    st = stage_seconds()
    text = (f"train {st['ann_train'] * 1e3:.1f} ms, fused pass {st['ann_encode'] * 1e3:.1f} ms, "
            f"finalize {st['ann_finalize'] * 1e3:.1f} ms")
    log(f"ivf-pq: build of {x.shape[0]} x {x.shape[1]} (nlist {index.nlist}, m 32) on the "
        f"{label}: {secs:.3f} s; {text}")
    return index, secs


def row_lists(index):
    """[N] list id of each original row, [N, M] its codes."""
    import numpy as np

    lists = np.searchsorted(index.list_offsets, np.arange(index.n), side="right") - 1
    by_row = np.empty(index.n, np.int64)
    by_row[index.perm] = lists
    codes = np.empty_like(index.codes)
    codes[index.perm] = index.codes
    return by_row, codes


def ivf_pq_index_phase(dev):
    """The index layer: a clustered 100k set built twice on the card
    (byte-equal) and once on the CPU; on the card's quantizers, a Lloyd step
    and the fused pass on the card and on the CPU agree on >= 99.9% of the
    assignments and code bytes and answer 64 queries alike (exact re-rank);
    then 10M rows made on the card."""
    import numpy as np
    import torch

    from semtools_tpu_torch.index import IvfPqIndex, kmeans
    from semtools_tpu_torch.index.ivf_pq import _chunk_rows, _fused_assign_encode
    from semtools_tpu_torch.index.pq import pq_encode
    from semtools_tpu_torch.store.store import Store

    rng = np.random.default_rng(SEED + 2)
    centers = rng.standard_normal((ANN_CENTERS, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, ANN_CENTERS, ANN_ROWS)] + ANN_SPREAD * rng.standard_normal(
        (ANN_ROWS, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    nlist = Store._ann_nlist(ANN_ROWS)
    card1, t_card = build_timed(x, "card", nlist=nlist, device=dev)
    card2, t_card = build_timed(x, "card, again", nlist=nlist, device=dev)
    host, t_cpu = build_timed(x, "CPU", nlist=nlist, device=torch.device("cpu"))
    for name in ("centroids", "codes", "perm", "list_offsets", "vectors"):
        if getattr(card1, name).tobytes() != getattr(card2, name).tobytes():
            raise AssertionError(f"ivf-pq: two card builds differ in {name}")
    if card1.pq.codebooks.tobytes() != card2.pq.codebooks.tobytes():
        raise AssertionError("ivf-pq: two card builds differ in the codebooks")
    # The full builds diverge: k-means amplifies the last-bit differences of
    # two BLAS. Card against CPU is held on the SAME quantizers: one Lloyd
    # step from the card's centroids, and the fused pass with the card's
    # centroids and codebooks.
    lists_c, codes_c = row_lists(card1)
    lists_h, codes_h = row_lists(host)
    log(f"ivf-pq: full builds, card against CPU: {(lists_c == lists_h).mean():.6f} of the "
        f"assignments, {(codes_c == codes_h).mean():.6f} of the code bytes equal, centroids max "
        f"|diff| {np.abs(card1.centroids - host.centroids).max():.3g}; the CPU build "
        f"{t_cpu / t_card:.1f}x the card's wall")
    xh = torch.from_numpy(x)
    cents = torch.from_numpy(card1.centroids)
    step_d, a_d = kmeans.kmeans_step(xh.to(dev), cents.to(dev), nlist)
    step_h, a_h = kmeans.kmeans_step(xh, cents, nlist)
    same_step = float((a_d.cpu() == a_h).float().mean())
    step_err = float((step_d.cpu() - step_h).abs().max())
    books = torch.from_numpy(card1.pq.codebooks)
    a_f, c_f = [], []
    rows = _chunk_rows(ANN_ROWS, nlist, 32)
    for s in range(0, ANN_ROWS, rows):
        a, c = _fused_assign_encode(xh[s : s + rows], cents, 0.5 * (cents * cents).sum(1), books,
                                    0.5 * (books * books).sum(2))
        a_f.append(a.numpy())
        c_f.append(c.numpy())
    a_f, c_f = np.concatenate(a_f), np.concatenate(c_f)
    same_list = float((lists_c == a_f).mean())
    same_byte = float((codes_c == c_f).mean())
    log(f"ivf-pq: same quantizers, card against CPU: a Lloyd step {same_step:.6f} of the "
        f"assignments equal (centroids max |diff| {step_err:.3g}); the fused pass "
        f"{same_list:.6f} of the assignments, {same_byte:.6f} of the code bytes "
        f"({(codes_c == c_f).all(axis=1).mean():.6f} of the rows' codes) equal")
    if min(same_step, same_list, same_byte) < AGREE:
        raise AssertionError(f"ivf-pq: the card and the CPU agree on {same_step} / {same_list} "
                             f"/ {same_byte} (Lloyd step / assignments / code bytes) < {AGREE}")
    perm = np.argsort(a_f, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(a_f, minlength=nlist))])
    on_cpu = IvfPqIndex(card1.centroids, card1.pq, c_f[perm], perm, offsets, x[perm])
    q = x[rng.choice(ANN_ROWS, ANN_QUERIES, replace=False)] + 0.02 * rng.standard_normal(
        (ANN_QUERIES, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    exact = np.argsort(-(q @ x.T), axis=1, kind="stable")[:, :10]
    answers = {}
    for label, index in (("card", card1), ("CPU, card's quantizers", on_cpu), ("CPU", host)):
        d, i = index.search(q, k=10, nprobe=64, rerank=64)
        answers[label] = (d, i)
        recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i, exact)])
        log(f"ivf-pq: {ANN_QUERIES} queries (nprobe 64, 640 re-ranked) on the {label} build: "
            f"recall@10 {recall:.4f} against the exact scan; "
            f"{int((i == answers['card'][1]).all(axis=1).sum())} answers equal the card's")
    (d_c, i_c), (d_h, i_h) = answers["card"], answers["CPU, card's quantizers"]
    if not np.array_equal(i_c, i_h) or np.abs(d_c - d_h).max() > 1e-6:
        raise AssertionError(f"ivf-pq: the card and the CPU answer {ANN_QUERIES} queries "
                             f"differently on the same quantizers ({int((i_c != i_h).sum())} ids)")
    del card1, card2, host

    # at scale, from a tensor on the card: 10M rows, nlist 4096
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cent = torch.randn((SCALE_CENTERS, D), generator=gen, device=dev)
    cent /= cent.norm(dim=1, keepdim=True)
    big = torch.empty((SCALE_ROWS, D), device=dev)
    for s in range(0, SCALE_ROWS, 1 << 20):
        e = min(s + (1 << 20), SCALE_ROWS)
        lab = torch.randint(0, SCALE_CENTERS, (e - s,), generator=gen, device=dev)
        blk = cent[lab] + ANN_SPREAD * torch.randn((e - s, D), generator=gen, device=dev)
        big[s:e] = blk / blk.norm(dim=1, keepdim=True)
    del cent, lab, blk
    nlist = Store._ann_nlist(SCALE_ROWS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    index, _ = build_timed(big, "card, from a tensor there", nlist=nlist, keep_vectors=False)
    peak = torch.cuda.max_memory_allocated()
    log(f"ivf-pq: 10M build: device memory peak {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
        f"GiB above the {base / 2**30:.2f} GiB corpus); codes {index.codes.nbytes} bytes")
    if index.codes.shape != (SCALE_ROWS, 32) or int(index.list_offsets[-1]) != SCALE_ROWS or \
            np.bincount(index.perm, minlength=SCALE_ROWS).min() != 1:
        raise AssertionError("ivf-pq: the 10M index is not a permutation of its rows")
    lists, _ = row_lists(index)
    n_chk = _chunk_rows(SCALE_ROWS, nlist, 32)
    rows = np.sort(np.random.default_rng(SEED + 4).choice(SCALE_ROWS, n_chk, replace=False))
    xs = big[torch.from_numpy(rows).to(dev)]
    cents = torch.from_numpy(index.centroids).to(dev)
    a = kmeans._assign(xs, cents)
    codes = pq_encode(xs - cents[a], index.pq)
    inv = np.empty(SCALE_ROWS, np.int64)
    inv[index.perm] = np.arange(SCALE_ROWS)
    same_list = float((a.cpu().numpy() == lists[rows]).mean())
    same_code = float((codes == index.codes[inv[rows]]).mean())
    log(f"ivf-pq: 10M: {n_chk} sampled rows' lists and codes recomputed by the separate passes: "
        f"{same_list:.6f} / {same_code:.6f} equal")
    if same_list < AGREE or same_code < AGREE:
        raise AssertionError("ivf-pq: the 10M fused pass disagrees with the separate passes")
    del big, xs, index
    torch.cuda.empty_cache()


def served_from_mmap(results, queries, model) -> float:
    """Max |served distance - (1 - row . q)| over every hit, the row read
    from the workspace's vector file; raises above 1e-6."""
    import numpy as np

    from semtools_tpu_torch.store import Workspace
    from semtools_tpu_torch.store.store import Store

    q = model.encode(queries).cpu().numpy()
    err = 0.0
    with Store(Workspace.open("smoke").config.root_dir, device="cpu") as store:
        start = {p: st for p, st, _ in store._valid_ranges()}
        mm = store._mmap("r")
        for qi, rs in enumerate(results):
            for r in rs:
                row = np.asarray(mm[start[r["filename"]] + r["match_line_number"]])
                err = max(err, abs(r["distance"] - float(1.0 - row @ q[qi])))
        del mm
    if not err <= 1e-6:
        raise AssertionError(f"IVF-PQ hits: served distances differ from the vector file by {err}")
    return err


def ann_steps(files, qfile, subset, model, corpus, starts):
    """The IVF-PQ tier on the workspace (``SEMTOOLS_TPU_FORCE_ANN=1``):
    ``workspace index --force -j`` built on the card; ``status``; a ``-Q`` 8
    search (distances from the vector file; recall@10 against the exact
    scan of ``corpus``); the 300-file subset (the compact path: exact, the
    fused kernels launched, counts reset just before); ``workspace compact``
    (remapped; the next search names ``ivf-pq`` with the same hits); a
    one-line edit served through the delta without a rebuild."""
    import numpy as np

    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.ops.scan import _topk_chunk
    from semtools_tpu_torch.store import Workspace
    from semtools_tpu_torch.store.store import Store

    common = ["-w", "smoke", "--top-k", "10", "-j"]
    root = Path(Workspace.open("smoke").config.root_dir)
    n_lines = N_FILES * LINES_PER_FILE
    os.environ["SEMTOOLS_TPU_FORCE_ANN"] = "1"
    try:
        kernels.reset_launch_counts()
        out, err, wall, stages = run_cli(["workspace", "index", "smoke", "--force", "-j"])
        report = json.loads(out)
        if report != {"workspace": "smoke", "index_type": "ivf-pq", "built": True,
                       "total_lines": n_lines} or "(device backend)" not in err:
            raise AssertionError(f"workspace index --force: {report} / {err[-500:]!r}")
        log(f"ivf-pq: workspace index --force -j: {wall:.3f} s wall; stages: {stages}; "
            f"kernel launches {sum(kernels.launch_counts().values())}")
        text = run_cli(["workspace", "status", "smoke"])[0]
        if "Index: Yes (ivf-pq)" not in text:
            raise AssertionError(f"workspace status under the forced IVF-PQ tier: {text!r}")
        with np.load(root / "ann.npz") as z:
            nlist = z["centroids"].shape[0]
        nprobe = nlist if n_lines <= 1 << 16 else max(16, nlist // 16)  # the store's rule at k 10
        log(f"ivf-pq: status names ivf-pq; nlist {nlist}, nprobe {nprobe}, probed pool "
            f"~{n_lines * nprobe // nlist} rows, ADC cut "
            f"{Store._ann_candidate_depth(10, n_lines, nlist, nprobe)}")

        ref_d, ref_i = _topk_chunk(model.encode(QUERIES), corpus, 0, corpus.shape[0], 10)
        kth = ref_d[:, -1].cpu().numpy()  # each query's exact 10th distance
        pos = {f: i for i, f in enumerate(files)}
        for probe in (None, str(nlist // 4)):  # the store's rule, then a quarter of the lists
            if probe:
                os.environ["SEMTOOLS_TPU_ANN_NPROBE"] = probe
            try:
                out, err, wall, stages = run_cli(["search", "-Q", qfile, *files, *common])
            finally:
                os.environ.pop("SEMTOOLS_TPU_ANN_NPROBE", None)
            if "Updating workspace" in err or "Building IVF-PQ" in err:
                raise AssertionError(f"ivf-pq -Q 8: updated or rebuilt: {err[-500:]!r}")
            batch = [json.loads(x)["results"] for x in out.splitlines() if x.strip()]
            d_err = served_from_mmap(batch, QUERIES, model)
            recall = np.mean([len({int(starts[pos[r["filename"]]]) + r["match_line_number"]
                                   for r in rs} & set(ref_i[qi].tolist())) / 10
                              for qi, rs in enumerate(batch)])
            # rows at the same distance (equal lines) are equally right answers
            as_good = np.mean([sum(r["distance"] <= kth[qi] + TOL for r in rs) / 10
                               for qi, rs in enumerate(batch)])
            log(f"ivf-pq: search -w -Q 8 (nprobe {probe or nprobe}): {wall:.3f} s wall; stages: "
                f"{stages}; distances equal the vector file's (max |d| err {d_err:.3g}); "
                f"recall@10 against the exact scan {recall:.4f} by row, {as_good:.4f} by "
                f"distance (hits no farther than the exact 10th)")
        busy, wall_ms, _ = device_busy(lambda: run_cli(["search", QUERIES[0], *files, *common]))
        log(f"ivf-pq: warm search -w under torch.profiler: device busy {busy:.3f} ms of "
            f"{wall_ms:.1f} ms wall ({100 * busy / wall_ms:.2f}%)")

        kernels.reset_launch_counts()
        out, _, wall, stages = run_cli(["search", QUERIES[2], *subset, *common])
        launches_of(F32_PATH, "ivf-pq store, 300-file subset")
        n_sub = SUBSET_FILES * LINES_PER_FILE
        d_err = check_hits([json.loads(out)["results"]], QUERIES[2:3], model, corpus[:n_sub],
                           starts, subset, 10)
        log(f"ivf-pq: {SUBSET_FILES}-file subset (compact path, exact): {wall:.3f} s wall; "
            f"stages: {stages}; hits equal the plain scan (max |d| err {d_err:.3g})")

        before = run_cli(["search", QUERIES[0], *files, *common])[0]
        out, _, wall, _ = run_cli(["workspace", "compact", "smoke", "-j"])
        report = json.loads(out)
        if not report["index_remapped"] or report["slots_reclaimed"] != LINES_PER_FILE:
            raise AssertionError(f"workspace compact under the IVF-PQ tier: {report}")
        log(f"ivf-pq: workspace compact: {wall:.3f} s wall; {report}")
        after, _, wall, stages = run_cli(["search", QUERIES[0], *files, *common])
        text = run_cli(["workspace", "status", "smoke"])[0]
        if after != before or "Index: Yes (ivf-pq)" not in text:
            raise AssertionError("ivf-pq: after compact, another answer or tier "
                                 f"({text.splitlines()[3:4]})")
        log(f"ivf-pq: search -w after compact: {wall:.3f} s wall; stages: {stages}; ivf-pq, "
            f"the same hits")

        meta = root / "ann_meta.npz"
        mtime = meta.stat().st_mtime_ns
        edit = (11, 20, "river mountain forest under the morning fog")
        lines = Path(files[edit[0]]).read_text().split("\n")
        lines[edit[1]] = edit[2]
        Path(files[edit[0]]).write_text("\n".join(lines))
        out, err, wall, stages = run_cli(["search", QUERIES[4], *files, *common])
        hits = json.loads(out)["results"]
        with Store(str(root), device="cpu") as store:
            changed, _, drift = store._ann_layout_diff(store._ann_meta_light()[1])
            delta = len(store._ann_current()[4])
        if "Building IVF-PQ" in err or meta.stat().st_mtime_ns != mtime or \
                [c[0] for c in changed] != [files[edit[0]]] or delta != LINES_PER_FILE:
            raise AssertionError(f"ivf-pq edit: rebuilt or not reconciled ({changed}, {delta})")
        if (files[edit[0]], edit[1]) not in [(r["filename"], r["match_line_number"]) for r in hits]:
            raise AssertionError("ivf-pq edit: the edited line is not among the hits")
        d_err = served_from_mmap([hits], QUERIES[4:5], model)
        log(f"ivf-pq: one-line edit, then search -w: {wall:.3f} s wall; stages: {stages}; no "
            f"rebuild (meta untouched), 1 document ({delta} rows) in the delta, drift {drift} "
            f"rows; the edited line served (max |d| err {d_err:.3g})")
    finally:
        os.environ.pop("SEMTOOLS_TPU_FORCE_ANN")


# -- phase 10: parse and ask --------------------------------------------------------

# n_lines 0: a search chunk starts at its matched line, which the checks read
ASK_SEARCH = {"n_lines": 0, "top_k": 10}
ASK_GREP = r"quick brown fox \w+"  # matches the workspace phase's edited line
INT8_MASKED_PATH = ("int8_tilemax_masked", "select_subtiles", "int8_rescan_topk_masked")
ASK_LAUNCHES = {}  # kernel -> launches summed over the ask runs
CARD = ""  # nvidia-smi's name and power limit, beside phase 10's times
PLANTED = ("zephyr lattice harbor quartz beacon", "marble orchid signal tundra violin",
           "copper meadow glacier lantern sonnet", "saffron canyon pixel walrus ember",
           "indigo falcon archive prism lagoon")
DOC_FORMATS = ("docx", "pptx", "xlsx", "html", "pdf")
N_DOCS = 250  # the local parse's documents, 50 of each format
N_LLAMA_DOCS = 8  # the fake LlamaParse's


def fake_servers():
    """``tests/fake_servers.py`` of this checkout, loaded by path: a ``tests``
    package installed in site-packages would shadow the repository's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("semtools_smoke_fake_servers",
                                                  REPO / "tests" / "fake_servers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zip(members) -> bytes:
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, content in members.items():
            zf.writestr(name, content)
    return buf.getvalue()


def document_bytes(fmt: str, lines) -> bytes:
    """One document of ``fmt`` whose text is ``lines`` (the first a title)."""
    import html as html_mod
    import zlib

    esc = [html_mod.escape(ln) for ln in lines]
    if fmt == "docx":
        w = "http://schemas.openxmlformats.org/wordprocessingml/2006/main"
        body = "".join(f"<w:p><w:r><w:t>{ln}</w:t></w:r></w:p>" for ln in esc)
        return _zip({"word/document.xml": f'<?xml version="1.0"?><w:document xmlns:w="{w}">'
                                          f"<w:body>{body}</w:body></w:document>"})
    if fmt == "pptx":
        p = "http://schemas.openxmlformats.org/presentationml/2006/main"
        a = "http://schemas.openxmlformats.org/drawingml/2006/main"
        bullets = "".join(f"<a:p><a:r><a:t>{ln}</a:t></a:r></a:p>" for ln in esc[1:])
        shapes = (f'<p:sp><p:nvSpPr><p:nvPr><p:ph type="title"/></p:nvPr></p:nvSpPr><p:txBody>'
                  f"<a:p><a:r><a:t>{esc[0]}</a:t></a:r></a:p></p:txBody></p:sp>"
                  f'<p:sp><p:nvSpPr><p:nvPr><p:ph type="body"/></p:nvPr></p:nvSpPr>'
                  f"<p:txBody>{bullets}</p:txBody></p:sp>")
        return _zip({"ppt/slides/slide1.xml": f'<?xml version="1.0"?><p:sld xmlns:p="{p}" '
                     f'xmlns:a="{a}"><p:cSld><p:spTree>{shapes}</p:spTree></p:cSld></p:sld>'})
    if fmt == "xlsx":
        s = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
        r = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
        rel = "http://schemas.openxmlformats.org/package/2006/relationships"
        shared = "".join(f"<si><t>{ln}</t></si>" for ln in esc)
        rows = "".join(f'<row r="{i + 1}"><c r="A{i + 1}" t="s"><v>{i}</v></c></row>'
                       for i in range(len(lines)))
        return _zip({
            "xl/sharedStrings.xml": f'<?xml version="1.0"?><sst xmlns="{s}">{shared}</sst>',
            "xl/worksheets/sheet1.xml": f'<?xml version="1.0"?><worksheet xmlns="{s}">'
                                        f"<sheetData>{rows}</sheetData></worksheet>",
            "xl/workbook.xml": f'<?xml version="1.0"?><workbook xmlns="{s}" xmlns:r="{r}">'
                               '<sheets><sheet name="Sheet" sheetId="1" r:id="rId1"/></sheets>'
                               "</workbook>",
            "xl/_rels/workbook.xml.rels": f'<?xml version="1.0"?><Relationships xmlns="{rel}">'
                                         '<Relationship Id="rId1" Type="x" '
                                         'Target="worksheets/sheet1.xml"/></Relationships>',
        })
    if fmt == "html":
        return (f"<html><body><h1>{esc[0]}</h1>"
                + "".join(f"<p>{ln}</p>" for ln in esc[1:]) + "</body></html>").encode()
    # pdf: one page, one FlateDecode content stream, a line per Td
    text = b"BT /F1 12 Tf 72 760 Td " + b" 0 -14 Td ".join(
        b"(%s) Tj" % ln.encode() for ln in lines) + b" ET"
    z = zlib.compress(text)
    objects = [
        (1, b"<< /Type /Catalog /Pages 2 0 R >>"),
        (2, b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>"),
        (3, b"<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>"),
        (4, b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(z) + z + b"\nendstream"),
    ]
    return b"%PDF-1.4\n" + b"".join(b"%d 0 obj\n" % n + body + b"\nendobj\n"
                                    for n, body in objects) + b"%%EOF\n"


def write_documents(root: Path, n: int, seed: int):
    """``n`` documents of 12-30 seeded lines, round robin over DOC_FORMATS;
    document i < 5 carries the planted line PLANTED[i] (so each format
    carries one). Returns the paths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        fmt = DOC_FORMATS[i % len(DOC_FORMATS)]
        lines = [" ".join(rng.choice(WORDS, size=int(rng.integers(4, 11))))
                 for _ in range(int(rng.integers(12, 31)))]
        if i < len(PLANTED):
            lines[1 + i] = PLANTED[i]
        path = root / f"doc_{i:04d}.{fmt}"
        path.write_bytes(document_bytes(fmt, lines))
        paths.append(str(path))
    return paths


def parse_steps(root: Path):
    """``parse -b local`` over N_DOCS seeded documents, then ``search`` on the
    card over the markdown it printed (each planted line must rank first for
    its own text), a second ``parse`` served from the cache; then ``parse``
    against a fake LlamaParse on localhost with one injected 5xx (the retry
    taken), and a rerun that sends no request."""
    fakes = fake_servers()
    FakeLlamaParse, FakeServer = fakes.FakeLlamaParse, fakes.FakeServer

    docs = write_documents(root / "docs", N_DOCS, SEED + 2)
    out, err, wall, stages = run_cli(["parse", "-b", "local", "-j", *docs])
    results = json.loads(out)["results"]
    if [r["input_path"] for r in results] != docs or any(r["was_cached"] for r in results) \
            or "Error" in err:
        raise AssertionError(f"parse -b local: {len(results)} results of {len(docs)}; "
                             f"{err[-500:]!r}")
    md = [r["output_path"] for r in results]
    n_lines = sum(len(Path(p).read_text().splitlines()) for p in md)
    log(f"parse: parse -b local, {len(docs)} documents ({', '.join(DOC_FORMATS)}; "
        f"{n_lines} markdown lines): {wall:.3f} s wall; stages: {stages}")
    again, _, wall, stages = run_cli(["parse", "-b", "local", "-j", *docs])
    if [r["output_path"] for r in json.loads(again)["results"]] != md or \
            not all(r["was_cached"] for r in json.loads(again)["results"]):
        raise AssertionError("parse -b local, again: not served from the cache")
    log(f"parse: the same parse again: {wall:.3f} s wall, every document from the cache")

    qfile = root / "planted.txt"
    qfile.write_text("\n".join(PLANTED) + "\n")
    out, _, wall, stages = run_cli(["search", "-Q", str(qfile), *md, "--top-k", "3", "-n", "0",
                                    "-j"])
    for i, line in enumerate(out.splitlines()):
        top = json.loads(line)["results"][0]
        if top["filename"] != md[i] or PLANTED[i] not in top["content"]:
            raise AssertionError(f"search over the parsed markdown: {PLANTED[i]!r} ranks "
                                 f"{top['filename']}:{top['match_line_number']} first")
    log(f"parse: search -Q 5 planted lines over the {len(md)} markdown files on the card: "
        f"{wall:.3f} s wall; stages: {stages}; each planted line first "
        f"({', '.join(DOC_FORMATS)})")

    pdfs = [d for d in docs if d.endswith(".pdf")][:N_LLAMA_DOCS]
    app = FakeLlamaParse(fail_uploads=1, markdown_pages=["# Page one\n\ntext", "two"])
    with FakeServer(app) as server:
        cfg = root / "llamaparse.json"
        cfg.write_text(json.dumps({"parse": {"api_key": "k", "base_url": server.url,
                                             "check_interval": 0.01, "retry_delay_ms": 1}}))
        out, err, wall, stages = run_cli(["parse", "-c", str(cfg), "-j", *pdfs])
        sent = len(app.requests)
        again, _, wall2, _ = run_cli(["parse", "-c", str(cfg), "-j", *pdfs])
    results = json.loads(out)["results"]
    if len(results) != len(pdfs) or app.upload_attempts != len(pdfs) + 1 or \
            "Job creation failed (attempt 1/11): server error. Retrying in 1ms..." not in err:
        raise AssertionError(f"parse (LlamaParse): {len(results)} results, "
                             f"{app.upload_attempts} uploads; {err[-500:]!r}")
    if len(app.requests) != sent or \
            not all(r["was_cached"] for r in json.loads(again)["results"]):
        raise AssertionError("parse (LlamaParse) again: requests sent or not from the cache")
    if Path(results[0]["output_path"]).read_text() != "# Page one\n\ntext\n\ntwo\n\n":
        raise AssertionError("parse (LlamaParse): the pages were not assembled")
    log(f"parse: parse against a fake LlamaParse on localhost, {len(pdfs)} documents, one "
        f"5xx injected: {wall:.3f} s wall ({sent} requests, the retry taken; stages: "
        f"{stages}); again: {wall2:.3f} s wall, no request, every document from the cache")


def tool_turn(api, calls):
    """An LLM turn that asks for ``calls`` [(tool, arguments)] in parallel."""
    if api == "responses":
        return {"output": [{"type": "function_call", "name": name, "arguments": json.dumps(args),
                            "call_id": f"call_{i}", "id": f"fc_{i}"}
                           for i, (name, args) in enumerate(calls)]}
    return {"choices": [{"message": {"role": "assistant", "content": None, "tool_calls": [
        {"id": f"call_{i}", "type": "function",
         "function": {"name": name, "arguments": json.dumps(args)}}
        for i, (name, args) in enumerate(calls)]}}]}


def answer_turn(api, text):
    if api == "responses":
        return {"output": [{"type": "message", "role": "assistant",
                            "content": [{"type": "output_text", "text": text}]}]}
    return {"choices": [{"message": {"role": "assistant", "content": text}}]}


def ask_script(api, files, with_grep):
    """Turn 1: four parallel searches with one config; (turn 2: a grep and a
    read); the answer."""
    turns = [tool_turn(api, [("search", {"query": q, "config": ASK_SEARCH})
                             for q in QUERIES[:4]])]
    if with_grep:
        turns.append(tool_turn(api, [("grep", {"pattern": ASK_GREP, "is_regex": True}),
                                     ("read", {"path": files[7], "start_line": 95,
                                               "end_line": 106})]))
    return turns + [answer_turn(api, f"answer ({api})")]


def tool_outputs(requests, api):
    """Every tool output the LLM received, in call order (the last request
    carries the whole history)."""
    body = requests[-1]["body"]
    if api == "chat":
        return [m["content"] for m in body["messages"] if m["role"] == "tool"]
    return [it["output"] for it in body["input"] if it.get("type") == "function_call_output"]


def chunk_hits(output):
    """A search tool output's hits as the CLI's JSON results (n_lines 0)."""
    return [{"filename": f, "match_line_number": int(s), "distance": float(d)}
            for f, s, d in re.findall(r"<chunk file=(\S+) start=(\d+) end=\d+ distance=([^>]+)>",
                                      output)]


def run_ask(argv, api, files, path, what, with_grep=False):
    """One ``ask`` through the CLI against a fake LLM on localhost with the
    counts reset just before: the path's kernels must show launches, the
    four searches must be served by one batched scan, no tool output may
    start with ``Error:``, and a grep must run the native scanner. Returns
    (stdout, tool outputs)."""
    from semtools_tpu_torch.ask import agent, tools
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.utils import grepscan
    fakes = fake_servers()
    batches, singles, greps = [], [], []
    real = (tools.search_tool_batched, agent.search_tool, grepscan.match_lines)
    tools.search_tool_batched = lambda f, qs, *a, **k: batches.append(list(qs)) or real[0](
        f, qs, *a, **k)
    agent.search_tool = lambda *a, **k: singles.append(a) or real[1](*a, **k)
    grepscan.match_lines = lambda *a: greps.append(a) or real[2](*a)
    try:
        with fakes.FakeServer(fakes.FakeOpenAI(ask_script(api, files, with_grep))) as llm:
            kernels.reset_launch_counts()
            out, _, wall, stages = run_cli([*argv, "--api-mode", api, "--base-url", llm.url,
                                            "--api-key", "k"])
            launches = launches_of(path, f"ask ({what})")
            requests = llm.app.requests
    finally:
        tools.search_tool_batched, agent.search_tool, grepscan.match_lines = real
    for name, n in launches.items():
        ASK_LAUNCHES[name] = ASK_LAUNCHES.get(name, 0) + n
    outputs = tool_outputs(requests, api)
    failed = [o[:200] for o in outputs if o.startswith("Error:")]
    if failed:
        raise AssertionError(f"ask ({what}): tool outputs {failed}")
    if batches != [QUERIES[:4]] or singles:
        raise AssertionError(f"ask ({what}): the four searches ran as {batches} batched and "
                             f"{len(singles)} single")
    if with_grep and len(greps) != len(files):
        raise AssertionError(f"ask ({what}): the native grep scanner ran on {len(greps)} files")
    if not out.endswith(f"\nanswer ({api})\n") or len(requests) != 2 + with_grep:
        raise AssertionError(f"ask ({what}): {len(requests)} LLM calls; stdout ends "
                             f"{out[-200:]!r}")
    log(f"ask: {what}: {wall:.3f} s wall; {len(requests)} LLM calls, {len(outputs)} tool calls; "
        f"stages: {stages} ({CARD})")
    return out, outputs


def ask_steps(files, subset, model, corpus, starts):
    """``ask`` on the workspace of phase 7 (its int8 tier warm; ``corpus``
    holds its embeddings): chat mode without ``-w`` over the 1M lines (four
    parallel searches, then a grep and a read), responses mode with ``-w``
    over all files (K3) and over the 300-file subset (K4). Each search tool
    output's hits must equal the plain scan of the same embeddings, and the
    grep output a Python ``re`` scan."""
    from semtools_tpu_torch.ask import tools
    from semtools_tpu_torch.utils import grepscan

    if not grepscan.available():
        raise AssertionError("ask: the native grep scanner is not loaded")
    question = ["ask", "which lines speak of caches and rivers?"]
    _, outs = run_ask([*question, *files], "chat", files, F32_PATH,
                      f"chat, {len(files)} files, plain", with_grep=True)
    err = check_hits([chunk_hits(o) for o in outs[:4]], QUERIES[:4], model, corpus, starts,
                     files, 10)
    real = grepscan.available
    grepscan.available = lambda: False
    try:  # the same grep through Python re alone
        want = tools.grep_tool(files, ASK_GREP, None, True, True, 3)
    finally:
        grepscan.available = real
    if outs[4] != want or "<chunk" not in want:
        raise AssertionError("ask: the native grep output differs from a Python re scan")
    if not outs[5].startswith(f"<chunk file={files[7]} start=95 end=106>\n"):
        raise AssertionError(f"ask: read output {outs[5][:120]!r}")
    argv = [*question, *files, "-w", "smoke"]
    _, outs = run_ask(argv, "responses", files, INT8_PATH,
                      f"responses, -w, {len(files)} files (int8)")
    err = max(err, check_hits([chunk_hits(o) for o in outs], QUERIES[:4], model, corpus,
                              starts, files, 10))
    busy, wall_ms, _ = device_busy(lambda: run_ask(argv, "responses", files, INT8_PATH,
                                                   "the same, under torch.profiler"))
    log(f"ask: ask -w under torch.profiler: device busy {busy:.3f} ms of {wall_ms:.1f} ms wall "
        f"({100 * busy / wall_ms:.2f}%)")
    _, outs = run_ask([*question, *subset, "-w", "smoke"], "responses", subset,
                      INT8_MASKED_PATH, f"responses, -w, {len(subset)}-file subset (masked int8)")
    n_sub = len(subset) * LINES_PER_FILE
    err = max(err, check_hits([chunk_hits(o) for o in outs], QUERIES[:4], model,
                              corpus[:n_sub], starts, subset, 10))
    log(f"ask: every search tool output equals the plain scan of the same embeddings (max |d| "
        f"err {err:.3g}); the grep output equals a Python re scan "
        f"({want.count('<chunk')} chunks)")


def ask_int4_steps(files, subset, model, corpus, starts):
    """``ask -w`` (responses) on the int4 rung (``SEMTOOLS_TPU_STORE_INT4=1``,
    its corpus built by the int4 steps of phase 7) over all files and the
    300-file subset: the deep-candidate sweep, plain and masked (K6). Hits as
    in :func:`ask_steps`."""
    question = ["ask", "which lines speak of caches and rivers?"]
    os.environ["SEMTOOLS_TPU_STORE_INT4"] = "1"
    try:
        _, outs = run_ask([*question, *files, "-w", "smoke"], "responses", files,
                          ("int4_sims_max",), f"responses, -w, {len(files)} files (int4)")
        err = check_hits([chunk_hits(o) for o in outs], QUERIES[:4], model, corpus, starts,
                         files, 10)
        _, outs = run_ask([*question, *subset, "-w", "smoke"], "responses", subset,
                          ("int4_sims_max_masked",),
                          f"responses, -w, {len(subset)}-file subset (masked int4)")
        n_sub = len(subset) * LINES_PER_FILE
        err = max(err, check_hits([chunk_hits(o) for o in outs], QUERIES[:4], model,
                                  corpus[:n_sub], starts, subset, 10))
    finally:
        os.environ.pop("SEMTOOLS_TPU_STORE_INT4")
    log(f"ask: the int4 rung's search tool outputs equal the plain scan (max |d| err {err:.3g})")


# -- phase 11: sharded serving ------------------------------------------------------

SHARDS = 4  # the mesh of phase 11: one card cut into four shards
SHARDED_PATH = ("fused_tilemax", "select_subtiles", "fused_rescan_topk", "int8_tilemax",
                "int8_rescan_topk", "int4_sims_max", *SELECTION)
SHARDED_LAUNCHES = {}  # kernel -> launches on phase 11's sharded main path


def _client_env_argv(files, query):
    from semtools_tpu_torch.utils import native

    env = dict(os.environ, PYTHONPATH=str(REPO), SEMTOOLS_TPU_DAEMON="auto",
               SEMTOOLS_TPU_PYTHON=sys.executable)
    return env, [str(native.client_path()), "search", query, *files, "--top-k", "10", "-j"]


def native_client_forwarded(files, forwarded):
    """The native client (built in phase 1), with the daemon up, from a child
    process 10 times: stdout and exit code equal to the Python client's
    ``forwarded``; logs the median wall."""
    from semtools_tpu_torch import daemon

    if not daemon.ping():
        raise AssertionError("native client: the daemon is not up")
    env, argv = _client_env_argv(files, QUERIES[0])
    walls = []
    for i in range(10):
        t0 = time.perf_counter()
        r = subprocess.run(argv, env=env, cwd=str(REPO), stdin=subprocess.DEVNULL,
                           capture_output=True, text=True, timeout=300)
        walls.append(time.perf_counter() - t0)
        if r.returncode != 0 or r.stdout != forwarded:
            raise AssertionError(f"native client run {i}: exit {r.returncode}, stdout "
                                 f"{'equal' if r.stdout == forwarded else 'differs'}: "
                                 f"{r.stderr[-1000:]}")
    walls.sort()
    log(f"daemon: search -w through the native client, 10 runs from new processes: "
        f"median {(walls[4] + walls[5]) / 2:.4f} s wall (min {walls[0]:.4f}, max "
        f"{walls[-1]:.4f}); stdout and exit code equal to the Python-forwarded run ({CARD})")


def native_client_fallback(files, query, after_edit):
    """The native client with the daemon stopped: it execs ``python -m
    semtools_tpu_torch.cli``, which prints ``after_edit``."""
    from semtools_tpu_torch import daemon

    if daemon.ping():
        raise AssertionError("native client fallback: the daemon is still up")
    env, argv = _client_env_argv(files, query)
    t0 = time.perf_counter()
    r = subprocess.run(argv, env=env, cwd=str(REPO), stdin=subprocess.DEVNULL,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or r.stdout != after_edit:
        raise AssertionError(f"native client, no daemon: exit {r.returncode}, stdout "
                             f"{'equal' if r.stdout == after_edit else 'differs'}: "
                             f"{r.stderr[-1000:]}")
    log(f"daemon: with the daemon stopped the native client ran python -m "
        f"semtools_tpu_torch.cli: {time.perf_counter() - t0:.3f} s wall, the daemon's answer")


def same_output(what, single: str, sharded: str) -> float:
    """Two search outputs (JSON, one document or NDJSON lines) equal apart
    from distances, which agree within TOL; returns the max |difference|."""
    def docs(text):
        return [json.loads(x) for x in text.splitlines() if x.strip()] \
            if text.lstrip().startswith('{"query"') else [json.loads(text)]

    dists = ([], [])

    def strip(obj, out):
        if isinstance(obj, dict):
            return {k: (out.append(v) if k == "distance" else strip(v, out))
                    for k, v in obj.items()}
        if isinstance(obj, list):
            return [strip(v, out) for v in obj]
        return obj

    a, b = strip(docs(single), dists[0]), strip(docs(sharded), dists[1])
    if a != b or len(dists[0]) != len(dists[1]) or not dists[0]:
        raise AssertionError(f"{what}: the sharded output differs from the single-device one")
    err = max(abs(x - y) for x, y in zip(*dists))
    if not err <= TOL:
        raise AssertionError(f"{what}: distances differ by {err} > {TOL}")
    return err


def sharded_kernel_steps(mesh):
    """(b): each sharded scan at phases 2-4's sizes against the single-device
    kernel path on the same tensors (Q 8, k 10, a ragged n_true that leaves
    the last shard partly padding, planted duplicates lowest first), each
    kernel launched once per shard, and both timed."""
    import torch

    from semtools_tpu_torch.ops import fused_scan as fs
    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops import int8_scan as i8
    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.parallel import scan as sh
    from semtools_tpu_torch.parallel.mesh import shard_corpus, shard_rows

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    qn, k = 8, 10

    def once_per_shard(fn, names, what):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {n: kernels.launch_counts()[n] for n in names}
        if any(v != SHARDS for v in got.values()):
            raise AssertionError(f"{what}: launches {got}, want {SHARDS} each")
        return out

    def times(what, single, sharded):
        t = {"single_ms": cuda_ms(single), "sharded_ms": cuda_ms(sharded),
             "single_device_ms": device_ms(single), "sharded_device_ms": device_ms(sharded)}
        log(f"sharded: {what}: one device {t['single_ms']:.4f} ms events, "
            f"{t['single_device_ms']:.4f} ms device; {SHARDS} shards {t['sharded_ms']:.4f} ms "
            f"events, {t['sharded_device_ms']:.4f} ms device ({CARD})")

    n = 2_000_000
    n_true = n - 1000
    e, dups = make_corpus(n, torch.float32, n_true, gen)
    q = unit_rows(qn, gen)
    q[0] = e[5]
    es, _ = shard_corpus(e[:n_true], mesh)
    if not es.shape[0] - n_true > 0 or not es.n_local * (SHARDS - 1) < n_true:
        raise AssertionError("the f32 corpus leaves no shard partly padding")
    d, i = once_per_shard(lambda: sh.sharded_topk_scan_device(q, es, n_true, k),
                          F32_PATH, "sharded f32 top-k")
    ref_d, ref_i = fs.fused_topk_scan(q, e, k + 1, n_true)
    err = agree("sharded f32 top-k", 1.0 - d, 1.0 - ref_d, i, ref_i)
    if i[0, :5].tolist() != sorted(dups):
        raise AssertionError(f"sharded f32: planted duplicates {i[0, :5].tolist()}")
    times(f"f32 top-k, {n_true} x {D}, Q {qn}, k {k}",
          lambda: fs.fused_topk_scan(q, e, k, n_true),
          lambda: sh.sharded_topk_scan_device(q, es, n_true, k))
    log(f"sharded: f32 top-k equals the single-device kernel path (max |d| err {err:.3g}); "
        f"K1a, sel, K1b launched once per shard")
    del e, es

    n = 10_000_000
    n_true = n - 1000
    e8 = torch.randint(-127, 128, (n, D), generator=gen, device="cuda", dtype=torch.int8)
    e8[[127, 128, n // 2, n_true - 1]] = e8[5].clone()
    q = torch.randn((qn, D), generator=gen, device="cuda")
    q[0] = e8[5].float()
    e8s, _ = shard_corpus(e8[:n_true], mesh)
    d, i = once_per_shard(lambda: sh.sharded_int8_topk_scan_device(q, e8s, E_SCALE, k, n_true),
                          INT8_PATH, "sharded int8 top-k")
    d1, i1 = i8.int8_topk_scan(q, e8, E_SCALE, k, n_true=n_true)
    if not (torch.equal(d, d1) and torch.equal(i, i1)):
        raise AssertionError("sharded int8 top-k: sims or rows differ from the single device")
    if i[0, :5].tolist() != [5, 127, 128, n // 2, n_true - 1]:
        raise AssertionError(f"sharded int8: planted duplicates {i[0, :5].tolist()}")
    times(f"int8 top-k, {n_true} x {D}, Q {qn}, k {k}",
          lambda: i8.int8_topk_scan(q, e8, E_SCALE, k, n_true=n_true),
          lambda: sh.sharded_int8_topk_scan_device(q, e8s, E_SCALE, k, n_true))
    log("sharded: int8 top-k equals the single-device kernel path exactly; K3a, sel, K3b "
        "launched once per shard")
    del e8, e8s

    p4, dups = make_packed(n, n_true, gen)
    q, _, _ = int4_queries(p4, qn, gen)
    p4s, _ = shard_corpus(p4[:n_true], mesh, fill=i4.PACKED_ZERO_BYTE)
    half = (torch.rand(n_true, generator=gen, device="cuda") < 0.5).to(torch.uint8)
    half[dups] = 1
    for mask, name in ((None, "int4_sims_max"), (half, "int4_sims_max_masked")):
        ms = None if mask is None else shard_rows(mask, mesh)
        ids = once_per_shard(lambda: sh.sharded_int4_deep_candidates_device(
            q, p4s, n_true, mask=ms), (name,), f"sharded {name}")
        # a shard's tops and counts, and the merged cutoff; one extraction a shard
        selection = {n: kernels.launch_counts()[n] for n in SELECTION}
        if selection != {"int4_cutoff_counts": 2 * SHARDS + 1, "int4_extract_above": SHARDS}:
            raise AssertionError(f"sharded {name}: selection launches {selection}")
        selection_path(f"sharded {name} deep candidates",
                       lambda: sh.sharded_int4_deep_candidates_device(q, p4s, n_true, mask=ms),
                       {"select_kernel": SHARDS, "int4_cutoff_kernel": SHARDS + 1,
                        "int4_count_kernel": SHARDS, "int4_write_kernel": SHARDS})
        want = i4.int4_deep_candidates(q, p4, n_true=n_true, mask=mask)
        for r in range(qn):
            got_r, want_r = ids[r][ids[r] < n_true], want[r][want[r] < n_true]
            if not torch.equal(got_r.sort().values, want_r.sort().values):
                raise AssertionError(f"sharded {name}: query {r}'s candidate set differs")
        if not set(dups) <= set(ids[0].tolist()):
            raise AssertionError(f"sharded {name}: the planted rows are not candidates")
        times(f"{name} deep candidates, {n_true} x {D // 2} B, Q {qn}",
              lambda: i4.int4_deep_candidates(q, p4, n_true=n_true, mask=mask),
              lambda: sh.sharded_int4_deep_candidates_device(q, p4s, n_true, mask=ms))
        with past_the_cap():
            past = sh.sharded_int4_deep_candidates_device(q, p4s, n_true, mask=ms)
            want = plain_sharded_candidates(q, p4s, n_true, ms)
            selection_path(f"sharded {name} deep candidates past the cap ({OVER_CAP})",
                           lambda: sh.sharded_int4_deep_candidates_device(q, p4s, n_true, mask=ms),
                           {"select_kernel": SHARDS, "int4_cutoff_kernel": SHARDS + 1,
                            "int4_count_kernel": SHARDS, "int4_write_kernel": SHARDS,
                            "int4_rule_kernel": SHARDS})
        if past.shape != want.shape:
            raise AssertionError(f"sharded {name} past the cap: {tuple(past.shape)} candidates, "
                                 f"the plain twin {tuple(want.shape)}")
        for r in range(qn):
            got_r, want_r = past[r][past[r] < n_true], want[r][want[r] < n_true]
            if not torch.equal(got_r.sort().values, want_r.sort().values):
                raise AssertionError(f"sharded {name} past the cap: query {r}'s candidate set "
                                     f"differs from the plain twin's")
    log("sharded: int4 deep-candidate sets equal the single device's, plain and masked, and "
        f"past the cap ({OVER_CAP}) the plain twin's; K6 and int4_extract_above launched once "
        "per shard, int4_cutoff_counts twice and once for the merge")


def plain_sharded_candidates(q, p4s, n_true, ms, k_cut: int = 10):
    """``sharded_int4_deep_candidates_device`` composed of the plain versions
    on the card (each shard's sweep, tops, counts and extraction, the cutoff
    of the merged tops), in its [Q, shards * cap] layout."""
    import torch

    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops.int8_scan import quantize_on_device
    from semtools_tpu_torch.parallel import scan as sh

    q8 = quantize_on_device(q)[0].contiguous()
    qn = q8.shape[0]
    margin = torch.tensor(i4.cutoff_margin(q8), device=q8.device)
    held, tops = {}, []
    for j, (g0, lt) in enumerate(sh._local_trues(p4s, n_true)):
        if not lt:
            tops.append(torch.full((qn, k_cut), float("-inf"), device=q8.device))
            continue
        sims, bmax = i4.sims_max_reference(q8, p4s.shards[j], lt,
                                           None if ms is None else ms.shards[j])
        tops.append(i4.block_tops_reference(sims, bmax, k_cut))
        held[g0] = (lt, sims, bmax)
    cutoff = i4.tops_cutoff_reference(torch.cat(tops, dim=1), margin, k_cut)
    counts = [i4.counts_above_reference(sims, bmax, cutoff) for _, sims, bmax in held.values()]
    max_count = max(int(c.max()) for c, _ in counts)
    max_nb = max(int(b.max()) for _, b in counts)
    cap, n_b = i4.candidate_sizes(max_count, max_nb, n_true, -(-p4s.n_local // i4.SIMS_ROWS))
    cap = min(cap, p4s.n_local)
    sentinel = p4s.n_local * p4s.mesh.size
    ids = []
    for g0, _ in sh._local_trues(p4s, n_true):
        if g0 not in held:
            ids.append(torch.full((qn, cap), sentinel, dtype=torch.int64, device=q8.device))
            continue
        lt, sims, bmax = held[g0]
        loc = i4.extract_above(sims, bmax, cutoff, n_b=n_b, cap=cap)
        ids.append(torch.where(loc < lt, loc + g0, sentinel))
    return torch.cat(ids, dim=1)


def sharded_workspace_steps(args):
    """(c) and (d), each command run on one device (SEMTOOLS_TPU_SHARDED=0)
    and on the mesh (=1) in this process, outputs equal. The counts are reset
    just before each run on the mesh and read just after; their sums are the
    sharded main path's launches."""
    from semtools_tpu_torch.ops import kernels

    files, subset, qfile, thr = args["files"], args["subset"], args["qfile"], args["thr"]
    ws = ["-w", "smoke", "--top-k", "10", "-j"]
    launches = {}

    def on_mesh(argv):
        kernels.reset_launch_counts()
        out = run_cli(argv)
        for name, n in kernels.launch_counts().items():
            launches[name] = launches.get(name, 0) + n
        return out

    def both(label, argv, env=(), single_env=()):
        outs, walls = [], []
        for sharded in ("0", "1"):
            extra = dict(env)
            if sharded == "0":
                extra.update(single_env)
            old = {k: os.environ.get(k) for k in (*extra, "SEMTOOLS_TPU_SHARDED")}
            os.environ.update(extra, SEMTOOLS_TPU_SHARDED=sharded)
            try:
                out, err, wall, stages = (on_mesh if sharded == "1" else run_cli)(argv)
                status = run_cli(["workspace", "status", "smoke"])[0] if "-w" in argv else ""
            finally:
                for key, v in old.items():
                    if v is None:
                        os.environ.pop(key, None)
                    else:
                        os.environ[key] = v
            outs.append(out)
            walls.append((wall, stages, status))
        err = same_output(label, *outs)
        tier = re.search(r"Index: Yes \(([^)]*)\)", walls[1][2])
        log(f"sharded: {label}: one device {walls[0][0]:.3f} s wall (stages {walls[0][1]}); "
            f"{SHARDS} shards {walls[1][0]:.3f} s wall ({tier.group(1) if tier else 'plain search'}; "
            f"stages {walls[1][1]}); outputs equal (max |d| err {err:.3g})")
        return tier.group(1) if tier else None, walls[1][1]

    tiers = {}
    tiers["warm"], _ = both("search -w", ["search", QUERIES[0], *files, *ws])
    tiers["-Q 8"], _ = both("search -w -Q 8", ["search", "-Q", qfile, *files, *ws])
    tiers["subset"], _ = both(f"search -w, {len(subset)}-file subset",
                              ["search", QUERIES[2], *subset, *ws])
    tiers["-m"], _ = both(f"search -w -m {thr:.4f}",
                          ["search", QUERIES[3], *files, "-w", "smoke", "-m", str(thr), "-j"])
    edit_file, edit_line = 11, 77
    lines = Path(files[edit_file]).read_text().split("\n")
    lines[edit_line] = "sharded patch of the quick brown fox"
    Path(files[edit_file]).write_text("\n".join(lines))
    os.environ["SEMTOOLS_TPU_SHARDED"] = "1"
    try:
        on_mesh(["search", QUERIES[1], *files, *ws])
        stages = stage_seconds()
    finally:
        os.environ.pop("SEMTOOLS_TPU_SHARDED")
    if "slot_corpus_build" in stages or "slot_corpus_patch" not in stages:
        raise AssertionError(f"sharded edit: stages {sorted(stages)}: not served by a patch")
    log(f"sharded: one-line edit on the mesh: patched in {stages['slot_corpus_patch'] * 1e3:.1f}"
        f" ms, no slot_corpus_build")
    tiers["edit"], _ = both("search -w after the edit", ["search", QUERIES[1], *files, *ws])
    tiers["f32"], _ = both("search -w, f32 tier", ["search", QUERIES[0], *files, *ws],
                           {"SEMTOOLS_TPU_STORE_INT8": "0"})
    tiers["int4"], _ = both("search -w, int4 rung", ["search", QUERIES[0], *files, *ws],
                            {"SEMTOOLS_TPU_STORE_INT4": "1"})
    rung, budget = REDUCED_BUDGETS[0]
    tiers[rung], _ = both(f"search -w, {rung} rung", ["search", QUERIES[0], *files, *ws],
                          {"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(budget // SHARDS)},
                          {"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": str(budget)})
    want = {"warm": "sharded-int8-scan[4]", "-Q 8": "sharded-int8-scan[4]",
            "subset": "sharded-int8-scan[4]", "-m": "sharded-int8-scan[4]",
            "edit": "sharded-int8-scan[4]", "f32": "sharded-exact-scan[4]",
            "int4": "sharded-int4-scan[4]", rung: f"sharded-int8-scan[4]-{rung}"}
    if tiers != want:
        raise AssertionError(f"sharded tiers {tiers}, want {want}")
    both("plain search -Q 8 (search.py's sharded branch)",
         ["search", "-Q", qfile, *files, "--top-k", "10", "-j"])
    log(f"sharded: main path's kernel launches on the mesh: {launches}")
    missing = [name for name in SHARDED_PATH if not launches.get(name)]
    if missing:
        raise AssertionError(f"the sharded main path never launched {missing}")
    return launches


def sharded_child(args_path: str) -> int:
    """Phase 11 in a process of its own (``SEMTOOLS_TORCH_VIRTUAL_DEVICES=4``
    fixes its mesh): (a) the dry run, (b) the kernel checks, (c)-(d) the
    workspace and plain search; writes the sharded main path's launches."""
    import torch

    from semtools_tpu_torch.parallel.dryrun import dryrun_multichip
    from semtools_tpu_torch.parallel.mesh import corpus_mesh

    global CARD
    args = json.loads(Path(args_path).read_text())
    CARD = args["card"]
    mesh = corpus_mesh(device="cuda")
    if mesh.size != SHARDS or set(mesh.devices) != {torch.device("cuda", 0)}:
        raise AssertionError(f"phase 11's mesh is {mesh}, not {SHARDS} shards of cuda:0")
    t0 = time.perf_counter()
    log(f"sharded: dryrun_multichip({SHARDS}) on the card: {dryrun_multichip(SHARDS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    sharded_kernel_steps(mesh)
    launches = sharded_workspace_steps(args)
    Path(args["out"]).write_text(json.dumps(launches))
    return 0


def sharded_phase(files, qfile, subset, thr):
    """Phase 11 (sharded serving) in a child process on the card; its
    sharded main path's launches go to SHARDED_LAUNCHES."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="semtools_smoke_sharded_") as tmp:
        args = Path(tmp) / "args.json"
        args.write_text(json.dumps({"files": files, "qfile": qfile, "subset": subset,
                                    "thr": thr, "card": CARD,
                                    "out": str(Path(tmp) / "launches.json")}))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("SEMTOOLS_TPU_DAEMON", "SEMTOOLS_WORKSPACE",
                                    "SEMTOOLS_TPU_FORCE_ANN", "SEMTOOLS_TPU_STORE"))}
        env.update(SEMTOOLS_TORCH_VIRTUAL_DEVICES=str(SHARDS), SEMTOOLS_TPU_DAEMON="off",
                   PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--sharded-child",
                               str(args)], env=env, cwd=str(REPO), stdin=subprocess.DEVNULL,
                              timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"phase 11 (sharded serving) failed: exit {proc.returncode}")
        SHARDED_LAUNCHES.update(json.loads((Path(tmp) / "launches.json").read_text()))
    log(f"sharded: phase 11 done in {time.perf_counter() - t0:.1f} s")


# Phase 12: the soak's size (the largest that keeps the phase near 4 minutes
# on the card), the serving kernels its routes must launch, the sharded
# twins by the store campaign's tier, and the kernels it is not expected to
# reach with the routing that keeps them out.
SOAK_ARGS = ("--steps", "40", "--seeds", "2", "--crash-rounds", "16")
SOAK_KERNELS = ("select_subtiles", "int8_tilemax", "int8_rescan_topk", "int8_tilemax_masked",
                "int8_rescan_topk_masked", "int4_sims_max", "int4_sims_max_masked",
                "int4_cutoff_counts", "int4_extract_above", "fused_tilemax",
                "fused_rescan_topk")
SOAK_SHARDED = {
    "SHARDED=1": ("fused_tilemax", "select_subtiles", "fused_rescan_topk"),
    "SHARDED=1+STORE_INT8=1": ("int8_tilemax", "select_subtiles", "int8_rescan_topk"),
    "SHARDED=1+STORE_INT4=1": ("int4_sims_max", "int4_cutoff_counts", "int4_extract_above"),
}
SOAK_REPORTED = {
    "fused_scan_candidates": "K2: one device's f32 scan takes the single phase while "
                             "tiles <= 2*Q*k (ops/fused_scan.py fused_topk_scan), "
                             "and only from 256 slots, k <= 64, Q <= 32 (ops/scan.py _use_fused)",
    "int4_tilemax": "K5: the store never calls int4_topk_scan; its int4 tiers sweep "
                    "through K6 (store/store.py _search_slot_cached_batched)",
    "int4_rescan_topk": "K5, as int4_tilemax",
    "int4_tilemax_masked": "K5, as int4_tilemax",
    "int4_rescan_topk_masked": "K5, as int4_tilemax",
}
SOAK_LAUNCHES = {}  # kernel -> launches summed over phase 12's campaigns


def soak_phase() -> None:
    """Phase 12: the soak in a child process on the card; the launches of
    its campaigns go to SOAK_LAUNCHES."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMTOOLS_")}
    env.update(SEMTOOLS_TORCH_VIRTUAL_DEVICES=str(SHARDS), SEMTOOLS_TPU_NO_FETCH="1",
               SEMTOOLS_TPU_ALLOW_FALLBACK="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "semtools_tpu_torch.soak", *SOAK_ARGS],
                          env=env, cwd=str(REPO), stdin=subprocess.DEVNULL,
                          capture_output=True, text=True, timeout=480)
    reports = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith('{"campaign"')]
    for ln in proc.stdout.splitlines():
        if "MISMATCH" in ln or "FAILURE" in ln:
            log(f"soak: {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"phase 12 (soak) exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    names = [r["campaign"] for r in reports]
    if names != ["store", "workspace", "daemon", "crash"]:
        raise AssertionError(f"phase 12 reported campaigns {names}")
    for r in reports:
        launched = {k: v for k, v in r["launches"].items() if v}
        log(f"soak: {r['campaign']} campaign: {r['checks']} checks, {r['failures']} failures, "
            f"{r['wall_s']:.3f} s wall; launches {launched} ({CARD})")
        if r["failures"] or r["checks"] <= 0:
            raise AssertionError(f"phase 12: the {r['campaign']} campaign: {r}")
        for k, v in r["launches"].items():
            SOAK_LAUNCHES[k] = SOAK_LAUNCHES.get(k, 0) + v
    tiers = reports[0]["tiers"]
    for tier, counts in tiers.items():
        log(f"soak: store tier {tier}: launches {counts}")
    missing = [k for k in SOAK_KERNELS if not SOAK_LAUNCHES.get(k)]
    missing += [f"{k} ({tier})" for tier, ks in SOAK_SHARDED.items() for k in ks
                if not tiers.get(tier, {}).get(k)]
    if missing:
        raise AssertionError(f"phase 12: the soak's routes never launched {missing}")
    for k, why in SOAK_REPORTED.items():
        log(f"soak: {k}: {SOAK_LAUNCHES.get(k, 0)} launches ({why})")
    log(f"soak: phase 12 done in {time.perf_counter() - t0:.1f} s ({CARD})")


def main() -> int:
    if not (REPO / "semtools_tpu_torch").is_dir() or not (REPO / "cpp").is_dir():
        print("error: run chip_smoke.py from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device: the port's kernels need one", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--sharded-child"]:
        return sharded_child(sys.argv[2])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    global CARD
    CARD = card
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"{card}")
    t_start = time.perf_counter()

    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")
    build_phase()
    floor = launch_floor()
    errs, times = f32_kernel_phase()
    errs8, times8 = int8_kernel_phase()
    errs4, times4, k5_launches = int4_kernel_phase()
    errs.update(errs8)
    errs.update(errs4)
    times.update(times8)
    times.update(times4)
    log(f"kernels: done at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    probes, roof = probe_phase()
    roof_shares(times, roof)
    log(f"probes: done in {time.perf_counter() - t0:.1f} s")

    os.environ.update(SEMTOOLS_TPU_ALLOW_FALLBACK="1", SEMTOOLS_TPU_NO_FETCH="1",
                      SEMTOOLS_TPU_TIMINGS="1")
    os.environ.pop("SEMTOOLS_WORKSPACE", None)
    t0 = time.perf_counter()
    ivf_pq_index_phase(dev)
    log(f"ivf-pq: index layer done in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="semtools_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        files, lines = write_corpus(root, N_FILES, LINES_PER_FILE, SEED)
        (root / "small").mkdir()
        small, small_lines = write_corpus(root / "small", 1, 2000, SEED + 1)
        log(f"main: wrote {len(lines)} lines in {len(files)} files in "
            f"{time.perf_counter() - t0:.1f} s")
        outs, qfile, launches = main_path_phase(files, small)
        model = StaticModel.from_pretrained("minishlab/potion-multilingual-128M", device=dev)
        corpus = model.encode(lines)
        starts = np.arange(len(files) + 1) * LINES_PER_FILE
        check_main_path(outs, model, corpus, starts, files, small_lines, small)
        ws_launches, k6_launches = workspace_phase(files, qfile, model, corpus, starts)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="semtools_smoke_parse_") as home:
            old_home, os.environ["HOME"] = os.environ.get("HOME"), home
            try:
                parse_steps(root / "parse")
            finally:
                if old_home is None:
                    os.environ.pop("HOME", None)
                else:
                    os.environ["HOME"] = old_home
        log(f"parse: done in {time.perf_counter() - t0:.1f} s ({card})")
    soak_phase()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "semtools_tpu"))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    from semtools_tpu_torch.utils import tracing

    tracing.reset()  # the checks' own stages: nothing to report at exit

    # each kernel's launches on its own path's run: the plain search for the
    # fused kernels and the selection, workspace search for int8, the
    # int4-tier workspace steps for the sweep (K6) and int4_topk_scan's
    # calls for K5
    path_of = {name: launches for name in REPLACES
               if name.startswith("fused") or name == "select_subtiles"}
    path_of.update({name: ws_launches for name in REPLACES if name.startswith("int8")})
    path_of.update({name: k5_launches for name in K5 if name != "select_subtiles"})
    path_of.update({name: k6_launches for name in K6 + SELECTION})
    summary = {"kernels": []}
    for name in REPLACES:
        r = times[name]
        summary["kernels"].append({
            "name": name, "route": "cuda",
            "source": SELECT_ABOVE_SOURCE if name in SELECTION else SOURCES[name.split("_")[0]],
            "replaces": REPLACES[name],
            "launches": path_of[name][name],
            "max_abs_err": errs[name], "ms": r["ms"], "device_ms": r["device_ms"],
            "floor_ms": floor[1], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ask_launches": ASK_LAUNCHES.get(name, 0),
            "sharded_launches": SHARDED_LAUNCHES.get(name, 0),
            "soak_launches": SOAK_LAUNCHES.get(name, 0),
        })
    for name, r in probes.items():  # launches on each probe module's own run
        summary["kernels"].append({
            "name": name, "route": "cuda",
            "source": STREAM_SOURCE if name.startswith("stream") else PROBE_SOURCE,
            "replaces": PROBES[name][0],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "floor_ms": floor[1], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ask_launches": ASK_LAUNCHES.get(name, 0),
            "sharded_launches": SHARDED_LAUNCHES.get(name, 0),
            "soak_launches": SOAK_LAUNCHES.get(name, 0),
        })
    log(f"stream_roof_gbps: {roof:.1f} ({card or 'card name and power limit unavailable'})")
    log(card or "nvidia-smi: name and power limit unavailable")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
