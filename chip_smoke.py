#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``semtools_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and ``make``/``g++``;
exits non-zero without them. Phases:

1. build: compiles the scan kernels (``semtools_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once) for sm_90a and the native tokenizer
   (``cpp/`` into ``semtools_tpu_torch/_build/``);
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
   sims and block maxima bit-equal, the phases as in phase 3; the deep
   candidates of the kernel path equal those of the plain sweep through the
   same extraction, also past the candidate cap (``SEMTOOLS_TPU_INT4_CAP``),
   and equal the rows at or above their lowest sim when under it. Then
   ``int4_topk_scan`` through its public entry point (counts reset just
   before: the two-phase kernels' own path) against the plain phases, and
   times as in phase 2 at N = 10M, Q = 8, k = 10;
5. main path: ``semtools search`` through ``semtools_tpu_torch.cli.main``
   over ~1M lines of seeded synthetic text in 500 files (the corpus sits on
   the card as 1M x 256 f32) with the built-in 65,536 x 256 embedder, one
   query and an 8-query ``-Q`` batch, plus a 2,000-line search that routes
   to the single-phase kernel;
6. workspace: under a fresh HOME, ``workspace use``, a cold ``search -w``
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
   ``int4-mxu-scan`` and a search is served from it.

Phases 5 and 6 check their hits against a plain exact scan of the same
embeddings on the card (tolerance as in phase 2), and every kernel of each
path must show launches in that path's run (counts reset just before it).
The launch floor (an empty kernel through the kernels' ctypes path) is
timed after the build. The last line of stdout is ``{"ok": true,
"device": {...}}``; the lines before it are the card's name and power limit
and the per-kernel JSON summary (with ``device_ms`` and ``floor_ms`` beside
the contract's keys).
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
}
SOURCES = {"fused": FUSED_SOURCE, "int8": INT8_SOURCE, "int4": INT4_SOURCE,
           "select": SELECT_SOURCE}
K5 = ("int4_tilemax", "select_subtiles", "int4_rescan_topk", "int4_tilemax_masked",
      "int4_rescan_topk_masked")
K6 = ("int4_sims_max", "int4_sims_max_masked")
INT4_BUDGET = 209_715_200  # bytes: under the int8 corpus of 1M x 256, over the int4 one
E_SCALE = 1.0 / 7.0  # the packed corpora of phase 4 are random bytes: any scale serves
# Data-sheet peaks of one H100 SXM at 700 W: HBM bytes/s, f32 FLOP/s on the
# CUDA cores, int8 tensor-core OP/s.
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "int8": 1979e12}


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


def device_ms(fn, name=None, reps: int = 20) -> float:
    """Device time of ``fn`` under torch.profiler over ``reps`` calls: with
    ``name``, the mean of the traced launches of the kernels whose name holds
    it (one a call); without, all traced device work summed, per call. Where
    the profiler traces no device work, events around the replay of a CUDA
    graph of the same calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in e.name)]
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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
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
    return p4, dups


def int4_queries(p4, qn, gen):
    """(f32 queries, their int8 form, its scale); the first query is row 5's
    unpacked values, so the planted duplicates are its best rows."""
    import torch

    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops import int8_scan as i8

    q = torch.randn((qn, D), generator=gen, device="cuda")
    row = i4.unpack_f32(p4[5])
    row[: D // 2] -= 8
    q[0] = row
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
            q, q8, _ = int4_queries(p4, qn, gen)
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
                cand = i4.int4_deep_candidates(q, p4, n_true=n_true, mask=mask)
                same_candidates(f"deep candidates ({label})", cand,
                                i4.select_candidates(q8, ref_sims, ref_max, n_true), n_true,
                                ref_sims)
                if label == "few" and not all(
                        int((c < n_true).sum()) == int(mask[:n_true].sum()) for c in cand):
                    raise AssertionError("int4 deep candidates: not every kept row")
                if qn == 8 and label != "few":
                    check_over_cap(q, q8, p4, n_true, mask, ref_sims, ref_max)
                del ref_sims, ref_max, cand
                torch.cuda.empty_cache()
            log(f"kernels: int4 N={n} n_true={n_true} Q={qn} k=3,10,64,200 masks none/half/few: "
                f"equal to the plain versions; deep candidates equal the plain path's")
        if n == 10_000_000:
            launches = int4_topk_path(p4, n_true, dups, gen)
            times = time_int4_kernels(p4, n_true, gen)
        del p4
        torch.cuda.empty_cache()
    return errs, times, launches


OVER_CAP = "4"  # candidates kept per query when the cap binds (SEMTOOLS_TPU_INT4_CAP)


def check_over_cap(q, q8, p4, n_true, mask, ref_sims, ref_max):
    """Past the cap the tie rule alone decides: the kernel path keeps the same
    rows as the plain one; query 0 keeps the first 4 of its 7 equal rows."""
    from semtools_tpu_torch.ops import int4_scan as i4

    os.environ["SEMTOOLS_TPU_INT4_CAP"] = OVER_CAP
    try:
        cand = i4.int4_deep_candidates(q, p4, n_true=n_true, mask=mask)
        same_candidates("deep candidates over the cap", cand,
                        i4.select_candidates(q8, ref_sims, ref_max, n_true), n_true)
    finally:
        os.environ.pop("SEMTOOLS_TPU_INT4_CAP")
    if cand.shape[1] != int(OVER_CAP):
        raise AssertionError(f"over the cap: {cand.shape[1]} candidates per query")
    if mask is None and sorted(cand[0].tolist()) != [5, 127, 128, 511]:
        raise AssertionError(f"over the cap: query 0 kept {sorted(cand[0].tolist())}")


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
        return i4.select_candidates(q8, *i4.sims_max_reference(q8, p4, n_true, m), n_true)

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
    log_times(f"int4 N={p4.shape[0]} Q={qn} k={k}", t)
    for sfx in ("", "_masked"):
        after_phase1(t, "int4_topk_scan" + sfx, "int4_tilemax" + sfx)
    busy, wall, ops = device_busy(lambda: i4.int4_deep_candidates(q, p4, n_true=n_true), top=6)
    log(f"time: int4_deep_candidates N={p4.shape[0]} Q={qn} under torch.profiler: device busy "
        f"{busy:.3f} ms of {wall:.3f} ms wall; by kernel: "
        + "; ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in ops))
    return t


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
    stages = ", ".join(f"{name} {secs * 1e3:.1f} ms" for name, secs, _ in tracing.timings())
    return out.getvalue(), err.getvalue(), wall, stages


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
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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

            # a one-line edit: the rewrite re-embeds one line and reuses the rest
            edit_file, edit_line = 7, 100
            lines = Path(files[edit_file]).read_text().split("\n")
            lines[edit_line] = "quick brown fox crossing the river at night"
            Path(files[edit_file]).write_text("\n".join(lines))
            out, err, wall, stages = run_cli(
                ["search", QUERIES[1], *files, "-w", "smoke", "--top-k", "10", "-j"])
            if "embedded 1 unique new lines" not in err:
                raise AssertionError(f"workspace (edit): no reuse line in {err[-500:]!r}")
            hits["edit"] = out
            log(f"workspace: search -w (one-line edit): {wall:.3f} s wall; stages: {stages}; "
                f"{[ln.strip() for ln in err.splitlines() if 'reused' in ln][0]}")
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
            ref_d, _ = _topk_chunk(model.encode(QUERIES[3:4]), edited, 0, edited.shape[0], 10)
            thr = float(ref_d[0, 4] + ref_d[0, 5]) / 2  # five hits below it
            hits4, launches4 = int4_workspace_steps(files, qfile, subset, thr)
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
    return launches, launches4


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
    return hits, launches_of(K6, "int4 workspace")


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
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

    os.environ.update(SEMTOOLS_TPU_ALLOW_FALLBACK="1", SEMTOOLS_TPU_NO_FETCH="1",
                      SEMTOOLS_TPU_TIMINGS="1")
    os.environ.pop("SEMTOOLS_WORKSPACE", None)
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
    path_of.update({name: k6_launches for name in K6})
    summary = {"kernels": []}
    for name in REPLACES:
        r = times[name]
        summary["kernels"].append({
            "name": name, "route": "cuda",
            "source": SOURCES[name.split("_")[0]],
            "replaces": REPLACES[name],
            "launches": path_of[name][name],
            "max_abs_err": errs[name], "ms": r["ms"], "device_ms": r["device_ms"],
            "floor_ms": floor[1], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(card or "nvidia-smi: name and power limit unavailable")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
