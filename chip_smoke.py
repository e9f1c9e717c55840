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
   rows across sub-tile boundaries. Sims agree rank by rank within 1e-5;
   indices must be equal except at ranks where the plain version's
   neighbouring sims lie within 1e-5 (near-ties of summation order);
   planted duplicates resolve to the lower index. CUDA-event times of
   kernel and plain path at N = 2M, Q = 8, k = 10;
3. int8 kernels: each int8 kernel (plain and masked) against its plain
   version on int8 corpora of N = 2M and 10M rows x 256 (``quantize_global``
   of seeded unit rows; ragged n_true; planted duplicates), Q in {1, 8, 32},
   k in {3, 10, 64}, with no mask, a random 50% mask and a mask keeping
   fewer than k rows. Integer arithmetic: sims equal rank by rank, indices
   equal wherever finite, duplicates lowest first. CUDA-event times at
   N = 10M, Q = 8, k = 10;
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
   CUDA-event times at N = 10M, Q = 8, k = 10;
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
The last line of stdout is ``{"ok": true, "device": {...}}``; the lines
before it are the card's name and power limit and the per-kernel JSON
summary.
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
REPLACES = {
    "fused_tilemax": "semtools_tpu/ops/pallas_scan.py:269",
    "fused_rescan": "semtools_tpu/ops/pallas_scan.py:293",
    "fused_scan_candidates": "semtools_tpu/ops/pallas_scan.py:152",
    "int8_tilemax": "semtools_tpu/ops/int8_scan.py:118",
    "int8_rescan": "semtools_tpu/ops/int8_scan.py:133",
    "int8_tilemax_masked": "semtools_tpu/ops/int8_scan.py:217",
    "int8_rescan_masked": "semtools_tpu/ops/int8_scan.py:236",
    "int4_sims_max": "semtools_tpu/ops/int4_scan.py:317",
    "int4_sims_max_masked": "semtools_tpu/ops/int4_scan.py:334",
    "int4_tilemax": "semtools_tpu/ops/int4_scan.py:220",
    "int4_rescan": "semtools_tpu/ops/int4_scan.py:232",
    "int4_tilemax_masked": "semtools_tpu/ops/int4_scan.py:608",
    "int4_rescan_masked": "semtools_tpu/ops/int4_scan.py:624",
}
SOURCES = {"fused": FUSED_SOURCE, "int8": INT8_SOURCE, "int4": INT4_SOURCE}
K5 = ("int4_tilemax", "int4_rescan", "int4_tilemax_masked", "int4_rescan_masked")
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
    errs = {name: 0.0 for name in ("fused_tilemax", "fused_rescan", "fused_scan_candidates")}
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
                ids = fs.select_subtiles(ref_max, k)
                v, i = fs.rescan(q, e, n_true, ids, k)
                vr, ir = fs.rescan_reference(q, e, n_true, ids, k + 1)
                errs["fused_rescan"] = max(errs["fused_rescan"], agree("rescan", v, vr, i, ir))
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
    ids = fs.select_subtiles(fs.tilemax_reference(q, e, n_true), k)
    item = e.element_size()
    s = fs._num_blocks(n_true)
    u = ids.unique().numel()
    scan_ops = 2.0 * qn * n_true * D
    t = {
        "fused_tilemax": (
            cuda_ms(lambda: fs.tilemax(q, e, n_true)),
            cuda_ms(lambda: fs.tilemax_reference(q, e, n_true)),
            bound(n_true * D * item + qn * D * 4 + qn * s * 4, scan_ops, "f32")),
        "fused_rescan": (
            cuda_ms(lambda: fs.rescan(q, e, n_true, ids, k)),
            cuda_ms(lambda: fs.rescan_reference(q, e, n_true, ids, k)),
            bound(u * fs.SUB_ROWS * D * item + qn * D * 4 + ids.numel() * (8 + k * 12),
                  2.0 * ids.numel() * fs.SUB_ROWS * D, "f32")),
        "fused_scan_candidates": (
            cuda_ms(lambda: fs.scan_candidates(q, e, n_true, k)),
            cuda_ms(lambda: fs.scan_candidates_reference(q, e, n_true, k)),
            bound(n_true * D * item + qn * D * 4 + s * qn * k * 12, scan_ops, "f32")),
        "topk_scan": (
            cuda_ms(lambda: fs.fused_topk_scan(q, e, k, n_true=n_true)),
            cuda_ms(lambda: _topk_chunk(q, e, 0, n_true, k)),
            bound(n_true * D * item, scan_ops, "f32")),
    }
    for name, (ms, plain, (b, by)) in t.items():
        log(f"time: {e.dtype} N={e.shape[0]} Q={qn} k={k} {name}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
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
    from semtools_tpu_torch.ops.fused_scan import select_subtiles

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
                    ids = select_subtiles(ref_max, k)
                    v, i = i8.rescan(q8, e8, n_true, ids, k, mask)
                    vr, ir = i8.rescan_reference(q8, e8, n_true, ids, k, mask)
                    errs["int8_rescan" + sfx] = max(errs["int8_rescan" + sfx], equal(
                        f"int8_rescan{sfx}", v, vr, i, ir))
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
    from semtools_tpu_torch.ops.fused_scan import SUB_ROWS, _num_blocks, merge_candidates, \
        select_subtiles

    qn, k = 8, 10
    q = unit_rows(qn, gen)
    q8, _ = i8.quantize_global(q)
    s = _num_blocks(n_true)
    mask = int8_masks(e8.shape[0], gen)["half"]

    def plain_topk(mask):
        sub = i8.tilemax_reference(q8, e8, n_true, mask)
        v, i = i8.rescan_reference(q8, e8, n_true, select_subtiles(sub, k), k, mask)
        return merge_candidates(v.flatten(1), i.flatten(1), k)

    t = {}
    for sfx, m in (("", None), ("_masked", mask)):
        ids = select_subtiles(i8.tilemax(q8, e8, n_true, m), k)
        u = ids.unique().numel()
        mask_bytes = 0 if m is None else n_true
        t["int8_tilemax" + sfx] = (
            cuda_ms(lambda: i8.tilemax(q8, e8, n_true, m)),
            cuda_ms(lambda: i8.tilemax_reference(q8, e8, n_true, m)),
            bound(n_true * D + mask_bytes + qn * D + qn * s * 4, 2.0 * qn * n_true * D, "int8"))
        t["int8_rescan" + sfx] = (
            cuda_ms(lambda: i8.rescan(q8, e8, n_true, ids, k, m)),
            cuda_ms(lambda: i8.rescan_reference(q8, e8, n_true, ids, k, m)),
            bound(u * SUB_ROWS * (D + (0 if m is None else 1)) + qn * D
                  + ids.numel() * (8 + k * 12), 2.0 * ids.numel() * SUB_ROWS * D, "int8"))
        t["int8_topk_scan" + sfx] = (
            cuda_ms(lambda: i8.int8_topk_scan(q, e8, e_scale, k, n_true=n_true, mask=m)),
            cuda_ms(lambda: plain_topk(m)),
            bound(n_true * D + mask_bytes, 2.0 * qn * n_true * D, "int8"))
    for name, (ms, plain, (b, by)) in t.items():
        log(f"time: int8 N={e8.shape[0]} Q={qn} k={k}{' 50% mask' if 'masked' in name else ''} "
            f"{name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
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
    from semtools_tpu_torch.ops.fused_scan import SUB_ROWS, merge_candidates, select_subtiles

    sub = i4.tilemax_reference(q8, p4, n_true, mask)
    ids = select_subtiles(sub, min(k, sub.shape[1]))
    v, i = i4.rescan_reference(q8, p4, n_true, ids, min(k, SUB_ROWS), mask)
    return merge_candidates(v.flatten(1), i.flatten(1), k)


def int4_kernel_phase():
    import torch

    from semtools_tpu_torch.ops import int4_scan as i4
    from semtools_tpu_torch.ops.fused_scan import MAX_QUERIES, SUB_ROWS, select_subtiles

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
                        ids = select_subtiles(ref_sub, min(k, ref_sub.shape[1]))
                        kr = min(k, SUB_ROWS)
                        v, i = i4.rescan(qc, p4, n_true, ids, kr, mask)
                        vr, ir = i4.rescan_reference(qc, p4, n_true, ids, kr, mask)
                        equal(f"int4_rescan{sfx}", v, vr, i, ir)
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
    from semtools_tpu_torch.ops.fused_scan import SUB_ROWS, _num_blocks, select_subtiles

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
        ids = select_subtiles(i4.tilemax(q8, p4, n_true, m), k)
        u = ids.unique().numel()
        t["int4_sims_max" + sfx] = (
            cuda_ms(lambda: i4.sims_max(q8, p4, n_true, m)),
            cuda_ms(lambda: i4.sims_max_reference(q8, p4, n_true, m), reps=5),
            bound(n_true * row_bytes + mask_bytes + qn * D + qn * n_pad * 4
                  + qn * (n_pad // i4.SIMS_ROWS) * 4, scan_ops, "int8"))
        t["int4_tilemax" + sfx] = (
            cuda_ms(lambda: i4.tilemax(q8, p4, n_true, m)),
            cuda_ms(lambda: i4.tilemax_reference(q8, p4, n_true, m), reps=5),
            bound(n_true * row_bytes + mask_bytes + qn * D + qn * s * 4, scan_ops, "int8"))
        t["int4_rescan" + sfx] = (
            cuda_ms(lambda: i4.rescan(q8, p4, n_true, ids, k, m)),
            cuda_ms(lambda: i4.rescan_reference(q8, p4, n_true, ids, k, m)),
            bound(u * SUB_ROWS * (row_bytes + (0 if m is None else 1)) + qn * D
                  + ids.numel() * (8 + k * 12), 2.0 * ids.numel() * SUB_ROWS * D, "int8"))
        t["int4_topk_scan" + sfx] = (
            cuda_ms(lambda: i4.int4_topk_scan(q, p4, E_SCALE, k, n_true=n_true, mask=m)),
            cuda_ms(lambda: plain_int4_topk(q8, p4, n_true, k, m), reps=5),
            bound(n_true * row_bytes + mask_bytes, scan_ops, "int8"))
        t["int4_deep_candidates" + sfx] = (
            cuda_ms(lambda: i4.int4_deep_candidates(q, p4, n_true=n_true, mask=m)),
            cuda_ms(lambda: plain_deep(m), reps=5),
            bound(n_true * row_bytes + mask_bytes, scan_ops, "int8"))
    for name, (ms, plain, (b, by)) in t.items():
        log(f"time: int4 N={p4.shape[0]} Q={qn} k={k}{' 50% mask' if 'masked' in name else ''} "
            f"{name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by})")
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
    launches = launches_of(("fused_tilemax", "fused_rescan", "fused_scan_candidates"), "main")
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
            launches = launches_of([n for n in REPLACES if n.startswith("int8")
                                    or n in ("fused_tilemax", "fused_rescan")], "workspace")

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
    # fused kernels, workspace search for int8, the int4-tier workspace
    # steps for the sweep (K6) and int4_topk_scan's calls for K5
    path_of = {name: launches for name in REPLACES if name.startswith("fused")}
    path_of.update({name: ws_launches for name in REPLACES if name.startswith("int8")})
    path_of.update({name: k5_launches for name in K5})
    path_of.update({name: k6_launches for name in K6})
    summary = {"kernels": []}
    for name in REPLACES:
        ms, plain, (b, by) = times[name]
        summary["kernels"].append({
            "name": name, "route": "cuda",
            "source": SOURCES[name.split("_")[0]],
            "replaces": REPLACES[name],
            "launches": path_of[name][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })
    log(card or "nvidia-smi: name and power limit unavailable")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
