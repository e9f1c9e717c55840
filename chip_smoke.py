#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``semtools_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and ``make``/``g++``;
exits non-zero without them. Phases:

1. build: compiles the fused scan kernels (``semtools_tpu_torch/csrc``) for
   sm_90a and the native tokenizer (``make -C cpp``);
2. kernels: each kernel against its plain PyTorch version on the card, at
   N = 2M and 10M rows x D = 256 f32 (plus bf16 at 2M), Q in {1, 8, 32},
   k in {3, 10, 64}, ragged n_true, planted duplicate rows across sub-tile
   boundaries. Sims agree rank by rank within 1e-5; indices must be equal
   except at ranks where the plain version's neighbouring sims lie within
   1e-5 (near-ties of summation order); planted duplicates resolve to the
   lower index. CUDA-event times of kernel and plain path at N = 2M, Q = 8,
   k = 10;
3. main path: ``semtools search`` through ``semtools_tpu_torch.cli.main``
   over ~1M lines of seeded synthetic text in 500 files (the corpus sits on
   the card as 1M x 256 f32) with the built-in 65,536 x 256 embedder, one
   query and an 8-query ``-Q`` batch, plus a 2,000-line search that routes
   to the single-phase kernel. Hits must equal the plain scan of the same
   embeddings (same tolerance), and every kernel's launch count from this
   phase must be non-zero.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the per-kernel JSON summary.
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
SOURCE = "semtools_tpu_torch/csrc/fused_scan.cu"
REPLACES = {
    "fused_tilemax": "semtools_tpu/ops/pallas_scan.py:269",
    "fused_rescan": "semtools_tpu/ops/pallas_scan.py:293",
    "fused_scan_candidates": "semtools_tpu/ops/pallas_scan.py:152",
}


def log(msg: str) -> None:
    print(msg, flush=True)


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

    t0 = time.perf_counter()
    path = kernels.build()
    lib = kernels.library()
    from semtools_tpu_torch.ops.fused_scan import SUB_ROWS

    if lib.semtools_scan_rows() != SUB_ROWS:
        raise AssertionError("kernel rows per block disagree with fused_scan.SUB_ROWS")
    log(f"build: kernels {path.name} ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.last_build_seconds} s)")
    report = path.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", report)]
    log(f"build: ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} registers, "
        f"{sum(1 for b in spills if b)} with spill stores (at most {max(spills)} bytes)")
    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-C", str(REPO / "cpp")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"make -C cpp failed:\n{proc.stderr[-2000:]}")
    log(f"build: native tokenizer (make -C cpp) in {time.perf_counter() - t0:.2f} s")


def make_corpus(n, dtype, n_true, gen):
    import torch

    e = torch.randn((n, 256), generator=gen, device="cuda")
    e /= e.norm(dim=1, keepdim=True)
    dups = [5, 127, 128, n // 2, n_true - 1]  # inside, across sub-tiles, far
    e[dups[1:]] = e[5].clone()
    return e.to(dtype), dups


def kernel_phase():
    import torch

    from semtools_tpu_torch.ops import fused_scan as fs

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {name: 0.0 for name in REPLACES}
    times = {}
    cases = [(n, torch.float32) for n in (2_000_000, 10_000_000)] + [(2_000_000, torch.bfloat16)]
    for n, dtype in cases:
        n_true = n - 777
        e, dups = make_corpus(n, dtype, n_true, gen)
        for qn in (1, 8, 32):
            q = torch.randn((qn, 256), generator=gen, device="cuda")
            q /= q.norm(dim=1, keepdim=True)
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
        if n == 2_000_000:
            times[str(dtype)[6:]] = time_kernels(e, n_true, gen)
        del e
        torch.cuda.empty_cache()
    return errs, times


def time_kernels(e, n_true, gen):
    import torch

    from semtools_tpu_torch.ops import fused_scan as fs
    from semtools_tpu_torch.ops.scan import _topk_chunk

    q = torch.randn((8, 256), generator=gen, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    k = 10
    ids = fs.select_subtiles(fs.tilemax_reference(q, e, n_true), k)
    t = {
        "fused_tilemax": (cuda_ms(lambda: fs.tilemax(q, e, n_true)),
                          cuda_ms(lambda: fs.tilemax_reference(q, e, n_true))),
        "fused_rescan": (cuda_ms(lambda: fs.rescan(q, e, n_true, ids, k)),
                         cuda_ms(lambda: fs.rescan_reference(q, e, n_true, ids, k))),
        "fused_scan_candidates": (cuda_ms(lambda: fs.scan_candidates(q, e, n_true, k)),
                                  cuda_ms(lambda: fs.scan_candidates_reference(q, e, n_true, k))),
        "topk_scan": (cuda_ms(lambda: fs.fused_topk_scan(q, e, k, n_true=n_true)),
                      cuda_ms(lambda: _topk_chunk(q, e, 0, n_true, k))),
    }
    for name, (ms, plain) in t.items():
        log(f"time: {e.dtype} N={e.shape[0]} Q=8 k=10 {name}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms")
    return t


WORDS = (
    "index query vector cosine search token embed kernel shard stream corpus "
    "database table row column page disk cache memory latency throughput file "
    "line word model device host batch merge select rank score distance tile "
    "quick brown fox lazy dog river mountain forest ocean city night morning "
    "error warn info debug trace span metric log event request reply server"
).split()


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
    from semtools_tpu_torch import cli
    from semtools_tpu_torch.utils import tracing

    tracing.reset()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"semtools search exited {rc}: {argv[:3]}...")
    stages = ", ".join(f"{name} {secs * 1e3:.1f} ms" for name, secs, _ in tracing.timings())
    return out.getvalue(), wall, stages


def check_hits(results, queries, model, corpus, starts, files, k):
    """CLI hits == plain scan of the same embeddings (tolerance as above)."""
    import torch

    from semtools_tpu_torch.ops.scan import _topk_chunk

    q = model.encode(queries)
    ref_d, ref_i = _topk_chunk(q, corpus, 0, corpus.shape[0], k + 1)
    pos = {f: i for i, f in enumerate(files)}
    got_i = torch.tensor([[starts[pos[r["filename"]]] + r["match_line_number"] for r in rs]
                          for rs in results], device=corpus.device)
    got_d = torch.tensor([[r["distance"] for r in rs] for rs in results], device=corpus.device)
    return agree("search hits", got_d, ref_d, got_i, ref_i)


def main_path_phase(dev):
    import numpy as np

    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.ops import kernels

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
        queries = ["database page cache latency", "quick brown fox", "vector search kernel",
                   "error log request", "river mountain forest", "shard merge select",
                   "token embed model", "night morning city"]
        qfile = root / "queries.txt"
        qfile.write_text("\n".join(queries) + "\n")

        kernels.reset_launch_counts()
        runs = [
            ("1 query, cold", ["search", queries[0], *files, "--top-k", "10", "-j"]),
            ("1 query, warm", ["search", queries[0], *files, "--top-k", "10", "-j"]),
            ("-Q 8 queries", ["search", "-Q", str(qfile), *files, "--top-k", "10", "-j"]),
            ("2000 lines", ["search", queries[1], *small, "--top-k", "10", "-j"]),
        ]
        outs = {}
        for label, argv in runs:
            out, wall, stages = run_cli(argv)
            outs[label] = out
            log(f"main: semtools search ({label}): {wall:.3f} s wall; stages: {stages}")
        launches = kernels.launch_counts()
        log(f"main: kernel launches from the main path: {launches}")
        missing = [name for name, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"main path never launched {missing}")

        model = StaticModel.from_pretrained("minishlab/potion-multilingual-128M", device=dev)
        corpus = model.encode(lines)
        starts = np.arange(len(files) + 1) * LINES_PER_FILE
        err = check_hits([json.loads(outs["1 query, warm"])["results"]], queries[:1],
                         model, corpus, starts, files, 10)
        batch = [json.loads(x) for x in outs["-Q 8 queries"].splitlines() if x.strip()]
        if [b["query"] for b in batch] != queries:
            raise AssertionError("-Q output does not list the 8 queries in order")
        err = max(err, check_hits([b["results"] for b in batch], queries, model, corpus,
                                  starts, files, 10))
        err = max(err, check_hits([json.loads(outs["2000 lines"])["results"]], queries[1:2],
                                  model, model.encode(small_lines), [0], small, 10))
        log(f"main: hits equal the plain scan of the same embeddings (max |d| err {err:.3g})")
        return launches


def main() -> int:
    if not (REPO / "semtools_tpu_torch").is_dir() or not (REPO / "semtools_tpu").is_dir():
        print("error: run chip_smoke.py from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device: the port's kernels need one", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from semtools_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")
    build_phase()
    errs, times = kernel_phase()
    launches = main_path_phase(dev)
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times["float32"][name][0], "plain_ms": times["float32"][name][1]}
        for name in REPLACES
    ]}
    log(card or "nvidia-smi: name and power limit unavailable")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
