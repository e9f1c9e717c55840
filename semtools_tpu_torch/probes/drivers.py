"""The repo's end-to-end measurement drivers on the card, with their gates:
what ``chip_smoke.py``'s phase 17 and ``tests/test_torch_drivers_cuda.py``
run.

Each driver runs in a child process on the card (``RUNS``), at the JAX
driver's own sizes, or at ``--small``'s for the card test:

- ``run_bench`` (every config but ``sharded_scan``), ``run_bench`` with
  ``sharded_scan`` on 4 shards of the card (``SEMTOOLS_TORCH_VIRTUAL_DEVICES=
  4``: a mesh of one card, so that no other config shards), and
  ``tier_recall`` again at 1,000,000 rows (full size only);
- ``workspace_e2e`` (8,000 papers; 400 small), ``daemon_parallel`` (2,000
  papers and 8 clients; 400 small), ``embed_baseline`` and
  ``embed_variants`` (their defaults; 2^16 tokens over 2^12 lines small).

:func:`run_all` fails when a driver exits non-zero (its own asserts), when a
record is missing, when ``int8-full`` or ``reduced-int8-64d`` reach a
recall@10 under ``MIN_RECALL``, or when a kernel that a config routes to
(``routes``) did not launch in it. It returns the records and each kernel's
launches summed over the drivers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

REPO = Path(__file__).resolve().parents[2]
MIN_RECALL = 0.99  # int8-full and reduced-int8-64d, at every size
F32 = ("fused_tilemax", "select_subtiles", "fused_rescan_topk")
INT8 = ("int8_tilemax", "select_subtiles", "int8_rescan_topk")
INT8_MASKED = ("int8_tilemax_masked", "select_subtiles", "int8_rescan_topk_masked")
BENCH_CONFIGS = ("search_e2e,batched_scan,batched_threshold,workspace_warm,workspace_batched,"
                 "line_reuse,ivfpq_recall,tier_recall,subset_warm")
TIER_ROWS = 1_000_000  # tier_recall's second size, as the JAX package's records have it
# (tag, driver, arguments, small arguments or None to skip, extra environment, timeout s)
RUNS = (
    ("run_bench", "run_bench", ("--configs", BENCH_CONFIGS),
     ("--configs", BENCH_CONFIGS, "--small"), {}, 600),
    ("run_bench_sharded", "run_bench", ("--configs", "sharded_scan"),
     ("--configs", "sharded_scan", "--small"), {"SEMTOOLS_TORCH_VIRTUAL_DEVICES": "4"}, 300),
    ("tier_recall_1m", "run_bench", ("--configs", "tier_recall", "--tier-n", str(TIER_ROWS)),
     None, {}, 600),
    ("workspace_e2e", "workspace_e2e", ("--papers", "8000"), ("--papers", "400"), {}, 600),
    ("daemon_parallel", "daemon_parallel", ("--papers", "2000", "--parallel", "8"),
     ("--papers", "400", "--parallel", "8"), {}, 600),
    ("embed_baseline", "embed_baseline", (), ("--tokens", "65536", "--lines", "4096"), {}, 300),
    ("embed_variants", "embed_variants", (), ("--tokens", "65536", "--lines", "4096"), {}, 300),
)


def routes(record: dict, small: bool) -> Tuple[str, ...]:
    """The kernels a record's path routes to (``ops/scan.py _use_fused``:
    Q <= 32, k <= 64, n >= 256 f32 rows; ``store.py``: the int8 tier from
    262,144 rows; ``int8_topk_scan`` always takes the int8 kernels; a mask,
    an int8 corpus through ``topk_scan``, Q 1,000 and IVF-PQ take none)."""
    config = record["config"]
    if config in ("search_e2e", "workspace_warm", "workspace_batched", "line_reuse_edit",
                  "sharded_scan", "daemon_parallel_reads"):
        return F32
    if config == "subset_warm":  # f32 below 262,144 rows: the mask is plain, compact fused
        return F32 if small else INT8 + INT8_MASKED
    if config == "tier_recall" and record["tier"] == "int8-full":
        return INT8
    if config == "workspace_e2e_realpipeline":
        return F32 if small else INT8
    return ()


def launches_of(record: dict) -> Dict[str, int]:
    """A record's launches summed over its steps (the e2e driver keeps them
    by step)."""
    counts = record.get("launches") or {}
    if counts and all(isinstance(v, dict) for v in counts.values()):
        total: Dict[str, int] = {}
        for step in counts.values():
            for k, v in step.items():
                total[k] = total.get(k, 0) + v
        return total
    return dict(counts)


def _child(name: str, args, out: Path, env_extra: dict) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMTOOLS_")}
    env.update(PYTHONPATH=str(REPO), **env_extra)
    return subprocess.Popen([sys.executable, "-m", f"semtools_tpu_torch.probes.{name}", *args,
                             "--out", str(out)], env=env, cwd=str(REPO),
                            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _records(out: Path) -> List[dict]:
    """A driver's ``--out``: one JSON object a line."""
    return [json.loads(ln) for ln in out.read_text().splitlines() if ln.strip()]


def host_memory_and_disk() -> str:
    import shutil
    import tempfile

    avail = "unknown"
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = f"{int(line.split()[1]) * 1024} bytes"
    except OSError:
        pass
    tmp = tempfile.gettempdir()
    return f"host memory available {avail}; {shutil.disk_usage(tmp).free} bytes free in {tmp}"


def run_all(out_dir: Path, small: bool = False, log: Callable[[str], None] = print) -> dict:
    """Every driver of ``RUNS`` on the card in turn, its gates held; returns
    {"records": {tag: [...]}, "launches": {kernel: total}, "walls_s": {tag: s}}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    records: Dict[str, List[dict]] = {}
    walls: Dict[str, float] = {}
    for tag, name, args, small_args, env_extra, timeout in RUNS:
        if small and small_args is None:
            continue
        if tag == "tier_recall_1m":  # ~1 GB of f32 on the host, made by numpy
            log(f"drivers: {tag}: {host_memory_and_disk()}")
        out = out_dir / f"{tag}.json"
        out.unlink(missing_ok=True)
        t0 = time.perf_counter()
        proc = _child(name, small_args if small else args, out, env_extra)
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        finally:
            proc.kill()
        walls[tag] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"drivers: {tag} exited {proc.returncode}: {stdout[-2000:]}"
                                 f"{stderr[-3000:]}")
        records[tag] = _records(out)
        log(f"drivers: {tag}: {len(records[tag])} records in {walls[tag]:.1f} s")
    check(records, small)
    launches: Dict[str, int] = {}
    for rows in records.values():
        for r in rows:
            for k, v in launches_of(r).items():
                launches[k] = launches.get(k, 0) + v
    return {"records": records, "launches": launches, "walls_s": walls}


def _want(small: bool) -> List[Tuple[str, str, object]]:
    """(tag, config, tier) of every record the runs must give."""
    bench = [("run_bench", c, None) for c in ("search_e2e", "batched_scan", "batched_threshold",
                                              "workspace_warm", "workspace_batched",
                                              "line_reuse_edit", "ivfpq_recall", "subset_warm")]
    tiers = ("int8-full", "reduced-int8-64d", "reduced-int8-32d", "ivf-pq-host")
    bench += [("run_bench", "tier_recall", t) for t in tiers]
    if not small:
        bench += [("tier_recall_1m", "tier_recall", t) for t in tiers]
    return bench + [("run_bench_sharded", "sharded_scan", None),
                    ("workspace_e2e", "workspace_e2e_realpipeline", None),
                    ("daemon_parallel", "daemon_parallel_reads", None)]


def check(records: Dict[str, List[dict]], small: bool) -> None:
    """The gates: every record there, the recall floors, the routed kernels
    launched."""
    for tag, config, tier in _want(small):
        got = [r for r in records.get(tag, []) if r.get("config") == config
               and (tier is None or r.get("tier") == tier)]
        if len(got) != 1:
            raise AssertionError(f"drivers: {tag} gave {len(got)} {config} {tier or ''} records")
        r = got[0]
        if r.get("device") != "cuda":
            raise AssertionError(f"drivers: {tag} {config} ran on {r.get('device')}")
        if tier in ("int8-full", "reduced-int8-64d") and r["value"] < MIN_RECALL:
            raise AssertionError(f"drivers: {tag} {tier} recall@10 {r['value']} at {r['n']} rows")
        missing = [k for k in routes(r, small) if not launches_of(r).get(k)]
        if missing:
            raise AssertionError(f"drivers: {tag} {config} {tier or ''} never launched {missing}: "
                                 f"{launches_of(r)}")
    for tag in ("embed_baseline", "embed_variants"):
        if not records.get(tag):
            raise AssertionError(f"drivers: {tag} gave no record")
