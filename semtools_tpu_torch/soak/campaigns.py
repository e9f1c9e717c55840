"""Randomized soak of the port's serving stack against brute force.

Counterpart of the repository's ``scripts/soak.py`` (the bigger cousin of
the fuzz tests; its randomized traffic caught the zero-slot
candidate-crowding bug the fixed-seed fuzz missed). Four campaigns:

1. store: random upsert / partial edit / delete / compact / search
   sequences on every serving tier of :data:`TIERS`, random ``top_k``,
   thresholds, path subsets and batch sizes, degenerate rows (zeros,
   duplicates), dims 13 and 16;
2. workspace: random file writes, edits and deletes, then searches through
   ``search_with_workspace`` (line reuse, change detection, ignore-case)
   against the truth recomputed from the files;
3. daemon: searches forwarded to the port's daemon racing CLI writer
   processes (on the CPU), then a quiescent search against the truth;
4. crash: SIGKILL injection (:mod:`semtools_tpu_torch.soak.crash_harness`),
   the deterministic phase traps and random-instant kills.

Usage::

    python -m semtools_tpu_torch.soak [--steps 80] [--seeds 2] [--crash-rounds N]
        [--device cpu] [--campaigns store,workspace,daemon,crash]

It serves on the card unless ``--device cpu`` is given: no CUDA device and
no ``--device cpu`` is an error (exit 2), never a run on the CPU. The
sharded tiers run on a mesh of ``SEMTOOLS_TORCH_VIRTUAL_DEVICES`` shards of
the device (4 unless that variable is set). The crash campaign's children
mutate on the CPU (the crash contract is the host's); its verifier serves on
the device. After each campaign one JSON line: its checks, failures and wall
seconds, and the kernel launches of ``ops/kernels.py`` counted from zero
(the store campaign also by tier; the daemon campaign's are the daemon's and
the writers' processes'). Exit 1 on any mismatch or campaign error.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

os.environ.setdefault("SEMTOOLS_TORCH_VIRTUAL_DEVICES", "4")
os.environ.setdefault("SEMTOOLS_TPU_NO_FETCH", "1")
os.environ.setdefault("SEMTOOLS_TPU_ALLOW_FALLBACK", "1")

import numpy as np

from semtools_tpu_torch.soak import CHILD_TIMEOUT, LAUNCH_DIR_ENV, check_no_jax, child_env

CAMPAIGNS = ("store", "workspace", "daemon", "crash")

TIERS = [
    {},
    {"SEMTOOLS_TPU_STORE_INT8": "1"},
    {"SEMTOOLS_TPU_SHARDED": "1"},
    {"SEMTOOLS_TPU_SHARDED": "1", "SEMTOOLS_TPU_STORE_INT8": "1"},
    {"SEMTOOLS_TPU_REDUCED_DIM": "8", "SEMTOOLS_TPU_DEVICE_CACHE_BYTES": "6000"},
    {"SEMTOOLS_TPU_SCAN": "host"},
    # IVF-PQ under mutation churn: the index is rebuilt after 70% of the
    # writes, so whole-store queries serve from the probe (at soak scale the
    # candidate depth covers every row) and the stale windows fall through
    # to the exact paths; subsets take the compact path.
    {"SEMTOOLS_TPU_FORCE_ANN": "1"},
    # The int4 capacity rung: forced, sharded, and picked by a budget
    # squeeze. The budgets straddle the soak's corpus (up to ~300 rows x
    # 13/16 B of int8): int8 passes 2600 B early while int4 fits, and
    # 1800 B forces the reduced rung mid-churn as the corpus grows.
    {"SEMTOOLS_TPU_STORE_INT4": "1"},
    {"SEMTOOLS_TPU_SHARDED": "1", "SEMTOOLS_TPU_STORE_INT4": "1"},
    {"SEMTOOLS_TPU_DEVICE_CACHE_BYTES": "2600"},
    {"SEMTOOLS_TPU_REDUCED_DIM": "8", "SEMTOOLS_TPU_DEVICE_CACHE_BYTES": "1800"},
]
CLEAR = [
    "SEMTOOLS_TPU_STORE_INT8", "SEMTOOLS_TPU_SHARDED", "SEMTOOLS_TPU_REDUCED_DIM",
    "SEMTOOLS_TPU_DEVICE_CACHE_BYTES", "SEMTOOLS_TPU_SCAN",
    "SEMTOOLS_TPU_SUBSET_DEVICE", "SEMTOOLS_TPU_FORCE_ANN",
    "SEMTOOLS_TPU_STORE_INT4",
]


def tier_label(tier: dict) -> str:
    return "+".join(f"{k[len('SEMTOOLS_TPU_'):]}={v}" for k, v in tier.items()) or "exact"


def make_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    nn = np.linalg.norm(x, axis=1, keepdims=True)
    x = x / np.where(nn > 0, nn, 1)
    for i in range(n):
        r = rng.random()
        if r < 0.08:
            x[i] = 0.0
        elif r < 0.2 and i > 0:
            x[i] = x[int(rng.integers(0, i))]
    return x


def content_hashes(rows):
    """Content-derived per-row hashes (like lines.h64): re-upserting a
    partly edited doc then takes the patch's device-side moves, not only
    whole-range uploads."""
    import hashlib

    return np.array(
        [int.from_bytes(hashlib.blake2b(r.tobytes(), digest_size=8).digest(), "little") | 1
         for r in rows],
        np.uint64,
    )


def mutate_doc(rng, rows, d):
    """A partial edit of a doc: point edits and maybe an insert or a delete
    (shifting every later line, like a real file edit)."""
    m = rows.copy()
    for _ in range(int(rng.integers(1, max(2, len(m) // 4)))):
        m[int(rng.integers(0, len(m)))] = make_rows(rng, 1, d)[0]
    r = rng.random()
    if r < 0.3:
        at = int(rng.integers(0, len(m) + 1))
        m = np.concatenate([m[:at], make_rows(rng, 1, d), m[at:]])
    elif r < 0.5 and len(m) > 1:
        at = int(rng.integers(0, len(m)))
        m = np.concatenate([m[:at], m[at + 1:]])
    return m


def check_rows(got, dist, owner, order, t):
    """Tie-aware: distances agree position by position (the f32 path's
    tolerance) and every hit's reported distance is its true one."""
    if len(got) != len(order):
        return False
    for r, j in zip(got, order):
        if abs(r.distance - float(dist[j])) > 3e-4:
            return False
        jj = owner.index((r.path, r.line_number))
        if abs(float(dist[jj]) - r.distance) > 3e-4:
            return False
        if t is not None and not (r.distance < t + 3e-4):
            return False
    return True


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


def soak_store(steps, seeds, device):
    """Returns (checks, failures, {tier label: {kernel: launches}})."""
    from semtools_tpu_torch.ops.kernels import launch_counts
    from semtools_tpu_torch.store import device_cache
    from semtools_tpu_torch.store.store import Store

    fails = checks = 0
    by_tier: dict = {}
    for seed, tier, d in itertools.product(range(seeds), TIERS, (13, 16)):
        for k in CLEAR:
            os.environ.pop(k, None)
        os.environ.update(tier)
        device_cache.invalidate()
        before = launch_counts()
        rng = np.random.default_rng(7000 + seed)
        with tempfile.TemporaryDirectory(prefix="soak_store_") as td:
            s = Store(td + "/ws", dim=d, device=device)
            model = {}
            paths = [f"/doc{i}.txt" for i in range(6)]
            for step in range(steps):
                op = rng.random()
                p = paths[int(rng.integers(0, len(paths)))]
                if op < 0.5:
                    if p in model and rng.random() < 0.5:
                        m = mutate_doc(rng, model[p], d)
                    else:
                        m = make_rows(rng, int(rng.integers(1, 50)), d)
                    s.upsert_document_lines(p, m, content_hashes(m))
                    model[p] = m
                    if tier.get("SEMTOOLS_TPU_FORCE_ANN") and rng.random() < 0.7:
                        # 30% of the writes leave the index stale: queries must
                        # see the generation mismatch and fall through
                        s.build_ann_index(force=True)
                elif op < 0.65 and model:
                    victim = list(model)[int(rng.integers(0, len(model)))]
                    s.delete_line_embeddings([victim])
                    del model[victim]
                elif op < 0.7:
                    # a vacuum mid-churn: rows move, the free table empties, a
                    # fresh index remaps in place, a stale one retires
                    s.compact()
                elif model:
                    keys = sorted(model)
                    if rng.random() < 0.5 and len(keys) > 1:
                        # A path subset: the masked device path (forced half the
                        # time, so that it also runs cold) against the subset's
                        # truth.
                        take = int(rng.integers(1, len(keys)))
                        keys = sorted(rng.choice(keys, size=take, replace=False).tolist())
                        os.environ["SEMTOOLS_TPU_SUBSET_DEVICE"] = (
                            "1" if rng.random() < 0.5 else "auto")
                    else:
                        os.environ.pop("SEMTOOLS_TPU_SUBSET_DEVICE", None)
                    rows = np.concatenate([model[k2] for k2 in keys], axis=0)
                    owner = [(k2, i) for k2 in keys for i in range(len(model[k2]))]
                    top_k = int(rng.choice([1, 3, 70, len(owner) + 5]))
                    t = float(rng.uniform(0.3, 1.6)) if rng.random() < 0.5 else None
                    nq = int(rng.choice([1, 2, 40]))
                    qrows = make_rows(rng, nq, d)
                    per = s.search_line_embeddings_batched(qrows, keys, top_k, t)
                    for r in range(nq):
                        dist = 1.0 - rows @ qrows[r]
                        order = np.argsort(dist, kind="stable")[:top_k]
                        if t is not None:
                            order = order[dist[order] < t]
                        checks += 1
                        if not check_rows(per[r], dist, owner, order, t):
                            fails += 1
                            print(f"STORE MISMATCH seed={seed} tier={tier} d={d} "
                                  f"step={step} k={top_k} t={t} q={r}", flush=True)
            s.close()
        label = tier_label(tier)
        got = by_tier.setdefault(label, {})
        for k, v in _delta(before, launch_counts()).items():
            got[k] = got.get(k, 0) + v
        print(f"store campaign seed={seed} d={d} tier={label}: {checks} cumulative "
              f"checks, {fails} failures", flush=True)
    for k in CLEAR:
        os.environ.pop(k, None)
    device_cache.invalidate()
    return checks, fails, by_tier


WORDS = ["alpha", "beta", "gamma", "delta", "engine", "matrix", "tensor",
         "kernel", "fox", "jumps", "database", "index", "line", "search"]


@contextlib.contextmanager
def _home():
    """A HOME of its own (workspaces live under ~/.semtools)."""
    old = os.environ.get("HOME")
    with tempfile.TemporaryDirectory(prefix="soak_home_") as home:
        os.environ["HOME"] = home
        try:
            yield home
        finally:
            if old is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = old


def _truth(model, lines, query):
    emb = model.encode(lines, max_length=2048).cpu().numpy()
    qe = model.encode_single(query).cpu().numpy()
    return 1.0 - emb @ qe


def soak_workspace(steps, device):
    for k in CLEAR:
        os.environ.pop(k, None)
    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.search import SearchConfig, search_with_workspace
    from semtools_tpu_torch.store import Workspace, WorkspaceConfig
    from semtools_tpu_torch.store.store import Store

    model = StaticModel.fallback(device=device)
    fails = checks = 0
    with _home(), tempfile.TemporaryDirectory(prefix="soak_files_") as root:
        Workspace(WorkspaceConfig(name="fz", root_dir=Workspace.root_path("fz"))).save()
        rng = np.random.default_rng(123)
        tick = [time.time()]

        def write(path, lines):
            path.write_text("\n".join(lines) + ("\n" if lines else ""))
            tick[0] += 11
            os.utime(path, (tick[0], tick[0]))

        def rand_line():
            return " ".join(rng.choice(WORDS, rng.integers(1, 8)).tolist())

        files = {}
        for step in range(steps):
            op = rng.random()
            p = Path(root) / f"f{int(rng.integers(0, 5))}.txt"
            if op < 0.35 or not files:
                lines = [rand_line() for _ in range(int(rng.integers(1, 30)))]
                write(p, lines)
                files[str(p)] = lines
            elif op < 0.55 and str(p) in files:
                lines = files[str(p)]
                r2 = rng.random()
                if r2 < 0.4 and lines:
                    lines[int(rng.integers(0, len(lines)))] = rand_line()
                elif r2 < 0.7:
                    lines.insert(int(rng.integers(0, len(lines) + 1)), rand_line())
                elif len(lines) > 1:
                    lines.pop(int(rng.integers(0, len(lines))))
                write(p, lines)
            elif op < 0.65 and str(p) in files:
                p.unlink()
                del files[str(p)]
                with Store(Workspace.root_path("fz"), dim=model.dim, device=device) as s:
                    s.delete_documents([str(p)])
            else:
                if not files:
                    continue
                q = rand_line()
                cfg = SearchConfig(
                    top_k=int(rng.integers(1, 5)), n_lines=0,
                    ignore_case=bool(rng.random() < 0.3),
                    max_distance=float(rng.uniform(0.4, 1.2)) if rng.random() < 0.4 else None,
                )
                paths = sorted(files)
                qq = q.lower() if cfg.ignore_case else q
                got = search_with_workspace(paths, qq, model, cfg, "fz")
                all_lines = [ln.lower() if cfg.ignore_case else ln
                             for pp in paths for ln in files[pp]]
                dist = _truth(model, all_lines, qq)
                order = np.argsort(dist, kind="stable")[:cfg.top_k]
                if cfg.max_distance is not None:
                    order = order[dist[order] < cfg.max_distance]
                checks += 1
                ok = len(got) == len(order) and all(
                    abs(r.distance - float(dist[j])) < 3e-4 for r, j in zip(got, order))
                if not ok:
                    fails += 1
                    print(f"WORKSPACE MISMATCH step={step} cfg={cfg}", flush=True)
    return checks, fails


def _children_launches(launch_dir: Path) -> dict:
    total: dict = {}
    for f in sorted(launch_dir.glob("*.json")):
        for k, v in json.loads(f.read_text()).items():
            total[k] = total.get(k, 0) + v
    return total


def soak_daemon(steps, device):
    """Forwarded searches racing CLI writer processes.

    Three kinds of process touch one workspace: the resident daemon on
    ``device`` (the forwarded searches, from its device cache), CLI writers
    with the daemon off, on the CPU (they embed changed files and mutate the
    store under the flock: host work, as the crash campaign's children), and
    this one (the truth). A forwarded search fired while a writer runs
    must complete without error (passing staleness is allowed); once
    quiescent, a forwarded search must equal the truth recomputed from the
    files: the daemon's generation-keyed corpus must follow every
    mutation of another process. Returns (checks, failures, launches of the
    daemon's and the writers' processes)."""
    import socket as _socket
    import subprocess

    from semtools_tpu_torch.models.static_model import StaticModel

    fails = checks = 0
    with _home() as home, tempfile.TemporaryDirectory(prefix="soak_dmn_") as dmn_dir, \
            tempfile.TemporaryDirectory(prefix="soak_files_") as root:
        launch_dir = Path(dmn_dir) / "launches"
        launch_dir.mkdir()
        env = child_env(device, HOME=home, SEMTOOLS_TPU_DAEMON_DIR=dmn_dir,
                        SEMTOOLS_WORKSPACE="dz", **{LAUNCH_DIR_ENV: str(launch_dir)})
        cli = [sys.executable, "-m", "semtools_tpu_torch.soak.cli_child"]

        def run_cli(argv, extra_env=None, wait=True):
            e = dict(env, SEMTOOLS_TORCH_DEVICE="cpu")
            e.update(extra_env or {})
            p = subprocess.Popen(cli + argv, env=e, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, stdin=subprocess.DEVNULL)
            if not wait:
                return p
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"{argv} exited {p.returncode}: {err[-2000:]}")
            return out

        run_cli(["workspace", "use", "dz"])
        daemon = subprocess.Popen(cli + ["daemon", "run"], env=env, stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True, stdin=subprocess.DEVNULL)
        sock = Path(dmn_dir) / "daemon-torch.sock"
        deadline = time.monotonic() + CHILD_TIMEOUT
        while not sock.exists() and daemon.poll() is None and time.monotonic() < deadline:
            time.sleep(0.2)
        if not sock.exists():
            daemon.kill()
            raise AssertionError(f"the daemon never came up: {daemon.communicate()[1][-2000:]}")
        fwd_env = {k: v for k, v in env.items() if k.startswith("SEMTOOLS_")
                   and k not in ("SEMTOOLS_TPU_DAEMON", "SEMTOOLS_TPU_DAEMON_DIR")}
        fwd_env["HOME"] = home

        def request(payload, timeout=CHILD_TIMEOUT):
            with _socket.socket(_socket.AF_UNIX) as s:
                s.settimeout(timeout)
                s.connect(str(sock))
                s.sendall(json.dumps(payload).encode() + b"\n")
                buf = b""
                while not buf.endswith(b"\n"):
                    c = s.recv(1 << 20)
                    if not c:
                        break
                    buf += c
            return json.loads(buf)

        def forwarded(argv):
            resp = request({"argv": argv, "stdin": None, "cwd": home, "env": fwd_env})
            if resp.get("exit") != 0:
                raise AssertionError(f"forwarded {argv[:2]}: {resp.get('stderr')}")
            return resp

        model = StaticModel.fallback(device=device)  # the daemon's model
        words = WORDS[:12]
        rng = np.random.default_rng(321)
        tick = [time.time()]
        files = {}

        def write(path, lines):
            path.write_text("\n".join(lines) + ("\n" if lines else ""))
            tick[0] += 11
            os.utime(path, (tick[0], tick[0]))

        def rand_line():
            return " ".join(rng.choice(words, rng.integers(1, 7)).tolist())

        try:
            for step in range(steps):
                for _ in range(int(rng.integers(1, 4))):  # mutate 1-3 files
                    p = Path(root) / f"f{int(rng.integers(0, 5))}.txt"
                    lines = [rand_line() for _ in range(int(rng.integers(1, 25)))]
                    write(p, lines)
                    files[str(p)] = lines
                paths = sorted(files)
                # a CLI writer (embeds the changes, mutates the store)
                writer = run_cli(["search", rand_line(), *paths, "-n", "0"],
                                 extra_env={"SEMTOOLS_TPU_DAEMON": "off"}, wait=False)
                # forwarded reads racing the writer: must not fail
                for _ in range(2):
                    forwarded(["search", rand_line(), *paths, "-n", "0", "-j"])
                _, err = writer.communicate(timeout=CHILD_TIMEOUT)
                if writer.returncode != 0:
                    raise AssertionError(f"writer exited {writer.returncode}: {err[-2000:]}")
                if rng.random() < 0.3:
                    # a vacuum in another process: rows move on disk and the
                    # generation bumps; the daemon's corpus must follow
                    run_cli(["workspace", "compact"], extra_env={"SEMTOOLS_TPU_DAEMON": "off"})
                # quiescent: a forwarded search (it runs any pending update
                # itself) must equal the truth from the files
                q2 = rand_line()
                resp = forwarded(["search", q2, *paths, "-n", "0", "--top-k", "3", "-j"])
                got = json.loads(resp["stdout"])["results"]
                dist = _truth(model, [ln for pp in paths for ln in files[pp]], q2)
                order = np.argsort(dist, kind="stable")[:3]
                checks += 1
                ok = len(got) == len(order) and all(
                    abs(r["distance"] - float(dist[j])) < 3e-4 for r, j in zip(got, order))
                if not ok:
                    fails += 1
                    print(f"DAEMON MISMATCH step={step} q={q2!r}", flush=True)
        finally:
            with contextlib.suppress(Exception):
                request({"op": "stop"}, timeout=10)
            try:
                _, err = daemon.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                daemon.kill()
                _, err = daemon.communicate()
        if daemon.returncode != 0:
            raise AssertionError(f"the daemon exited {daemon.returncode}: {err[-2000:]}")
        launches = _children_launches(launch_dir)
    return checks, fails, launches


def soak_crash(rounds, device):
    """SIGKILL crash injection: every phase trap and random-instant kills of
    a child mutator, each round's store verified against the copy-on-write
    contract (atomic per-doc state, sidecar agreement, disjoint ranges,
    exact search on ``device``, writability)."""
    from semtools_tpu_torch.soak import crash_harness as ch

    fails = checks = 0
    rng = np.random.default_rng(424242)
    phases = sorted(ch.PHASES)
    for r in range(rounds):
        # Even rounds walk the phase traps in order (r // 2: every one of
        # them, not only the even indices); odd rounds kill at random.
        phase = phases[(r // 2) % len(phases)] if r % 2 == 0 else None
        kill_after = float(rng.uniform(0.05, 1.2))
        with tempfile.TemporaryDirectory(prefix="soak_crash_") as td:
            try:
                checks += ch.run_round(td, seed=1000 + r, phase=phase,
                                       steps=int(rng.integers(4, 25)),
                                       kill_after=kill_after, device=device)
            except ch.CrashVerifyError as e:
                fails += 1
                print(f"CRASH SOAK FAILURE round={r} phase={phase} "
                      f"kill_after={kill_after:.2f}: {e}", flush=True)
    return checks, fails


def _report(name: str, checks: int, fails: int, wall: float, launches: dict, **extra) -> None:
    print(json.dumps({"campaign": name, "checks": checks, "failures": fails,
                      "wall_s": round(wall, 3), "launches": launches, **extra}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m semtools_tpu_torch.soak",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--crash-rounds", type=int, default=None,
                    help="SIGKILL crash-injection rounds (default max(8, steps // 2))")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default cuda; no fallback)")
    ap.add_argument("--campaigns", default=",".join(CAMPAIGNS),
                    help=f"comma-separated subset of {','.join(CAMPAIGNS)}")
    args = ap.parse_args(argv)
    wanted = [c for c in args.campaigns.split(",") if c]
    unknown = sorted(set(wanted) - set(CAMPAIGNS))
    if unknown:
        ap.error(f"unknown campaigns {unknown}")

    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.utils.platform import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    device = str(dev)
    os.environ["SEMTOOLS_TORCH_DEVICE"] = device
    rounds = args.crash_rounds if args.crash_rounds is not None else max(8, args.steps // 2)
    runs = {
        "store": lambda: soak_store(args.steps, args.seeds, device),
        "workspace": lambda: soak_workspace(args.steps, device),
        "daemon": lambda: soak_daemon(min(args.steps, 12), device),
        "crash": lambda: soak_crash(rounds, device),
    }
    totals = {}
    for name in CAMPAIGNS:
        if name not in wanted:
            continue
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        extra = {}
        try:
            out = runs[name]()
            checks, fails = out[0], out[1]
            launches = kernels.launch_counts()
            if name == "store":
                extra["tiers"] = out[2]
            if name == "daemon":
                launches = {k: v + out[2].get(k, 0) for k, v in launches.items()}
        except Exception:  # noqa: BLE001 - a campaign error fails the soak, the rest still runs
            traceback.print_exc()
            checks, fails, launches = 0, 1, kernels.launch_counts()
            extra["error"] = traceback.format_exc(limit=1).strip().splitlines()[-1]
        _report(name, checks, fails, time.perf_counter() - t0, launches, **extra)
        totals[name] = (checks, fails)
    check_no_jax("soak")
    for name, (checks, fails) in totals.items():
        print(f"{name} soak: {checks} checks, {fails} failures", flush=True)
    return 1 if any(f for _, f in totals.values()) else 0
