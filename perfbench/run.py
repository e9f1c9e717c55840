"""Run one cell of the port's benchmark on the card this process is given.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is the ``workloads`` entry of
``BENCHMARK.json``; its configuration, traffic mix, limits and per-layer
metrics are files under this folder, found by name (``cells.py``). The run:

1. makes the cell's inputs from the seed and hands them to the program
   (``semtools_tpu_torch``) on the route the configuration's ``serve``
   names: ``library`` (the default) hands it the documents (embedded by
   the program in set-up, or views of one tensor made on the card), the
   model and a pool of request queries; ``workspace`` writes the documents
   as files under a fresh temporary directory, makes a workspace of its
   own whose store lies in another, and builds the store with one cold
   search over every file (``WorkspaceProgram``). Then it warms up with
   the cell's own requests;
2. measures for ``--seconds``: ``clients`` threads in a closed loop, each
   request one call of ``search_documents_batched`` (after
   ``_encode_queries`` where the queries are text), or on the workspace
   route one call of ``search_with_workspace_batched`` over every file,
   timed from its call to its return. Where the cell has an end-to-end
   metric read from the device's trace, the window runs under
   ``torch.profiler`` recording the device's activity alone.
   ``--trace 1`` runs the window under ``torch.profiler`` with the
   program's stage timings on, and reports the per-layer metrics instead
   of the end-to-end ones;
3. frees the program's state and judges a sample of the window's requests,
   drawn from the seed, against the plain reference (``compare.py``),
   printing each number beside its limit as the last lines of stderr
   (before them, one line of what the host did during the window: the
   process's CPU time, its involuntary context switches, the machine's
   stolen CPU time and the garbage collector's passes);
4. prints one JSON line: ``correct``, ``attempted``, ``failed`` (queries),
   ``metrics``, ``device`` and, traced, ``breakdown``; ``checks`` last.

Whatever the workspace route writes (the files, the store, the
workspace's ``config.json`` under ``~/.semtools/workspaces``) is removed
when the run ends, also after a failed request or an exception.

It exits non-zero with no result when there is no CUDA card (or fewer than
the cell asks for), when the program cannot be imported, and when the
process has loaded JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
import uuid  # noqa: E402
from contextlib import ExitStack, contextmanager, nullcontext  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(REPO)  # the program and this folder as a package, not its modules

from perfbench import cells, compare, devtrace, inputs, reference  # noqa: E402

# Top-level module names the run may not hold once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "semtools_tpu")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def n_lines(cell: cells.Cell) -> int:
    """Lines of context a hit: the traffic mix's, where it names them (an
    agent's tool call does), else the configuration's."""
    return int(cell.traffic.get("n_lines", cell.config["n_lines"]))


class HostWatch:
    """What the host did between :meth:`start` and :meth:`stop`: this
    process's CPU seconds and involuntary context switches, the machine's
    stolen CPU seconds (``/proc/stat``, all CPUs) and the garbage
    collector's passes and seconds by generation."""

    def __init__(self):
        self.gc_n = [0, 0, 0]
        self.gc_s = [0.0, 0.0, 0.0]
        self._t = 0.0

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.gc_n[g] += 1
            self.gc_s[g] += time.perf_counter() - self._t

    @staticmethod
    def _read():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        try:
            with open("/proc/stat") as f:
                fields = f.readline().split()
            steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            steal = float("nan")
        return time.perf_counter(), ru.ru_utime + ru.ru_stime, ru.ru_nivcsw, steal

    def start(self):
        self.t0 = self._read()
        gc.callbacks.append(self._gc)

    def stop(self):
        gc.callbacks.remove(self._gc)
        self.t1 = self._read()

    def line(self) -> str:
        (w0, c0, s0, st0), (w1, c1, s1, st1) = self.t0, self.t1
        return (f"host in the window: {w1 - w0:.3f} s wall, process CPU {c1 - c0:.3f} s, "
                f"{s1 - s0} involuntary context switches, {st1 - st0:.2f} s stolen over "
                f"{os.cpu_count()} CPUs ({len(os.sched_getaffinity(0))} usable); gc passes "
                f"{self.gc_n} taking {[round(x, 4) for x in self.gc_s]} s by generation")


@dataclass
class Record:
    client: int
    seq: int
    item: int  # index into the query pool
    start: float
    end: float
    queries: int
    results: int
    ok: bool

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Program:
    """The program under test on the library route, set up for one cell:
    its documents, its model where the queries are text, the request
    queries. It writes nothing outside the process, so ``scratch`` is not
    used."""

    def __init__(self, cell: cells.Cell, seed: int, device, scratch: Optional[ExitStack] = None):
        from semtools_tpu_torch import search

        self.search = search
        cfg, tr = cell.config, cell.traffic
        self.kind = cfg["corpus"]["kind"]
        if tr["query"]["kind"] != {"text": "text", "vectors": "vector"}[self.kind]:
            raise cells.BenchError(f"{tr['query']['kind']} queries on a {self.kind} corpus")
        self.config = search.SearchConfig(
            n_lines=n_lines(cell), top_k=int(tr["top_k"]),
            max_distance=tr.get("max_distance"), ignore_case=bool(cfg["ignore_case"]))
        self.model = None
        if self.kind == "text":
            self.corpus = inputs.text_corpus(cfg, seed)
            self.model = static_model(cfg, seed, device)
            self.documents = search.create_documents_from_contents(
                list(zip(self.corpus.filenames, self.corpus.contents)), self.model,
                self.config.ignore_case)
            self.pool = inputs.text_queries(cfg, tr, self.corpus, seed)
        else:
            self.corpus = inputs.vector_corpus_text(cfg, seed)
            rows = inputs.vector_corpus_rows(cfg, seed, device)
            self.documents, at = [], 0
            for name, lines in zip(self.corpus.filenames, self.corpus.lines):
                self.documents.append(search.Document(name, lines, rows[at:at + len(lines)]))
                at += len(lines)
            self.pool = inputs.vector_queries(tr, rows, seed)
        self.pool_size = len(self.pool)

    @property
    def rows(self) -> int:
        return self.corpus.rows

    @property
    def dim(self) -> int:
        return int(self.documents[0].embeddings.shape[1])

    @staticmethod
    def answers(per) -> List[tuple]:
        """One query's results as ``compare.judge`` reads them. This route
        returns context, so a result that lacks it reads as wrong context,
        not as a route without any."""
        return [(r.filename, r.lines or [], r.start, r.end, r.match_line, r.distance)
                for r in per]

    def request(self, item: int, span):
        """One request: the program's answers, one list a query."""
        if self.kind == "text":
            with span("embed_query"):
                q = self.search._encode_queries(self.pool[item], self.model, self.config)
        else:
            q = self.pool[item]
        with span("search"):
            return self.search.search_documents_batched(self.documents, q, self.config)

    def queries(self, item: int) -> int:
        return len(self.pool[item])


def static_model(cfg: dict, seed: int, device):
    """The configuration's hashed-tokenizer ``StaticModel``, its table made
    on ``device`` from the seed."""
    from semtools_tpu_torch.models.static_model import StaticModel
    from semtools_tpu_torch.models.tokenizer import HashTokenizer

    m = cfg["model"]
    tok = inputs.tokenizer_of(cfg)
    return StaticModel(
        inputs.model_table(cfg, seed, device),
        HashTokenizer(vocab_size=tok.vocab, ngram_min=tok.ngram_min,
                      ngram_max=tok.ngram_max),
        normalize=bool(m["normalize"]), name=cfg["name"])


# The configuration's ``workspace`` settings, each with the program's
# variable that carries it; every other serving setting is the program's
# default.
WORKSPACE_SETTINGS = {"device_cache_bytes": "SEMTOOLS_TPU_DEVICE_CACHE_BYTES",
                      "coalesce": "SEMTOOLS_TPU_COALESCE"}
# Variables of the program that the harness sets itself.
HARNESS_ENV = ("SEMTOOLS_TPU_NO_FETCH", "SEMTOOLS_TPU_TIMINGS")


def _pin_environment(scratch: ExitStack, values: Dict[str, str]) -> None:
    """Set the program's variables to ``values`` and unset its others
    (``SEMTOOLS_*``, but those the harness sets), so the configuration alone
    chooses how the store serves; restored when ``scratch`` closes."""
    saved = {k: v for k, v in os.environ.items()
             if k.startswith("SEMTOOLS_") and k not in HARNESS_ENV}

    def restore() -> None:
        for k in values:
            os.environ.pop(k, None)
        os.environ.update(saved)

    scratch.callback(restore)
    for k in saved:
        del os.environ[k]
    os.environ.update(values)


def _remove_workspace_config(config_dir: Path) -> None:
    """The workspace's folder under ``~/.semtools/workspaces``, then the
    folders above it where that leaves them empty."""
    shutil.rmtree(config_dir, ignore_errors=True)
    for parent in (config_dir.parent, config_dir.parent.parent):
        try:
            parent.rmdir()
        except OSError:
            break


class WorkspaceProgram:
    """The program serving a text corpus from the workspace store, as
    ``semtools search -w`` does in process and the daemon's
    ``_run_command`` does a request: each request one call of
    ``search_with_workspace_batched`` over every file, which embeds the
    query texts, checks every file for a change, and scans the store on the
    tier its policy picks.

    Set-up writes the documents as files under a fresh temporary directory,
    makes a workspace of a name of this run's own whose ``config.json``
    points its store at another, and builds the model; one cold call over
    every file then reads, hashes, embeds and upserts the files and picks
    the tier (``build_s``). The configuration's ``workspace`` object sets
    ``device_cache_bytes`` (the store's budget) and ``coalesce`` (merge
    concurrent searches into one scan, as the daemon does); the program's
    other variables are unset for the run. When ``scratch`` closes, the
    store's corpora leave the device cache and everything written is
    removed."""

    kind = "text"

    def __init__(self, cell: cells.Cell, seed: int, device, scratch: ExitStack):
        from semtools_tpu_torch import search
        from semtools_tpu_torch.store import (Store, Workspace, WorkspaceConfig, coalesce,
                                              device_cache)

        cfg, tr = cell.config, cell.traffic
        if cfg["corpus"]["kind"] != "text" or tr["query"]["kind"] != "text":
            raise cells.BenchError("the workspace route serves text corpora and text queries")
        settings = dict(cfg.get("workspace") or {})
        unknown = sorted(set(settings) - set(WORKSPACE_SETTINGS))
        if unknown:
            raise cells.BenchError(f"unknown workspace settings {unknown}; known: "
                                   f"{sorted(WORKSPACE_SETTINGS)}")
        self.search = search
        self.config = search.SearchConfig(
            n_lines=n_lines(cell), top_k=int(tr["top_k"]),
            max_distance=tr.get("max_distance"), ignore_case=bool(cfg["ignore_case"]))
        values = {WORKSPACE_SETTINGS[k]: str(int(v)) for k, v in settings.items()}
        # ``coalesce.enable()`` lasts the process, so a run without
        # ``coalesce`` keeps the funnel shut by the program's own switch
        values.setdefault(WORKSPACE_SETTINGS["coalesce"], "0")
        _pin_environment(scratch, values)
        if settings.get("coalesce"):
            coalesce.enable()  # as ``daemon.serve`` does

        self.corpus = inputs.text_corpus(cfg, seed)
        data_dir = Path(tempfile.mkdtemp(prefix="perfbench-files-"))
        scratch.callback(shutil.rmtree, data_dir, True)
        store_dir = tempfile.mkdtemp(prefix="perfbench-store-")
        scratch.callback(shutil.rmtree, store_dir, True)
        self.files = [str(data_dir / name) for name in self.corpus.filenames]
        text_bytes = 0
        for path, text in zip(self.files, self.corpus.contents):
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            text_bytes += Path(path).write_bytes(text.encode("utf-8"))
        self.names = dict(zip(self.files, self.corpus.filenames))
        self.workspace = f"perfbench-{uuid.uuid4().hex}"
        scratch.callback(_remove_workspace_config,
                         Path(Workspace.config_path_for(self.workspace)).parent)
        Workspace(WorkspaceConfig(name=self.workspace, root_dir=store_dir)).save()
        self.model = static_model(cfg, seed, device)
        self.pool = inputs.text_queries(cfg, tr, self.corpus, seed)
        self.pool_size = len(self.pool)

        t0 = time.perf_counter()
        self.search.search_with_workspace_batched(
            self.files, self.pool[self.pool_size - 1], self.model, self.config, self.workspace)
        self.build_s = time.perf_counter() - t0
        with Store(store_dir, dim=self.model.dim, model_name=self.model.name,
                   device=self.model.device) as store:
            self.rows = store.count_line_embeddings()
            self.dim = store.dim
            self.tier = store.serving_tier(self.rows)
        self.store_bytes = sum(p.stat().st_size for p in Path(store_dir).rglob("*")
                               if p.is_file())
        log(f"workspace: {len(self.files)} files of {text_bytes} bytes, {self.rows} lines, "
            f"store {self.store_bytes} bytes on disk, tier {self.tier}; cold build "
            f"{self.build_s:.3f} s")
        # every request closed its store; the card goes back before the reference
        scratch.callback(device_cache.invalidate)

    def answers(self, per) -> List[tuple]:
        """One query's ``RankedLine``s as ``compare.judge`` reads them: the
        corpus's filename and the line, no context."""
        return [(self.names.get(r.path, r.path), None, None, None, r.line_number, r.distance)
                for r in per]

    def request(self, item: int, span):
        """One request: the program's answers, one list of ``RankedLine`` a
        query."""
        with span("search"):
            return self.search.search_with_workspace_batched(
                self.files, self.pool[item], self.model, self.config, self.workspace)

    def queries(self, item: int) -> int:
        return len(self.pool[item])


ROUTES = {"library": Program, "workspace": WorkspaceProgram}


def route_of(cell: cells.Cell) -> str:
    route = cell.config.get("serve", "library")
    if route not in ROUTES:
        raise cells.BenchError(f"serve {route!r}: one of {sorted(ROUTES)}")
    return route


_current = threading.local()  # the span factory of the request a client thread is in


class StageWatch:
    """Log a harness span of kind ``scan`` around each of the program's own
    ``stage("scan")`` blocks (``utils/tracing.stage``, as ``search`` calls
    it), so the trace reader can tell the corpus concatenation before it
    from the scan. Installed for a traced window only."""

    def __init__(self, search_module):
        self.module = search_module
        self.real = search_module.stage

    def __enter__(self):
        real = self.real

        @contextmanager
        def stage(name):
            span = getattr(_current, "span", None)
            with (span("scan") if name == "scan" and span is not None else nullcontext()):
                with real(name):
                    yield

        self.module.stage = stage
        return self

    def __exit__(self, *exc):
        self.module.stage = self.real


class Keeper:
    """The requests kept for the check: a reservoir of ``size`` drawn with
    the seed's generator, and the request with the most results."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(inputs.sub_seed(seed, 9))
        self.kept: List[tuple] = []
        self.most: Optional[tuple] = None
        self.seen = 0
        self.lock = threading.Lock()

    def offer(self, rec: Record, results) -> None:
        with self.lock:
            self.seen += 1
            if self.most is None or rec.results > self.most[0].results:
                self.most = (rec, results)
            if len(self.kept) < self.size:
                self.kept.append((rec, results))
            else:
                j = self.rng.randrange(self.seen)
                if j < self.size:
                    self.kept[j] = (rec, results)

    def sample(self) -> List[tuple]:
        out = list(self.kept)
        if self.most is not None and all(r is not self.most[0] for r, _ in out):
            out.append(self.most)
        return sorted(out, key=lambda x: (x[0].client, x[0].seq))


class _Span:
    """A span on the host's clock, logged when it ends."""

    def __init__(self, log: list, client: int, kind: str, rid: int):
        self.log, self.client, self.kind, self.rid = log, client, kind, rid

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.log.append(devtrace.Span(self.client, self.kind, self.rid, self.t0,
                                      time.perf_counter_ns()))


def drive(program: Program, clients: int, seconds: float, keeper: Keeper,
          spans: Optional[list], first_item: int = 0, per_client: Optional[int] = None):
    """The closed loop: ``clients`` threads, each sending its next request
    when the last returns, until ``seconds`` have passed since the start
    (or each has sent ``per_client``). Returns (start, records, first
    error); given a ``spans`` list, each request's spans go to it."""
    records: List[List[Record]] = [[] for _ in range(clients)]
    errors: List[str] = []
    barrier = threading.Barrier(clients + 1)
    clock = {}

    def client(c: int) -> None:
        barrier.wait()
        stop = clock["stop"]
        seq = 0
        while time.perf_counter() < stop and (per_client is None or seq < per_client):
            item = (first_item + seq * clients + c) % program.pool_size
            rid = c * 1_000_000 + seq

            def span(kind, rid=rid, c=c):
                return nullcontext() if spans is None else _Span(spans, c, kind, rid)

            _current.span = span
            t0 = time.perf_counter()
            try:
                with span("request"):
                    res = program.request(item, span)
                ok = True
            except Exception:  # a failed request counts as failed, the run goes on
                res, ok = None, False
                if not errors:
                    errors.append(traceback.format_exc())
            t1 = time.perf_counter()
            rec = Record(c, seq, item, t0, t1, program.queries(item),
                         sum(len(r) for r in res) if ok else 0, ok)
            records[c].append(rec)
            if ok:
                keeper.offer(rec, res)
            seq += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"client{c}")
               for c in range(clients)]
    for t in threads:
        t.start()
    start = time.perf_counter()
    clock["stop"] = start + seconds
    barrier.wait()
    for t in threads:
        t.join()
    return start, [r for rs in records for r in rs], (errors[0] if errors else None)


@dataclass
class Readings:
    """What the per-layer metric readers read (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    rows: int
    dim: int
    requests: List[Record]
    window_s: float
    stages: Dict[str, tuple]  # name -> (seconds, count), over the window
    setup_stages: Dict[str, tuple]
    launches: Dict[str, int]  # program kernel launches over the window
    trace: Optional[devtrace.Summary]
    peak_window_bytes: int
    device_name: str
    power_limit_w: Optional[float]
    tier: Optional[str] = None  # the store's serving tier (``Store.serving_tier``), if any

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    def stage_ms_per_request(self, name: str) -> Optional[float]:
        if name not in self.stages or not self.requests:
            return None
        return self.stages[name][0] * 1e3 / len(self.requests)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def log(text: str) -> None:
    print(f"perfbench: [{time.perf_counter() - T_START:8.3f} s] {text}", file=sys.stderr,
          flush=True)


def percentile(values: List[float], p: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    v = sorted(values)
    x = (len(v) - 1) * p / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def reference_check(cell: cells.Cell, seed: int, device, corpus: inputs.Corpus, pool,
                    kept: List[tuple], notes: List[str],
                    tf32_control: bool = False) -> Dict[str, Dict]:
    """The numbers of the kept requests (each answer as ``compare.judge``
    reads it) against the plain reference (the inputs made again from the
    seed); with ``tf32_control`` also the numbers of the control, the
    reference in TF32 put in the program's place, over the same queries. Examples of faults go to ``notes``."""
    cfg, tr = cell.config, cell.traffic
    n_ctx, top_k, thr = n_lines(cell), int(tr["top_k"]), tr.get("max_distance")
    if cfg["corpus"]["kind"] == "text":
        lines = [reference.split_lines(c) for c in corpus.contents]
        layout = reference.Layout.of(corpus.filenames, lines)
        flat = [ln for doc in lines for ln in doc]
        table = inputs.model_table(cfg, seed, device)
        tok = inputs.tokenizer_of(cfg)
        m = cfg["model"]
        e = reference.embed_texts(flat, table, tok, int(m["max_length"]), bool(m["normalize"]))
        texts = [t for rec, _ in kept for t in pool[rec.item]]
        q = reference.embed_texts(texts, table, tok, int(m["max_length"]),
                                  bool(m["normalize"]))
        del table
        twins = reference.twin_ranks_of_keys(flat, device)
    else:
        layout = reference.Layout.of(corpus.filenames, corpus.lines)
        e = inputs.vector_corpus_rows(cfg, seed, device)
        qpool = inputs.vector_queries(tr, e, seed)
        q = qpool[[rec.item for rec, _ in kept]].flatten(0, 1)
        del qpool
        twins = reference.twin_ranks(e)
    results = [per for _, res in kept for per in res]
    hits = sorted(len(x) for x in results)
    if hits:
        notes.append(f"hits a checked query: median {percentile(hits, 50)}, mean "
                     f"{sum(hits) / len(hits)}, max {hits[-1]}, over {len(hits)} queries")
    out = {"program": compare.judge(results, q, e, layout, n_ctx, top_k, thr, twins, notes)}
    if tf32_control:
        if thr is None:
            d, i = reference.topk(q, e, top_k, tf32=True)
            pairs = zip(d.tolist(), i.tolist())
        else:
            pairs = ((d.tolist(), i.tolist()) for d, i in reference.threshold(q, e, thr, tf32=True))
        control = [reference.answers(layout, d, i, n_ctx) for d, i in pairs]
        out["control"] = compare.judge(control, q, e, layout, n_ctx, top_k, thr, twins)
    return out


def execute(cell: cells.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
            t_start: float = T_START, tf32_control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object. What the
    run writes outside the process is removed when it returns or raises."""
    with ExitStack() as scratch:
        return _execute(cell, seed, seconds, traced, device, t_start, tf32_control, scratch)


def _execute(cell: cells.Cell, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, tf32_control: bool, scratch: ExitStack) -> dict:
    route = route_of(cell)
    os.environ["SEMTOOLS_TPU_NO_FETCH"] = "1"
    if traced:
        os.environ["SEMTOOLS_TPU_TIMINGS"] = "1"
    else:
        os.environ.pop("SEMTOOLS_TPU_TIMINGS", None)
    import torch

    from semtools_tpu_torch.ops import kernels
    from semtools_tpu_torch.utils import tracing
    from semtools_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    tr = cell.traffic
    clients = int(tr["clients"])
    log("program imported")
    program = ROUTES[route](cell, seed, dev, scratch)
    log("inputs made")
    # warm-up: the cell's own requests, every client at once, from the
    # end of the pool
    warm_keeper = Keeper(0, seed)
    for r in range(int(tr["warmup_rounds"])):
        _, _, err = drive(program, clients, float("inf"), warm_keeper, None,
                          first_item=program.pool_size - (r + 1) * clients, per_client=1)
        if err:
            raise RuntimeError(f"warm-up request failed:\n{err}")
    if on_cuda:
        torch.cuda.synchronize(dev)
    setup_stages = {n: (s, c) for n, s, c in tracing.timings()}
    tracing.reset()
    kernels.reset_launch_counts()
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = spans = None
    # an end-to-end metric of the device's time: a trace of the device's
    # activity alone over the untraced window
    device_clock = on_cuda and not traced and any(
        m["source"] == "device_trace" for m in cell.end_to_end)
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        with record_function(devtrace.ANCHOR):
            anchor_ns = time.perf_counter_ns()
        spans = []
    elif device_clock:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    keeper = Keeper(int(tr["check_requests"]), seed)
    host = HostWatch()
    host.start()
    with StageWatch(program.search) if traced else nullcontext():
        start, records, error = drive(program, clients, float(seconds), keeper, spans)
    host.stop()
    setup_s = start - t_start
    if on_cuda:
        torch.cuda.synchronize(dev)
    summary = device_s = None
    if prof is not None:
        prof.__exit__(None, None, None)
        log("profiler stopped")
        events = prof.profiler.kineto_results.events()
        if traced:
            summary = devtrace.summarize(events, spans, anchor_ns)
        else:
            device_s = devtrace.busy_seconds(events)
        log("trace read")
        del prof, events
    window_end = max(r.end for r in records)
    window_s = window_end - start
    window_peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    stages = {n: (s, c) for n, s, c in tracing.timings()}
    tracing.reset()
    launches = kernels.launch_counts()
    ok = [r for r in records if r.ok]
    attempted = sum(r.queries for r in records)
    failed = sum(r.queries for r in records if not r.ok)
    device_name = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    power = power_limit_w() if on_cuda else None

    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not traced:
        values = {"setup_s": setup_s}
        if ok:
            answered = sum(r.queries for r in ok)
            values["search_qps"] = answered / window_s
            if device_s:
                values["search_device_ms"] = device_s * 1e3 / answered
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        readings = Readings(cell.config, tr, program.rows, program.dim, ok, window_s,
                            stages, setup_stages, launches, summary, window_peak,
                            device_name, power, getattr(program, "tier", None))
        for m in cell.per_layer:
            value = cell.reader(m["name"])(readings)
            if value is None:
                continue
            entry = value if isinstance(value, dict) else {"value": value}
            metrics[m["name"]] = {"value": float(entry.pop("value")), "unit": units[m["name"]],
                                  **entry}
    dev_info = {"platform": "gpu" if on_cuda else "cpu", "kind": device_name, "count": cell.chips,
                "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if power is not None:
        dev_info["power_limit_w"] = power
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in summary.by_name[:10]],
                               "idle_gaps": [list(x) for x in summary.idle[:10]]}
    # the program's state goes before the reference runs
    corpus, pool = program.corpus, program.pool
    if program.kind == "vectors":
        pool = None
    kept = [(rec, [program.answers(per) for per in res]) for rec, res in keeper.sample()]
    n_ok = len(ok)
    scratch.close()
    del program, records, ok, keeper
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    if error:
        print(f"perfbench: a request failed:\n{error}", file=sys.stderr)
    log(f"window {window_s:.3f} s, {n_ok} requests; set-up {setup_s:.3f} s")
    log(host.line())
    notes: List[str] = []
    numbers = {"program": {}, "control": {}}  # nothing answered, nothing to judge
    if kept:
        numbers = reference_check(cell, seed, dev, corpus, pool, kept, notes, tf32_control)
    log("reference check done")
    for line in notes:
        print(f"perfbench: {line}", file=sys.stderr)
    checks = {name: {"value": value, "limit": cell.limits.get(name)}
              for name, value in numbers["program"].items()}
    checks["requests_checked"] = {"value": len(kept), "limit": 1}
    result["correct"] = bool(kept) and not failed and compare.verdict(numbers["program"],
                                                                     cell.limits)
    if tf32_control:
        result["control_checks"] = numbers["control"]
        result["control_correct"] = compare.verdict(numbers["control"], cell.limits)
    result["checks"] = checks
    return result


NO_CONTEXT = ("check context: not checked: the answers carry none (the workspace route "
              "returns path, line and distance; the CLI reads the context from the file when "
              "it prints)")


def check_lines(result: dict) -> List[str]:
    checks = result["checks"]
    lines = [] if "context" in checks or "unanswered" not in checks else [NO_CONTEXT]
    for name, c in checks.items():
        rel = ">=" if name == "requests_checked" else "<="
        lines.append(f"check {name} = {c['value']!r} (limit {rel} {c['limit']!r})")
    lines.append(f"correct = {result['correct']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = cells.load_cell(REPO / "BENCHMARK.json", args.workload)
    except cells.BenchError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print("\n".join(check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
