"""Read a ``torch.profiler`` trace of the window.

The harness logs a span around each request and around each of its calls
into the program (kind ``request``, ``embed_query`` or ``search``) on the
host's clock, on every client thread, and one around each of the program's
own ``scan`` stages (``utils/tracing.stage("scan")`` inside
``search_documents_batched``, kind ``scan``). The profiler records annotations of
the thread that started it only, so the main thread marks one instant
(``bench:anchor``) that puts the two clocks side by side. From the raw
trace events this module gives:

- the traced window (first request's start to last request's end) and the
  seconds in it that the device was busy: the union of every device
  operation's interval (kernels, copies, fills);
- each device operation with the span it was launched from: the
  launching runtime call shares the operation's correlation id, and its
  thread is the client whose spans hold most of that thread's launches; an
  operation launched in a search before the program's ``scan`` stage began
  is the corpus concatenation's (``_corpus_of``), whatever its name;
- the device's time by operation name;
- the idle gaps, each labelled by what the client thread was doing at
  its middle: between requests, in ``embed_query``, or in ``search``
  before the start of its first operation launched in the scan stage
  (``search:corpus``), between that and the end of its last
  (``search:scan``) or after it (``search:results``). With several clients each client's labels are
  listed apart, after its number, so the seconds add up once a client.

A window of a 10M-line cell holds millions of device copies, so after one
pass over the events everything is numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
from torch.autograd import DeviceType

SPAN = "bench:"
ANCHOR = SPAN + "anchor"
KINDS = ("embed_query", "search")
# Launches that vote on which client a launching thread is.
VOTES = 50_000
_PHASES = ("between requests", "request, outside the program", "embed_query",
           "search:corpus", "search:scan", "search:results")


@dataclass
class Span:
    client: int
    kind: str
    request: int
    start: int  # ns, on the host's perf_counter clock
    end: int


@dataclass
class Summary:
    window_s: float
    busy_s: float
    by_name: List[Tuple[str, float]]
    idle: List[Tuple[str, float]]
    requests: int
    # one entry a device operation: its duration (ns), the kind of span it
    # was launched from (an index of KINDS, -1 for none), and whether it is
    # the corpus concatenation's: launched in a search before the search's
    # scan stage began
    dur: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    kind: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    corpus: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    staged: bool = False  # a scan stage of the program was seen

    def launched_in(self, kind: str) -> bool:
        return bool((self.kind == KINDS.index(kind)).any())

    def seconds(self, kind: str, corpus: bool) -> float:
        """Device seconds of the operations launched inside ``kind`` spans
        that are the corpus concatenation's (``corpus``), or of the others
        (kernels, copies and fills). Without a scan stage no operation is
        the concatenation's."""
        keep = (self.kind == KINDS.index(kind)) & (self.corpus if corpus else ~self.corpus)
        return float(self.dur[keep].sum()) / 1e9


def _empty() -> Summary:
    return Summary(0.0, 0.0, [], [], 0)


def busy_seconds(events) -> float:
    """Seconds in which any device operation ran (the union of their
    intervals), over all of ``events``: a trace of device activity alone,
    started and stopped around the window with the device synchronised at
    both ends, so every operation in it is the window's."""
    iv = np.array([(e.start_ns(), e.duration_ns()) for e in events
                   if e.device_type() != DeviceType.CPU and e.duration_ns() > 0],
                  np.int64).reshape(-1, 2)
    if not len(iv):
        return 0.0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    start, end = iv[:, 0], iv[:, 0] + iv[:, 1]
    reach = np.maximum.accumulate(end)
    gaps = np.maximum(start[1:] - reach[:-1], 0).sum()
    return float(reach[-1] - start[0] - gaps) / 1e9


def _span_at(starts: np.ndarray, ends: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Index of the span (sorted, not overlapping) holding each time, -1
    for none."""
    if not len(starts):
        return np.full(len(t), -1, np.int64)
    i = np.searchsorted(starts, t, side="right") - 1
    hit = (i >= 0) & (ends[np.maximum(i, 0)] >= t)
    return np.where(hit, i, -1)


def summarize(events, spans: Sequence[Span], anchor_ns: int) -> Summary:
    """A :class:`Summary` of the raw events of
    ``profile.profiler.kineto_results.events()`` and the harness's spans;
    ``anchor_ns`` is the host clock's reading inside ``bench:anchor``."""
    names: Dict[str, int] = {}
    d_name, d_start, d_dur, d_corr = [], [], [], []
    l_corr, l_tid, l_t = [], [], []
    offset = None
    for e in events:
        if e.device_type() != DeviceType.CPU:
            dur = e.duration_ns()
            if dur > 0:
                n = e.name()
                i = names.get(n)
                if i is None:
                    i = names[n] = len(names)
                d_name.append(i)
                d_start.append(e.start_ns())
                d_dur.append(dur)
                d_corr.append(e.linked_correlation_id() or e.correlation_id())
            continue
        n = e.name()
        if n[:2] == "cu":
            l_corr.append(e.correlation_id())
            l_tid.append(e.start_thread_id())
            l_t.append(e.start_ns())
        elif n == ANCHOR:
            offset = e.start_ns() - anchor_ns
    if offset is None or not spans:
        return _empty()
    kind_of = {k: i for i, k in enumerate(KINDS)}
    by_client: Dict[int, Dict[str, list]] = {}
    stage_at: Dict[int, int] = {}  # request -> start of its scan stage
    for sp in spans:
        c = by_client.setdefault(sp.client, {"req": [], "leaf": []})
        if sp.kind == "scan":
            stage_at.setdefault(sp.request, sp.start + offset)
            continue
        row = (sp.start + offset, sp.end + offset, sp.request, kind_of.get(sp.kind, -1))
        c["req" if sp.kind == "request" else "leaf"].append(row)
    clients = sorted(by_client)
    req, leaf = {}, {}
    for c in clients:
        for key, store in (("req", req), ("leaf", leaf)):
            a = np.array(sorted(by_client[c][key]), np.int64).reshape(-1, 4)
            store[c] = a
    all_req = np.concatenate([req[c] for c in clients])
    if not len(all_req):
        return _empty()
    w0, w1 = int(all_req[:, 0].min()), int(all_req[:, 1].max())

    names_list = [None] * len(names)
    for n, i in names.items():
        names_list[i] = n
    name = np.array(d_name, np.int64)
    start = np.array(d_start, np.int64)
    dur = np.array(d_dur, np.int64)
    end = start + dur
    corr = np.array(d_corr, np.int64)

    # the client of each launching thread, by votes; then each operation's span
    l_corr_a, l_tid_a, l_t_a = (np.array(x, np.int64) for x in (l_corr, l_tid, l_t))
    hold = np.stack([_span_at(leaf[c][:, 0], leaf[c][:, 1], l_t_a[:VOTES]) >= 0
                     for c in clients]) if len(l_t_a) else np.zeros((len(clients), 0), bool)
    one = hold.sum(0) == 1
    client_of: Dict[int, int] = {}
    if one.any():
        pairs = np.stack([l_tid_a[:VOTES][one], np.argmax(hold[:, one], axis=0)], 1)
        uniq, counts = np.unique(pairs, axis=0, return_counts=True)
        for (tid, ci), n in sorted(zip(uniq.tolist(), counts.tolist()), key=lambda x: x[1]):
            client_of[tid] = clients[ci]  # the most votes come last and win
    order = np.argsort(l_corr_a, kind="stable")
    pos = np.searchsorted(l_corr_a[order], corr)
    found = (pos < len(order)) & (l_corr_a[order][np.minimum(pos, len(order) - 1)] == corr) \
        if len(order) else np.zeros(len(corr), bool)
    li = order[np.minimum(pos, max(len(order) - 1, 0))] if len(order) else pos
    kind = np.full(len(corr), -1, np.int64)
    rid = np.full(len(corr), -1, np.int64)
    op_t = np.zeros(len(corr), np.int64)
    if len(order):
        op_tid, op_t = l_tid_a[li], l_t_a[li]
        for tid, c in client_of.items():
            sel = found & (op_tid == tid)
            j = _span_at(leaf[c][:, 0], leaf[c][:, 1], op_t[sel])
            ok = j >= 0
            idx = np.nonzero(sel)[0][ok]
            kind[idx] = leaf[c][j[ok], 3]
            rid[idx] = leaf[c][j[ok], 2]

    # busy time and idle gaps inside the window
    inw = (end > w0) & (start < w1)
    s = np.clip(start[inw], w0, w1)
    t = np.clip(end[inw], w0, w1)
    o = np.argsort(s, kind="stable")
    s, t = s[o], t[o]
    gap_a = np.maximum.accumulate(np.concatenate([[w0], t]))
    gap_b = np.concatenate([s, [w1]])
    g = gap_b > gap_a
    gap_a, gap_b = gap_a[g], gap_b[g]
    busy = (w1 - w0) - int((gap_b - gap_a).sum())
    w = np.bincount(name[inw], weights=dur[inw], minlength=len(names_list))
    by_name = sorted(((names_list[i][:120], float(w[i]) / 1e9) for i in np.nonzero(w)[0]),
                     key=lambda x: -x[1])

    # the corpus concatenation: launched in a search before its scan stage
    # began; then each request's first scan operation start and last end
    search = kind == KINDS.index("search")
    rids, inv = np.unique(rid[search], return_inverse=True)
    big = np.iinfo(np.int64).max
    began = np.array([stage_at.get(r, -1) for r in rids.tolist()], np.int64)
    corpus = np.zeros(len(corr), bool)
    corpus[search] = op_t[search] < began[inv]
    scan = search & ~corpus
    first = np.full(len(rids), big, np.int64)
    last = np.full(len(rids), np.iinfo(np.int64).min, np.int64)
    np.minimum.at(first, inv[~corpus[search]], start[scan])
    np.maximum.at(last, inv[~corpus[search]], end[scan])

    mid = (gap_a + gap_b) // 2
    idle = []
    for c in clients:
        r = _span_at(req[c][:, 0], req[c][:, 1], mid)
        j = _span_at(leaf[c][:, 0], leaf[c][:, 1], mid)
        ph = np.where(r < 0, 0, 1)
        lk = np.where(j >= 0, leaf[c][np.maximum(j, 0), 3], -1)
        ph = np.where((r >= 0) & (lk == KINDS.index("embed_query")), 2, ph)
        srch = (r >= 0) & (lk == KINDS.index("search"))
        a = b = np.full(len(mid), big, np.int64)  # a search that launched nothing
        if len(rids):
            k = np.minimum(np.searchsorted(rids, leaf[c][np.maximum(j, 0), 2]), len(rids) - 1)
            known = rids[k] == leaf[c][np.maximum(j, 0), 2]
            a, b = np.where(known, first[k], big), np.where(known, last[k], big)
        ph = np.where(srch, np.where(mid < a, 3, np.where(mid > b, 5, 4)), ph)
        sums = np.bincount(ph, weights=(gap_b - gap_a).astype(np.float64),
                           minlength=len(_PHASES))
        who = f"client {c}: " if len(clients) > 1 else ""
        idle += [(who + _PHASES[i], float(sums[i]) / 1e9) for i in np.nonzero(sums)[0]]
    idle.sort(key=lambda x: -x[1])
    return Summary((w1 - w0) / 1e9, busy / 1e9, by_name, idle, len(all_req), dur, kind, corpus,
                   bool(stage_at))
