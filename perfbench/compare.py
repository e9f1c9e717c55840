"""The numbers that decide ``correct``: the program's answers to a sample of
the window's requests, judged against the plain reference.

Per query, a result is (filename, lines, start, end, match_line,
distance). A result whose lines, start and end are all None carries no
context (the workspace store's ``RankedLine``: path, line, distance; the CLI
reads the context from the file when it prints); where no result carries
any, ``context`` is left out of the numbers. The numbers, each over every
checked query:

- ``unanswered``: queries whose count of results is not min(k, rows) (top-k
  mode only), and results without context that name no row; exact,
  limit 0;
- ``order``: neighbouring results out of order (a larger distance first,
  or an equal one with the higher row first where the two rows are twins)
  or a row given twice; exact. Rows that tie only in exact arithmetic (the
  same bag of tokens in another order) embed a few ulps apart, so the
  order of such rows at one printed distance is rounding's, not a fault;
- ``ties``: results whose lower twins (rows of the same bits, so of the
  same distance to every query) are not all returned; exact;
- ``context``: results whose filename, match line, context start, end or
  lines differ from the reference's for that row, or that name no row, and,
  where some results carry context, the results that carry none; exact;
- ``dist_err``: the widest gap between a result's distance and the
  reference's distance of the same row;
- ``rank_gap`` (top-k): the widest amount by which the i-th nearest of the
  returned rows, by the reference's distances, lies beyond the reference's
  i-th nearest distance;
- ``threshold_gap`` (threshold mode): the widest amount by which a row the
  reference puts under the threshold and the program leaves out lies under
  it, or a returned row lies at or over it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import reference

EXACT = ("unanswered", "order", "ties", "context")


def judge(results: Sequence[Sequence[tuple]], q: torch.Tensor, e: torch.Tensor,
          layout: reference.Layout, n_lines: int, top_k: int,
          max_distance: Optional[float], twins,
          notes: Optional[List[str]] = None) -> Dict[str, float]:
    """The numbers over one batch of queries ``q`` [Q, D] (the reference's
    embeddings) and the program's ``results`` for them; a few examples of
    each fault go to ``notes``."""
    notes = [] if notes is None else notes
    told: Dict[str, int] = {}

    def note(kind: str, text: str) -> None:
        if told.get(kind, 0) < 3:
            told[kind] = told.get(kind, 0) + 1
            notes.append(f"{kind}: {text}")

    group, rank = twins
    # a query with no answer reads as an empty list; an answer to no query
    # counts as unanswered
    extra = max(0, len(results) - q.shape[0])
    results = list(results[:q.shape[0]]) + [[]] * (q.shape[0] - len(results[:q.shape[0]]))
    index = {f: i for i, f in enumerate(layout.filenames)}
    n = e.shape[0]
    out = {name: 0.0 for name in EXACT}
    out["unanswered"] += extra
    out["dist_err"] = 0.0
    rows_of: List[List[int]] = []
    bare = carried = 0  # results without and with context
    for res in results:
        rows = []
        for (fname, ctx, start, end, line, _dist) in res:
            row = layout.row(index, fname, line)
            rows.append(row)
            if ctx is None and start is None and end is None:
                bare += 1
                if row < 0:
                    out["unanswered"] += 1
                    note("unanswered", f"{fname!r} line {line} names no row")
                continue
            carried += 1
            if row < 0:
                out["context"] += 1
                note("context", f"{fname!r} line {line} names no row")
                continue
            s, t, want = reference.context(layout.lines[index[fname]], line, n_lines)
            if (start, end, list(ctx)) != (s, t, want):
                out["context"] += 1
                note("context", f"{fname!r} line {line}: got {start}..{end}, want {s}..{t}")
        rows_of.append(rows)
    # the reference's distance of every returned row
    flat_q = [qi for qi, rows in enumerate(rows_of) for r in rows if r >= 0]
    flat_r = [r for rows in rows_of for r in rows if r >= 0]
    ref_d = np.zeros(0)
    if flat_r:
        qi = torch.tensor(flat_q, device=e.device)
        ri = torch.tensor(flat_r, device=e.device)
        ref_d = reference.distances_of(q[qi], e[ri]).cpu().numpy()
    group_of = group[torch.tensor(flat_r, device=e.device)].tolist() if flat_r else []
    rank_of = rank[torch.tensor(flat_r, device=e.device)].tolist() if flat_r else []
    at = 0
    per_query_ref = []
    for res, rows in zip(results, rows_of):
        ok = [j for j, r in enumerate(rows) if r >= 0]
        d_ref = ref_d[at:at + len(ok)]
        groups = group_of[at:at + len(ok)]
        ranks = rank_of[at:at + len(ok)]
        at += len(ok)
        per_query_ref.append(d_ref)
        if ok:
            got = np.array([res[j][5] for j in ok], np.float64)
            out["dist_err"] = max(out["dist_err"], float(np.max(np.abs(got - d_ref))))
        # order: distance ascending, twins by row ascending, no row twice
        group_at = {rows[j]: g for j, g in zip(ok, groups)}
        for a, b in zip(range(len(res) - 1), range(1, len(res))):
            da, db = res[a][5], res[b][5]
            twins_ = rows[a] in group_at and group_at.get(rows[b]) == group_at[rows[a]]
            if db < da or (db == da and rows[b] < rows[a] and twins_):
                out["order"] += 1
                note("order", f"rows {rows[a]}, {rows[b]} at {da!r}, {db!r}")
        if len(set(rows)) != len(rows):
            out["order"] += 1
        # ties: a returned row's lower twins are returned too
        seen: Dict[int, List[int]] = {}
        for j, g in enumerate(groups):
            seen.setdefault(g, []).append(rows[ok[j]])
        for j, g in enumerate(groups):
            if ranks[j] and sum(1 for r in seen[g] if r < rows[ok[j]]) != ranks[j]:
                out["ties"] += 1
                note("ties", f"row {rows[ok[j]]} (program {res[ok[j]][5]!r}, reference "
                             f"{d_ref[j]!r}) returned with {ranks[j]} lower twins, of which "
                             f"{sorted(r for r in seen[g] if r < rows[ok[j]])} returned; "
                             f"all returned: {rows}")
    if max_distance is None:
        out["rank_gap"] = 0.0
        want_d, _ = reference.topk(q, e, top_k)
        want_d = want_d.cpu().numpy()
        for i, (res, d_ref) in enumerate(zip(results, per_query_ref)):
            if len(res) != min(top_k, n):
                out["unanswered"] += 1
            got = np.sort(d_ref)
            m = min(len(got), want_d.shape[1])
            if m:
                out["rank_gap"] = max(out["rank_gap"], float(np.max(got[:m] - want_d[i, :m])))
    else:
        out["threshold_gap"] = 0.0
        want = reference.threshold(q, e, max_distance)
        for rows, d_ref, (wd, wr) in zip(rows_of, per_query_ref, want):
            returned = set(r for r in rows if r >= 0)
            for dv, rv in zip(wd.tolist(), wr.tolist()):
                if rv not in returned:
                    out["threshold_gap"] = max(out["threshold_gap"], max_distance - dv)
            over = d_ref[d_ref >= max_distance]
            if len(over):
                out["threshold_gap"] = max(out["threshold_gap"],
                                           float(np.max(over - max_distance)))
    if bare and not carried:
        del out["context"]
    elif bare:
        out["context"] += bare
        note("context", f"{bare} results carry no context beside {carried} that do")
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (an exact one at 0); a number
    without a limit fails."""
    return all(name in limits and value <= limits[name] for name, value in numbers.items())
