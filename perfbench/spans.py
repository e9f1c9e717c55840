"""The program's own spans over the traced window, for the per-layer readers.

Under ``SEMTOOLS_TPU_TIMINGS`` (set in a traced run before the program is
imported) ``semtools_tpu_torch.utils.tracing`` keeps the process's newest
spans in memory (``KEPT``, several windows' worth): ``records()`` gives
each one's name, request id, span
id, parent id, thread, start and end on ``time.perf_counter_ns()`` (the
clock of the harness's request times) and counters. A span opened with no
span open above it starts a request of its own: ``search`` around each
``search_documents_batched`` call, ``embed_query`` around the query embed.

The window's spans are those of every root span that lies inside one of
the window's requests, children and the collector's ``gc`` spans under
them included. A reader gives its number a program ``search`` a request;
nothing where the program keeps no spans (a program without
``records()``) or no ``search`` lies in the window.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

SLACK_NS = 1_000  # the harness's float seconds against integer nanoseconds


def program_records() -> Optional[list]:
    """The program's kept spans, or None where it keeps none."""
    from semtools_tpu_torch.utils import tracing

    records = getattr(tracing, "records", None)
    return None if records is None else records()


@dataclass
class Window:
    spans: list  # the records of the window's program requests
    searches: int  # program ``search`` calls among them

    def _children_ns(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for s in self.spans:
            if s.parent is not None:
                out[s.parent] = out.get(s.parent, 0) + (s.end - s.start)
        return out

    def self_ms(self, name: str) -> Optional[float]:
        """Self time of the spans named ``name`` (their duration less that
        of their children, ``gc`` spans included) a search, in ms; None
        where there is no such span."""
        kids = self._children_ns()
        own = [s.end - s.start - kids.get(s.span, 0) for s in self.spans if s.name == name]
        return sum(own) / 1e6 / self.searches if own else None

    def counter(self, name: str, key: str) -> Optional[float]:
        """Counter ``key`` of the spans named ``name``, a search."""
        found = [s for s in self.spans if s.name == name]
        if not found:
            return None
        return sum((s.attrs or {}).get(key, 0) for s in found) / self.searches

    def gc_ms(self) -> float:
        """The collector's passes under a program span, ms a search."""
        return sum(s.end - s.start for s in self.spans
                   if s.name == "gc" and s.parent is not None) / 1e6 / self.searches


def window(readings, records: Optional[Sequence] = None) -> Optional[Window]:
    """The program's spans of the requests in ``readings`` (``run.Readings``);
    ``records`` defaults to the program's."""
    if records is None:
        records = program_records()
    if not records or not readings.requests:
        return None
    reqs = sorted((round(r.start * 1e9) - SLACK_NS, round(r.end * 1e9) + SLACK_NS)
                  for r in readings.requests)
    starts = [a for a, _ in reqs]
    reach: List[int] = []  # the latest end of the requests started so far
    for _, b in reqs:
        reach.append(max(b, reach[-1]) if reach else b)
    rids, searches = set(), 0
    for s in records:
        if s.parent is not None or s.name == "gc":
            continue
        i = bisect.bisect_right(starts, s.start) - 1
        if i >= 0 and reach[i] >= s.end:
            rids.add(s.request)
            searches += s.name == "search"
    if not searches:
        return None
    return Window([s for s in records if s.request in rids], searches)
