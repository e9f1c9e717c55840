"""Find a cell and everything that belongs to it, by name.

``BENCHMARK.json`` at the repository root lists the cells (``workloads``) and
metrics. Everything of one configuration, traffic mix, per-layer metric or
cell lies in a file of its own under this folder, found by its name:

- ``configs/<config>.json``: the deployment (corpus, vocabulary, model
  shape, search settings, and the route it is served on: ``serve``
  ``library``, the default, or ``workspace`` with its ``workspace``
  settings; ``run.py`` says what each does);
- ``traffic/<traffic>.json``: the mix (clients, queries a request, top-k or
  threshold, the query generator's parameters, how many requests are
  checked);
- ``metrics/<metric>.py``: a reader with ``read(readings)`` that returns the
  metric's value, or None where it finds nothing to read;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` in that cell.

A later cell, configuration, mix or metric is added by adding files and
entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


class BenchError(Exception):
    """The benchmark's own files do not describe the cell asked for."""


def _load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError(f"{path} is missing") from None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports
    root: Path  # the folder the cell's files were read from

    def reader(self, metric: str) -> Callable:
        """``read`` of ``metrics/<metric>.py``."""
        return read_of(self.root, metric)


def read_of(root: Path, metric: str) -> Callable:
    """``read`` of ``root/metrics/<metric>.py``; a reader that reads what
    another does under another name returns this."""
    path = Path(root) / "metrics" / f"{metric}.py"
    if not path.exists():
        raise BenchError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reports(metric: dict, workload: str) -> bool:
    listed = metric.get("workloads")
    return listed is None or workload in listed


def load_cell(benchmark_json: Path, workload: str, root: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``benchmark_json``, its files read from
    ``root`` (default: this folder)."""
    root = HERE if root is None else Path(root)
    bench = _load_json(Path(benchmark_json))
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in {benchmark_json}")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload) and m["moves"] in reported]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_load_json(root / "configs" / f"{w['config']}.json"),
        traffic=_load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(root / "limits" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        root=root,
    )
