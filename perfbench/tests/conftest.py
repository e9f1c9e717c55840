"""The benchmark's tests: the package ``perfbench`` from the repository
root, and a copy of the benchmark cut to a size the CPU runs in a second."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SEED = 2 ** 31 + 11  # a seed past 32 signed bits, as a run's may be


def shrink(root: Path) -> None:
    """Cut every configuration and traffic mix under ``root/perfbench`` to
    a CPU size; the shapes' kinds stay."""
    pb = root / "perfbench"
    for path in (pb / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["vocabulary"]["words"] = 2000
        if c["corpus"]["kind"] == "text":
            c["corpus"].update(documents=20, lines=3000, repeated_lines=50)
            c["model"]["table_rows"] = 5000
        else:
            c["corpus"].update(documents=30, lines_per_document=100, centroids=16,
                               text_pool_lines=500)
        path.write_text(json.dumps(c))
    for path in (pb / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(pool_requests=8, check_requests=3, warmup_rounds=1,
                 queries_per_request=min(t["queries_per_request"], 16))
        path.write_text(json.dumps(t))


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``perfbench/`` cut to CPU size."""
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shrink(tmp_path)
    return tmp_path


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
