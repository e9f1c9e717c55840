"""The store-scale drivers on a card, with the gates of ``chip_smoke.py``'s
store-scale phase, at sizes that take seconds.

``semtools_tpu_torch.probes.capacity_ladder`` at a 16 MiB budget (54,390 to
283,605 rows: every hop names its tier, recall@10 1.0, distances within
1e-5, threshold mode exact, the int8 hop launching K3 and ``sel``, the int4
hop K6, ``sel``, K6c and K6x) and ``.patch_scale`` at 300 x 100 (the int8
tier forced by ``SEMTOOLS_TPU_STORE_INT8=1``: each update ships at most two
int8 documents, the one-line edit in a 30,000-line document at most 1 KiB,
every planted row found). Needs a CUDA card and skips without one; imports
neither jax nor tests/conftest.py's jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_store_scale_cuda.py -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from semtools_tpu_torch.probes import capacity_ladder, patch_scale

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the serving kernels have no CPU mode")


def _run(name: str, *args, tmp: Path, **env) -> list:
    out = tmp / f"{name}.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"semtools_tpu_torch.probes.{name}", *args, "--out", str(out)],
        cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO), **env),
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.cuda
def test_ladder_on_the_card(card, tmp_path):
    records = _run("capacity_ladder", "--budget", str(16 << 20), "--queries", "32",
                   "--reps", "2", tmp=tmp_path)
    hops = [r for r in records if r["config"] == "capacity_ladder"]
    assert [r["hop"] for r in hops] == list(capacity_ladder.HOPS)
    for row in hops:
        capacity_ladder.check_hop(row)
        assert row["device"] == "cuda" and row["card"].startswith("card: ")


@pytest.mark.cuda
@pytest.mark.parametrize("args", [("--docs", "300", "--lines", "100"),
                                  ("--single-file", "--lines", "30000")],
                         ids=["many_docs", "single_file"])
def test_patch_on_the_card(card, tmp_path, args):
    (row,) = _run("patch_scale", *args, tmp=tmp_path, SEMTOOLS_TPU_STORE_INT8="1")
    patch_scale.check(row)
    assert row["tier"] == "int8-mxu-scan"
    launched = {k for step in row["launches"].values() for k in step}
    assert {"int8_tilemax", "select_subtiles", "int8_rescan_topk"} <= launched
