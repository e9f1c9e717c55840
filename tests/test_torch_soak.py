"""The port's soak (``python -m semtools_tpu_torch.soak``) on the CPU.

Each campaign runs at a few steps in a process of its own with ``--device
cpu`` and must report checks and no mismatch; a planted fault (the store's
batched search dropping each query's last hit) must make the soak exit 1: a
soak that cannot fail proves nothing. The soak's process checks that it
loaded nothing of jax or of the JAX package (exit 3 otherwise).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
ARGS = {
    "store": ["--steps", "8", "--seeds", "1"],
    "workspace": ["--steps", "12"],
    "daemon": ["--steps", "2"],
    "crash": ["--crash-rounds", "3"],
}


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMTOOLS_")}
    env.update(PYTHONPATH=str(REPO), HOME=str(tmp_path), SEMTOOLS_TPU_NO_FETCH="1",
               SEMTOOLS_TPU_ALLOW_FALLBACK="1")
    return env


def _reports(stdout: str):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith('{"campaign"')]


@pytest.mark.parametrize("campaign", sorted(ARGS))
def test_campaign_passes_on_cpu(tmp_path, campaign):
    proc = subprocess.run(
        [sys.executable, "-m", "semtools_tpu_torch.soak", "--device", "cpu",
         "--campaigns", campaign, *ARGS[campaign]],
        env=_env(tmp_path), cwd=str(tmp_path), capture_output=True, text=True,
        stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (rep,) = _reports(proc.stdout)
    assert rep["campaign"] == campaign and rep["failures"] == 0 and rep["checks"] > 0, rep
    assert rep["wall_s"] > 0 and set(rep["launches"]) >= {"int8_tilemax", "int4_sims_max"}
    if campaign == "store":
        assert len(rep["tiers"]) == 11


_PLANTED = r"""
import sys
from semtools_tpu_torch.store.store import Store

real = Store._search_batched_impl

def drop_last(self, *a, **k):
    return [hits[:-1] for hits in real(self, *a, **k)]

Store._search_batched_impl = drop_last
from semtools_tpu_torch.soak.campaigns import main
sys.exit(main(sys.argv[1:]))
"""


def test_planted_fault_fails_the_soak(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _PLANTED, "--device", "cpu", "--campaigns", "store",
         "--steps", "6", "--seeds", "1"],
        env=_env(tmp_path), cwd=str(tmp_path), capture_output=True, text=True,
        stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 1, proc.stderr[-3000:]
    (rep,) = _reports(proc.stdout)
    assert rep["failures"] > 0 and "STORE MISMATCH" in proc.stdout


def test_soak_needs_a_device(tmp_path):
    """Without a CUDA device and without ``--device cpu`` the soak refuses
    to run (no fallback to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "semtools_tpu_torch.soak", "--steps", "2"],
                          env=_env(tmp_path), cwd=str(tmp_path), capture_output=True,
                          text=True, stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert not _reports(proc.stdout)
