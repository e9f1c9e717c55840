"""The end-to-end measurement drivers on a card, with the gates of
``chip_smoke.py``'s phase 17, at ``--small``'s sizes (seconds each):

``semtools_tpu_torch.probes.drivers.run_all(small=True)``: ``run_bench
--small`` (every config; ``sharded_scan`` on 4 shards of the card),
``workspace_e2e`` and ``daemon_parallel`` at 400 papers, and both embed
drivers at 2^16 tokens over 2^12 lines. Every driver's asserts, every
record on the card, recall@10 of ``int8-full`` and ``reduced-int8-64d`` at
least 0.99, and every kernel a config routes to launched in it. Needs a
CUDA card and skips without one; imports neither jax nor tests/conftest.py's
jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_drivers_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from semtools_tpu_torch.probes import drivers


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the drivers run the kernels, which have no CPU mode")


@pytest.fixture(scope="module")
def small_run(card, tmp_path_factory):
    return drivers.run_all(tmp_path_factory.mktemp("drivers"), small=True)


@pytest.mark.cuda
def test_drivers_gates_on_the_card(small_run):
    records = small_run["records"]
    assert set(records) == {tag for tag, _, _, small_args, *_ in drivers.RUNS
                            if small_args is not None}
    assert all(r["card"].startswith("card: ") for rows in records.values() for r in rows)


@pytest.mark.cuda
def test_drivers_launch_the_routed_kernels(small_run):
    launches = small_run["launches"]
    for name in drivers.F32 + drivers.INT8:
        assert launches.get(name), (name, launches)


@pytest.mark.cuda
def test_sharded_scan_on_four_shards(small_run):
    (rec,) = small_run["records"]["run_bench_sharded"]
    assert rec["devices"] == 4 and rec["virtual_shards_of_one_card"]
    assert rec["matches_single_device"]
